"""Twins-SVT encoder (stages 1-2) and the RPE-context blocks of the cost
encoder's vertical attention (port of stitchax/models/twins.py).

The global-subsample attention of every GSA block runs the CUDA kernel K1
(`ops.kernels.gsa_attention`), the windowed attention of every LSA block
the CUDA kernel K4 (`ops.kernels.window_attention`), which reads the three
strided thirds of the fused qkv product in place. Context pairing follows
stitchax: the (B, ...) context is repeated per sample (`repeat_interleave`)
to the (B*K, ...) latent batch, not tiled like the reference's `.repeat`.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from .kernels_plain import gsa_attention
from .kernels_plain import window_attention
from .layers import Conv, Mlp, linear_position_embedding_sine, pad_to_multiple


class PatchEmbed(nn.Module):
    def __init__(self, cin: int, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = Conv(cin, embed_dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x):
        return self.norm(self.proj(x))


class PosConv(nn.Module):
    """PEG: depthwise 3x3 conv + residual."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = Conv(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x):
        return self.proj(x) + x


class LocallyGroupedAttn(nn.Module):
    """LSA: windowed self-attention with a fused qkv projection."""

    def __init__(self, dim: int, num_heads: int, ws: int = 7):
        super().__init__()
        self.num_heads, self.ws = num_heads, ws
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        C = x.shape[-1]
        qkv = x @ self.qkv.weight.T
        qx, kx, vx = qkv.split(C, -1)
        bq, bk, bv = self.qkv.bias.split(C)
        T = self.ws * self.ws
        out = window_attention(qx, kx, vx, bq.expand(T, C), bk.expand(T, C),
                               bv[None], heads=self.num_heads, ws=self.ws)
        return self.proj(out)


class GlobalSubSampleAttn(nn.Module):
    """GSA: queries on all tokens, keys/values on the sr-subsampled map."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.q = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = Conv(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.kv = nn.Linear(dim, dim * 2)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, H, W, C = x.shape
        q = self.q(x).reshape(B, H * W, C)
        xs = self.norm(self.sr(x)) if self.sr_ratio > 1 else x
        k, v = self.kv(xs).reshape(B, -1, 2 * C).split(C, -1)
        out = gsa_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            heads=self.num_heads)
        return self.proj(out.reshape(B, H, W, C))


class TwinsBlock(nn.Module):
    """Pre-norm block: x + attn(norm1 x); x + mlp(norm2 x); ws == 1 -> GSA."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 ws: int = 7, sr_ratio: int = 8):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = (GlobalSubSampleAttn(dim, num_heads, sr_ratio) if ws == 1
                     else LocallyGroupedAttn(dim, num_heads, ws))
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class TwinsSVT(nn.Module):
    """Stages 1-2 of twins_svt_large; returns (1/8-res 256-ch features,
    1/4-res 128-ch features)."""

    def __init__(self, embed_dims: Tuple[int, ...] = (128, 256),
                 num_heads: Tuple[int, ...] = (4, 8),
                 depths: Tuple[int, ...] = (2, 2),
                 patch_sizes: Tuple[int, ...] = (4, 2),
                 sr_ratios: Tuple[int, ...] = (8, 4), ws: int = 7,
                 mlp_ratio: int = 4):
        super().__init__()
        self.depths = depths
        cin = 3
        for i, dim in enumerate(embed_dims):
            setattr(self, f"patch_embed{i}",
                    PatchEmbed(cin, patch_sizes[i], dim))
            for j in range(depths[i]):
                setattr(self, f"block{i}_{j}",
                        TwinsBlock(dim, num_heads[i], mlp_ratio,
                                   ws if j % 2 == 0 else 1, sr_ratios[i]))
            setattr(self, f"pos_block{i}", PosConv(dim))
            cin = dim

    def forward(self, x):
        x_quarter = None
        for i, depth in enumerate(self.depths):
            x = getattr(self, f"patch_embed{i}")(x)
            for j in range(depth):
                x = getattr(self, f"block{i}_{j}")(x)
                if j == 0:
                    x = getattr(self, f"pos_block{i}")(x)
            if i == 0:
                x_quarter = x
        return x, x_quarter


def _project_context(proj: nn.Linear, context: torch.Tensor, batch: int):
    """Project the (B, ...) context once, then repeat each sample's result
    for its batch // B latents (per-sample pairing)."""
    ctx = proj(context)
    if ctx.shape[0] != batch:
        ctx = ctx.repeat_interleave(batch // ctx.shape[0], dim=0)
    return ctx


class LocallyGroupedAttnRPEContext(nn.Module):
    """Windowed attention with a window-local sine RPE and the projected
    context concatenated to the q/k stream (reference twins.py:229-304)."""

    def __init__(self, dim: int, num_heads: int, ws: int, vert_c_dim: int,
                 context_dim: int = 256):
        super().__init__()
        self.num_heads, self.ws, self.vert_c_dim = num_heads, ws, vert_c_dim
        self.context_proj = nn.Linear(context_dim, vert_c_dim)
        self.q = nn.Linear(dim + vert_c_dim, dim)
        self.k = nn.Linear(dim + vert_c_dim, dim)
        self.v = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, context):
        C = x.shape[-1]
        Cqk = C + self.vert_c_dim
        ctx = _project_context(self.context_proj, context, x.shape[0])
        x_qk = torch.cat([x, ctx], -1)
        g = torch.arange(self.ws, device=x.device, dtype=x.dtype)
        gy, gx = torch.meshgrid(g, g, indexing="ij")
        T = self.ws * self.ws
        enc = linear_position_embedding_sine(
            torch.stack([gx, gy], -1), dim=Cqk).reshape(T, Cqk)
        q_bias = self.q(enc)                   # W_q enc + b_q per position
        k_bias = self.k(enc)
        qx = x_qk @ self.q.weight.T            # bias-free streams
        kx = x_qk @ self.k.weight.T
        vx = x @ self.v.weight.T
        out = window_attention(qx, kx, vx, q_bias, k_bias, self.v.bias[None],
                               heads=self.num_heads, ws=self.ws)
        return self.proj(out)


class GlobalSubSampleAttnRPEContext(nn.Module):
    """Subsampled global attention with absolute sine RPE and context on the
    q/k stream (reference twins.py:306-392); its attention core is K1."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int,
                 vert_c_dim: int, context_dim: int = 256):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.vert_c_dim = vert_c_dim
        self.context_proj = nn.Linear(context_dim, vert_c_dim)
        self.q = nn.Linear(dim + vert_c_dim, dim)
        if sr_ratio > 1:
            self.sr_value = Conv(dim, dim, sr_ratio, stride=sr_ratio)
            self.sr_key = Conv(dim + vert_c_dim, dim, sr_ratio,
                               stride=sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, context):
        B, H, W, C = x.shape
        Cqk = C + self.vert_c_dim
        ctx = _project_context(self.context_proj, context, B)
        x_qk = torch.cat([x, ctx], -1)
        sr = self.sr_ratio
        x, (h0, w0) = pad_to_multiple(x, sr)
        x_qk, _ = pad_to_multiple(x_qk, sr)
        Hp, Wp = x.shape[1], x.shape[2]
        gy, gx = torch.meshgrid(
            torch.arange(Hp, device=x.device, dtype=x.dtype),
            torch.arange(Wp, device=x.device, dtype=x.dtype), indexing="ij")
        enc_q = linear_position_embedding_sine(torch.stack([gx, gy], -1),
                                               dim=Cqk)
        q = self.q(x_qk + enc_q[None])
        if sr > 1:
            xv = self.norm(self.sr_value(x))
            xk = self.norm(self.sr_key(x_qk))
        else:
            xv, xk = x, x_qk
        hs, ws_ = Hp // sr, Wp // sr
        gy, gx = torch.meshgrid(
            torch.arange(hs, device=x.device, dtype=x.dtype),
            torch.arange(ws_, device=x.device, dtype=x.dtype), indexing="ij")
        enc_k = linear_position_embedding_sine(
            torch.stack([gx, gy], -1) * sr, dim=C)
        k = self.k(xk + enc_k[None])
        v = self.v(xv)
        out = gsa_attention(q.reshape(B, Hp * Wp, C).contiguous(),
                            k.reshape(B, hs * ws_, C).contiguous(),
                            v.reshape(B, hs * ws_, C).contiguous(),
                            heads=self.num_heads)
        out = out.reshape(B, Hp, Wp, C)[:, :h0, :w0]
        return self.proj(out)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, nH*nW, ws*ws, C); H and W multiples of ws."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // ws) * (W // ws), ws * ws, C)


def window_merge(x: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    """The inverse of `window_partition`."""
    B, C = x.shape[0], x.shape[-1]
    x = x.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


class GroupAttnRPEContext(nn.Module):
    """Shifted-group windowed attention, the MAE-era variant (stitchax
    twins.py:297; reference twins.py:64-151): the batch splits into five
    equal groups whose key/value maps shift up / down / left / right / not
    at all by one window before windowed attention. No configuration builds
    it; it is plain attention in stitchax too, so no kernel here."""

    def __init__(self, dim: int, num_heads: int, ws: int, vert_c_dim: int,
                 context_dim: int = 256):
        super().__init__()
        self.num_heads, self.ws, self.vert_c_dim = num_heads, ws, vert_c_dim
        self.context_proj = nn.Linear(context_dim, vert_c_dim)
        self.q = nn.Linear(dim + vert_c_dim, dim)
        self.k = nn.Linear(dim + vert_c_dim, dim)
        self.v = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, context):  # x (B, H, W, C); context (B0, H, W, Cc)
        B, H, W, C = x.shape
        if B % 5:
            raise ValueError("GroupAttnRPEContext needs a batch divisible "
                             "by 5")
        ws, Cqk = self.ws, C + self.vert_c_dim
        x_qk = torch.cat([x, _project_context(self.context_proj, context, B)],
                         -1)
        x, _ = pad_to_multiple(x, ws)
        x_qk, _ = pad_to_multiple(x_qk, ws)
        Hp, Wp = x.shape[1], x.shape[2]
        gy, gx = torch.meshgrid(
            torch.arange(Hp, device=x.device, dtype=x.dtype),
            torch.arange(Wp, device=x.device, dtype=x.dtype), indexing="ij")
        enc = linear_position_embedding_sine(torch.stack([gx, gy], -1),
                                             dim=Cqk)[None]
        q = self.q(x_qk + enc)
        kv = torch.cat([self.k(x_qk + enc), self.v(x)], -1)
        # groups 0-3 shift by one window (edge rows / columns repeated),
        # group 4 stays (stitchax twins.py:340-353)
        n = B // 5
        g = [kv[i * n:(i + 1) * n] for i in range(5)]
        kv = torch.cat([
            torch.cat([g[0][:, ws:], g[0][:, Hp - ws:]], 1),
            torch.cat([g[1][:, :ws], g[1][:, :Hp - ws]], 1),
            torch.cat([g[2][:, :, ws:], g[2][:, :, Wp - ws:]], 2),
            torch.cat([g[3][:, :, :ws], g[3][:, :, :Wp - ws]], 2),
            g[4]], 0)
        k, v = kv.split(C, -1)
        T, h = ws * ws, self.num_heads
        d = C // h
        qw, kw, vw = (window_partition(t, ws).reshape(B, -1, T, h, d)
                      for t in (q, k, v))
        logits = torch.einsum("bnihd,bnjhd->bnhij", qw, kw) * d ** -0.5
        out = torch.einsum("bnhij,bnjhd->bnihd", torch.softmax(logits, -1),
                           vw)
        out = window_merge(out.reshape(B, -1, T, C), ws, Hp, Wp)[:, :H, :W]
        return self.proj(out)


class TwinsBlockRPEContext(nn.Module):
    """Pre-norm block around the RPE-context attention; ws == 1 -> global."""

    def __init__(self, dim: int, num_heads: int, ws: int, sr_ratio: int,
                 vert_c_dim: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = (GlobalSubSampleAttnRPEContext(dim, num_heads, sr_ratio,
                                                   vert_c_dim) if ws == 1
                     else LocallyGroupedAttnRPEContext(dim, num_heads, ws,
                                                       vert_c_dim))
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x, context):
        x = x + self.attn(self.norm1(x), context)
        return x + self.mlp(self.norm2(x))
