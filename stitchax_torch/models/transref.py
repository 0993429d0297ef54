"""TransRef: reference-guided transformer inpainting (port of
stitchax/models/transref.py:39-371).

A 4-stage SegFormer-style pyramid encoder (`Tenc`) patch-embeds the masked
input (with its inverse mask) and the reference image, aligns reference
features to input features with RefPA (deformable-conv alignment and
SE-style gating), runs a self-attention chain beside a cross-attention
branch over mini-patch embeddings, and adds the branch into the next stage;
a one-block-deep decoder at 1/64 (`Tdec`) and a transposed-conv tail with
skips (`ConvProjection`) produce a tanh image. NHWC throughout; modules
carry stitchax's names so `convert.load_jax_params` maps its param tree.
Attention is plain matmul + softmax (logits and softmax in fp32, then the
values' dtype), as stitchax's einsum is. Every LayerNorm has eps 1e-6;
GELU is the exact (erf) form; leaky ReLU slope 0.01.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deform import deform_conv2d_b
from .layers import Conv

EMBED_DIMS = (64, 128, 320, 512)
NUM_HEADS = (1, 2, 4, 4)
MLP_RATIOS = (2, 2, 2, 2)
DEPTHS = (2, 2, 2, 2)
SR_RATIOS = (4, 2, 2, 1)


def _ln(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6)


def _max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2, on NHWC (flax nn.max_pool, VALID): a side
    under 2 gives an empty map, as flax's does (TransRef at 128^2 pools a
    1x1 map at 1/128)."""
    if min(x.shape[1:3]) < 2:
        return x[:, :x.shape[1] // 2, :x.shape[2] // 2]
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def _softmax_f32(logits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.softmax(logits.float(), -1).to(dtype)


class ConvTranspose(nn.ConvTranspose2d):
    """flax nn.ConvTranspose on NHWC tensors, held as torch's
    ConvTranspose2d (see convert.py for the kernel and padding maps)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class OverlapPatchEmbed(nn.Module):
    """Strided conv patch embedding + LayerNorm."""

    def __init__(self, cin: int, embed_dim: int, patch: int = 7,
                 stride: int = 4):
        super().__init__()
        self.proj = Conv(cin, embed_dim, patch, stride=stride,
                         padding=patch // 2)
        self.norm = _ln(embed_dim)

    def forward(self, x):
        return self.norm(self.proj(x))


class DWConvMlp(nn.Module):
    """fc1 -> 3x3 depthwise conv -> exact GELU -> fc2."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = Conv(hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.gelu(self.dwconv(self.fc1(x))))


def _attend(q, k, v, heads: int):
    """Multi-head softmax attention over (B, N, C) tokens."""
    B, Nq, C = q.shape
    d = C // heads
    qh = q.reshape(B, Nq, heads, d).transpose(1, 2)
    kh = k.reshape(B, -1, heads, d).transpose(1, 2)
    vh = v.reshape(B, -1, heads, d).transpose(1, 2)
    logits = qh.float() @ kh.float().transpose(-1, -2) * d ** -0.5
    out = _softmax_f32(logits, v.dtype) @ vh
    return out.transpose(1, 2).reshape(B, Nq, C)


class SRAttention(nn.Module):
    """Self-attention with spatial-reduction keys; with `kv_source` it is
    cross-attention to the reference stream."""

    def __init__(self, dim: int, heads: int, sr_ratio: int):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr_ratio
        self.q = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = Conv(dim, dim, sr_ratio, stride=sr_ratio)
            self.sr_norm = _ln(dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, kv_source=None):
        B, H, W, C = x.shape
        kv_in = x if kv_source is None else kv_source
        q = self.q(x).reshape(B, H * W, C)
        if self.sr_ratio > 1:
            kv_in = self.sr_norm(self.sr(kv_in))
        k, v = self.kv(kv_in).reshape(B, -1, 2 * C).split(C, -1)
        out = self.proj(_attend(q, k, v, self.heads))
        return out.reshape(B, H, W, C)


class Block(nn.Module):
    """Pre-norm attention + DWConv-Mlp; attention "ref" attends to the
    normalised reference stream."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int, sr_ratio: int,
                 attention: str = "self"):
        super().__init__()
        self.attention = attention
        self.norm1 = _ln(dim)
        if attention == "ref":
            self.norm1_ref = _ln(dim)
        self.attn = SRAttention(dim, heads, sr_ratio)
        self.norm2 = _ln(dim)
        self.mlp = DWConvMlp(dim, dim * mlp_ratio, dim)

    def forward(self, x, ref=None):
        y = self.norm1(x)
        if self.attention == "ref":
            y = self.attn(y, self.norm1_ref(ref))
        else:
            y = self.attn(y)
        x = x + y
        return x + self.mlp(self.norm2(x))


# --------------------------- RefPA alignment --------------------------------


class NonLocal2D(nn.Module):
    """Embedded-gaussian non-local block with 2x2-subsampled phi/g."""

    def __init__(self, channels: int):
        super().__init__()
        inter = max(channels // 2, 1)
        self.g = Conv(channels, inter, 1)
        self.phi = Conv(channels, inter, 1)
        self.theta = Conv(channels, inter, 1)
        self.w = Conv(inter, channels, 1)

    def forward(self, x):
        B, H, W, _ = x.shape
        inter = self.g.out_channels
        g = _max_pool2(self.g(x)).reshape(B, -1, inter)
        phi = _max_pool2(self.phi(x)).reshape(B, -1, inter)
        theta = self.theta(x).reshape(B, H * W, inter)
        logits = theta.float() @ phi.float().transpose(1, 2)
        y = (_softmax_f32(logits, x.dtype) @ g).reshape(B, H, W, inter)
        return self.w(y) + x


class DynamicOffsetEstimator(nn.Module):
    """U-shaped offset feature net with non-local attention at each scale;
    the ups are torch ConvTranspose2d(k3, s2, p1, output_padding=1), i.e.
    flax padding ((1, 2), (1, 2))."""

    def __init__(self, cin: int, out_channels: int):
        super().__init__()
        self.down1 = Conv(cin, 64, 3, stride=2, padding=1)
        self.down2 = Conv(64, 64, 3, stride=2, padding=1)
        self.down3 = Conv(64, 64, 3, stride=2, padding=1)
        for i in (1, 2, 3):
            setattr(self, f"attn{i}", NonLocal2D(64))
            setattr(self, f"up{i}", ConvTranspose(64, 64, 3, stride=2,
                                                  padding=1, output_padding=1))
        self.scale = Conv(64, out_channels, 3, padding=1)

    def forward(self, x):
        act = lambda t: F.leaky_relu(t, 0.01)
        h2 = act(self.down1(x))
        h4 = act(self.down2(h2))
        h8 = act(self.down3(h4))
        a8 = self.attn1(h8) + h8
        u4 = act(self.up1(a8))
        a4 = self.attn2(u4) + h4
        u2 = act(self.up2(a4))
        a2 = self.attn3(u2) + h2
        u1 = act(self.up3(a2))
        return self.scale(u1)


class PA(nn.Module):
    """Offset-estimated deformable alignment of ref features to the input."""

    def __init__(self, channels: int):
        super().__init__()
        self.offset_estimator = DynamicOffsetEstimator(2 * channels, channels)
        self.offset_conv = Conv(channels, 18, 3, padding=1, bias=False)
        # He-normal over the (9 C, C) kernel's fan-in 9 C, as stitchax's
        self.deform_kernel = nn.Parameter(
            torch.randn(9 * channels, channels) * (2 / (9 * channels)) ** 0.5)

    def forward(self, feat, ref):
        est = self.offset_estimator(torch.cat([feat, ref], -1))
        return deform_conv2d_b(ref, self.offset_conv(est), self.deform_kernel)


class PH(nn.Module):
    """SE-style gated fusion of the input and the aligned reference."""

    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        self.fc1 = Conv(2 * channels, channels // reduction, 1)
        self.fc2 = Conv(channels // reduction, 2 * channels, 1)
        self.reduc = Conv(2 * channels, channels, 1)

    def forward(self, x, aligned):
        cat = torch.cat([x, aligned], -1)
        y = F.gelu(self.fc2(F.gelu(self.fc1(cat))))
        return F.gelu(self.reduc(cat * y))


class RefPA(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.pa = PA(channels)
        self.ph = PH(channels)

    def forward(self, feat, ref):
        return self.ph(feat, self.pa(feat, ref))


# ------------------------------ encoder -------------------------------------


class Tenc(nn.Module):
    """4-stage encoder with RefPA fusion and the intra-patch cross-attention
    branch."""

    def __init__(self):
        super().__init__()
        d = EMBED_DIMS
        pe = OverlapPatchEmbed
        self.patch_embed1 = pe(6, d[0], 7, 4)
        self.patch_embed1_ref = pe(3, d[0], 7, 4)
        for s in (1, 2, 3):                      # stages with a ref branch
            c = d[s - 1]
            setattr(self, f"refpa{s}", RefPA(c))
            setattr(self, f"mini_patch_embed{s}", pe(c, d[s], 3, 2))
            setattr(self, f"mini_patch_embed{s}_ref", pe(c, d[s], 3, 2))
            setattr(self, f"pnorm{s}", _ln(d[s]))
            # reference quirk: patch_block3 uses num_heads[1]
            heads = NUM_HEADS[s - 1] if s < 3 else NUM_HEADS[1]
            setattr(self, f"patch_block{s}_0",
                    Block(d[s], heads, MLP_RATIOS[s - 1], SR_RATIOS[s - 1],
                          attention="ref"))
        for s in (2, 3):
            setattr(self, f"patch_embed{s}_ref", pe(d[s - 2], d[s - 1], 3, 2))
        for s in (2, 3, 4):
            setattr(self, f"patch_embed{s}", pe(d[s - 2], d[s - 1], 3, 2))
        for s in (1, 2, 3, 4):
            for i in range(DEPTHS[s - 1]):
                setattr(self, f"block{s}_{i}",
                        Block(d[s - 1], NUM_HEADS[s - 1], MLP_RATIOS[s - 1],
                              SR_RATIOS[s - 1]))
            setattr(self, f"norm{s}", _ln(d[s - 1]))

    def _stage(self, s: int, x):
        for i in range(DEPTHS[s - 1]):
            x = getattr(self, f"block{s}_{i}")(x)
        return getattr(self, f"norm{s}")(x)

    def _branch(self, s: int, aligned, r1):
        x2 = getattr(self, f"mini_patch_embed{s}")(aligned)
        r2 = getattr(self, f"mini_patch_embed{s}_ref")(r1)
        return x2, r2

    def _cross(self, s: int, x2, r2):
        x2 = getattr(self, f"patch_block{s}_0")(x2, r2)
        return getattr(self, f"pnorm{s}")(x2)

    def forward(self, x, ref) -> List[torch.Tensor]:
        x1 = self.patch_embed1(x)
        r1 = self.patch_embed1_ref(ref)
        x2, r2 = self._branch(1, self.refpa1(x1, r1), r1)
        x1 = self._stage(1, x1)
        x2 = self._cross(1, x2, r2)
        outs = [x1]
        y = x1
        for s in (2, 3):
            y = getattr(self, f"patch_embed{s}")(y)
            r1 = getattr(self, f"patch_embed{s}_ref")(r1)
            y = y + x2
            a = getattr(self, f"refpa{s}")(y, r1)
            x2, r2 = self._branch(s, a, r1)
            y = self._stage(s, y)
            outs.append(y)
            x2 = self._cross(s, x2, r2)
        w = self.patch_embed4(y) + x2
        outs.append(self._stage(4, w))
        return outs


class Tdec(nn.Module):
    """One extra downsample, then three plain self-attention blocks at
    1/64."""

    def __init__(self):
        super().__init__()
        self.patch_embed1 = OverlapPatchEmbed(EMBED_DIMS[3], EMBED_DIMS[3],
                                              3, 2)
        for i in range(3):
            setattr(self, f"block1_{i}", Block(EMBED_DIMS[3], 8, 4, 1))
        self.norm1 = _ln(EMBED_DIMS[3])

    def forward(self, feats):
        x = self.patch_embed1(feats[3])
        for i in range(3):
            x = getattr(self, f"block1_{i}")(x)
        return self.norm1(x)


class ResidualBlock(nn.Module):
    """conv-relu-conv * 0.1 + skip."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = Conv(channels, channels, 3, padding=1)
        self.conv2 = Conv(channels, channels, 3, padding=1)

    def forward(self, x):
        return x + 0.1 * self.conv2(F.relu(self.conv1(x)))


class ConvProjection(nn.Module):
    """Upsampling tail with encoder skips; each up is torch
    ConvTranspose2d(k4, s2, p1), i.e. flax padding ((2, 2), (2, 2))."""

    UPS = (("convd32x", 512, 512), ("convd16x", 512, 320),
           ("convd8x", 320, 128), ("convd4x", 128, 64), ("convd2x", 64, 16),
           ("convd1x", 16, 8))

    def __init__(self):
        super().__init__()
        for name, cin, cout in self.UPS:
            setattr(self, name, ConvTranspose(cin, cout, 4, stride=2,
                                              padding=1))
        for name, c in (("dense4", 320), ("dense3", 128), ("dense2", 64),
                        ("dense1", 16)):
            setattr(self, name, ResidualBlock(c))

    def forward(self, feats, dec):
        x = self.convd32x(dec) + feats[3]
        x = self.dense4(self.convd16x(x)) + feats[2]
        x = self.dense3(self.convd8x(x)) + feats[1]
        x = self.dense2(self.convd4x(x)) + feats[0]
        x = self.dense1(self.convd2x(x))
        return self.convd1x(x)


class TransRefBase(nn.Module):
    """detail (B, H, W, 3) in [-1, 1] with the hole pre-filled, mask
    (B, H, W, 1) with 1 = hole, reference (B, H, W, 3) in [-1, 1] -> tanh
    image (B, H, W, 3). H and W are multiples of 64."""

    def __init__(self):
        super().__init__()
        self.tenc = Tenc()
        self.tdec = Tdec()
        self.convtail = ConvProjection()
        self.clean = Conv(8, 3, 3, padding=1)

    def forward(self, detail, mask, reference):
        inv_mask = (1.0 - mask).expand_as(detail)
        feats = self.tenc(torch.cat([detail, inv_mask], -1), reference)
        tail = self.convtail(feats, self.tdec(feats))
        return torch.tanh(self.clean(tail))
