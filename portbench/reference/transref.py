"""The reference's TransRef (Liu et al., "TransRef: Multi-Scale Reference
Embedding Transformer for Reference-Guided Image Inpainting",
arXiv:2306.11528; the reference repo vendors it at
core/inference/mix_methods/utils/TransRef/models/TransRef.py:896 with its
RefPA under models/RefPA/): a frozen copy of the port's plain
`models/transref.py` and `ops/deform.py`, in plain PyTorch and float32,
without the port's spans and counters, and a reader of the tracked flax
msgpack weights (`results/transref_ckpt_r05_bf16.msgpack`).

The model: a 4-stage SegFormer-style pyramid encoder (embed dims
64/128/320/512, heads 1/2/4/4, MLP ratio 2, depths 2/2/2/2, spatial
reduction 4/2/2/1, depthwise-conv MLPs) over the masked input (with its
inverse mask) and the reference image; RefPA in stages 1-3 (a U-shaped
offset estimator with non-local blocks, a deformable 3x3 convolution of the
reference features, SE-style gated fusion); an intra-patch cross-attention
branch to the reference stream added into the next stage; a one-block-deep
decoder at 1/64 and a transposed-conv tail with skips; a tanh image.

Departures from the published model, as the port and the JAX package have
them:
- NHWC tensors throughout; every LayerNorm has eps 1e-6; GELU is the exact
  (erf) form; leaky ReLU slope 0.01.
- mmcv's CUDA DeformConv2d (one deform group, no modulation, zero padding,
  no bias) is a bilinear gather of the K*K taps and one matmul; its
  backward is autograd's scatter-add.
- The reference's quirk is kept: the third cross-attention block
  (`patch_block3_0`) uses num_heads[1], 2 heads (TransRef.py:120).
- The decoder's `Attention_dec` (task queries) is dead code upstream:
  `Block_dec` builds the plain attention, as here.
- The 2x2 max pool of a non-local block floors odd sides and returns an
  empty map for a side under 2, as flax's VALID pool does (at 128^2 the
  third RefPA pools a 1x1 map); attention over no keys then gives zeros.
- The transposed convolutions double the side exactly, so the upstream
  odd-size crops never act on the power-of-two sides used here.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv
from .weights import decode_bf16, load_jax_params

EMBED_DIMS = (64, 128, 320, 512)
NUM_HEADS = (1, 2, 4, 4)
MLP_RATIOS = (2, 2, 2, 2)
DEPTHS = (2, 2, 2, 2)
SR_RATIOS = (4, 2, 2, 1)


# ------------------------------ the weights ---------------------------------

class _Msgpack:
    """A msgpack decoder for what `flax.serialization.to_bytes` writes of a
    state dict: maps, arrays, str / bin, ints, floats, nil, bool and flax's
    ext type 1 (an ndarray as [shape, dtype name, buffer])."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated input")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def num(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7f:
            return t
        if t >= 0xe0:
            return t - 0x100
        if t <= 0x8f:
            return self.map(t & 0x0f)
        if t <= 0x9f:
            return [self.read() for _ in range(t & 0x0f)]
        if t <= 0xbf:
            return self.take(t & 0x1f).decode()
        if 0xd4 <= t <= 0xd8:
            return self.ext(1 << (t - 0xd4))
        if t in (0xc0, 0xc2, 0xc3):
            return {0xc0: None, 0xc2: False, 0xc3: True}[t]
        sized = {0xc4: "B", 0xc5: "H", 0xc6: "I", 0xd9: "B", 0xda: "H",
                 0xdb: "I", 0xdc: "H", 0xdd: "I", 0xde: "H", 0xdf: "I",
                 0xc7: "B", 0xc8: "H", 0xc9: "I"}
        if t in sized:
            n = self.num(sized[t])
            if t in (0xc4, 0xc5, 0xc6):
                return self.take(n)
            if t in (0xd9, 0xda, 0xdb):
                return self.take(n).decode()
            if t in (0xdc, 0xdd):
                return [self.read() for _ in range(n)]
            if t in (0xde, 0xdf):
                return self.map(n)
            return self.ext(n)
        scalar = {0xca: "f", 0xcb: "d", 0xcc: "B", 0xcd: "H", 0xce: "I",
                  0xcf: "Q", 0xd0: "b", 0xd1: "h", 0xd2: "i", 0xd3: "q"}
        if t in scalar:
            return self.num(scalar[t])
        raise ValueError(f"msgpack: unsupported type byte 0x{t:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, n: int) -> np.ndarray:
        code = self.num("b")
        if code != 1:
            raise ValueError(f"msgpack: unsupported ext type {code}")
        shape, dtype, buf = _Msgpack(self.take(n)).read()
        a = (decode_bf16(np.frombuffer(buf, np.uint16)) if dtype == "bfloat16"
             else np.frombuffer(buf, np.dtype(dtype)).copy())
        return a.reshape(tuple(shape))


def load_flax_msgpack(path: str) -> Dict[str, Any]:
    """The nested dict of float32 numpy arrays of a flax msgpack file (bf16
    leaves decoded exactly)."""
    with open(path, "rb") as f:
        r = _Msgpack(f.read())
    tree = r.read()
    if r.pos != len(r.data) or not isinstance(tree, dict):
        raise ValueError(f"{path}: not one flax state dict")
    return tree


def load_transref(path: str) -> "TransRef":
    """TransRef in float32 on the CPU, every leaf from the msgpack."""
    return load_jax_params(TransRef(), load_flax_msgpack(path))


# --------------------------- deformable conv --------------------------------

def _gather_zero(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                 ) -> torch.Tensor:
    """Bilinear samples of img (B, H, W, C) at pixel coords x / y (B, ...),
    a corner outside the map reading zero -> (B, ..., C)."""
    B, H, W, C = img.shape
    shape = x.shape
    x, y = x.reshape(B, -1), y.reshape(B, -1)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    flat = img.reshape(B, H * W, C)
    out = 0.0
    for xi, yi, w in ((x0, y0, (1 - wx) * (1 - wy)),
                      (x0 + 1, y0, wx * (1 - wy)),
                      (x0, y0 + 1, (1 - wx) * wy),
                      (x0 + 1, y0 + 1, wx * wy)):
        ix = xi.nan_to_num(0.0).clamp(0, W - 1).long()
        iy = yi.nan_to_num(0.0).clamp(0, H - 1).long()
        inside = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        v = torch.gather(flat, 1, (iy * W + ix)[..., None].expand(-1, -1, C))
        out = out + v * (w * inside.to(img.dtype))[..., None]
    return out.reshape(*shape, C)


def deform_conv3x3(x: torch.Tensor, offsets: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """out(p) = sum_k W_k x(p + r_k + delta_k(p)): x (B, H, W, C), offsets
    (B, H, W, 18) as (dy, dx) per tap in row-major order, weights (9 C,
    C_out) -> (B, H, W, C_out)."""
    B, H, W, C = x.shape
    ys, xs = torch.meshgrid(torch.arange(H, device=x.device, dtype=x.dtype),
                            torch.arange(W, device=x.device, dtype=x.dtype),
                            indexing="ij")
    tap = torch.arange(9, device=x.device)
    off = offsets.reshape(B, H, W, 9, 2)
    sy = ys[..., None] + (tap // 3 - 1).to(x.dtype) + off[..., 0]
    sx = xs[..., None] + (tap % 3 - 1).to(x.dtype) + off[..., 1]
    taps = _gather_zero(x, sx, sy)                   # (B, H, W, 9, C)
    return (taps.reshape(B, H * W, 9 * C) @ weights).reshape(B, H, W, -1)


# ------------------------------- blocks -------------------------------------

def _ln(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6)


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2, NHWC; a side under 2 gives an empty map."""
    if min(x.shape[1:3]) < 2:
        return x[:, :x.shape[1] // 2, :x.shape[2] // 2]
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class ConvTranspose(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class OverlapPatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, patch: int = 7, stride: int = 4):
        super().__init__()
        self.proj = Conv(cin, dim, patch, stride=stride, padding=patch // 2)
        self.norm = _ln(dim)

    def forward(self, x):
        return self.norm(self.proj(x))


class DWConvMlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = Conv(hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.gelu(self.dwconv(self.fc1(x))))


def _attend(q, k, v, heads: int):
    B, Nq, C = q.shape
    d = C // heads
    split = lambda t: t.reshape(B, -1, heads, d).transpose(1, 2)
    logits = split(q) @ split(k).transpose(-1, -2) * d ** -0.5
    out = torch.softmax(logits, -1) @ split(v)
    return out.transpose(1, 2).reshape(B, Nq, C)


class SRAttention(nn.Module):
    """Spatial-reduction attention; cross-attention with `kv_source`."""

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
        if self.sr_ratio > 1:
            kv_in = self.sr_norm(self.sr(kv_in))
        k, v = self.kv(kv_in).reshape(B, -1, 2 * C).split(C, -1)
        out = _attend(self.q(x).reshape(B, H * W, C), k, v, self.heads)
        return self.proj(out).reshape(B, H, W, C)


class Block(nn.Module):
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
        y = self.attn(y, self.norm1_ref(ref)) if self.attention == "ref" \
            else self.attn(y)
        x = x + y
        return x + self.mlp(self.norm2(x))


class NonLocal2D(nn.Module):
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
        g = _pool2(self.g(x)).reshape(B, -1, inter)
        phi = _pool2(self.phi(x)).reshape(B, -1, inter)
        theta = self.theta(x).reshape(B, H * W, inter)
        y = torch.softmax(theta @ phi.transpose(1, 2), -1) @ g
        y = y.reshape(B, H, W, inter)
        return self.w(y) + x


class DynamicOffsetEstimator(nn.Module):
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
        u4 = act(self.up1(self.attn1(h8) + h8))
        u2 = act(self.up2(self.attn2(u4) + h4))
        u1 = act(self.up3(self.attn3(u2) + h2))
        return self.scale(u1)


class PA(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.offset_estimator = DynamicOffsetEstimator(2 * channels, channels)
        self.offset_conv = Conv(channels, 18, 3, padding=1, bias=False)
        # He-normal over the (9 C, C) kernel's fan-in, as the port's
        self.deform_kernel = nn.Parameter(
            torch.randn(9 * channels, channels) * (2 / (9 * channels)) ** 0.5)

    def forward(self, feat, ref):
        est = self.offset_estimator(torch.cat([feat, ref], -1))
        return deform_conv3x3(ref, self.offset_conv(est), self.deform_kernel)


class PH(nn.Module):
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


class Tenc(nn.Module):
    def __init__(self):
        super().__init__()
        d, pe = EMBED_DIMS, OverlapPatchEmbed
        self.patch_embed1 = pe(6, d[0], 7, 4)
        self.patch_embed1_ref = pe(3, d[0], 7, 4)
        for s in (1, 2, 3):
            c = d[s - 1]
            setattr(self, f"refpa{s}", RefPA(c))
            setattr(self, f"mini_patch_embed{s}", pe(c, d[s], 3, 2))
            setattr(self, f"mini_patch_embed{s}_ref", pe(c, d[s], 3, 2))
            setattr(self, f"pnorm{s}", _ln(d[s]))
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
        return (getattr(self, f"mini_patch_embed{s}")(aligned),
                getattr(self, f"mini_patch_embed{s}_ref")(r1))

    def _cross(self, s: int, x2, r2):
        return getattr(self, f"pnorm{s}")(
            getattr(self, f"patch_block{s}_0")(x2, r2))

    def forward(self, x, ref) -> List[torch.Tensor]:
        x1 = self.patch_embed1(x)
        r1 = self.patch_embed1_ref(ref)
        x2, r2 = self._branch(1, self.refpa1(x1, r1), r1)
        y = self._stage(1, x1)
        x2 = self._cross(1, x2, r2)
        outs = [y]
        for s in (2, 3):
            y = getattr(self, f"patch_embed{s}")(y) + x2
            r1 = getattr(self, f"patch_embed{s}_ref")(r1)
            x2, r2 = self._branch(s, getattr(self, f"refpa{s}")(y, r1), r1)
            y = self._stage(s, y)
            outs.append(y)
            x2 = self._cross(s, x2, r2)
        outs.append(self._stage(4, self.patch_embed4(y) + x2))
        return outs


class Tdec(nn.Module):
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
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = Conv(channels, channels, 3, padding=1)
        self.conv2 = Conv(channels, channels, 3, padding=1)

    def forward(self, x):
        return x + 0.1 * self.conv2(F.relu(self.conv1(x)))


class ConvProjection(nn.Module):
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
        return self.convd1x(self.dense1(self.convd2x(x)))


class TransRef(nn.Module):
    """detail (B, H, W, 3) in [-1, 1] with the hole pre-filled, mask
    (B, H, W, 1) with 1 = hole, reference (B, H, W, 3) in [-1, 1] -> tanh
    image (B, H, W, 3); H and W multiples of 64."""

    def __init__(self):
        super().__init__()
        self.tenc = Tenc()
        self.tdec = Tdec()
        self.convtail = ConvProjection()
        self.clean = Conv(8, 3, 3, padding=1)

    def forward(self, detail, mask, reference):
        inv = (1.0 - mask).expand_as(detail)
        feats = self.tenc(torch.cat([detail, inv], -1), reference)
        return torch.tanh(self.clean(self.convtail(feats, self.tdec(feats))))
