"""The plain versions of the port's kernels K1, K3 and K4, frozen: the
reference's FlowFormer++ calls these where the program launches its CUDA
kernels. Copied unchanged from the port's `ops/kernels/` (their `*_plain`
functions), which hold them to stitchax's XLA oracles."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gsa_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, heads: int) -> torch.Tensor:
    """q (B, N, C), k/v (B, M, C) -> (B, N, C): multi-head softmax
    attention, logits scaled by (C/heads)^-0.5, computed in fp32, output in
    q's dtype (the oracle `gsa_attention_ref`, :92)."""
    B, N, C = q.shape
    M = k.shape[1]
    d = C // heads
    qh = q.float().reshape(B, N, heads, d).transpose(1, 2)
    kh = k.float().reshape(B, M, heads, d).transpose(1, 2)
    vh = v.float().reshape(B, M, heads, d).transpose(1, 2)
    attn = torch.softmax(qh @ kh.transpose(-1, -2) * d ** -0.5, dim=-1)
    out = (attn @ vh).transpose(1, 2).reshape(B, N, C)
    return out.to(q.dtype)


def cost_lookup_plain(cost_maps: torch.Tensor, coords: torch.Tensor,
                      r: int = 4) -> torch.Tensor:
    """cost_maps (P, H2, W2), coords (P, 2) xy pixel coords ->
    (P, (2r+1)^2) fp32, channel k = a*(2r+1) + t (a: x offset, t: y offset).

    Zeros out of bounds; bilinear weights rounded to the cost dtype; the
    vertical pass accumulated in fp32 and rounded to the cost dtype, the
    horizontal pass accumulated in fp32."""
    P, H2, W2 = cost_maps.shape
    dt = cost_maps.dtype
    win = 2 * r + 1
    c = coords.float()
    f0 = torch.floor(c)
    frac = c - f0
    w0 = (1.0 - frac).to(dt).float()                      # (P, 2)
    w1 = frac.to(dt).float()
    steps = torch.arange(win + 1, device=c.device, dtype=torch.float32)
    xs = f0[:, 0:1] - r + steps                          # (P, win+1)
    ys = f0[:, 1:2] - r + steps
    vx = (xs >= 0) & (xs < W2)
    vy = (ys >= 0) & (ys < H2)
    xi = xs.clamp(0, W2 - 1).long()
    yi = ys.clamp(0, H2 - 1).long()
    base = torch.arange(P, device=c.device).view(P, 1, 1) * (H2 * W2)
    idx = base + yi[:, :, None] * W2 + xi[:, None, :]     # (P, y, x)
    g = cost_maps.reshape(-1)[idx].float()
    g = g * (vy[:, :, None] & vx[:, None, :])
    rows = (w0[:, 1, None, None] * g[:, :win]
            + w1[:, 1, None, None] * g[:, 1:]).to(dt).float()   # (P, t, x)
    s = (w0[:, 0, None, None] * rows[:, :, :win]
         + w1[:, 0, None, None] * rows[:, :, 1:])               # (P, t, a)
    return s.transpose(1, 2).reshape(P, win * win)


def partition(t: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> zero-padded windows (B, nW, ws*ws, C)."""
    B, H, W, C = t.shape
    ph, pw = (ws - H % ws) % ws, (ws - W % ws) % ws
    t = F.pad(t, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    t = t.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
    return t.permute(0, 1, 3, 2, 4, 5).reshape(B, -1, ws * ws, C)


def biased_windows(qx, kx, vx, q_bias, k_bias, v_bias, ws: int):
    """The partitioned streams with their biases added in the streams'
    dtype, as stitchax adds them: three (B, nW, ws*ws, C) tensors."""
    T = ws * ws
    C = qx.shape[-1]
    return (partition(qx, ws) + q_bias.reshape(1, 1, T, C),
            partition(kx, ws) + k_bias.reshape(1, 1, T, C),
            partition(vx, ws) + v_bias.reshape(1, 1, 1, C))


def window_attention_plain(qx, kx, vx, q_bias, k_bias, v_bias, *, heads: int,
                           ws: int) -> torch.Tensor:
    """Pad, partition, add the biases (rounded to the streams' dtype), then
    per window and head softmax(q k^T * d^-0.5) v in fp32, rounded once to
    the streams' dtype, merged and cropped to (B, H, W, C)."""
    B, H, W, C = qx.shape
    T = ws * ws
    d = C // heads
    q, k, v = biased_windows(qx, kx, vx, q_bias, k_bias, v_bias, ws)

    def split(t):
        return t.float().reshape(B, -1, T, heads, d).transpose(2, 3)

    qh, kh, vh = split(q), split(k), split(v)
    attn = torch.softmax(qh @ kh.transpose(-1, -2) * d ** -0.5, dim=-1)
    Hp, Wp = -(-H // ws) * ws, -(-W // ws) * ws
    o = (attn @ vh).transpose(2, 3).reshape(B, Hp // ws, Wp // ws, ws, ws, C)
    o = o.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    return o[:, :H, :W].to(qx.dtype)

# the names the models call
gsa_attention = gsa_attention_plain
cost_lookup = cost_lookup_plain
window_attention = window_attention_plain
