"""Windowed multi-head attention for the twins LSA blocks.

Port of `window_attention_split` (stitchax/ops/window_attention.py:53).
Inputs are the bias-free projected streams qx/kx/vx (B, H, W, C) plus
per-window-position biases q_bias/k_bias (ws*ws, C) and v_bias (1, C):
zero-padded border tokens then reduce exactly to the biases, as the
reference pads before projecting. Plain PyTorch in this slice (the retired
TPU kernel `tools/exp_window_attn.py:96` is still to be ported).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pad_part(t: torch.Tensor, ws: int):
    B, H, W, C = t.shape
    ph, pw = (ws - H % ws) % ws, (ws - W % ws) % ws
    t = F.pad(t, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    t = t.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
    return t.permute(0, 1, 3, 2, 4, 5).reshape(B, -1, ws * ws, C), (Hp, Wp)


def window_attention_split(qx, kx, vx, q_bias, k_bias, v_bias, *, heads: int,
                           ws: int) -> torch.Tensor:
    B, H, W, C = qx.shape
    T = ws * ws
    d = C // heads
    q, (Hp, Wp) = _pad_part(qx, ws)
    k, _ = _pad_part(kx, ws)
    v, _ = _pad_part(vx, ws)
    q = q + q_bias.reshape(1, 1, T, C)
    k = k + k_bias.reshape(1, 1, T, C)
    v = v + v_bias.reshape(1, 1, 1, C)

    def split(t):
        return t.reshape(B, -1, T, heads, d).transpose(2, 3)

    qh, kh, vh = split(q), split(k), split(v)
    attn = torch.softmax(qh @ kh.transpose(-1, -2) * d ** -0.5, dim=-1)
    o = (attn @ vh).transpose(2, 3).reshape(B, Hp // ws, Wp // ws, ws, ws, C)
    o = o.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    return o[:, :H, :W]
