"""Shared building blocks of the port's models (NHWC, tokens (B, N, C)).

Modules are named after stitchax's flax modules so the port's state_dict
keys follow stitchax's param paths (see convert.params_from_jax): a flax
`Dense` is `nn.Linear`, `Conv` is the NHWC `Conv` below, `LayerNorm`
`nn.LayerNorm`, `BatchNorm` the inference-only `BatchNorm` below.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def linear_position_embedding_sine(x: torch.Tensor, dim: int = 128,
                                   normalize_factor: float = 1.0 / 200
                                   ) -> torch.Tensor:
    """(..., 2) coords -> (..., dim) sin/cos features (the reference's
    3.14 literal kept; stitchax/models/layers.py:18)."""
    freqs = torch.linspace(0.0, dim // 4 - 1, dim // 4, device=x.device,
                           dtype=x.dtype)
    fx = 3.14 * x[..., -2:-1] * freqs * normalize_factor
    fy = 3.14 * x[..., -1:] * freqs * normalize_factor
    return torch.cat([torch.sin(fx), torch.cos(fx), torch.sin(fy),
                      torch.cos(fy)], -1)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         heads: int) -> torch.Tensor:
    """Softmax attention on (B, N, C) tokens, logits scaled by
    (C/heads)^-0.5 (stitchax's multi_head_attention / tiny_token_attention /
    stacked_token_attention, which differ only in their TPU lowering)."""
    B, Nq, C = q.shape
    d = C // heads
    qh = q.reshape(B, Nq, heads, d).transpose(1, 2)
    kh = k.reshape(B, k.shape[1], heads, d).transpose(1, 2)
    vh = v.reshape(B, v.shape[1], heads, d).transpose(1, 2)
    attn = torch.softmax(qh @ kh.transpose(-1, -2) * d ** -0.5, dim=-1)
    return (attn @ vh).transpose(1, 2).reshape(B, Nq, C)


class Conv(nn.Conv2d):
    """flax nn.Conv on NHWC tensors (weights kept in torch's OIHW)."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0,
                 groups: int = 1, bias: bool = True, dilation: int = 1):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         dilation=dilation, groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """Inference BatchNorm over the last axis with flax's running stats."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return (x - self.running_mean) * scale + self.bias


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 (timm Mlp parity)."""

    def __init__(self, dim: int, hidden_dim: int, out_dim: Optional[int] = None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim or dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class TokenFfn(Mlp):
    """The reference's dense -> GELU -> dense ffn with hidden == dim."""

    def __init__(self, dim: int):
        super().__init__(dim, dim)


def pad_to_multiple(x: torch.Tensor, m: int):
    """Zero-pad (B, H, W, C) bottom/right to multiples of m."""
    H, W = x.shape[1], x.shape[2]
    ph, pw = (m - H % m) % m, (m - W % m) % m
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    return x, (H, W)
