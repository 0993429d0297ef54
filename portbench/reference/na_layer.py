"""The neighborhood-attention vertical layer, the cost encoder's
`vertical_encoder_attn == "NA"` variant (port of
stitchax/models/na_layer.py).

Context-augmented q / k over an 11 x 11 shifted window with a learned
relative-position bias (`ops.neighborhood_attention`), heads of 16
channels scaled by 16^-0.5, the attention output concatenated with the
input and projected back to the latent width, then a pre-norm ffn with
the exact GELU. NHWC, flax's names, so `convert.load_jax_params` fills it
from stitchax's trees.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .neighborhood_attention import neighborhood_attention


class NeighborhoodSelfAttentionLayer(nn.Module):
    """Drop-in alternative to `VerticalSelfAttention`: x (B K, H1, W1, D),
    context (B, H1, W1, encoder_latent_dim)."""

    def __init__(self, cost_latent_dim: int = 128, vert_c_dim: int = 64,
                 encoder_latent_dim: int = 256, attn_dim: int = 128,
                 kernel_size: int = 11, expand_factor: int = 4):
        super().__init__()
        D = cost_latent_dim
        self.attn_dim, self.kernel_size = attn_dim, kernel_size
        self.heads = attn_dim // 16
        self.context_norm = nn.LayerNorm(encoder_latent_dim, eps=1e-5)
        self.context_proj = nn.Linear(encoder_latent_dim, vert_c_dim)
        self.norm1 = nn.LayerNorm(D + vert_c_dim, eps=1e-5)
        self.norm1_v = nn.LayerNorm(D, eps=1e-5)
        self.q = nn.Linear(D + vert_c_dim, attn_dim)
        self.k = nn.Linear(D + vert_c_dim, attn_dim)
        self.v = nn.Linear(D, attn_dim)
        self.rpb = nn.Parameter(torch.zeros(
            self.heads, 2 * kernel_size - 1, 2 * kernel_size - 1))
        self.proj = nn.Linear(attn_dim + D, D)
        self.norm2 = nn.LayerNorm(D, eps=1e-5)
        self.ffn_fc1 = nn.Linear(D, D * expand_factor)
        self.ffn_fc2 = nn.Linear(D * expand_factor, D)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        Bk, H, W, _ = x.shape
        short_cut = x
        ctx = self.context_proj(self.context_norm(context))
        ctx = torch.repeat_interleave(ctx, Bk // ctx.shape[0], dim=0)
        qk = self.norm1(torch.cat([x, ctx], -1))
        v_in = self.norm1_v(x)
        q = self.q(qk) * (16 ** -0.5)
        to_heads = lambda t: t.reshape(Bk, H, W, self.heads, 16)
        # q pre-scaled as the reference does; the helper's own scale undone
        out = neighborhood_attention(to_heads(q) * (16 ** 0.5),
                                     to_heads(self.k(qk)),
                                     to_heads(self.v(v_in)), self.rpb,
                                     self.kernel_size)
        x = short_cut + self.proj(torch.cat(
            [out.reshape(Bk, H, W, self.attn_dim), short_cut], -1))
        y = self.ffn_fc2(F.gelu(self.ffn_fc1(self.norm2(x))))
        return x + y
