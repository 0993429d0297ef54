"""The CLIP text tower that gives the UNet its (77, width) context (port of
stitchax/models/clip_text.py): token and position embeddings, pre-norm
layers of causal attention and a quick-GELU MLP, a final LayerNorm. The
empty prompt needs no tokenizer: it is [BOS, EOS, EOS, ...], SD padding
with the EOS token.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

BOS_TOKEN = 49406
EOS_TOKEN = 49407
MAX_TOKENS = 77


def empty_prompt_tokens(batch: int = 1) -> torch.Tensor:
    """Token ids of the prompt '' with SD's padding (pad token == EOS)."""
    ids = np.full((batch, MAX_TOKENS), EOS_TOKEN, np.int64)
    ids[:, 0] = BOS_TOKEN
    return torch.from_numpy(ids)


class ClipAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, causal):
        B, N, C = x.shape
        d = C // self.heads
        split = lambda t: t.reshape(B, N, self.heads, d).transpose(1, 2)
        q = split(self.q_proj(x)) * d ** -0.5
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        logits = torch.where(causal, logits, torch.full_like(logits, -1e9))
        a = torch.softmax(logits, -1).to(v.dtype)
        return self.out_proj(torch.matmul(a, v).transpose(1, 2)
                             .reshape(B, N, C))


class ClipLayer(nn.Module):
    def __init__(self, width: int, heads: int, mlp_dim: int):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(width, eps=1e-5)
        self.self_attn = ClipAttention(width, heads)
        self.layer_norm2 = nn.LayerNorm(width, eps=1e-5)
        self.fc1 = nn.Linear(width, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, width)

    def forward(self, x, causal):
        x = x + self.self_attn(self.layer_norm1(x), causal)
        h = self.fc1(self.layer_norm2(x))
        return x + self.fc2(h * torch.sigmoid(1.702 * h))     # quick_gelu


class ClipTextEncoder(nn.Module):
    """ViT-L/14 text tower by default: 12 layers, width 768, 12 heads."""

    def __init__(self, vocab_size: int = 49408, width: int = 768,
                 layers: int = 12, heads: int = 12,
                 max_tokens: int = MAX_TOKENS):
        super().__init__()
        self.token_embedding = nn.Parameter(torch.zeros(vocab_size, width))
        self.position_embedding = nn.Parameter(torch.zeros(max_tokens, width))
        self.n_layers = layers
        for i in range(layers):
            setattr(self, f"layer{i}", ClipLayer(width, heads, width * 4))
        self.final_layer_norm = nn.LayerNorm(width, eps=1e-5)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        N = token_ids.shape[1]
        x = self.token_embedding[token_ids] + self.position_embedding[None, :N]
        causal = torch.ones(N, N, dtype=torch.bool,
                            device=token_ids.device).tril()[None, None]
        for i in range(self.n_layers):
            x = getattr(self, f"layer{i}")(x, causal)
        return self.final_layer_norm(x)


def convert_clip_text(sd) -> Dict[str, Any]:
    """transformers CLIPTextModel state dict (with or without its
    `text_model.` prefix) -> the encoder's param tree
    (stitchax/models/clip_text.py:102-132)."""
    from ..convert import _np, linear_params, norm_params

    p = "text_model." if any(k.startswith("text_model") for k in sd) else ""
    params: Dict[str, Any] = {
        "token_embedding": _np(sd[f"{p}embeddings.token_embedding.weight"]),
        "position_embedding": _np(
            sd[f"{p}embeddings.position_embedding.weight"]),
        "final_layer_norm": norm_params(sd, f"{p}final_layer_norm"),
    }
    i = 0
    while f"{p}encoder.layers.{i}.layer_norm1.weight" in sd:
        lp = f"{p}encoder.layers.{i}"
        params[f"layer{i}"] = {
            "layer_norm1": norm_params(sd, f"{lp}.layer_norm1"),
            "layer_norm2": norm_params(sd, f"{lp}.layer_norm2"),
            "self_attn": {n: linear_params(sd, f"{lp}.self_attn.{n}")
                          for n in ("q_proj", "k_proj", "v_proj",
                                    "out_proj")},
            "fc1": linear_params(sd, f"{lp}.mlp.fc1"),
            "fc2": linear_params(sd, f"{lp}.mlp.fc2"),
        }
        i += 1
    return {"params": params}
