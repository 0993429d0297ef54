"""The SD AutoencoderKL (port of stitchax/models/vae.py), NCHW.

Named as stitchax's flax modules (`encoder` / `decoder` from its setup(),
`down{i}_res{j}`, `mid`, ...), so `convert.load_jax_params` fills it from
stitchax's trees. GroupNorm eps 1e-6 throughout; the encoder pads (0, 1,
0, 1) and then convolves with stride 2 and no padding; the decoder
upsamples 2x by nearest neighbour. Attention is stitchax's single-head
matmul, softmax, matmul, logits scaled by C^-0.5 after the product.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch.nn as nn
import torch.nn.functional as F

from .diffusion import SameConv, from_tokens, to_tokens
from .layers import multi_head_attention

SD_VAE_SCALE = 0.18215


class VaeResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int = 32):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-6)
        self.conv1 = SameConv(cin, cout, 3)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-6)
        self.conv2 = SameConv(cout, cout, 3)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VaeAttention(nn.Module):
    """Single-head self-attention over the positions, all projections
    biased."""

    def __init__(self, ch: int, groups: int = 32):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.Linear(ch, ch)

    def forward(self, x):
        H, W = x.shape[2:]
        t = to_tokens(self.group_norm(x))
        o = multi_head_attention(self.to_q(t), self.to_k(t), self.to_v(t), 1)
        return x + from_tokens(self.to_out(o), H, W)


class VaeMidBlock(nn.Module):
    def __init__(self, ch: int, groups: int = 32):
        super().__init__()
        self.res0 = VaeResBlock(ch, ch, groups)
        self.attn = VaeAttention(ch, groups)
        self.res1 = VaeResBlock(ch, ch, groups)

    def forward(self, x):
        return self.res1(self.attn(self.res0(x)))


class VaeEncoder(nn.Module):
    def __init__(self, block_channels: Tuple[int, ...] = (128, 256, 512, 512),
                 latent_channels: int = 4, groups: int = 32):
        super().__init__()
        self.block_channels = block_channels
        self.conv_in = SameConv(3, block_channels[0], 3)
        cin = block_channels[0]
        for i, ch in enumerate(block_channels):
            for j in range(2):
                setattr(self, f"down{i}_res{j}",
                        VaeResBlock(cin if j == 0 else ch, ch, groups))
            if i < len(block_channels) - 1:
                setattr(self, f"down{i}_down", nn.Conv2d(ch, ch, 3, stride=2))
            cin = ch
        self.mid = VaeMidBlock(cin, groups)
        self.conv_norm_out = nn.GroupNorm(groups, cin, eps=1e-6)
        self.conv_out = SameConv(cin, 2 * latent_channels, 3)
        self.quant_conv = nn.Conv2d(2 * latent_channels, 2 * latent_channels,
                                    1)

    def forward(self, x):
        x = self.conv_in(x)
        for i in range(len(self.block_channels)):
            for j in range(2):
                x = getattr(self, f"down{i}_res{j}")(x)
            if i < len(self.block_channels) - 1:
                x = getattr(self, f"down{i}_down")(F.pad(x, (0, 1, 0, 1)))
        x = F.silu(self.conv_norm_out(self.mid(x)))
        return self.quant_conv(self.conv_out(x))


class VaeDecoder(nn.Module):
    def __init__(self, block_channels: Tuple[int, ...] = (128, 256, 512, 512),
                 latent_channels: int = 4, groups: int = 32):
        super().__init__()
        rev = tuple(reversed(block_channels))
        self.n = len(rev)
        self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)
        self.conv_in = SameConv(latent_channels, rev[0], 3)
        self.mid = VaeMidBlock(rev[0], groups)
        cin = rev[0]
        for i, ch in enumerate(rev):
            for j in range(3):
                setattr(self, f"up{i}_res{j}",
                        VaeResBlock(cin if j == 0 else ch, ch, groups))
            if i < self.n - 1:
                setattr(self, f"up{i}_up", SameConv(ch, ch, 3))
            cin = ch
        self.conv_norm_out = nn.GroupNorm(groups, cin, eps=1e-6)
        self.conv_out = SameConv(cin, 3, 3)

    def forward(self, z):
        x = self.mid(self.conv_in(self.post_quant_conv(z)))
        for i in range(self.n):
            for j in range(3):
                x = getattr(self, f"up{i}_res{j}")(x)
            if i < self.n - 1:
                x = getattr(self, f"up{i}_up")(
                    F.interpolate(x, scale_factor=2, mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """encode_mode(image in [-1, 1]) -> scaled posterior mean;
    decode(latents) -> image in about [-1, 1]. NCHW."""

    def __init__(self, block_channels: Tuple[int, ...] = (128, 256, 512, 512),
                 latent_channels: int = 4, groups: int = 32):
        super().__init__()
        self.latent_channels = latent_channels
        self.encoder = VaeEncoder(block_channels, latent_channels, groups)
        self.decoder = VaeDecoder(block_channels, latent_channels, groups)

    def encode_mode(self, x):
        return self.encoder(x)[:, :self.latent_channels] * SD_VAE_SCALE

    def decode(self, latents):
        return self.decoder(latents / SD_VAE_SCALE)

    def forward(self, x):
        return self.decode(self.encode_mode(x))


def convert_vae(sd) -> Dict[str, Any]:
    """diffusers AutoencoderKL state dict -> the VAE's param tree
    (stitchax/models/vae.py:165-216)."""
    from ..convert import conv_params, linear_params, norm_params

    def res(p):
        out = {"norm1": norm_params(sd, f"{p}.norm1"),
               "conv1": conv_params(sd, f"{p}.conv1"),
               "norm2": norm_params(sd, f"{p}.norm2"),
               "conv2": conv_params(sd, f"{p}.conv2")}
        if f"{p}.conv_shortcut.weight" in sd:
            out["conv_shortcut"] = conv_params(sd, f"{p}.conv_shortcut")
        return out

    def mid(p):
        a = f"{p}.attentions.0"
        return {"res0": res(f"{p}.resnets.0"),
                "attn": {"group_norm": norm_params(sd, f"{a}.group_norm"),
                         "to_q": linear_params(sd, f"{a}.to_q"),
                         "to_k": linear_params(sd, f"{a}.to_k"),
                         "to_v": linear_params(sd, f"{a}.to_v"),
                         "to_out": linear_params(sd, f"{a}.to_out.0")},
                "res1": res(f"{p}.resnets.1")}

    enc: Dict[str, Any] = {"conv_in": conv_params(sd, "encoder.conv_in")}
    for i in range(4):
        for j in range(2):
            enc[f"down{i}_res{j}"] = res(f"encoder.down_blocks.{i}.resnets.{j}")
        if i < 3:
            enc[f"down{i}_down"] = conv_params(
                sd, f"encoder.down_blocks.{i}.downsamplers.0.conv")
    enc["mid"] = mid("encoder.mid_block")
    enc["conv_norm_out"] = norm_params(sd, "encoder.conv_norm_out")
    enc["conv_out"] = conv_params(sd, "encoder.conv_out")
    enc["quant_conv"] = conv_params(sd, "quant_conv")

    dec: Dict[str, Any] = {"post_quant_conv": conv_params(sd,
                                                          "post_quant_conv"),
                           "conv_in": conv_params(sd, "decoder.conv_in"),
                           "mid": mid("decoder.mid_block")}
    for i in range(4):
        for j in range(3):
            dec[f"up{i}_res{j}"] = res(f"decoder.up_blocks.{i}.resnets.{j}")
        if i < 3:
            dec[f"up{i}_up"] = conv_params(
                sd, f"decoder.up_blocks.{i}.upsamplers.0.conv")
    dec["conv_norm_out"] = norm_params(sd, "decoder.conv_norm_out")
    dec["conv_out"] = conv_params(sd, "decoder.conv_out")
    return {"params": {"encoder": enc, "decoder": dec}}
