"""The SD-style UNet, its ControlNet and the DDIM inpainting loop (port of
stitchax/models/diffusion.py).

The modules carry stitchax's flax names, so `convert.load_jax_params`
fills them from its param trees with no extra map. They run in NCHW (the
layout of the card's convolutions); stitchax's NHWC trees convert as
every other model's do. Attention is stitchax's: two matmuls around the
softmax, logits scaled after the product, so that the sums are its sums
(`layers.multi_head_attention`; the plugin runs in fp32, as stitchax runs
it, so the logits and the softmax are fp32).

flax details kept: `padding="SAME"` with stride 2 pads (0, 1) on an even
size (`SameConv`), `nn.gelu` is the tanh approximation, `ResBlock` and the
output norm use GroupNorm eps 1e-5 and `TransformerBlock.norm_in` 1e-6.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import multi_head_attention


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 9              # SD inpaint: 4 + 1 + 4
    out_channels: int = 4
    block_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attention_resolutions: Tuple[int, ...] = (0, 1, 2)  # block indices
    context_dim: int = 768
    num_heads: int = 8
    num_train_timesteps: int = 1000
    norm_groups: int = 32


class SameConv(nn.Conv2d):
    """flax nn.Conv with padding "SAME" on NCHW: per axis the total pad is
    max((ceil(n / s) - 1) * s + k - n, 0), the smaller half before."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        pads = []
        for n in (x.shape[3], x.shape[2]):       # F.pad order: W, then H
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads) if any(pads) else x)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding, cos half then sin half."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


def to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C), row-major over (H, W) as NHWC is."""
    return x.flatten(2).transpose(1, 2)


def from_tokens(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], h, w)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb_dim: int, groups: int = 32):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-5)
        self.conv1 = SameConv(cin, cout, 3)
        self.temb_proj = nn.Linear(temb_dim, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-5)
        self.conv2 = SameConv(cout, cout, 3)
        self.skip = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.temb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class TransformerBlock(nn.Module):
    """Self-attention, cross-attention to the context, GEGLU ffn."""

    def __init__(self, ch: int, heads: int, context_dim: int,
                 groups: int = 32):
        super().__init__()
        self.heads = heads
        self.norm_in = nn.GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = nn.Conv2d(ch, ch, 1)
        for name, kv in (("attn1", ch), ("attn2", context_dim)):
            setattr(self, f"{name}_q", nn.Linear(ch, ch, bias=False))
            setattr(self, f"{name}_k", nn.Linear(kv, ch, bias=False))
            setattr(self, f"{name}_v", nn.Linear(kv, ch, bias=False))
            setattr(self, f"{name}_out", nn.Linear(ch, ch))
        self.norm1 = nn.LayerNorm(ch, eps=1e-5)
        self.norm2 = nn.LayerNorm(ch, eps=1e-5)
        self.norm3 = nn.LayerNorm(ch, eps=1e-5)
        self.geglu = nn.Linear(ch, ch * 8)
        self.ffn_out = nn.Linear(ch * 4, ch)
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def _attn(self, name: str, q_in, kv_in):
        return getattr(self, f"{name}_out")(multi_head_attention(
            getattr(self, f"{name}_q")(q_in), getattr(self, f"{name}_k")(kv_in),
            getattr(self, f"{name}_v")(kv_in), self.heads))

    def forward(self, x, context):
        B, C, H, W = x.shape
        t = to_tokens(self.proj_in(self.norm_in(x)))
        n = self.norm1(t)
        t = t + self._attn("attn1", n, n)
        ctx = context.expand(B, *context.shape[-2:])
        t = t + self._attn("attn2", self.norm2(t), ctx)
        a, g = self.geglu(self.norm3(t)).chunk(2, -1)
        t = t + self.ffn_out(a * F.gelu(g, approximate="tanh"))
        return self.proj_out(from_tokens(t, H, W)) + x


class DownBlock(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int, use_attn: bool,
                 cfg: UNetConfig, temb_dim: int, downsample: bool):
        super().__init__()
        self.layers, self.use_attn = layers, use_attn
        for i in range(layers):
            setattr(self, f"res{i}", ResBlock(cin if i == 0 else cout, cout,
                                              temb_dim, cfg.norm_groups))
            if use_attn:
                setattr(self, f"attn{i}", TransformerBlock(
                    cout, cfg.num_heads, cfg.context_dim, cfg.norm_groups))
        self.down = SameConv(cout, cout, 3, stride=2) if downsample else None

    def forward(self, x, temb, context):
        skips = []
        for i in range(self.layers):
            x = getattr(self, f"res{i}")(x, temb)
            if self.use_attn:
                x = getattr(self, f"attn{i}")(x, context)
            skips.append(x)
        if self.down is not None:
            x = self.down(x)
            skips.append(x)
        return x, skips


class UpBlock(nn.Module):
    def __init__(self, cin: int, skip_chs: List[int], cout: int,
                 use_attn: bool, cfg: UNetConfig, temb_dim: int,
                 upsample: bool):
        """`skip_chs`: the channels of the skips this block pops, in pop
        order."""
        super().__init__()
        self.layers, self.use_attn = len(skip_chs), use_attn
        for i, sc in enumerate(skip_chs):
            setattr(self, f"res{i}", ResBlock((cin if i == 0 else cout) + sc,
                                              cout, temb_dim,
                                              cfg.norm_groups))
            if use_attn:
                setattr(self, f"attn{i}", TransformerBlock(
                    cout, cfg.num_heads, cfg.context_dim, cfg.norm_groups))
        self.up = SameConv(cout, cout, 3) if upsample else None

    def forward(self, x, skips, temb, context):
        for i in range(self.layers):
            x = torch.cat([x, skips.pop()], 1)
            x = getattr(self, f"res{i}")(x, temb)
            if self.use_attn:
                x = getattr(self, f"attn{i}")(x, context)
        if self.up is not None:
            x = self.up(F.interpolate(x, scale_factor=2, mode="nearest"))
        return x


def _time_mlp(module: nn.Module, ch0: int) -> None:
    module.time1 = nn.Linear(ch0, ch0 * 4)
    module.time2 = nn.Linear(ch0 * 4, ch0 * 4)


def _temb(module: nn.Module, t: torch.Tensor, ch0: int) -> torch.Tensor:
    temb = timestep_embedding(t, ch0).to(module.time1.weight.dtype)
    return module.time2(F.silu(module.time1(temb)))


def _down_path(module: nn.Module, cfg: UNetConfig, temb_dim: int
               ) -> List[int]:
    """Build conv_in's successors down{i}, mid_res1/mid_attn/mid_res2 on
    `module`; returns the skip channels in push order (conv_in first)."""
    ch = cfg.block_channels
    skips, cin = [ch[0]], ch[0]
    for i, c in enumerate(ch):
        down = i < len(ch) - 1
        setattr(module, f"down{i}", DownBlock(
            cin, c, cfg.layers_per_block, i in cfg.attention_resolutions,
            cfg, temb_dim, down))
        skips += [c] * (cfg.layers_per_block + int(down))
        cin = c
    module.mid_res1 = ResBlock(ch[-1], ch[-1], temb_dim, cfg.norm_groups)
    module.mid_attn = TransformerBlock(ch[-1], cfg.num_heads,
                                       cfg.context_dim, cfg.norm_groups)
    module.mid_res2 = ResBlock(ch[-1], ch[-1], temb_dim, cfg.norm_groups)
    return skips


def _run_down_mid(module: nn.Module, cfg: UNetConfig, x, temb, context):
    skips = [x]
    for i in range(len(cfg.block_channels)):
        x, s = getattr(module, f"down{i}")(x, temb, context)
        skips += s
    x = module.mid_res1(x, temb)
    x = module.mid_attn(x, context)
    return module.mid_res2(x, temb), skips


class UNet2DCondition(nn.Module):
    """The SD-1.5-shaped conditional UNet (NCHW)."""

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = c = cfg
        ch0, temb_dim = c.block_channels[0], c.block_channels[0] * 4
        _time_mlp(self, ch0)
        self.conv_in = SameConv(c.in_channels, ch0, 3)
        skips = _down_path(self, c, temb_dim)
        x_ch = c.block_channels[-1]
        for i in reversed(range(len(c.block_channels))):
            n = c.layers_per_block + 1
            pops = [skips.pop() for _ in range(n)]
            setattr(self, f"up{i}", UpBlock(
                x_ch, pops, c.block_channels[i],
                i in c.attention_resolutions, c, temb_dim, upsample=i > 0))
            x_ch = c.block_channels[i]
        self.norm_out = nn.GroupNorm(c.norm_groups, ch0, eps=1e-5)
        self.conv_out = SameConv(ch0, c.out_channels, 3)

    def forward(self, latents, t, context,
                control_residuals: Optional[List[torch.Tensor]] = None,
                control_mid: Optional[torch.Tensor] = None):
        c = self.cfg
        temb = _temb(self, t, c.block_channels[0])
        x, skips = _run_down_mid(self, c, self.conv_in(latents), temb,
                                 context)
        if control_mid is not None:
            x = x + control_mid
        if control_residuals is not None:
            skips = [s + r for s, r in zip(skips, control_residuals)]
        for i in reversed(range(len(c.block_channels))):
            x = getattr(self, f"up{i}")(x, skips, temb, context)
        return self.conv_out(F.silu(self.norm_out(x)))


HINT_CHANNELS = (16, 32, 32, 96, 96, 256)


class ControlNet(nn.Module):
    """Mirrors the UNet's down path on the bare 4-channel latents plus the
    control image's embedding; returns the per-skip residuals and the mid
    residual, each through its zero conv."""

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = c = cfg
        ch0, temb_dim = c.block_channels[0], c.block_channels[0] * 4
        _time_mlp(self, ch0)
        self.hint_in = SameConv(3, 16, 3)
        cin = 16
        for i, ch in enumerate(HINT_CHANNELS):
            setattr(self, f"hint{i}", SameConv(cin, ch, 3,
                                               stride=2 if i % 2 else 1))
            cin = ch
        self.hint_out = SameConv(cin, ch0, 3)
        self.conv_in = SameConv(c.out_channels, ch0, 3)
        self.zero0 = nn.Conv2d(ch0, ch0, 1)
        _down_path(self, c, temb_dim)
        for i, ch in enumerate(c.block_channels):
            n = c.layers_per_block + int(i < len(c.block_channels) - 1)
            for j in range(n):
                setattr(self, f"zero{i}_{j}", nn.Conv2d(ch, ch, 1))
        ch_last = c.block_channels[-1]
        self.zero_mid = nn.Conv2d(ch_last, ch_last, 1)

    def forward(self, latents, t, context, control_image):
        c = self.cfg
        temb = _temb(self, t, c.block_channels[0])
        h = F.silu(self.hint_in(control_image))
        for i in range(len(HINT_CHANNELS)):
            h = F.silu(getattr(self, f"hint{i}")(h))
        x = self.conv_in(latents) + self.hint_out(h)
        residuals = [self.zero0(x)]
        for i in range(len(c.block_channels)):
            x, s = getattr(self, f"down{i}")(x, temb, context)
            residuals += [getattr(self, f"zero{i}_{j}")(sk)
                          for j, sk in enumerate(s)]
        x = self.mid_res1(x, temb)
        x = self.mid_attn(x, context)
        x = self.mid_res2(x, temb)
        return residuals, self.zero_mid(x)


# ------------------------------ DDIM loop ------------------------------------

# alphas_cumprod of the SD-1.5 scheduler as stitchax computes it
# (stitchax/models/diffusion.py:278-279: an fp32 linspace squared, then
# jnp.cumprod). XLA's linspace and cumprod round differently from any
# sequential fp32 product, so stitchax's 1000 fp32 values are carried
# (written by `python tests/test_torch_sd.py --write`, held equal to
# stitchax's by tests/test_torch_sd.py).
ACP_FILE = "sd15_alphas_cumprod_f32.npy"


def ddim_schedule(num_train_steps: int, num_steps: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(ts, alphas_cumprod): the 'leading' timesteps t_i = i * (T // S) + 1
    from high to low, and the scaled-linear schedule's cumulative products
    (beta 0.00085 .. 0.012), float32."""
    if num_train_steps == 1000:
        acp = np.load(os.path.join(os.path.dirname(__file__), ACP_FILE))
    else:
        betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, num_train_steps,
                            dtype=np.float32) ** 2
        acp = np.cumprod(np.float32(1.0) - betas, dtype=np.float32)
    step = num_train_steps // num_steps
    ts = (np.arange(num_steps) * step)[::-1] + 1
    return ts, acp.astype(np.float32)


def first_step(strength: float, num_steps: int) -> int:
    """The first schedule index the loop runs: round((1 - s) * S) with
    Python's rounding, clamped to [0, S - 1]."""
    j0 = int(round((1.0 - float(strength)) * num_steps))
    return max(0, min(j0, num_steps - 1))


def make_inpaint_denoiser(unet: Callable, controlnet: Callable,
                          context: torch.Tensor, num_steps: int = 50,
                          num_train_steps: int = 1000,
                          strength: float = 1.0) -> Callable:
    """denoise(mask_latent, masked_latents, control_image, noise[,
    init_latents]) -> latents (NCHW): DDIM over steps j0 .. num_steps - 1.
    With strength < 1 and init latents, the loop starts from them noised
    to the schedule point ts[j0]; otherwise from the noise over all steps.
    The step's scalars are computed in fp32 as stitchax computes them."""
    f32 = np.float32
    ts, acp = ddim_schedule(num_train_steps, num_steps)
    j0 = first_step(strength, num_steps)
    stride = num_train_steps // num_steps

    def step(lat, mask_latent, masked_latents, control_image, t):
        a_t = acp[t]
        a_prev = acp[t - stride] if t - stride >= 0 else acp[0]
        tb = torch.full((lat.shape[0],), float(t), dtype=torch.float32,
                        device=lat.device)
        res, mid = controlnet(lat, tb, context, control_image)
        inp = torch.cat([lat, mask_latent, masked_latents], 1)
        eps = unet(inp, tb, context, res, mid)
        x0 = (lat - float(np.sqrt(f32(1) - a_t)) * eps) / float(np.sqrt(a_t))
        return (float(np.sqrt(a_prev)) * x0
                + float(np.sqrt(f32(1) - a_prev)) * eps)

    def denoise(mask_latent, masked_latents, control_image, noise,
                init_latents=None):
        if j0 == 0 or init_latents is None:
            lat, start = noise, 0
        else:
            a0 = acp[ts[j0]]
            lat = (float(np.sqrt(a0)) * init_latents
                   + float(np.sqrt(f32(1) - a0)) * noise)
            start = j0
        for i in range(start, num_steps):
            lat = step(lat, mask_latent, masked_latents, control_image,
                       int(ts[i]))
        return lat

    return denoise


# ------------------------------ converters -----------------------------------
# diffusers state dicts -> stitchax's param trees (NHWC / flax layout), as
# stitchax/models/diffusion.py:346-447 builds them; load_jax_params then
# fills the modules above.


def _sd_res(sd, p):
    from ..convert import conv_params, linear_params, norm_params
    out = {"norm1": norm_params(sd, f"{p}.norm1"),
           "conv1": conv_params(sd, f"{p}.conv1"),
           "temb_proj": linear_params(sd, f"{p}.time_emb_proj"),
           "norm2": norm_params(sd, f"{p}.norm2"),
           "conv2": conv_params(sd, f"{p}.conv2")}
    if f"{p}.conv_shortcut.weight" in sd:
        out["skip"] = conv_params(sd, f"{p}.conv_shortcut")
    return out


def _sd_attn(sd, p):
    from ..convert import conv_params, linear_params, norm_params
    tb = f"{p}.transformer_blocks.0"
    out = {"norm_in": norm_params(sd, f"{p}.norm"),
           "proj_in": conv_params(sd, f"{p}.proj_in"),
           "proj_out": conv_params(sd, f"{p}.proj_out"),
           "norm1": norm_params(sd, f"{tb}.norm1"),
           "norm2": norm_params(sd, f"{tb}.norm2"),
           "norm3": norm_params(sd, f"{tb}.norm3"),
           "geglu": linear_params(sd, f"{tb}.ff.net.0.proj"),
           "ffn_out": linear_params(sd, f"{tb}.ff.net.2")}
    for a in ("attn1", "attn2"):
        for ours, theirs in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                             ("out", "to_out.0")):
            out[f"{a}_{ours}"] = linear_params(sd, f"{tb}.{a}.{theirs}")
    return out


def _sd_backbone(sd, params: Dict[str, Any], cfg: UNetConfig) -> None:
    """conv_in, time and down/mid mapping shared by UNet and ControlNet."""
    from ..convert import conv_params, linear_params
    params["conv_in"] = conv_params(sd, "conv_in")
    params["time1"] = linear_params(sd, "time_embedding.linear_1")
    params["time2"] = linear_params(sd, "time_embedding.linear_2")
    n = len(cfg.block_channels)
    for i in range(n):
        blk: Dict[str, Any] = {}
        for j in range(cfg.layers_per_block):
            blk[f"res{j}"] = _sd_res(sd, f"down_blocks.{i}.resnets.{j}")
            if i in cfg.attention_resolutions:
                blk[f"attn{j}"] = _sd_attn(sd,
                                           f"down_blocks.{i}.attentions.{j}")
        if i < n - 1:
            blk["down"] = conv_params(sd,
                                      f"down_blocks.{i}.downsamplers.0.conv")
        params[f"down{i}"] = blk
    params["mid_res1"] = _sd_res(sd, "mid_block.resnets.0")
    params["mid_attn"] = _sd_attn(sd, "mid_block.attentions.0")
    params["mid_res2"] = _sd_res(sd, "mid_block.resnets.1")


def convert_sd_unet(sd, cfg: UNetConfig = UNetConfig()) -> Dict[str, Any]:
    """diffusers UNet2DConditionModel (SD-1.5 inpaint) state dict -> the
    UNet's param tree; diffusers' up_blocks.k is up{n-1-k}."""
    from ..convert import conv_params, norm_params
    params: Dict[str, Any] = {}
    _sd_backbone(sd, params, cfg)
    n = len(cfg.block_channels)
    for k in range(n):
        i = n - 1 - k
        blk: Dict[str, Any] = {}
        for j in range(cfg.layers_per_block + 1):
            blk[f"res{j}"] = _sd_res(sd, f"up_blocks.{k}.resnets.{j}")
            if i in cfg.attention_resolutions:
                blk[f"attn{j}"] = _sd_attn(sd, f"up_blocks.{k}.attentions.{j}")
        if i > 0:
            blk["up"] = conv_params(sd, f"up_blocks.{k}.upsamplers.0.conv")
        params[f"up{i}"] = blk
    params["norm_out"] = norm_params(sd, "conv_norm_out")
    params["conv_out"] = conv_params(sd, "conv_out")
    return {"params": params}


def convert_controlnet(sd, cfg: UNetConfig = UNetConfig()) -> Dict[str, Any]:
    """diffusers ControlNetModel (v11p inpaint) state dict -> the
    ControlNet's param tree; controlnet_down_blocks.{0..} are the zero
    convs in walk order."""
    from ..convert import conv_params
    params: Dict[str, Any] = {}
    _sd_backbone(sd, params, cfg)
    emb = "controlnet_cond_embedding"
    params["hint_in"] = conv_params(sd, f"{emb}.conv_in")
    for i in range(len(HINT_CHANNELS)):
        params[f"hint{i}"] = conv_params(sd, f"{emb}.blocks.{i}")
    params["hint_out"] = conv_params(sd, f"{emb}.conv_out")
    params["zero0"] = conv_params(sd, "controlnet_down_blocks.0")
    flat, n = 1, len(cfg.block_channels)
    for i in range(n):
        for j in range(cfg.layers_per_block + int(i < n - 1)):
            params[f"zero{i}_{j}"] = conv_params(
                sd, f"controlnet_down_blocks.{flat}")
            flat += 1
    params["zero_mid"] = conv_params(sd, "controlnet_mid_block")
    return {"params": params}
