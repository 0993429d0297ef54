"""The SD + ControlNet inpainting plugin (port of
stitchax/models/sd_pipeline.py): VAE-encode the masked image, DDIM over
UNet + ControlNet with the empty-prompt context, VAE-decode, keep the
original pixels outside the hole.

The initial noise is stitchax's: `jax.random.normal(PRNGKey(seed), (1, h/8,
w/8, 4))` drawn in its NHWC latent layout (`utils.prng`), then laid out
NCHW. The nets run in fp32, as stitchax runs them.

Checkpoints (`load_sd_models`): the "stitchax_jax" container
(results/sd_ckpt_r05.pt: stitchax's trees, a precomputed context) or
diffusers / transformers state dicts under unet / controlnet / vae / clip,
converted as stitchax converts them. Its "configs" entry sizes the nets.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from .. import convert
from ..utils import prng
from .clip_text import ClipTextEncoder, convert_clip_text, empty_prompt_tokens
from .diffusion import (ControlNet, UNet2DCondition, UNetConfig,
                        convert_controlnet, convert_sd_unet, first_step,
                        make_inpaint_denoiser)
from .vae import AutoencoderKL, convert_vae


@dataclass
class SDModels:
    """The plugin's nets with their weights, the (1, 77, C) context and the
    checkpoint's preferred strength, on one device."""
    unet: UNet2DCondition
    controlnet: ControlNet
    vae: AutoencoderKL
    context: torch.Tensor
    preferred_strength: float = 1.0

    def to(self, device) -> "SDModels":
        for m in (self.unet, self.controlnet, self.vae):
            m.to(device=device, dtype=torch.float32).eval()
        self.context = self.context.to(device=device, dtype=torch.float32)
        return self

    @property
    def device(self) -> torch.device:
        return self.context.device


def _hwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(2, 0, 1)[None]


def make_sd_inpaint_fn(models: SDModels, num_steps: int = 50, seed: int = 0,
                       strength: float = 1.0) -> Callable:
    """inpaint_fn(image (H, W, 3) in [0, 255], mask (H, W, 1)) -> image,
    H and W multiples of 8. `strength` is diffusers': 1.0 denoises all
    steps from the noise; s < 1 starts from the classical push-pull fill
    of the hole, VAE-encoded and noised to ts[j0], j0 = round((1 - s) *
    num_steps), and runs the steps from j0. `inpaint_fn.steps` is the
    number of DDIM steps a call runs."""
    from ..compose.inpainters import push_pull_inpaint
    from ..ops.sampling import image_resize

    unet, cnet, vae = models.unet, models.controlnet, models.vae
    denoise = make_inpaint_denoiser(unet, cnet, models.context,
                                    num_steps=num_steps,
                                    num_train_steps=unet.cfg.num_train_timesteps,
                                    strength=strength)
    noise_by_shape: Dict[tuple, torch.Tensor] = {}

    def noise_for(shape, device):
        if shape not in noise_by_shape:
            n = prng.normal(seed, (shape[0], shape[2], shape[3], shape[1]))
            noise_by_shape[shape] = torch.from_numpy(n).permute(
                0, 3, 1, 2).contiguous()
        return noise_by_shape[shape].to(device)

    @torch.no_grad()
    def inpaint_fn(image, mask, _num_steps_unused=None):
        hole = (mask[..., :1] > 0.5).to(image.dtype)
        masked = (image / 127.5 - 1.0) * (1.0 - hole)
        lat_masked = vae.encode_mode(_hwc_to_nchw(masked))
        h8, w8 = lat_masked.shape[2], lat_masked.shape[3]
        mask_lat = _hwc_to_nchw(image_resize(hole, h8, w8, "nearest"))
        control = (image / 255.0) * (1.0 - hole) + (-1.0) * hole
        noise = noise_for(tuple(lat_masked.shape), image.device)
        init_lat = None
        if strength < 1.0:
            filled = push_pull_inpaint(image, hole) / 127.5 - 1.0
            init_lat = vae.encode_mode(_hwc_to_nchw(filled))
        lat = denoise(mask_lat, lat_masked, _hwc_to_nchw(control), noise,
                      init_lat)
        out = vae.decode(lat)[0].permute(1, 2, 0)
        out = ((out + 1.0) * 127.5).clamp(0.0, 255.0)
        return image * (1.0 - hole) + out * hole

    inpaint_fn.steps = num_steps - (first_step(strength, num_steps)
                                    if strength < 1.0 else 0)
    return inpaint_fn


def load_sd_models(path: str, cfg: Optional[UNetConfig] = None,
                   device="cuda") -> SDModels:
    """The plugin's nets from a packed checkpoint, every parameter filled
    and every leaf used (`convert.load_jax_params`), on `device`. An
    explicit `cfg` overrides the packed UNet config."""
    blob = convert.load_sd_container(path)
    configs: Dict[str, Any] = blob.get("configs", {})
    cfg = cfg or UNetConfig(**configs.get("unet", {}))
    vae = AutoencoderKL(**configs.get("vae", {}))
    if blob.get("format") == "stitchax_jax":
        trees = (blob["unet_vars"], blob["controlnet_vars"], blob["vae_vars"])
        context = torch.as_tensor(blob["context"], dtype=torch.float32)
    else:
        trees = (convert_sd_unet(blob["unet"], cfg),
                 convert_controlnet(blob["controlnet"], cfg),
                 convert_vae(blob["vae"]))
        clip = convert.load_jax_params(
            ClipTextEncoder(**configs.get("clip", {})),
            convert_clip_text(blob["clip"])).eval()
        with torch.no_grad():
            context = clip(empty_prompt_tokens())
    nets = [convert.load_jax_params(m, t) for m, t in
            zip((UNet2DCondition(cfg), ControlNet(cfg), vae), trees)]
    return SDModels(*nets, context,
                    float(blob.get("preferred_strength", 1.0))).to(device)


def load_sd_checkpoint(path: str, cfg: Optional[UNetConfig] = None,
                       num_steps: int = 50, seed: int = 0,
                       strength: Optional[float] = None,
                       device="cuda") -> Callable:
    """A ready inpaint_fn from a packed checkpoint; `strength=None` takes
    the checkpoint's preferred_strength (1.0 where it has none)."""
    models = load_sd_models(path, cfg, device)
    if strength is None:
        strength = models.preferred_strength
    return make_sd_inpaint_fn(models, num_steps, seed, strength)
