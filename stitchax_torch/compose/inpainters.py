"""Inpainters, by name (port of stitchax/compose/inpainters.py): the
classical push-pull `cv_inpainter` (:31, :83), `transref_inpainter`
(:94-138) and the SD + ControlNet `inpainter` (:141-221). Images (H, W, C)
float32 in [0, 255]; mask (H, W, 1) with 1 = hole."""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..models.sd_pipeline import SDModels, load_sd_models, make_sd_inpaint_fn
from ..models.transref import TransRefBase
from ..ops.sampling import image_resize
from ..utils.precision import call_in


def _down2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average downsample (H, W, C) -> (ceil(H/2), ceil(W/2), C)."""
    H, W, C = img.shape
    x = F.pad(img, (0, 0, 0, W % 2, 0, H % 2))
    return x.reshape(x.shape[0] // 2, 2, x.shape[1] // 2, 2, C).mean((1, 3))


def _resize_bilinear(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Half-pixel-centre bilinear upsample (jax.image.resize 'bilinear' on
    an upscale)."""
    x = F.interpolate(img.permute(2, 0, 1)[None], size=(h, w),
                      mode="bilinear", align_corners=False)
    return x[0].permute(1, 2, 0)


def push_pull_inpaint(image: torch.Tensor, mask: torch.Tensor,
                      smooth_iters: int = 2) -> torch.Tensor:
    """Fill holes with a valid-weighted pyramid average (push-pull), then a
    few 3x3 Jacobi relaxations restricted to the hole."""
    H, W, C = image.shape
    hole = (mask[..., 0:1] > 0.5).to(image.dtype)
    w = 1.0 - hole
    levels = [(image * w, w)]
    while min(levels[-1][0].shape[:2]) > 2:
        li, lw = levels[-1]
        levels.append((_down2(li), _down2(lw)))
    li, lw = levels[-1]
    filled = li / torch.clamp(lw, min=1e-8)
    for li, lw in reversed(levels[:-1]):
        up = _resize_bilinear(filled, li.shape[0], li.shape[1])
        known = (lw > 1e-8).to(image.dtype)
        filled = li / torch.clamp(lw, min=1e-8) * known + up * (1 - known)
    out = image * (1 - hole) + filled * hole
    k = torch.tensor([[0.0, 1.0, 0.0], [1.0, 0.0, 1.0], [0.0, 1.0, 0.0]],
                     device=image.device, dtype=image.dtype)[None, None] / 4.0
    for _ in range(smooth_iters):
        nb = F.conv2d(out.permute(2, 0, 1)[:, None], k, padding=1)
        out = out * (1 - hole) + nb[:, 0].permute(1, 2, 0) * hole
    return out


class DiffusionJacobiInpainter:
    """The classical inpainter (`cv_inpainter`)."""
    name = "cv_inpainter"

    def inpaint(self, image, mask, control_image=None):
        return push_pull_inpaint(image, mask)


class TransRefInpainter:
    """Reference-guided transformer inpainting at a fixed square size:
    resize the image and the control image to `size` (jax.image.resize
    semantics), normalise to [-1, 1], fill the hole with the image's mean
    colour outside it, run TransRef with the control image as reference,
    composite `out * mask + detail * (1 - mask)`, resize back and clip.

    `model` is a TransRefBase with trained weights, already on its device
    in `dtype` (bf16 as stitchax runs it; outputs come back in fp32). There
    is no random-init fallback: without a model this raises."""
    name = "transref_inpainter"

    def __init__(self, model: Optional[TransRefBase] = None, size: int = 512,
                 dtype: torch.dtype = torch.bfloat16):
        if model is None:
            raise ValueError("TransRefInpainter needs a TransRefBase with "
                             "trained weights (e.g. StitchModels.from_npz("
                             "..., transref=<flax msgpack>))")
        self.model, self.size, self.dtype = model, size, dtype

    def _run(self, image, mask, control):
        S = self.size
        H, W, _ = image.shape
        img = image_resize(image, S, S, "bilinear")
        ref = image_resize(control, S, S, "bilinear")
        m = (image_resize(mask.to(image.dtype), S, S, "nearest") > 0.5
             ).to(image.dtype)
        img_n = img / 127.5 - 1.0
        ref_n = ref / 127.5 - 1.0
        keep = 1 - m
        mean = (img_n * keep).sum((0, 1)) / (keep.sum((0, 1))).clamp(min=1.0)
        detail = img_n * keep + mean * m
        out = call_in(self.model, self.dtype, detail[None], m[None],
                      ref_n[None])[0]
        comp = (out * m + detail * keep + 1.0) * 127.5
        return image_resize(comp, H, W, "bilinear").clamp(0, 255)

    def inpaint(self, image, mask, control_image=None):
        control = image if control_image is None else control_image
        return self._run(image, mask, control)


# the committed in-repository SD checkpoint, stitchax's default
# (stitchax/compose/inpainters.py:170-176)
DEFAULT_SD_CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "..", "..", "results", "sd_ckpt_r05.pt")


def resolve_sd_ckpt(ckpt: Optional[str] = None) -> str:
    """stitchax's checkpoint resolution: `ckpt`, else STITCHAX_SD_CKPT,
    else the committed results/sd_ckpt_r05.pt. Where stitchax warns and
    fills holes by push-pull instead (no checkpoint, or "none"), this
    raises."""
    ckpt = ckpt or os.environ.get("STITCHAX_SD_CKPT")
    if not ckpt and os.path.isfile(DEFAULT_SD_CKPT):
        ckpt = DEFAULT_SD_CKPT
    if not ckpt or ckpt.lower() == "none":
        raise ValueError("the SD inpainter needs a packed SD checkpoint "
                         "(pass ckpt= or set STITCHAX_SD_CKPT, e.g. "
                         "results/sd_ckpt_r05.pt)")
    if not os.path.isfile(ckpt):
        raise FileNotFoundError(f"SD checkpoint {ckpt!r} does not exist")
    return ckpt


class StableDiffusionInpainter:
    """SD + ControlNet inpainting. Canvases above `resize_to_area_limit`
    pixels are denoised at a size scaled to that area (each side floored to
    a multiple of 8; image antialiased-bilinear, mask nearest) and resized
    back, the original kept outside the hole.

    The nets come as `models` (loaded once, e.g. by StitchModels.from_npz(
    ..., sd=...)) or from a checkpoint resolved as `resolve_sd_ckpt` does,
    loaded onto `device`; `denoise_fn(image, mask, num_steps)` replaces
    them. strength: the argument, else STITCHAX_SD_STRENGTH, else the
    checkpoint's preferred strength."""
    name = "inpainter"

    def __init__(self, denoise_fn: Optional[Callable] = None,
                 ckpt: Optional[str] = None, num_steps: int = 50,
                 strength: Optional[float] = None,
                 resize_to_area_limit: int = 750 * 750,
                 models: Optional[SDModels] = None, device="cuda"):
        self.num_steps = num_steps
        self.resize_to_area_limit = resize_to_area_limit
        env_s = os.environ.get("STITCHAX_SD_STRENGTH")
        if strength is None and env_s is not None:
            strength = float(env_s)
        if denoise_fn is None:
            if models is None:
                models = load_sd_models(resolve_sd_ckpt(ckpt), device=device)
            if strength is None:
                strength = models.preferred_strength
            denoise_fn = make_sd_inpaint_fn(models, num_steps,
                                            strength=strength)
        self.strength = strength
        self.denoise_fn = denoise_fn

    def inpaint(self, image, mask, control_image=None):
        H, W, _ = image.shape
        if H * W <= self.resize_to_area_limit:
            return self.denoise_fn(image, mask, self.num_steps)
        s = (self.resize_to_area_limit / (H * W)) ** 0.5
        nh, nw = max(int(H * s) // 8 * 8, 8), max(int(W * s) // 8 * 8, 8)
        small = image_resize(image, nh, nw, "bilinear")
        msk_s = (image_resize(mask, nh, nw, "nearest") > 0.5).to(image.dtype)
        out = image_resize(self.denoise_fn(small, msk_s, self.num_steps),
                           H, W, "bilinear")
        return image * (1 - mask) + out * mask


INPAINTERS = {"cv_inpainter": DiffusionJacobiInpainter,
              "transref_inpainter": TransRefInpainter,
              "inpainter": StableDiffusionInpainter}


def get_inpainter(name: str, **kwargs):
    if name not in INPAINTERS:
        raise KeyError(f"inpainter {name!r} is not ported yet "
                       f"(ported: {sorted(INPAINTERS)})")
    return INPAINTERS[name](**kwargs)
