"""Classical push-pull inpainter, registered as `cv_inpainter`
(port of stitchax/compose/inpainters.py:31, :83). Images (H, W, C) float32
in [0, 255]; mask (H, W, 1) with 1 = hole."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


INPAINTERS = {"cv_inpainter": DiffusionJacobiInpainter}


def get_inpainter(name: str):
    if name not in INPAINTERS:
        raise KeyError(f"inpainter {name!r} is not ported yet "
                       f"(ported: {sorted(INPAINTERS)})")
    return INPAINTERS[name]()
