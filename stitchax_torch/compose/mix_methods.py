"""Mix method `all_img1_with_inpaint` (port of
stitchax/compose/mix_methods.py:46): fill most holes from img1 and
model-inpaint only a thin border ring. Unbatched HWC tensors. With the
TransRef inpainter (`inpainter_name="transref"`) the img1-filled composite,
clipped to [0, 255], is both the inpainting input and the reference
(stitchax/compose/mix_methods.py:91-98)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..ops.morphology import dilate_binary, dilate_thin_area


@dataclass
class MixResult:
    tps_final_warp: torch.Tensor
    tps_final_warp_mask: torch.Tensor
    inpaint_img: torch.Tensor
    inpaint_img_mask: torch.Tensor
    inpaint_area_mask: torch.Tensor


def _use_inpaint_if_nonzero(inpaint_img, inpaint_img_mask, fallback_img,
                            fallback_mask):
    """Skip an all-zero inpaint result, as the reference does."""
    nonzero = (inpaint_img.abs().sum() > 0).to(inpaint_img.dtype)
    img = inpaint_img * nonzero + fallback_img * (1 - nonzero)
    msk = inpaint_img_mask * nonzero + fallback_mask * (1 - nonzero)
    return img, msk


def all_img1_with_inpaint(tps_h_warp, tps_h_warp_mask, output1, mask1,
                          final_warp, occlusion_mask,
                          inpaint: Optional[Callable] = None,
                          inpainter_name: str = "") -> MixResult:
    dtype = tps_h_warp.dtype
    inv_mask1 = 1.0 - (mask1 > 0.5).to(dtype)
    tps_final_warp = (final_warp * occlusion_mask * mask1
                      + tps_h_warp * inv_mask1)
    tps_final_warp_mask = occlusion_mask * mask1 + tps_h_warp_mask * inv_mask1

    hole = dilate_thin_area((1.0 - tps_final_warp_mask) * mask1)
    hole_dilated = (dilate_binary(hole, 7) > 0).to(dtype)
    mask1_border = (hole - hole_dilated).abs()
    inpaint_area_mask = hole_dilated

    inpaint_by_img1 = (1.0 - mask1_border) * inpaint_area_mask * mask1
    inpaint_img = (tps_final_warp * (1 - inpaint_by_img1)
                   + output1 * inpaint_by_img1)
    img1_filled = inpaint_img

    inpaint_by_other = dilate_thin_area((1.0 - inpaint_by_img1) * mask1_border,
                                        thickening_kernel_size=8)
    inpaint_by_other = (inpaint_by_other > 0.05).to(dtype)
    inpaint_img = inpaint_img * (1 - inpaint_by_other)
    if inpaint is not None:
        if inpainter_name == "transref":
            control = img1_filled.clamp(0, 255)
            inpaint_img = inpaint(control, inpaint_by_other, control)
        else:
            inpaint_img = inpaint(inpaint_img, inpaint_by_other)

    inpaint_img_mask = tps_h_warp_mask
    inpaint_img = inpaint_img * inpaint_img_mask
    tps_final_warp, tps_final_warp_mask = _use_inpaint_if_nonzero(
        inpaint_img, inpaint_img_mask, tps_final_warp, tps_final_warp_mask)
    area = torch.cat([img1_filled, inpaint_by_other[..., 0:1]], -1)
    return MixResult(tps_final_warp, tps_final_warp_mask, inpaint_img,
                     inpaint_img_mask, area)


MIX_METHODS = {"all_img1_with_inpaint": all_img1_with_inpaint}
