"""The breaking stage: preprocess flow -> control points -> TPS warp ->
mask cleanup -> mix with the flow warp -> blend (port of
stitchax/tps/pipeline.py, with its replicated reference quirks: flow
negation, the `final_warp >= 3` threshold, the 11x11 open on the inverted
TPS mask, and avg-pool smoothing with kernel min(grid)//2*2-1)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from ..ops.morphology import avg_pool_same, morph_open
from . import points as P
from . import solve as S


@dataclass(frozen=True)
class TPSConfig:
    grid_h: int = 12
    grid_w: int = 12
    pad_num: int = 4
    get_pt_method: str = "advanced_uniform_multi"
    kernel_variant: str = "opencv"
    flow_limit: float = -1.0
    add_corner: bool = False
    use_boundary_limit: bool = False
    residual_flow_use_forward: bool = False
    do_avg_pooling: bool = True
    use_occ_filter: bool = True
    use_border_points_mask: bool = True
    use_valid_on_flow: bool = False
    affine_scale: float = 1.0
    kernel_scale: float = 1.0
    output2_is_only_tps: bool = True
    mask_open_kernel: int = 11
    solve_reg: float = 1e-6

    @classmethod
    def from_inf_config(cls, tps_pipeline_config: Dict[str, Any]) -> "TPSConfig":
        """From an `inf_configs.<name>.get_tps_pipline_config(cfg)` dict, as
        out.py builds stitchax's TPSConfig."""
        c = tps_pipeline_config
        return cls(grid_h=c["grid_h"], grid_w=c["grid_w"],
                   pad_num=c["pad_num"],
                   get_pt_method=c["get_pt_methods"][0],
                   flow_limit=c["flow_limit"], add_corner=c["add_corner"],
                   use_boundary_limit=c["use_boundary_limit"],
                   residual_flow_use_forward=c["residual_flow_use_forward"],
                   do_avg_pooling=c["do_avg_pooling"],
                   use_occ_filter=c["use_occ_filter"],
                   use_border_points_mask=c["use_border_points_mask"],
                   use_valid_on_flow=c["use_valid_on_flow"],
                   affine_scale=c["affine_scale"],
                   kernel_scale=c["kernel_scale"],
                   output2_is_only_tps=c["output2_is_only_tps"])


def preprocess_flow(residual_flow: torch.Tensor,
                    valid: Optional[torch.Tensor], cfg: TPSConfig):
    """Smooth and negate the residual flow (H, W, 2)."""
    flow = residual_flow
    if cfg.do_avg_pooling:
        k = min(cfg.grid_h, cfg.grid_w) // 2 * 2 - 1
        if k >= 2:
            flow = avg_pool_same(flow, k)
    if not cfg.residual_flow_use_forward:
        flow = -flow
    if valid is not None:
        flow = flow * valid
    return flow


def sample_control_points(h_warp_cropped: torch.Tensor, flow: torch.Tensor,
                          width_min: torch.Tensor, height_min: torch.Tensor,
                          border_points_mask: Optional[torch.Tensor],
                          out_h: int, out_w: int, cfg: TPSConfig):
    """Control pairs in canvas coordinates + validity."""
    H, W, _ = h_warp_cropped.shape
    if cfg.get_pt_method == "advanced_uniform":
        grad = P.gradient_magnitude_l1(h_warp_cropped)
        border = P.sample_border_points(
            grad, max(H, W) // min(cfg.grid_h, cfg.grid_w), cfg.pad_num)
    elif cfg.get_pt_method == "advanced_uniform_multi":
        border = P.multi_level_border_points(h_warp_cropped, cfg.grid_h,
                                             cfg.grid_w, cfg.pad_num)
    else:
        raise NotImplementedError(cfg.get_pt_method)
    src, dst, valid = P.point_pairs(border, flow, cfg.flow_limit)
    src = P.shift_points(src, width_min, height_min)
    dst = P.shift_points(dst, width_min, height_min)
    if cfg.use_boundary_limit:
        valid = valid & P.boundary_validity(src, dst, out_h, out_w)
    if border_points_mask is not None:
        valid = valid & P.mask_lookup_validity(src, border_points_mask)
    if cfg.add_corner:
        corners = torch.tensor([[0, 0], [0, out_h - 1], [out_w - 1, 0],
                                [out_w - 1, out_h - 1]], device=src.device,
                               dtype=src.dtype)
        src = torch.cat([src, corners])
        dst = torch.cat([dst, corners])
        valid = torch.cat([valid, torch.ones(4, dtype=torch.bool,
                                             device=valid.device)])
    return src, dst, valid


def mix_tps_with_flow_warp(tps_h_warp, tps_mask_raw, output1, mask1,
                           final_warp, cfg: TPSConfig) -> Dict[str, Any]:
    """TPS-mask threshold + open on the inverted mask, mix with the flow
    warp, blend. Canvas tensors are (H, W, C)."""
    dtype = tps_h_warp.dtype
    tps_mask = (tps_mask_raw >= 0.5).to(dtype)
    k = (cfg.mask_open_kernel, cfg.mask_open_kernel)
    tps_mask = 1.0 - morph_open(1.0 - tps_mask, k)
    tps_h_warp = tps_h_warp * tps_mask

    fw_mask = ((final_warp >= 3).to(dtype).mean(-1, keepdim=True)
               >= 0.5).to(dtype)
    inv_mask1 = ((1.0 - mask1) >= 0.5).to(dtype)
    tps_final_warp = final_warp * fw_mask + tps_h_warp * (1 - fw_mask) * inv_mask1
    tps_final_warp_mask = fw_mask + (1 - fw_mask) * tps_mask * inv_mask1
    output2 = tps_final_warp * tps_final_warp_mask
    mask2 = tps_final_warp_mask
    blend = ((output1 * mask1 + output2 * mask2)
             / torch.clamp(mask1 + mask2, min=1e-6)).clamp(0, 255)
    out = dict(new_blend_image=blend, mix_tps_flow_warp=output2,
               mix_tps_flow_warp_mask=mask2, tps_output=tps_h_warp,
               tps_mask=tps_mask, output2=output2, mask2=mask2)
    if cfg.output2_is_only_tps:
        out["output2"] = tps_h_warp
        out["mask2"] = tps_mask
    return out


def tps_break_warp(output1, mask1, h_warp, h_warp_mask, final_warp,
                   residual_flow, width_min, height_min, cfg: TPSConfig,
                   occlusion_mask=None, valid_flow_mask=None
                   ) -> Dict[str, Any]:
    """The whole breaking stage for one pair (unbatched HWC tensors;
    residual_flow at the input resolution, width_min/height_min the canvas
    origin as 0-d tensors)."""
    out_h, out_w, _ = h_warp.shape
    img_h, img_w, _ = residual_flow.shape
    flow = preprocess_flow(residual_flow, valid_flow_mask, cfg)
    top = int(height_min.abs().item())
    left = int(width_min.abs().item())
    h_warp_cropped = h_warp[top:top + img_h, left:left + img_w]
    bpm = None
    if cfg.use_border_points_mask and occlusion_mask is not None:
        src_mask = occlusion_mask if cfg.use_occ_filter else h_warp_mask
        bpm = (src_mask[..., 0] > 0.5).to(h_warp.dtype)
    src, dst, valid = sample_control_points(
        h_warp_cropped, flow, width_min, height_min, bpm, out_h, out_w, cfg)
    warped = S.tps_warp_image(torch.cat([h_warp, h_warp_mask], -1), src, dst,
                              valid, variant=cfg.kernel_variant,
                              kernel_scale=cfg.kernel_scale,
                              affine_scale=cfg.affine_scale,
                              reg=cfg.solve_reg)
    out = mix_tps_with_flow_warp(warped[..., 0:3], warped[..., 3:4], output1,
                                 mask1, final_warp, cfg)
    out.update(control_src=src, control_dst=dst, control_valid=valid)
    return out
