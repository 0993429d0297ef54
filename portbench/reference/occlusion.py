"""Occlusion estimation: forward-backward consistency and range maps.

Port of stitchax/ops/occlusion.py. The wang range map is a bilinear forward
splat; on the GPU it is a scatter-add (`scatter_add_`), where stitchax
recast it as a selector matmul for the TPU. Masks are (B, H, W, 1).
"""

from __future__ import annotations

import torch

from .flow import flow_to_warp, flow_warp_b


def mask_invalid(coords: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 2) coords -> (B, H, W, 1) inside-the-image mask."""
    H, W = coords.shape[1], coords.shape[2]
    x, y = coords[..., 0], coords[..., 1]
    m = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    return m.to(coords.dtype)[..., None]


def compute_range_map_b(flow: torch.Tensor) -> torch.Tensor:
    """Forward-splat count map of flow (B, H, W, 2) -> (B, H, W, 1):
    bilinear deposit of 1 at p + flow(p), out-of-bounds taps dropped."""
    B, H, W, _ = flow.shape
    c = flow_to_warp(flow).reshape(B, -1, 2)
    x, y = c[..., 0], c[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    counts = torch.zeros(B, H * W, device=flow.device, dtype=flow.dtype)
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            yi, xi = y0 + dy, x0 + dx
            ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
            counts.scatter_add_(1, idx, wy * wx * ok)
    return counts.reshape(B, H, W, 1)


def compute_fb_consistency(flow_ij: torch.Tensor, flow_ji: torch.Tensor):
    flow_ji_in_i = flow_warp_b(flow_ji, flow_ij)
    fb_sq_diff = ((flow_ij + flow_ji_in_i) ** 2).sum(-1, keepdim=True)
    fb_sum_sq = (flow_ij ** 2 + flow_ji_in_i ** 2).sum(-1, keepdim=True)
    return fb_sq_diff, fb_sum_sq


def compute_occlusion_b(flow_ij: torch.Tensor, flow_ji: torch.Tensor,
                        occlusion_estimation: str = "wang",
                        occlusion_are_zeros: bool = False,
                        boundaries_occluded: bool = True) -> torch.Tensor:
    """Occlusion mask (B, H, W, 1); 1 = occluded unless flipped."""
    if occlusion_estimation == "none":
        occ = torch.zeros_like(flow_ij[..., :1])
    elif occlusion_estimation == "wang":
        occ = 1.0 - compute_range_map_b(flow_ji).clamp(0.0, 1.0)
    elif occlusion_estimation in ("brox", "fb_abs"):
        fb_sq_diff, fb_sum_sq = compute_fb_consistency(flow_ij, flow_ji)
        if occlusion_estimation == "brox":
            occ = (fb_sq_diff > 0.01 * fb_sum_sq + 0.5).to(flow_ij.dtype)
        else:
            occ = (fb_sq_diff ** 0.5 > 1.5).to(flow_ij.dtype)
    else:
        raise ValueError(f"unknown occlusion_estimation {occlusion_estimation}")
    if not boundaries_occluded:
        occ = torch.minimum(occ, mask_invalid(flow_to_warp(flow_ij)))
    if occlusion_are_zeros:
        occ = 1.0 - occ
    return occ
