"""Forward warping by bilinear splatting (scatter-add) onto a fixed canvas
(port of stitchax/ops/splat.py).

Each source pixel adds its value, times its bilinear weight, to the four
canvas pixels around its target; taps outside the canvas weigh 0. The
warp is the accumulated values over the accumulated weights where the
weight exceeds eps. Optional per-pixel weights give the reference's soft
depth weighting (reference: core/utils/warper.py:247-249).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .flow import flow_to_warp


def bilinear_splat_b(values: torch.Tensor, coords: torch.Tensor, out_h: int,
                     out_w: int, weights: Optional[torch.Tensor] = None,
                     eps: float = 1e-7) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter `values` (B, H, W, C) to `coords` (B, H, W, 2), xy, on an
    (out_h, out_w) canvas per batch item: (warped (B, out_h, out_w, C),
    weight map clipped to [0, 1] (B, out_h, out_w, 1))."""
    B, H, W, C = values.shape
    if weights is None:
        weights = torch.ones((B, H, W, 1), dtype=values.dtype,
                             device=values.device)
    floor = torch.floor(coords)
    off = coords - floor
    fx = floor[..., 0].to(torch.int64).reshape(B, -1)
    fy = floor[..., 1].to(torch.int64).reshape(B, -1)
    ox, oy = off[..., 0].reshape(B, -1), off[..., 1].reshape(B, -1)
    vals = values.reshape(B * H * W, C)
    wgt = weights.reshape(B, -1)
    base = (torch.arange(B, device=values.device) * (out_h * out_w))[:, None]

    acc = values.new_zeros((B * out_h * out_w, C))
    wacc = values.new_zeros((B * out_h * out_w,))
    for di in range(2):
        for dj in range(2):
            ix, iy = fx + di, fy + dj
            valid = (ix >= 0) & (ix < out_w) & (iy >= 0) & (iy < out_h)
            bw = (((1.0 - di) - ((-1.0) ** di) * ox)
                  * ((1.0 - dj) - ((-1.0) ** dj) * oy))
            w = (bw * wgt * valid.to(values.dtype)).reshape(-1)
            idx = (base + iy.clamp(0, out_h - 1) * out_w
                   + ix.clamp(0, out_w - 1)).reshape(-1)
            acc.index_add_(0, idx, vals * w[:, None])
            wacc.index_add_(0, idx, w)
    wmap = wacc.reshape(B, out_h, out_w, 1)
    out = torch.where(wmap > eps,
                      acc.reshape(B, out_h, out_w, C) / wmap.clamp(min=eps),
                      torch.zeros((), dtype=values.dtype,
                                  device=values.device))
    return out, wmap.clamp(0.0, 1.0)


def bilinear_splat(values: torch.Tensor, coords: torch.Tensor, out_h: int,
                   out_w: int, weights: Optional[torch.Tensor] = None,
                   eps: float = 1e-7) -> Tuple[torch.Tensor, torch.Tensor]:
    """`bilinear_splat_b` of one (H, W, C) image: ((out_h, out_w, C),
    (out_h, out_w, 1))."""
    out, wmap = bilinear_splat_b(
        values[None], coords[None], out_h, out_w,
        None if weights is None else weights[None], eps)
    return out[0], wmap[0]


def forward_warp_with_flow(img: torch.Tensor, flow: torch.Tensor, out_h: int,
                           out_w: int, offset_xy=(0.0, 0.0)
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward-warp an (H, W, C) image by its flow (H, W, 2) onto an
    (out_h, out_w) canvas, shifted by `offset_xy` in canvas pixels (for a
    negative canvas origin; reference: core/utils/warper.py:87-109)."""
    coords = flow_to_warp(flow) + torch.tensor(offset_xy, dtype=flow.dtype,
                                               device=flow.device)
    return bilinear_splat(img, coords, out_h, out_w)
