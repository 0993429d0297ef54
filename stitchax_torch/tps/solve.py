"""Thin-plate-spline solve and dense warp (port of stitchax/tps/solve.py).

`tps_fit` solves the (N+3) x (N+3) system in fp32 with a small Tikhonov
term; invalid control points get identity rows and exactly zero weight.
Where the system is singular (fewer valid points than the affine part
needs) every weight is NaN, as stitchax's solve gives, chosen on the device
without a host sync.
`tps_backward_warp` folds validity into the weights and evaluates the map
at every canvas pixel with the CUDA kernel K2 (`ops.kernels.tps_grid`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.kernels.tps_grid import tps_grid, u_kernel
from ..ops.sampling import grid_sample


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a[:, None, :] - b[None, :, :]
    return (d * d).sum(-1)


def tps_fit(ctrl: torch.Tensor, target: torch.Tensor,
            valid: Optional[torch.Tensor] = None, variant: str = "opencv",
            reg: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weights of the map g(ctrl_i) = target_i ([0, 1] coords):
    (kernel_weights (N, 2), affine_weights (3, 2) ordered [bias, x, y])."""
    N = ctrl.shape[0]
    dev, dtype = ctrl.device, ctrl.dtype
    v = (torch.ones(N, device=dev, dtype=dtype) if valid is None
         else valid.to(dtype))
    K = u_kernel(_sq_dist(ctrl, ctrl), variant) * v[:, None] * v[None, :]
    K = K + reg * torch.eye(N, device=dev, dtype=dtype)
    P = torch.cat([torch.ones(N, 1, device=dev, dtype=dtype), ctrl], 1) * v[:, None]
    L = torch.zeros(N + 3, N + 3, device=dev, dtype=dtype)
    L[:N, :N] = K + torch.diag(1.0 - v)
    L[:N, N:] = P
    L[N:, :N] = P.T
    rhs = torch.zeros(N + 3, 2, device=dev, dtype=dtype)
    rhs[:N] = target * v[:, None]
    w, info = torch.linalg.solve_ex(L, rhs)
    # singular L: too few valid points to fix the affine part (e.g. the
    # occlusion filter dropped them all); stitchax's solve gives NaN here
    w = torch.where(info != 0, torch.full_like(w, float("nan")), w)
    return w[:N], w[N:]


def tps_backward_warp(points_src: torch.Tensor, points_dst: torch.Tensor,
                      valid: Optional[torch.Tensor], out_h: int, out_w: int,
                      variant: str = "opencv", kernel_scale: float = 1.0,
                      affine_scale: float = 1.0, reg: float = 1e-6
                      ) -> torch.Tensor:
    """Fit the backward map g: dst -> src (pixel coords) and evaluate it at
    every output pixel: (out_h, out_w, 2) source coordinates."""
    scale = torch.tensor([out_w, out_h], device=points_src.device,
                         dtype=points_src.dtype)
    src_n = points_src / scale
    dst_n = points_dst / scale
    kw, aw = tps_fit(dst_n, src_n, valid, variant, reg)
    if valid is not None:
        kw = kw * valid.to(kw.dtype)[:, None]
    mapped = tps_grid(dst_n.contiguous(), kw.contiguous(), aw.contiguous(),
                      out_h, out_w, variant, kernel_scale, affine_scale)
    return mapped * scale


def tps_warp_image(img: torch.Tensor, points_src: torch.Tensor,
                   points_dst: torch.Tensor,
                   valid: Optional[torch.Tensor] = None,
                   variant: str = "opencv", kernel_scale: float = 1.0,
                   affine_scale: float = 1.0, reg: float = 1e-6
                   ) -> torch.Tensor:
    """TPS-warp (H, W, C) so content at points_src lands at points_dst;
    out-of-source samples are zero."""
    H, W, _ = img.shape
    coords = tps_backward_warp(points_src, points_dst, valid, H, W, variant,
                               kernel_scale, affine_scale, reg)
    gx = 2.0 * coords[..., 0] / (W - 1) - 1.0
    gy = 2.0 * coords[..., 1] / (H - 1) - 1.0
    return grid_sample(img, torch.stack([gx, gy], -1))
