"""Coordinate grids and homography meshes (NHWC, xy-last).

Port of stitchax/ops/grid.py. Grids are built on the caller's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tracing import count_sync


def xla_linspace(start: float, stop: float, n: int) -> np.ndarray:
    """float32 values of `jnp.linspace(start, stop, n)` as stitchax's
    jitted stages see them. There the endpoints are constants, and XLA folds
    the grid at compile time after rewriting jnp's `iota / (n-1)` as a
    product with the rounded reciprocal r and combining `stop * (i * r)`
    into `i * (stop * r)`; stop is appended as the last point. Eager jnp
    and `torch.linspace` give other values at a third or more of the
    points, and mask thresholds downstream hang on them."""
    f32 = np.float32
    if n == 1:
        return np.array([start], f32)
    i = np.arange(n - 1, dtype=f32)
    r = f32(1.0) / f32(n - 1)
    out = i * (f32(stop) * r) + f32(start) * (f32(1.0) - i * r)
    return np.append(out, f32(stop)).astype(f32)


def _linspace(start: float, stop: float, n: int, device, dtype):
    count_sync(device)              # a blocking host-to-device copy
    return torch.from_numpy(xla_linspace(start, stop, n)).to(device, dtype)


def coords_grid(h: int, w: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Pixel coordinate grid (H, W, 2), last axis (x, y)."""
    ys = torch.arange(h, device=device, dtype=dtype)
    xs = torch.arange(w, device=device, dtype=dtype)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], -1)


def normalized_grid(h: int, w: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Normalized coords in [-1, 1], (H, W, 2) (`xla_linspace`)."""
    xs = _linspace(-1.0, 1.0, w, device, dtype)
    ys = _linspace(-1.0, 1.0, h, device, dtype)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], -1)


def get_rigid_mesh(h: int, w: int, grid_h: int = 511, grid_w: int = 511,
                   device=None, dtype=torch.float32) -> torch.Tensor:
    """Regular (grid_h+1, grid_w+1, 2) mesh spanning [0, W] x [0, H]
    (`xla_linspace`)."""
    xs = _linspace(0.0, float(w), grid_w + 1, device, dtype)
    ys = _linspace(0.0, float(h), grid_h + 1, device, dtype)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], -1)


def apply_homography_to_points(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Project (..., 2) points through (3, 3) H, or (B, ..., 2) through
    (B, 3, 3), with the perspective divide."""
    p = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
    if H.dim() == 3:
        shape = p.shape
        q = (p.reshape(shape[0], -1, 3) @ H.transpose(1, 2)).reshape(shape)
    else:
        q = p @ H.T
    return q[..., :2] / q[..., 2:3]


def h2mesh(H: torch.Tensor, rigid_mesh: torch.Tensor) -> torch.Tensor:
    """Map a rigid mesh through H^-1 (the reference's H2Mesh convention)."""
    count_sync(H.device)            # linalg.inv checks its result on the host
    return apply_homography_to_points(torch.linalg.inv(H), rigid_mesh)
