"""Coordinate grids and homography meshes (NHWC, xy-last).

Port of stitchax/ops/grid.py. Grids are built on the caller's device.
"""

from __future__ import annotations

import torch


def coords_grid(h: int, w: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Pixel coordinate grid (H, W, 2), last axis (x, y)."""
    ys = torch.arange(h, device=device, dtype=dtype)
    xs = torch.arange(w, device=device, dtype=dtype)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], -1)


def normalized_grid(h: int, w: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Normalized coords in [-1, 1], (H, W, 2), torch linspace endpoints."""
    xs = torch.linspace(-1.0, 1.0, w, device=device, dtype=dtype)
    ys = torch.linspace(-1.0, 1.0, h, device=device, dtype=dtype)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], -1)


def get_rigid_mesh(h: int, w: int, grid_h: int = 511, grid_w: int = 511,
                   device=None, dtype=torch.float32) -> torch.Tensor:
    """Regular (grid_h+1, grid_w+1, 2) mesh spanning [0, W] x [0, H]."""
    xs = torch.linspace(0.0, float(w), grid_w + 1, device=device, dtype=dtype)
    ys = torch.linspace(0.0, float(h), grid_h + 1, device=device, dtype=dtype)
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
    return apply_homography_to_points(torch.linalg.inv(H), rigid_mesh)
