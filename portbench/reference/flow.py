"""Flow-field utilities: backward warp, resize, convex upsampling.

Port of stitchax/ops/flow.py. Flows are (B, H, W, 2), xy-last, in pixels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .grid import coords_grid
from .sampling import bilinear_gather_b, interpolate_bilinear_b


def flow_to_warp(flow: torch.Tensor) -> torch.Tensor:
    """flow (..., H, W, 2) -> absolute sampling coords grid + flow."""
    H, W = flow.shape[-3], flow.shape[-2]
    return coords_grid(H, W, device=flow.device, dtype=flow.dtype) + flow


def flow_warp_b(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """out(p) = x(p + flow(p)); grid_sample parity (align_corners), zeros
    padding. stitchax maps p + flow to [-1, 1] and back; XLA cancels that
    round trip under jit, so the samples are taken at p + flow itself."""
    coords = flow_to_warp(flow)
    return bilinear_gather_b(x, coords[..., 0], coords[..., 1])


def resize_flow_b(flow: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """Bilinear (align_corners=True) resize with vectors rescaled."""
    H, W = flow.shape[1], flow.shape[2]
    out = interpolate_bilinear_b(flow, new_h, new_w, align_corners=True)
    scale = torch.tensor([new_w / float(W), new_h / float(H)],
                         device=flow.device, dtype=flow.dtype)
    return out * scale


def convex_upsample_flow_b(flow: torch.Tensor, mask: torch.Tensor,
                           rate: int = 8) -> torch.Tensor:
    """RAFT convex upsampling: flow (B, H, W, 2), mask (B, H, W, 9*rate^2)
    logits -> (B, rate*H, rate*W, 2)."""
    B, H, W, _ = flow.shape
    m = torch.softmax(mask.reshape(B, H, W, 9, rate, rate), dim=3)
    fpad = F.pad(float(rate) * flow, (0, 0, 1, 1, 1, 1))
    nb = torch.stack([fpad[:, dy:dy + H, dx:dx + W]
                      for dy in range(3) for dx in range(3)], -1)
    up = torch.einsum("bhwcn,bhwnuv->bhwcuv", nb, m)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(B, rate * H, rate * W, 2)
