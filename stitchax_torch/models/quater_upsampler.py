"""Quarter-resolution flow refinement (port of
stitchax/models/quater_upsampler.py; off in the shipped configuration,
`quater_refine: False` in configs/last_config.py).

Upsample the 1/8-resolution flow to 1/4, correlate the 1/4-resolution
features of image1 with image2's warped by it over a 3x3 neighbourhood,
regress a flow delta, and convex-upsample 4x to full resolution. NHWC,
flax's names.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.flow import convex_upsample_flow_b, flow_warp_b
from ..ops.sampling import interpolate_bilinear_b
from .layers import Conv


def local_cost_3x3(f1: torch.Tensor, f2w: torch.Tensor) -> torch.Tensor:
    """Per-pixel 3x3 local correlation, (B, H, W, C) x2 -> (B, H, W, 9),
    the neighbours row-major from the top left, zero outside."""
    B, H, W, C = f1.shape
    pad = F.pad(f2w, (0, 0, 1, 1, 1, 1))
    costs = [(f1 * pad[:, dy:dy + H, dx:dx + W]).sum(-1) / float(C) ** 0.5
             for dy in range(3) for dx in range(3)]
    return torch.stack(costs, -1)


class QuaterUpsampler(nn.Module):
    """flow_lr (B, H/8, W/8, 2), feat1_q / feat2_q (B, H/4, W/4, feat_dim)
    -> full-resolution flow (B, H, W, 2)."""

    def __init__(self, feat_dim: int = 128):
        super().__init__()
        self.conv1 = Conv(9 + 2 + feat_dim, 128, 3, padding=1)
        self.conv2 = Conv(128, 64, 3, padding=1)
        self.flow_head = Conv(64, 2, 3, padding=1)
        self.mask1 = Conv(64, 128, 3, padding=1)
        self.mask2 = Conv(128, 16 * 9, 1)

    def forward(self, flow_lr, feat1_q, feat2_q):
        Hq, Wq = feat1_q.shape[1], feat1_q.shape[2]
        flow_q = interpolate_bilinear_b(flow_lr, Hq, Wq) * 2.0
        cost = local_cost_3x3(feat1_q, flow_warp_b(feat2_q, flow_q))
        x = torch.cat([cost, flow_q, feat1_q], -1)
        x = F.relu(self.conv2(F.relu(self.conv1(x))))
        flow_q = flow_q + self.flow_head(x)
        mask = 0.25 * self.mask2(F.relu(self.mask1(x)))
        return convex_upsample_flow_b(flow_q, mask, rate=4)
