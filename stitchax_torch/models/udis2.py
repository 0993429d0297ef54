"""UDIS2 homography regression (port of stitchax/models/udis2.py; the
composition net is not on this slice's path)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import ResNet50Stages
from .layers import Conv


def _patches_3x3(f: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, 9C) zero-padded 3x3 patches, (dy,dx)-major."""
    B, H, W, C = f.shape
    fp = F.pad(f, (0, 0, 1, 1, 1, 1))
    return torch.cat([fp[:, dy:dy + H, dx:dx + W] for dy in range(3)
                      for dx in range(3)], -1)


def ccl_correlation_flow(feature_1: torch.Tensor, feature_2: torch.Tensor,
                         softmax_scale: float = 10.0) -> torch.Tensor:
    """Contextual correlation: L2-normalized 3x3 patch matching of f1
    against every position of f2, scaled softmax over positions, then the
    expected displacement (B, H, W, 2) as (dx, dy)."""
    B, H, W, C = feature_1.shape
    n1 = feature_1 / feature_1.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    n2 = feature_2 / feature_2.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    p1 = _patches_3x3(n1).reshape(B, H * W, 9 * C)
    p2 = _patches_3x3(n2).reshape(B, H * W, 9 * C)
    match = (p1.float() @ p2.float().transpose(1, 2)).to(feature_1.dtype)
    attn = torch.softmax(match * softmax_scale, dim=-1)
    cy, cx = torch.meshgrid(
        torch.arange(H, device=feature_1.device, dtype=feature_1.dtype),
        torch.arange(W, device=feature_1.device, dtype=feature_1.dtype),
        indexing="ij")
    exp_x = attn @ cx.reshape(-1)
    exp_y = attn @ cy.reshape(-1)
    flow_w = (exp_x - cx.reshape(1, -1)).reshape(B, H, W)
    flow_h = (exp_y - cy.reshape(1, -1)).reshape(B, H, W)
    return torch.stack([flow_w, flow_h], -1)


class HomographyRegressionHead(nn.Module):
    """(B, S/16, S/16, 2) flow -> (B, 8) corner offsets; fc1 takes the
    flattened (S/128)^2 x 256 map (4096 at the model size S = 512)."""

    def __init__(self, input_size: int = 512):
        super().__init__()
        cin = 2
        for i, w in enumerate((64, 128, 256)):
            setattr(self, f"conv{i}a", Conv(cin, w, 3, padding=1, bias=False))
            setattr(self, f"conv{i}b", Conv(w, w, 3, padding=1, bias=False))
            cin = w
        self.fc1 = nn.Linear((input_size // 128) ** 2 * 256, 4096)
        self.fc2 = nn.Linear(4096, 1024)
        self.fc3 = nn.Linear(1024, 8)

    def forward(self, x):
        for i in range(3):
            x = F.relu(getattr(self, f"conv{i}a")(x))
            x = F.relu(getattr(self, f"conv{i}b")(x))
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)   # torch NCHW flatten
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.fc3(x)


class UDIS2HomographyNet(nn.Module):
    """ResNet features of both [-1, 1] inputs, CCL at 1/16 res, regression
    to the 8 corner offsets, for `input_size`^2 inputs."""

    def __init__(self, input_size: int = 512):
        super().__init__()
        self.feature_extractor = ResNet50Stages()
        self.regress1 = HomographyRegressionHead(input_size)

    def forward(self, input1, input2):
        f1 = self.feature_extractor(input1)[-1]
        f2 = self.feature_extractor(input2)[-1]
        return self.regress1(ccl_correlation_flow(f1, f2))
