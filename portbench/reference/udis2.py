"""UDIS2 homography regression and the composition net (port of
stitchax/models/udis2.py)."""

from __future__ import annotations

import numpy as np

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


class CompositionDownBlock(nn.Module):
    """[2x2 max pool] -> two 3x3 dilated convs with padding 1, each + ReLU.
    Keeps the reference's padding=1 with dilation > 1, which shrinks H/W
    by 2*(d-1) per conv; the up block's resize recombines the shapes."""

    def __init__(self, cin: int, features: int, dilation: int,
                 pool: bool = True):
        super().__init__()
        self.pool = pool
        self.conv1 = Conv(cin, features, 3, padding=1, dilation=dilation)
        self.conv2 = Conv(features, features, 3, padding=1,
                          dilation=dilation)

    def forward(self, x):
        if self.pool:
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        return F.relu(self.conv2(F.relu(self.conv1(x))))


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """torch F.interpolate(mode='nearest') source rows: floor(i * in/out),
    in fp32 as stitchax computes them (not jax.image.resize's half-pixel
    centres, which pick other taps on the odd sizes the dilated downs
    give)."""
    i = np.floor(np.arange(n_out, dtype=np.float32)
                 * np.float32(n_in / n_out)).astype(np.int64)
    return torch.from_numpy(i).to(device)


class CompositionUpBlock(nn.Module):
    """Nearest resize of the coarse input to the skip's size, 3x3 conv +
    ReLU ("half"), concat [skip, coarse], two dilated convs + ReLU."""

    def __init__(self, cin: int, features: int, dilation: int):
        super().__init__()
        self.half = Conv(cin, features, 3, padding=1)
        self.conv1 = Conv(2 * features, features, 3, padding=1,
                          dilation=dilation)
        self.conv2 = Conv(features, features, 3, padding=1,
                          dilation=dilation)

    def forward(self, x1, x2):
        H2, W2 = x2.shape[1], x2.shape[2]
        x1 = x1[:, _nearest_index(x1.shape[1], H2, x1.device)]
        x1 = x1[:, :, _nearest_index(x1.shape[2], W2, x1.device)]
        # "half" (stitchax's name) is shadowed by nn.Module.half()
        x1 = F.relu(self._modules["half"](x1))
        x = torch.cat([x2, x1], -1)
        return F.relu(self.conv2(F.relu(self.conv1(x))))


class CompositionNet(nn.Module):
    """Siamese dilated U-Net predicting img1's seam mask from the two
    [-1, 1] warps (the masks are not inputs of the net itself)."""

    DOWNS = ((3, 32, 1), (32, 64, 2), (64, 128, 3), (128, 256, 4),
             (256, 512, 5))
    UPS = ((512, 256, 4), (256, 128, 3), (128, 64, 2), (64, 32, 1))

    def __init__(self):
        super().__init__()
        for i, (cin, f, d) in enumerate(self.DOWNS):
            setattr(self, f"down{i + 1}",
                    CompositionDownBlock(cin, f, d, pool=i > 0))
        for i, (cin, f, d) in enumerate(self.UPS):
            setattr(self, f"up{i + 1}", CompositionUpBlock(cin, f, d))
        self.out = Conv(32, 1, 1)

    def _encode(self, t):
        feats = []
        for i in range(len(self.DOWNS)):
            t = getattr(self, f"down{i + 1}")(t)
            feats.append(t)
        return feats

    def forward(self, warp1, warp2, mask1, mask2):
        x = self._encode(warp1)
        y = self._encode(warp2)
        res = self.up1(x[4] - y[4], x[3] - y[3])
        res = self.up2(res, x[2] - y[2])
        res = self.up3(res, x[1] - y[1])
        res = self.up4(res, x[0] - y[0])
        return torch.sigmoid(self.out(res))


def compose_seam(out, warp1, warp2, mask1, mask2):
    """Blend the [-1, 1] warps with the learned masks."""
    learned_mask1 = (mask1 - mask1 * mask2) + mask1 * mask2 * out
    learned_mask2 = (mask2 - mask1 * mask2) + mask1 * mask2 * (1 - out)
    stitched = ((warp1 + 1.0) * learned_mask1 + (warp2 + 1.0) * learned_mask2
                - 1.0)
    return dict(learned_mask1=learned_mask1, learned_mask2=learned_mask2,
                stitched_image=stitched)
