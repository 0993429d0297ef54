"""ResNet-50 stem + layer1..3 (NHWC), the UDIS2 homography backbone
(port of stitchax/models/resnet.py)."""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Conv


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 -> 3x3(stride) -> 1x1(x4) + shortcut."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 use_projection: bool = False):
        super().__init__()
        self.use_projection = use_projection
        self.conv1 = Conv(cin, features, 1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv(features, features, 3, stride=stride, padding=1,
                          bias=False)
        self.bn2 = BatchNorm(features)
        self.conv3 = Conv(features, features * 4, 1, bias=False)
        self.bn3 = BatchNorm(features * 4)
        if use_projection:
            self.downsample_conv = Conv(cin, features * 4, 1, stride=stride,
                                        bias=False)
            self.downsample_bn = BatchNorm(features * 4)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = (self.downsample_bn(self.downsample_conv(x))
               if self.use_projection else x)
        return F.relu(y + res)


class ResNet50Stages(nn.Module):
    """Returns the outputs of layer1..layerN (the last is 1/16 res)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6),
                 features: Sequence[int] = (64, 128, 256)):
        super().__init__()
        self.layers = layers
        self.conv1 = Conv(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        for li, (n, f) in enumerate(zip(layers, features)):
            for b in range(n):
                setattr(self, f"layer{li + 1}_block{b}",
                        Bottleneck(cin, f, (1 if li == 0 else 2) if b == 0
                                   else 1, use_projection=b == 0))
                cin = f * 4

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        # torch maxpool k3 s2 p1 (pads with -inf)
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2,
                         padding=1).permute(0, 2, 3, 1)
        outs = []
        for li, n in enumerate(self.layers):
            for b in range(n):
                x = getattr(self, f"layer{li + 1}_block{b}")(x)
            outs.append(x)
        return outs
