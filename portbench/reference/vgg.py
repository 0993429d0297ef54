"""The reference's loss network and terms of TransRef's training objective
(the reference repo's .../TransRef/models/loss.py): VGG16 `features` up to
relu5_1 with L1 perceptual and Gram-matrix style losses, in plain PyTorch
and float32 (a frozen copy of the port's plain `models/vgg.py`).

Departures from the published objective, as the port and the JAX package
have them:
- The VGG's weights are not ImageNet's (the repository holds none): the
  trainer's CLI draws them from its seed, kernels ~ N(0, 1 / fan_in) (flax's
  default scale, `seeded_vgg`) and zero biases, layer by layer from one
  CPU `torch.Generator`.
- The upstream slicing bug is kept (loss.py:96-97): relu5_2 and relu5_3
  re-apply the relu5_1 block (2x2 max pool, conv5_1, ReLU), so conv5_2 and
  conv5_3 do not exist.
- The VGG is fed the raw [-1, 1] images, with no ImageNet normalisation,
  as upstream (TransRef.py:1023-1024). Pools floor odd sides.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

# (name, out channels, pool before), torchvision vgg16.features' order
LAYOUT = (
    ("conv1_1", 64, False), ("conv1_2", 64, False),
    ("conv2_1", 128, True), ("conv2_2", 128, False),
    ("conv3_1", 256, True), ("conv3_2", 256, False), ("conv3_3", 256, False),
    ("conv4_1", 512, True), ("conv4_2", 512, False), ("conv4_3", 512, False),
    ("conv5_1", 512, True),
)
PERCEPTUAL = ("relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1")
STYLE = ("relu2_2", "relu3_3", "relu4_3", "relu5_2")


class VGG16Features(nn.Module):
    """x (B, H, W, 3) in [-1, 1] -> {reluX_Y: (B, h, w, C)}."""

    def __init__(self):
        super().__init__()
        cin = 3
        for name, ch, _ in LAYOUT:
            setattr(self, name, nn.Conv2d(cin, ch, 3, padding=1))
            cin = ch

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        feats = {}
        for name, _, pool in LAYOUT:
            if pool:
                x = F.max_pool2d(x, 2)
            x = F.relu(getattr(self, name)(x))
            feats["relu" + name[4:]] = x
        for name in ("relu5_2", "relu5_3"):
            x = F.relu(self.conv5_1(F.max_pool2d(x, 2)))
            feats[name] = x
        return {k: v.permute(0, 2, 3, 1) for k, v in feats.items()}


@torch.no_grad()
def seeded_vgg(seed: int) -> VGG16Features:
    """The VGG as `python -m stitchax_torch.train_transref --seed <seed>`
    draws it without `--vgg_ckpt`: for each conv in order, a standard
    normal of its (O, I, 3, 3) shape from `torch.Generator().manual_seed
    (seed)` times fan_in ** -0.5, and a zero bias; frozen, on the CPU."""
    vgg = VGG16Features()
    g = torch.Generator().manual_seed(int(seed))
    for name, _, _ in LAYOUT:
        conv = getattr(vgg, name)
        w = torch.randn(conv.weight.shape, generator=g)
        conv.weight.copy_(w * conv.weight[0].numel() ** -0.5)
        conv.bias.zero_()
    return vgg.requires_grad_(False)


def gram(f: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, C), divided by H * W * C."""
    B, H, W, C = f.shape
    m = f.reshape(B, H * W, C)
    return m.transpose(1, 2) @ m / (H * W * C)


def objective(vgg: VGG16Features, pred: torch.Tensor, target: torch.Tensor,
              l1_weight: float, perc_weight: float, style_weight: float
              ) -> Dict[str, torch.Tensor]:
    """{total, l1, perceptual, style} of pred against target (both
    [-1, 1] NHWC): the mean |pred - target|, the mean L1 of the relu{1..5}_1
    features summed over the layers, the mean L1 of the style layers' Grams
    summed over the layers; no gradient reaches the target's features."""
    l1 = (pred - target).abs().mean()
    fx = vgg(pred)
    with torch.no_grad():
        fy = vgg(target)
    perc = sum((fx[k] - fy[k]).abs().mean() for k in PERCEPTUAL)
    style = sum((gram(fx[k]) - gram(fy[k])).abs().mean() for k in STYLE)
    total = l1_weight * l1 + perc_weight * perc + style_weight * style
    return {"total": total, "l1": l1, "perceptual": perc, "style": style}
