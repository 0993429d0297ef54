"""VGG16 features and the perceptual / style losses of TransRef's training
objective (port of stitchax/models/vgg.py).

`VGG16Features` is torchvision's vgg16 `features` up to relu5_1, returning
every reluX_Y activation (NHWC, as stitchax's), with stitchax's quirk kept:
relu5_2 and relu5_3 re-apply the relu5_1 block (2x2 max pool, conv5_1,
ReLU) instead of conv5_2 / conv5_3, which therefore do not exist here. The
inputs are raw [-1, 1] images with no ImageNet normalisation, as stitchax
feeds them. Pools floor odd sizes (flax's VALID `max_pool`); relu5_3 is
1/64 of the input side. The activations are NHWC throughout: on a card
every convolution, its input gradient too, runs on K7
(`ops/kernels/conv3x3_wide.py`); on the CPU its plain version runs
F.conv2d on NCHW views of the NHWC tensors (channels-last memory), as the
port's `layers.Conv` does, and the pools take the same views.

`load_torchvision_features` loads a torchvision vgg16 state dict's
`features.*` entries (OIHW already: no transpose) at indices 0, 2, 5, 7,
10, 12, 14, 17, 19, 21 and 24; the flax tree of stitchax's
`convert_vgg16_features` loads with `convert.load_jax_params` like any
other.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels.conv3x3_wide import conv3x3_wide_relu

# (name, out_channels, pool_before), torchvision vgg16.features' order
VGG16_LAYOUT = [
    ("conv1_1", 64, False), ("conv1_2", 64, False),
    ("conv2_1", 128, True), ("conv2_2", 128, False),
    ("conv3_1", 256, True), ("conv3_2", 256, False), ("conv3_3", 256, False),
    ("conv4_1", 512, True), ("conv4_2", 512, False), ("conv4_3", 512, False),
    ("conv5_1", 512, True),
]
# the index of each conv of VGG16_LAYOUT in torchvision's `features`
TORCHVISION_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24)
PERCEPTUAL_LAYERS = ("relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1")
STYLE_LAYERS = ("relu2_2", "relu3_3", "relu4_3", "relu5_2")


class VGG16Features(nn.Module):
    """x (B, H, W, 3) in [-1, 1] -> {reluX_Y: (B, h, w, C)}."""

    def __init__(self):
        super().__init__()
        cin = 3
        for name, ch, _ in VGG16_LAYOUT:
            setattr(self, name, nn.Conv2d(cin, ch, 3, padding=1))
            cin = ch

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """flax's default initialisers (stitchax's random VGG): kernels
        ~ N(0, 1 / fan_in), zero biases, drawn from `generator`."""
        for name, _, _ in VGG16_LAYOUT:
            conv = getattr(self, name)
            fan_in = conv.weight[0].numel()
            w = torch.randn(conv.weight.shape, generator=generator)
            conv.weight.copy_(w * fan_in ** -0.5)
            conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        def conv(name, h):
            c = getattr(self, name)
            return conv3x3_wide_relu(h, c.weight, c.bias)

        def pool(h):
            return F.max_pool2d(h.permute(0, 3, 1, 2), 2).permute(
                0, 2, 3, 1).contiguous()

        x, feats = x.contiguous(), {}
        for name, _, pooled in VGG16_LAYOUT:
            x = conv(name, pool(x) if pooled else x)
            feats["relu" + name[4:]] = x
        # stitchax's quirk (its vgg.py:49-54): relu5_2 / relu5_3 re-apply
        # the relu5_1 block
        for name in ("relu5_2", "relu5_3"):
            x = conv("conv5_1", pool(x))
            feats[name] = x
        return feats


def load_torchvision_features(module: VGG16Features, state_dict
                              ) -> VGG16Features:
    """Fill `module` from a torchvision vgg16 state dict (its `features.*`
    entries; the classifier and conv5_2 / conv5_3 are not read)."""
    sd = {}
    for (name, _, _), i in zip(VGG16_LAYOUT, TORCHVISION_INDEX):
        for leaf in ("weight", "bias"):
            sd[f"{name}.{leaf}"] = torch.as_tensor(
                state_dict[f"features.{i}.{leaf}"], dtype=torch.float32)
    module.load_state_dict(sd, strict=True)
    return module


def gram_matrix(f: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, C) Gram, divided by H * W * C."""
    B, H, W, C = f.shape
    m = f.reshape(B, H * W, C)
    return torch.bmm(m.transpose(1, 2), m) / (H * W * C)


def perceptual_loss(feats_x: Dict, feats_y: Dict,
                    weights: Sequence[float] = (1.0,) * 5) -> torch.Tensor:
    """Weighted L1 over relu1_1 ... relu5_1."""
    total = 0.0
    for w, layer in zip(weights, PERCEPTUAL_LAYERS):
        total = total + w * (feats_x[layer] - feats_y[layer]).abs().mean()
    return total


def style_loss(feats_x: Dict, feats_y: Dict) -> torch.Tensor:
    """L1 between the Gram matrices of relu2_2, relu3_3, relu4_3, relu5_2."""
    total = 0.0
    for layer in STYLE_LAYERS:
        total = total + (gram_matrix(feats_x[layer])
                         - gram_matrix(feats_y[layer])).abs().mean()
    return total


def _target_features(feats_apply: Callable, target: torch.Tensor):
    """The target's features: no gradient reaches them."""
    with torch.no_grad():
        return feats_apply(target)


def transref_total_loss(vgg: Callable, pred, target, mask,
                        l1_weight: float = 1.0, perc_weight: float = 0.1,
                        style_weight: float = 250.0
                        ) -> Dict[str, torch.Tensor]:
    """L1 + VGG perceptual + style on pred / target in [-1, 1] NHWC, fed
    to the VGG raw. `mask` is unused, as in stitchax. Returns total, l1,
    perceptual, style."""
    l1 = (pred - target).abs().mean()
    fx = vgg(pred)
    fy = _target_features(vgg, target)
    perc = perceptual_loss(fx, fy)
    style = style_loss(fx, fy)
    total = l1_weight * l1 + perc_weight * perc + style_weight * style
    return dict(total=total, l1=l1, perceptual=perc, style=style)


def feature_total_loss(feats_apply: Callable, pred, target, mask,
                       l1_weight: float = 1.0, perc_weight: float = 0.04,
                       style_weight: float = 250.0
                       ) -> Dict[str, torch.Tensor]:
    """`transref_total_loss` with any multi-scale feature extractor
    (`feats_apply(x) -> list of NHWC maps`) in place of the VGG: L1 and the
    Gram L1 summed over every map it returns."""
    l1 = (pred - target).abs().mean()
    fx: List[torch.Tensor] = feats_apply(pred)
    fy: List[torch.Tensor] = _target_features(feats_apply, target)
    perc = sum((a - b).abs().mean() for a, b in zip(fx, fy))
    style = sum((gram_matrix(a) - gram_matrix(b)).abs().mean()
                for a, b in zip(fx, fy))
    total = l1_weight * l1 + perc_weight * perc + style_weight * style
    return dict(total=total, l1=l1, perceptual=perc, style=style)
