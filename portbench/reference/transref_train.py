"""The reference's TransRef train step, in plain PyTorch and float32: the
masked input as the trainer prepares it, the objective 1 L1 + 0.04
perceptual + 250 style (`vgg.objective`) on the raw model output against
the ground truth, one backward pass and optax.adam(lr) (b1 0.9, b2 0.999,
eps 1e-8 outside the root, bias correction at count + 1), one tensor at a
time. Written from the port's `train/transref_trainer.py` and
`train/optim.py` (optax's semantics) without their fused `_foreach` calls.

The batch's gradient is taken in micro-batches so that the reference fits
the card after the program is freed: every term is a mean over the batch
of per-image means of equal sizes, so the batch's gradient is the sum over
the micro-batches of each one's gradient times its share of the batch.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from .transref import TransRef
from .vgg import VGG16Features, objective

B1, B2 = 0.9, 0.999            # optax.adam's defaults
f32 = np.float32


def prepare_inputs(gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """gt (B, H, W, 3) in [-1, 1] with each hole pixel (mask 1) replaced by
    the image's mean over its visible pixels (at least one pixel counted)."""
    vis = 1.0 - mask
    mean = (gt * vis).sum((1, 2)) / vis.sum((1, 2)).clamp(min=1.0)
    return gt * vis + mean[:, None, None, :] * mask


class Adam:
    """optax.adam(lr, eps=1e-8) on a dict of tensors, updated in place, each
    product and sum in the port's order (float32 rounds each)."""

    def __init__(self, lr: float, eps: float = 1e-8):
        self.lr, self.eps = lr, eps
        self.count = 0
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.count += 1
        bc1 = float(f32(1.0) - f32(B1) ** f32(self.count))
        bc2 = float(f32(1.0) - f32(B2) ** f32(self.count))
        for n, p in params.items():
            g = grads[n]
            zero = torch.zeros_like(p)
            mu = g * (1.0 - B1) + self.mu.get(n, zero) * B1
            nu = (g * g) * (1.0 - B2) + self.nu.get(n, zero) * B2
            self.mu[n], self.nu[n] = mu, nu
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(u * -float(f32(self.lr)))


def loss_and_grads(model: TransRef, vgg: VGG16Features, gt: torch.Tensor,
                   ref: torch.Tensor, mask: torch.Tensor, loss: Mapping,
                   micro: int
                   ) -> Tuple[Dict[str, float], Dict[str, torch.Tensor]]:
    """The batch's losses {total, l1, perceptual, style} and the gradient
    of total {name: tensor} at the model's parameters, `micro` images at a
    time. `loss` holds the weights l1, perceptual and style."""
    B = gt.shape[0]
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    sums = {"total": 0.0, "l1": 0.0, "perceptual": 0.0, "style": 0.0}
    for i in range(0, B, micro):
        sl = slice(i, min(i + micro, B))
        share = (sl.stop - sl.start) / B
        out = model(prepare_inputs(gt[sl], mask[sl]), mask[sl], ref[sl])
        terms = objective(vgg, out, gt[sl], loss["l1"], loss["perceptual"],
                          loss["style"])
        (terms["total"] * share).backward()
        for k in sums:
            sums[k] += float(terms[k].detach()) * share
    grads = {n: (p.grad.detach().clone() if p.grad is not None
                 else torch.zeros_like(p)) for n, p in params.items()}
    for p in params.values():
        p.grad = None
    return sums, grads
