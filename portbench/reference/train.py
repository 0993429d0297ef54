"""The reference's alignment train step: the sequence loss, one backward
pass, the global-norm clip and AdamW on the one-cycle schedule, in plain
PyTorch and float32, written from the port's `train/losses.py` and
`train/optim.py` (optax's semantics) without their fused `_foreach` calls.

The batch's gradient is taken in micro-batches so that the plain
attention's saved activations fit the card. The photometric terms divide
by the mask counts of the whole batch, so a first pass without gradient
sums each prediction's masked error S and mask count C (and keeps each
micro-batch's occlusion mask), and the second differentiates, per
micro-batch, (S_mb - (S / C) C_mb) / (C ch) plus the micro-batch's share
of the rigid and border means: summed over the micro-batches that is the
whole batch's gradient of the loss."""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch

from .align import AlignConfig, align_train_forward, occlusion_mask
from .flow import flow_warp_b

B1, B2 = 0.9, 0.999            # optax.adamw's defaults
f32 = np.float32


def onecycle(canonical_lr: float, num_steps: int, pct_start: float,
             anneal_strategy: str, batch_scale: int) -> Callable[[int], float]:
    """count -> learning rate: optax's one-cycle schedule over num_steps +
    100 steps (div 25, final div 1e4) with the float32 arithmetic of a
    jitted step (a copy of the port's `onecycle_schedule`)."""
    lr = canonical_lr * batch_scale
    T = num_steps + 100
    if anneal_strategy == "linear":
        scales = {int(pct_start * T): 25.0, int(1.0 * T): 1.0 / 25.0}
        scales[T] = 1.0 / 1e4
    else:
        scales = {int(pct_start * T): 25.0, T: 1.0 / (25.0 * 1e4)}
    bounds = [0, *sorted(scales)]
    values = np.cumprod([lr / 25.0, *(scales[b] for b in bounds[1:])])
    cosine = anneal_strategy != "linear"

    def schedule(count: int) -> float:
        if count >= bounds[-1]:
            return float(f32(values[-1]))
        i = max(j for j in range(len(bounds) - 1) if bounds[j] <= count)
        start, end = f32(values[i]), f32(values[i + 1])
        recip = f32(1.0) / f32(bounds[i + 1] - bounds[i])
        if cosine:
            pct = f32(count - bounds[i]) * recip
            c = f32(np.cos(f32(math.pi) * pct))
            return float(end + (start - end) / f32(2.0) * (c + f32(1.0)))
        slope = f32(f32(values[i + 1] - values[i]) * recip)
        return float(f32(np.float64(slope) * np.float64(count - bounds[i])
                         + np.float64(start)))

    return schedule


class AdamW:
    """clip_by_global_norm(clip) -> adamw(schedule, b1 0.9, b2 0.999, eps
    outside the root, decoupled weight decay on every tensor), one tensor
    at a time. `last_grads` keeps the clipped gradient of the last step."""

    def __init__(self, optim: Mapping, batch_scale: int):
        self.cfg = optim
        self.schedule = onecycle(optim["canonical_lr"], optim["num_steps"],
                                 optim["pct_start"],
                                 optim["anneal_strategy"], batch_scale)
        self.count = 0
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}
        self.last_grads: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> float:
        """Update `params` in place; returns the raw gradients' norm."""
        c = self.cfg
        norm = math.sqrt(sum(float((g.double() ** 2).sum())
                             for g in grads.values()))
        scale = c["clip"] / norm if norm >= c["clip"] else 1.0
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = float(f32(1.0) - f32(B1) ** f32(self.count))
        bc2 = float(f32(1.0) - f32(B2) ** f32(self.count))
        self.last_grads = {}
        for n, p in params.items():
            g = grads[n] * scale
            self.last_grads[n] = g
            mu = self.mu.get(n, torch.zeros_like(p))
            nu = self.nu.get(n, torch.zeros_like(p))
            mu = (1.0 - B1) * g + B1 * mu
            nu = (1.0 - B2) * g * g + B2 * nu
            self.mu[n], self.nu[n] = mu, nu
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + c["epsilon"])
            u = u + c["adamw_decay"] * p
            p.add_(u, alpha=-float(f32(lr)))
        return norm


def _terms(img1, fwd, occ, loss: Mapping) -> Tuple[torch.Tensor, ...]:
    """Per prediction the masked Charbonnier sum S and mask count C (n,),
    and the final flow's rigid-motion sum and border-ring sum."""
    sums, counts = [], []
    for flow in fwd["flow_predictions"]:
        mag = torch.sqrt((flow * flow).sum(-1, keepdim=True))
        valid_flow = (mag < loss["max_flow"]).to(img1.dtype)
        warped = flow_warp_b(fwd["output_H"], flow)
        w2, wmask = warped[..., 0:3], warped[..., 3:6].mean(-1, keepdim=True)
        m = wmask * valid_flow
        if occ is not None:
            m = m * occ
        diff = img1 - w2
        err = torch.sqrt(diff * diff + loss["charbonnier_eps"] ** 2)
        sums.append((err * m).sum())
        counts.append(m.sum())
    final = fwd["flow_predictions"][-1]
    rigid = torch.sqrt((final * final).sum(-1) + 1e-6).sum()
    b = loss["border_px"]
    ring = torch.zeros(final.shape[1:3], device=final.device,
                       dtype=final.dtype)
    ring[:b], ring[-b:], ring[:, :b], ring[:, -b:] = 1, 1, 1, 1
    border = (final.abs().sum(-1) * ring).sum()
    return torch.stack(sums), torch.stack(counts), rigid, border, ring.sum()


def loss_and_grads(nets: Mapping[str, torch.nn.Module],
                   params: Dict[str, torch.Tensor], img1: torch.Tensor,
                   img2: torch.Tensor, align: AlignConfig, loss: Mapping,
                   use_fb: bool, micro: int
                   ) -> Tuple[Dict[str, float], Dict[str, torch.Tensor]]:
    """The whole batch's losses {total, photometric, rigid, border} and
    gradient {name: tensor}, taken `micro` pairs at a time."""
    homo, flow = nets["homo"], nets["flow"]
    B, H, W, ch = img1.shape
    blocks = [slice(i, min(i + micro, B)) for i in range(0, B, micro)]
    S = C = None
    rigid = border = 0.0
    occs: List = []
    with torch.no_grad():
        for sl in blocks:
            fwd = align_train_forward(homo, flow, img1[sl], img2[sl], align)
            occ = occlusion_mask(flow, fwd, img1[sl], align) if use_fb else None
            occs.append(occ)
            s, c, r, bo, ring = _terms(img1[sl], fwd, occ, loss)
            S = s if S is None else S + s
            C = c if C is None else C + c
            rigid += float(r)
            border += float(bo)
    n = S.shape[0]
    Cc = torch.clamp(C, min=1.0)
    photo = S / (Cc * ch)
    weights = torch.tensor([loss["gamma"] ** (n - 1 - i) for i in range(n)],
                           device=S.device, dtype=S.dtype)
    rigid_mean = rigid / (B * H * W)
    border_mean = border / (float(ring) * B)
    total = (float((weights * photo).sum()) + loss["rigid_motion_weight"]
             * rigid_mean + loss["border_weight"] * border_mean)
    for p in params.values():
        p.grad = None
    for sl, occ in zip(blocks, occs):
        fwd = align_train_forward(homo, flow, img1[sl], img2[sl], align)
        s, c, r, bo, ring = _terms(img1[sl], fwd, occ, loss)
        dc = c * (C >= 1.0).to(c.dtype)
        surrogate = ((weights * (s - (S / Cc) * dc) / (Cc * ch)).sum()
                     + loss["rigid_motion_weight"] * r / (B * H * W)
                     + loss["border_weight"] * bo / (ring * B))
        surrogate.backward()
    grads = {k: (p.grad.detach().clone() if p.grad is not None
                 else torch.zeros_like(p)) for k, p in params.items()}
    for p in params.values():
        p.grad = None
    losses = {"total": total, "photometric": float(photo[-1]),
              "rigid": rigid_mean, "border": border_mean}
    return losses, grads
