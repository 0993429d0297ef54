"""Unsupervised alignment losses (port of stitchax/train/losses.py).

UDIS-D has no ground-truth flow, so the decoder's prediction sequence is
supervised photometrically: each prediction warps the homography-warped
img2 (and its coverage) onto img1, weighted by gamma^(n-1-i) as RAFT's
sequence loss, plus the final flow's rigid-motion and border terms with
configs/last_config.py's weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from ..ops.flow import flow_warp_b
from ..parallel.mesh import all_sum


@dataclass(frozen=True)
class LossConfig:
    gamma: float = 0.8
    rigid_motion_weight: float = 0.3
    border_weight: float = 0.5
    max_flow: float = 500.0
    border_px: int = 8
    charbonnier_eps: float = 1.0


def photometric_l1(img1: torch.Tensor, warped2: torch.Tensor,
                   mask: torch.Tensor, eps: float = 1.0) -> torch.Tensor:
    """Masked Charbonnier distance in raw gray levels [0, 255]: the
    reference's loss weights (rigid motion 0.3, border 0.5 of per-pixel
    flow magnitude) balance only against a gray-level photometric term
    (stitchax/train/losses.py:32-46)."""
    diff = img1 - warped2
    err = torch.sqrt(diff * diff + eps * eps)
    return (err * mask).sum() / (torch.clamp(mask.sum(), min=1.0)
                                 * img1.shape[-1])


def border_zero_flow_loss(flow: torch.Tensor, border_px: int) -> torch.Tensor:
    """Mean |flow| (x + y) over a border ring of `border_px` pixels."""
    B, H, W, _ = flow.shape
    b = border_px
    m = torch.zeros((H, W), device=flow.device, dtype=flow.dtype)
    m[:b], m[-b:], m[:, :b], m[:, -b:] = 1, 1, 1, 1
    mag = flow.abs().sum(-1)
    return (mag * m).sum() / torch.clamp(m.sum() * B, min=1.0)


def rigid_motion_loss(flow: torch.Tensor) -> torch.Tensor:
    """Mean residual-flow magnitude, so the homography explains as much of
    the motion as it can."""
    return torch.sqrt((flow * flow).sum(-1) + 1e-6).mean()


def smoothness_loss(flow: torch.Tensor) -> torch.Tensor:
    """First-order flow smoothness."""
    dx = (flow[:, :, 1:] - flow[:, :, :-1]).abs().mean()
    dy = (flow[:, 1:] - flow[:, :-1]).abs().mean()
    return dx + dy


def _global_photometric(sums: torch.Tensor, counts: torch.Tensor,
                        channels: int, world) -> List[torch.Tensor]:
    """Each prediction's photometric term over the global batch, from this
    rank's masked error sums and mask counts (n,) and every rank's:
    value S / (max(C, 1) ch) with S, C summed over the ranks (one
    collective), and a gradient that, averaged over the ranks, is the
    global term's: R (S_r' - (S / C) C_r') / (C ch) on rank r, C_r' where
    the clamp lets it through. Averaging each rank's own S_r / C_r would
    weight the ranks' pairs by 1 / C_r instead."""
    tot = all_sum(torch.stack([sums, counts]).detach(), world)
    S, C = tot[0], tot[1]
    Cc = torch.clamp(C, min=1.0)
    value = S / (Cc * channels)
    ds = sums - sums.detach()
    dc = (counts - counts.detach()) * (C >= 1.0).to(counts.dtype)
    terms = value + world.size * (ds - (S / Cc) * dc) / (Cc * channels)
    return list(terms.unbind(0))


def sequence_alignment_loss(img1: torch.Tensor, output_H: torch.Tensor,
                            flow_predictions: List[torch.Tensor],
                            occlusion_mask: Optional[torch.Tensor],
                            cfg: LossConfig, world=None
                            ) -> Dict[str, torch.Tensor]:
    """img1 (B, H, W, 3); output_H (B, H, W, 6), the H-warped img2 and its
    warped ones; flow_predictions, the decoder's per-iteration flows. A
    prediction's pixels with |flow| >= max_flow, outside the coverage or
    occluded do not count. Returns total, photometric (the last
    prediction's), rigid and border.

    With a `world` of ranks (parallel.World), the batch is this rank's
    block of the global batch: the photometric terms normalize by the mask
    counts of the global batch (`_global_photometric`), and the rigid and
    border means are this block's, which averaging over equal blocks makes
    global."""
    n = len(flow_predictions)
    total = torch.zeros((), device=img1.device, dtype=img1.dtype)
    photos, sums, counts = [], [], []
    for flow in flow_predictions:
        mag = torch.sqrt((flow * flow).sum(-1, keepdim=True))
        valid_flow = (mag < cfg.max_flow).to(img1.dtype)
        warped = flow_warp_b(output_H, flow)
        w2, wmask = warped[..., 0:3], warped[..., 3:6].mean(-1, keepdim=True)
        m = wmask * valid_flow
        if occlusion_mask is not None:
            m = m * occlusion_mask
        if world is None or world.backend is None:
            photos.append(photometric_l1(img1, w2, m, cfg.charbonnier_eps))
        else:
            diff = img1 - w2
            err = torch.sqrt(diff * diff + cfg.charbonnier_eps ** 2)
            sums.append((err * m).sum())
            counts.append(m.sum())
    if sums:
        photos = _global_photometric(torch.stack(sums), torch.stack(counts),
                                     img1.shape[-1], world)
    for i, photo in enumerate(photos):
        total = total + cfg.gamma ** (n - 1 - i) * photo
    final_flow = flow_predictions[-1]
    rigid = rigid_motion_loss(final_flow)
    border = border_zero_flow_loss(final_flow, cfg.border_px)
    total = (total + cfg.rigid_motion_weight * rigid
             + cfg.border_weight * border)
    return dict(total=total, photometric=photo, rigid=rigid, border=border)
