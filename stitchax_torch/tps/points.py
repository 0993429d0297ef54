"""Border control-point sampling (port of stitchax/tps/points.py).

The border layout comes from the static image size (numpy, host); the
per-segment argmax runs on the device as one gather over all segment
windows, padded to the largest window with -inf so that each argmax still
returns the first maximum in the window's row-major order.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops.filters import SOBEL_X, SOBEL_Y, conv2d_same


def gradient_magnitude_l1(image: torch.Tensor) -> torch.Tensor:
    """|sobel_x| + |sobel_y|, channel-meaned: (H, W, C) -> (H, W)."""
    planes = image.permute(2, 0, 1)
    gx = conv2d_same(planes, SOBEL_X).abs().mean(0)
    gy = conv2d_same(planes, SOBEL_Y).abs().mean(0)
    return gx + gy


def border_segments(H: int, W: int, step: int, pad: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Anchors at range(pad, dim - pad, step) along each border inset by
    `pad`, and the segments between consecutive anchors of one border:
    (anchors (A, 2) xy, segments (S, 4) [x1, y1, x2, y2])."""
    anchors: List[Tuple[int, int]] = []
    segments: List[Tuple[int, int, int, int]] = []

    def run(coords: Sequence[int], fixed: int, horizontal: bool):
        prev = None
        for i in coords:
            pt = (i, fixed) if horizontal else (fixed, i)
            anchors.append(pt)
            if prev is not None:
                a = (prev, fixed) if horizontal else (fixed, prev)
                segments.append((a[0], a[1], pt[0], pt[1]))
            prev = i

    xs = list(range(pad, W - pad, step))
    ys = list(range(pad, H - pad, step))
    run(xs, pad, True)
    run(xs, H - 1 - pad, True)
    run(ys, pad, False)
    run(ys, W - 1 - pad, False)
    return (np.unique(np.array(anchors, np.int64), axis=0)
            if anchors else np.zeros((0, 2), np.int64),
            np.array(segments, np.int64).reshape(-1, 4))


def _segment_windows(H: int, W: int, segs: np.ndarray):
    """Flat indices (S, L) of each segment's window [y1-2:y2+2, x1-2:x2+2]
    (clamped to the image), padded with -1, plus window widths/origins."""
    wins = []
    for x1, y1, x2, y2 in segs:
        ya, yb = max(int(y1) - 2, 0), min(int(y2) + 2, H)
        xa, xb = max(int(x1) - 2, 0), min(int(x2) + 2, W)
        wins.append((ya, yb, xa, xb))
    L = max((yb - ya) * (xb - xa) for ya, yb, xa, xb in wins)
    idx = np.full((len(wins), L), -1, np.int64)
    for s, (ya, yb, xa, xb) in enumerate(wins):
        yy, xx = np.mgrid[ya:yb, xa:xb]
        flat = (yy * W + xx).reshape(-1)
        idx[s, :flat.size] = flat
    return idx


def sample_border_points(grad: torch.Tensor, step: int, pad: int
                         ) -> torch.Tensor:
    """Max-gradient point per border segment: (H, W) grad -> (S, 2) xy."""
    H, W = grad.shape
    _, segs = border_segments(H, W, step, pad)
    if segs.shape[0] == 0:
        return torch.zeros((0, 2), dtype=torch.long, device=grad.device)
    idx = torch.from_numpy(_segment_windows(H, W, segs)).to(grad.device)
    vals = grad.reshape(-1)[idx.clamp(min=0)]
    vals = vals.masked_fill(idx < 0, float("-inf"))
    best = idx.gather(1, vals.argmax(1, keepdim=True))[:, 0]
    return torch.stack([best % W, best // W], -1)


def multi_level_pads(H: int, W: int, step: int, base_pad: int) -> List[int]:
    """base pad, then step, 2*step, ... while <= max(H, W)//4."""
    pads = [base_pad]
    p = step
    while p <= max(H, W) // 4:
        pads.append(p)
        p *= 2
    return pads


def multi_level_border_points(image: torch.Tensor, grid_h: int, grid_w: int,
                              base_pad: int) -> torch.Tensor:
    """All border points across pad levels: (H, W, C) -> (N, 2) xy."""
    H, W, _ = image.shape
    step = max(H, W) // min(grid_h, grid_w)
    grad = gradient_magnitude_l1(image)
    levels = [sample_border_points(grad, step, p)
              for p in multi_level_pads(H, W, step, base_pad)]
    levels = [lv for lv in levels if lv.shape[0] > 0]
    if not levels:
        return torch.zeros((0, 2), dtype=torch.long, device=image.device)
    return torch.cat(levels, 0)


def point_pairs(points: torch.Tensor, flow: torch.Tensor,
                flow_limit: float = -1.0):
    """src, src + flow[src], and |flow| < limit validity (limit -1 means
    ((H + W)//2)//8)."""
    H, W, _ = flow.shape
    if flow_limit == -1:
        flow_limit = ((H + W) // 2) // 8
    x = points[:, 0].clamp(0, W - 1)
    y = points[:, 1].clamp(0, H - 1)
    f = flow[y, x]
    valid = (f[:, 0].abs() < flow_limit) & (f[:, 1].abs() < flow_limit)
    src = points.to(flow.dtype)
    return src, src + f, valid


def shift_points(points: torch.Tensor, width_min: torch.Tensor,
                 height_min: torch.Tensor) -> torch.Tensor:
    """Image-frame points into canvas coordinates."""
    return points + torch.stack([width_min.abs(), height_min.abs()]).to(points)


def boundary_validity(points_src, points_dst, out_h: int, out_w: int):
    def inside(p):
        return ((p[:, 0] >= 0) & (p[:, 0] < out_w)
                & (p[:, 1] >= 0) & (p[:, 1] < out_h))
    return inside(points_src) & inside(points_dst)


def mask_lookup_validity(points: torch.Tensor, mask: torch.Tensor):
    """Keep points where mask[y, x] == 1. mask (H, W)."""
    H, W = mask.shape
    x = points[:, 0].long().clamp(0, W - 1)
    y = points[:, 1].long().clamp(0, H - 1)
    return mask[y, x] == 1
