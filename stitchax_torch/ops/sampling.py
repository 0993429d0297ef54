"""Bilinear samplers, resize and the homography warp (NHWC, xy-last).

Port of stitchax/ops/sampling.py with its two bilinear semantics:

  * `grid_sample` -- torch `F.grid_sample(align_corners=True,
    padding_mode='zeros')` parity: each of the four taps is zeroed when
    its own index is out of bounds.
  * `homography_warp` -- the UDIS2 spatial transformer: pixel map
    x = (s+1)*W/2 and "interior" weights that keep a sample only when its
    floor lies in [0, n-2], so warped all-ones channels are coverage masks.

Both gather the 2x2 block at the clamped start index and fold the bounds
into the weights, as stitchax does; on the GPU the gather is a plain
`torch.gather` (the TPU's 4-tap packed row-take is not carried over).
"""

from __future__ import annotations

import numpy as np
import torch

from .grid import normalized_grid


def _axis_weights(i0f: torch.Tensor, frac: torch.Tensor, n: int,
                  rule: str = "zeros"):
    start = i0f.clamp(0.0, float(n - 2))
    s = i0f - start
    if rule == "interior":
        ok = (s == 0.0).to(frac.dtype)
        w0, w1 = (1.0 - frac) * ok, frac * ok
    else:
        w0 = (1.0 - frac) * (s == 0.0) + frac * (s == -1.0)
        w1 = frac * (s == 0.0) + (1.0 - frac) * (s == 1.0)
    return start.long(), w0, w1


def bilinear_gather_b(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      rule: str = "zeros") -> torch.Tensor:
    """Sample img (B, H, W, C) at pixel coords x/y (B, ...) -> (B, ..., C)."""
    B, H, W, C = img.shape
    shape = x.shape
    x = x.reshape(B, -1)
    y = y.reshape(B, -1)
    x0, y0 = torch.floor(x), torch.floor(y)
    sx, wx0, wx1 = _axis_weights(x0, x - x0, W, rule)
    sy, wy0, wy1 = _axis_weights(y0, y - y0, H, rule)
    flat = img.reshape(B, H * W, C)

    def tap(iy, ix):
        idx = (iy * W + ix)[..., None].expand(-1, -1, C)
        return torch.gather(flat, 1, idx)

    wy0, wy1 = wy0.to(img.dtype)[..., None], wy1.to(img.dtype)[..., None]
    wx0, wx1 = wx0.to(img.dtype)[..., None], wx1.to(img.dtype)[..., None]
    out = (wy0 * (tap(sy, sx) * wx0 + tap(sy, sx + 1) * wx1)
           + wy1 * (tap(sy + 1, sx) * wx0 + tap(sy + 1, sx + 1) * wx1))
    return out.reshape(*shape, C)


def grid_sample_b(img: torch.Tensor, grid: torch.Tensor,
                  align_corners: bool = True) -> torch.Tensor:
    """Bilinear, zeros-padded sample of img (B, H, W, C) at normalized
    grid (B, ..., 2) in [-1, 1]."""
    B, H, W, _ = img.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        x = (gx + 1.0) * (W - 1) / 2.0
        y = (gy + 1.0) * (H - 1) / 2.0
    else:
        x = ((gx + 1.0) * W - 1.0) / 2.0
        y = ((gy + 1.0) * H - 1.0) / 2.0
    return bilinear_gather_b(img, x, y)


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                align_corners: bool = True) -> torch.Tensor:
    """Unbatched grid_sample_b: img (H, W, C), grid (..., 2)."""
    return grid_sample_b(img[None], grid[None], align_corners)[0]


def bilinear_sampler_b(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample at pixel coords (B, ..., 2): normalize by (W-1, H-1), then
    grid_sample with align_corners=True, zeros padding."""
    B, H, W, _ = img.shape
    gx = 2.0 * coords[..., 0] / (W - 1) - 1.0
    gy = 2.0 * coords[..., 1] / (H - 1) - 1.0
    return grid_sample_b(img, torch.stack([gx, gy], -1))


def _resize_matrix(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """(n_out, n_in) bilinear interpolation matrix, F.interpolate rules."""
    if align_corners:
        src = (np.arange(n_out) * (n_in - 1) / max(n_out - 1, 1)
               if n_out > 1 else np.zeros(1))
    else:
        src = np.clip((np.arange(n_out) + 0.5) * n_in / n_out - 0.5,
                      0, n_in - 1)
    i0 = np.floor(src).astype(np.int64)
    f = src - i0
    i1 = np.minimum(i0 + 1, n_in - 1)
    M = np.zeros((n_out, n_in), np.float32)
    M[np.arange(n_out), i0] += 1.0 - f
    M[np.arange(n_out), i1] += f
    return M


def interpolate_bilinear_b(imgs: torch.Tensor, out_h: int, out_w: int,
                           align_corners: bool = True) -> torch.Tensor:
    """Resize (B, H, W, C) -> (B, out_h, out_w, C) by two separable
    interpolation matrices (the same weights stitchax uses)."""
    B, H, W, C = imgs.shape
    Ry = torch.from_numpy(_resize_matrix(H, out_h, align_corners)).to(imgs)
    Rx = torch.from_numpy(_resize_matrix(W, out_w, align_corners)).to(imgs)
    out = torch.einsum("oh,bhwc->bowc", Ry, imgs)
    return torch.einsum("pw,bowc->bopc", Rx, out)


def resize_image_b(imgs: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """torchvision Resize parity (bilinear, align_corners=False)."""
    return interpolate_bilinear_b(imgs, out_h, out_w, align_corners=False)


def homography_warp_b(imgs: torch.Tensor, thetas: torch.Tensor,
                      out_h: int, out_w: int) -> torch.Tensor:
    """Warp (B, H, W, C) by normalized-space (B, 3, 3) transforms into
    (B, out_h, out_w, C): project the [-1, 1] output grid through theta,
    divide (1e-6 nudge on near-zero denominators), map to pixels with
    (s+1)*size/2 and sample with interior weights."""
    B, H, W, _ = imgs.shape
    grid = normalized_grid(out_h, out_w, device=imgs.device, dtype=imgs.dtype)
    g = torch.cat([grid, torch.ones_like(grid[..., :1])], -1)
    T = torch.einsum("hwk,bjk->bhwj", g, thetas.to(imgs.dtype))
    x_s, y_s, t_s = T[..., 0], T[..., 1], T[..., 2]
    t_s = t_s + 1e-6 * (1.0 - (t_s.abs() >= 1e-7).to(imgs.dtype))
    x = (x_s / t_s + 1.0) * W / 2.0
    y = (y_s / t_s + 1.0) * H / 2.0
    return bilinear_gather_b(imgs, x, y, rule="interior")
