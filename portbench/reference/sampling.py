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

`image_resize` is `jax.image.resize` (what stitchax's TransRef inpainter
resizes with), which `F.interpolate` matches in neither mode: "bilinear"
is a triangle filter that widens by the scale when it downsamples
(antialiasing), "nearest" picks floor((i + 0.5) * in / out).
"""

from __future__ import annotations

import numpy as np
import torch

from .grid import normalized_grid


def _axis_weights(i0f: torch.Tensor, frac: torch.Tensor, n: int,
                  rule: str = "zeros"):
    start = i0f.clamp(0.0, float(n - 2))
    s = i0f - start
    # weights are selected, not multiplied by the masks: jnp multiplies by
    # a boolean mask as a select (NaN * False is 0), so a NaN coordinate
    # samples zero in stitchax; for finite ones the two forms are equal
    pick = lambda cond, w: torch.where(cond, w, torch.zeros_like(w))
    if rule == "interior":
        w0, w1 = pick(s == 0.0, 1.0 - frac), pick(s == 0.0, frac)
    else:
        w0 = pick(s == 0.0, 1.0 - frac) + pick(s == -1.0, frac)
        w1 = pick(s == 0.0, frac) + pick(s == 1.0, 1.0 - frac)
    return start.nan_to_num(0.0).long(), w0, w1


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
    # stitchax's einsum (stitchax/ops/sampling.py:82), as XLA compiles it
    # on the CPU, eagerly and under jit alike: the weights wy*wx, rounded,
    # then a chain of fused multiply-adds over the taps in the order y0x0,
    # y1x0, y0x1, y1x1. torch fuses nothing across ops, so each FMA is
    # emulated: the product is exact in float64, the sum is rounded there
    # and then to the image dtype (a true FMA rounds once; the two can
    # differ only where the float64 sum lands on a tie of the narrow type)
    terms = ((wy0 * wx0, tap(sy, sx)), (wy1 * wx0, tap(sy + 1, sx)),
             (wy0 * wx1, tap(sy, sx + 1)), (wy1 * wx1, tap(sy + 1, sx + 1)))
    out = terms[0][0] * terms[0][1]
    for w, v in terms[1:]:
        out = (w.double() * v.double() + out.double()).to(img.dtype)
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


def _jax_linear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of jax.image.resize's "bilinear" along one
    axis (jax._src.image.scale.compute_weight_mat with the triangle kernel
    and antialias), computed in fp32 as jax computes them."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None])
    w = np.maximum(f32(0.0), f32(1.0) - x / kernel_scale)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).T.astype(f32)


def _jax_nearest_index(n_in: int, n_out: int) -> np.ndarray:
    f32 = np.float32
    src = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(n_in) / f32(n_out)
    return np.floor(src).astype(np.int64)


def image_resize(img: torch.Tensor, out_h: int, out_w: int,
                 method: str = "bilinear") -> torch.Tensor:
    """jax.image.resize of (H, W, C) to (out_h, out_w, C); method
    "bilinear" (antialiased when downsampling) or "nearest". An axis
    whose size does not change is left as it is, as in jax."""
    H, W, _ = img.shape
    if method == "nearest":
        if out_h != H:
            img = img[torch.from_numpy(_jax_nearest_index(H, out_h))
                      .to(img.device)]
        if out_w != W:
            img = img[:, torch.from_numpy(_jax_nearest_index(W, out_w))
                      .to(img.device)]
        return img
    if method != "bilinear":
        raise ValueError(f"image_resize: unsupported method {method!r}")
    if out_h != H:
        Ry = torch.from_numpy(_jax_linear_matrix(H, out_h)).to(img)
        img = torch.einsum("oh,hwc->owc", Ry, img)
    if out_w != W:
        Rx = torch.from_numpy(_jax_linear_matrix(W, out_w)).to(img)
        img = torch.einsum("pw,owc->opc", Rx, img)
    return img
