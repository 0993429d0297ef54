"""Pillow's `Image.resize(size, Image.BILINEAR)` on uint8 images, in numpy.

Bit-equal to Pillow's Resample.c: a triangle filter whose support widens by
the downscale factor (antialiasing), coefficients normalised in float64
and then held as fixed point with PRECISION_BITS = 22, rounded; a
horizontal pass, then a vertical one, each accumulating in integers from
a rounding offset and clipping to uint8. An equal size is a copy.
"""

from __future__ import annotations

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _coefficients(in_size: int, out_size: int):
    """precompute_coeffs + normalize_coeffs_8bpc for the bilinear filter:
    (out_size, ksize) source indices and fixed-point weights (zero past
    each output's window)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    x = np.arange(ksize)
    inside = x[None] < xmax[:, None]
    t = np.abs((x[None] + xmin[:, None] - center[:, None] + 0.5)
               * (1.0 / filterscale))
    w = np.where(inside & (t < 1.0), 1.0 - t, 0.0)
    ww = w[:, :1].copy()
    for j in range(1, ksize):          # summed in order, as Pillow does
        ww += w[:, j:j + 1]
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    fixed = np.trunc(0.5 + w * (1 << PRECISION_BITS)).astype(np.int64)
    idx = np.minimum(xmin[:, None] + x[None], in_size - 1)
    return idx, np.where(inside, fixed, 0)


def _clip8(acc: np.ndarray) -> np.ndarray:
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W[, C]) uint8 -> (height, width[, C]) uint8, as Pillow's
    BILINEAR resize."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_bilinear: uint8 input, got {img.dtype}")
    H, W = img.shape[:2]
    if (H, W) == (height, width):
        return img.copy()
    out = img.astype(np.int64)
    half = 1 << (PRECISION_BITS - 1)
    if width != W:
        idx, k = _coefficients(W, width)
        kk = k.reshape((1,) + k.shape + (1,) * (img.ndim - 2))
        out = _clip8(half + (out[:, idx] * kk).sum(2)).astype(np.int64)
    if height != H:
        idx, k = _coefficients(H, height)
        kk = k.reshape(k.shape + (1,) * (img.ndim - 1))
        out = _clip8(half + (out[idx] * kk).sum(1)).astype(np.int64)
    return out.astype(np.uint8)
