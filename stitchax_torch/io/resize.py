"""Pillow's `Image.resize(size, Image.BILINEAR)` in numpy, on uint8 images
and on float32 ones (Pillow's mode "F").

Bit-equal to Pillow's Resample.c: a triangle filter whose support widens by
the downscale factor (antialiasing), coefficients normalised in float64; a
horizontal pass, then a vertical one. For uint8 the coefficients are held
as fixed point with PRECISION_BITS = 22, rounded, and each pass accumulates
in integers from a rounding offset and clips to uint8. For float32 each
pass accumulates in float64, tap by tap in order, with the float64
coefficients, and rounds its output to float32. An equal size is a copy.
"""

from __future__ import annotations

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _weights(in_size: int, out_size: int):
    """precompute_coeffs for the bilinear filter: (out_size, ksize) source
    indices, float64 weights normalised per output (zero past each
    output's window), and the window mask."""
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
    idx = np.minimum(xmin[:, None] + x[None], in_size - 1)
    return idx, w, inside


def _coefficients(in_size: int, out_size: int):
    """_weights + normalize_coeffs_8bpc: the indices and fixed-point
    weights."""
    idx, w, inside = _weights(in_size, out_size)
    fixed = np.trunc(0.5 + w * (1 << PRECISION_BITS)).astype(np.int64)
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


def _float_pass(img: np.ndarray, in_size: int, out_size: int,
                axis: int) -> np.ndarray:
    """One pass of ImagingResample{Horizontal,Vertical}_32bpc along `axis`:
    ss = sum over the window of pixel * k (float64, in order), stored as
    float32."""
    idx, w, inside = _weights(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.float64)
    ss = np.zeros((out_size,) + src.shape[1:], np.float64)
    shape = (out_size,) + (1,) * (src.ndim - 1)
    for j in range(idx.shape[1]):
        # taps past an output's window are skipped, as the C loop stops
        tap = src[idx[:, j]] * w[:, j].reshape(shape)
        ss = np.where(inside[:, j].reshape(shape), ss + tap, ss)
    return np.moveaxis(ss.astype(np.float32), 0, axis)


def resize_bilinear_float(img: np.ndarray, height: int,
                          width: int) -> np.ndarray:
    """(H, W) float32 -> (height, width) float32, as Pillow's BILINEAR
    resize of a mode "F" image."""
    img = np.asarray(img)
    if img.dtype != np.float32 or img.ndim != 2:
        raise ValueError(f"resize_bilinear_float: (H, W) float32 input, got "
                         f"{img.dtype} {img.shape}")
    H, W = img.shape
    if (H, W) == (height, width):
        return img.copy()
    out = img
    if width != W:
        out = _float_pass(out, W, width, 1)
    if height != H:
        out = _float_pass(out, H, height, 0)
    return out
