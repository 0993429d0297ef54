"""PSNR and SSIM with skimage's semantics (port of the numpy reference in
stitchax/metrics.py).

uint8 inputs, data_range 255; SSIM with a uniform 7x7 window, K1 = 0.01,
K2 = 0.03, unbiased covariance, symmetric padding, the border cropped,
the mean over channels. Everything in float64.
"""

from __future__ import annotations

import numpy as np


def _uniform_filter(x: np.ndarray, win: int) -> np.ndarray:
    """Box filter with symmetric padding (scipy's 'reflect'), by summed
    area tables."""
    r = win // 2
    p = np.pad(x, ((r, r), (r, r)), mode="symmetric")
    c = np.cumsum(np.cumsum(p, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    H, W = x.shape
    s = (c[win:win + H, win:win + W] - c[:H, win:win + W]
         - c[win:win + H, :W] + c[:H, :W])
    return s / (win * win)


def _ssim_channel(a: np.ndarray, b: np.ndarray, win: int,
                  data_range: float) -> float:
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    NP = win * win
    cov_norm = NP / (NP - 1)
    ux = _uniform_filter(a, win)
    uy = _uniform_filter(b, win)
    uxx = _uniform_filter(a * a, win)
    uyy = _uniform_filter(b * b, win)
    uxy = _uniform_filter(a * b, win)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / (
        (ux ** 2 + uy ** 2 + C1) * (vx + vy + C2))
    pad = (win - 1) // 2
    return float(S[pad:-pad, pad:-pad].mean())


def psnr(img1: np.ndarray, img2: np.ndarray,
         data_range: float = 255.0) -> float:
    mse = np.mean((img1.astype(np.float64) - img2.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10 * np.log10(data_range ** 2 / mse))


def ssim(img1: np.ndarray, img2: np.ndarray, win: int = 7,
         data_range: float = 255.0) -> float:
    if img1.ndim == 2:
        return _ssim_channel(img1, img2, win, data_range)
    return float(np.mean([
        _ssim_channel(img1[..., c], img2[..., c], win, data_range)
        for c in range(img1.shape[-1])]))


def psnr_batch(img1: np.ndarray, img2: np.ndarray,
               data_range: float = 255.0) -> np.ndarray:
    """uint8 (B, H, W, C) pair -> (B,) PSNR."""
    return np.array([psnr(a, b, data_range) for a, b in zip(img1, img2)],
                    np.float64)


def ssim_batch(img1: np.ndarray, img2: np.ndarray, win: int = 7,
               data_range: float = 255.0) -> np.ndarray:
    """uint8 (B, H, W, C) pair -> (B,) multichannel SSIM."""
    return np.array([ssim(a, b, win, data_range) for a, b in zip(img1, img2)],
                    np.float64)
