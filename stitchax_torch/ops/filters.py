"""Sobel gradients and grayscale (port of stitchax/ops/filters.py)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

SOBEL_X = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]],
                   np.float32)
SOBEL_Y = np.array([[-1.0, -2.0, -1.0], [0.0, 0.0, 0.0], [1.0, 2.0, 1.0]],
                   np.float32)


def conv2d_same(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """(N, H, W) planes correlated with a 3x3 kernel, zero padding."""
    k = torch.from_numpy(kernel).to(img)[None, None]
    return F.conv2d(img[:, None], k, padding=1)[:, 0]


def sobel_magnitude(gray: torch.Tensor) -> torch.Tensor:
    """Gradient magnitude of a (H, W) grayscale image."""
    gx = conv2d_same(gray[None], SOBEL_X)[0]
    gy = conv2d_same(gray[None], SOBEL_Y)[0]
    return torch.sqrt(gx * gx + gy * gy)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) RGB -> (H, W) luminance (ITU-R BT.601)."""
    w = torch.tensor([0.299, 0.587, 0.114], device=img.device, dtype=img.dtype)
    return img @ w
