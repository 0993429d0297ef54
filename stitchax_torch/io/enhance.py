"""Pillow's ImageEnhance.Brightness, .Contrast and .Color on uint8 RGB
images, in numpy.

Each enhancer blends a degenerate image with the image
(`Image.blend(degenerate, image, factor)`, Pillow's ImagingBlend):
out = in1 + alpha (in2 - in1) in float32 (alpha the factor as a C float),
truncated to uint8 for 0 <= alpha <= 1 and clipped to [0, 255] first
otherwise. The degenerate images: black for Brightness; for Contrast a
flat gray at int(mean + 0.5), the mean of the image's "L" conversion
(ImageStat: the exact sum over the count); for Color the "L" conversion
back in RGB. RGB -> "L" is Pillow's integer luma,
(19595 R + 38470 G + 7471 B + 0x8000) >> 16.
"""

from __future__ import annotations

import numpy as np


def blend(im1: np.ndarray, im2: np.ndarray, alpha: float) -> np.ndarray:
    """Image.blend(im1, im2, alpha) of two uint8 images."""
    a = np.float32(alpha)
    t = (im1.astype(np.float32)
         + a * (im2.astype(np.float32) - im1.astype(np.float32)))
    if not 0.0 <= a <= 1.0:
        t = np.clip(t, 0.0, 255.0)
    return t.astype(np.uint8)


def to_gray(rgb: np.ndarray) -> np.ndarray:
    """Pillow's convert("L") of a uint8 RGB image."""
    c = rgb.astype(np.int64)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def brightness(rgb: np.ndarray, factor: float) -> np.ndarray:
    return blend(np.zeros_like(rgb), rgb, factor)


def contrast(rgb: np.ndarray, factor: float) -> np.ndarray:
    gray = to_gray(rgb)
    mean = int(int(gray.astype(np.int64).sum()) / gray.size + 0.5)
    return blend(np.full_like(rgb, mean), rgb, factor)


def color(rgb: np.ndarray, factor: float) -> np.ndarray:
    return blend(np.repeat(to_gray(rgb)[..., None], 3, -1), rgb, factor)
