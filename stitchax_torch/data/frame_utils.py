"""Optical-flow file IO: Middlebury .flo, PFM, 16-bit KITTI png (port of
stitchax/data/frame_utils.py).

numpy alone: images go through the port's own decoders (`io.png`, the
JPEG codec, `io.raster`'s PPM and BMP readers), which read what Pillow
reads, so `read_gen` and `read_kitti_png_flow` give stitchax's arrays.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

FLO_MAGIC = 202021.25


def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo -> (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = np.frombuffer(f.read(4), np.float32)[0]
        if magic != FLO_MAGIC:
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        data = np.frombuffer(f.read(4 * 2 * w * h), np.float32)
    return data.reshape(h, w, 2).copy()


def write_flo(path: str, flow: np.ndarray):
    h, w, c = flow.shape
    assert c == 2
    with open(path, "wb") as f:
        np.array([FLO_MAGIC], np.float32).tofile(f)
        np.array([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_pfm(path: str) -> np.ndarray:
    """PFM -> (H, W) or (H, W, 3) float32 (bottom-up storage handled)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        color = header == b"PF"
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM file")
        dims = f.readline()
        while dims.startswith(b"#"):
            dims = f.readline()
        m = re.match(rb"^(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: malformed PFM header")
        w, h = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape)).copy()


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0):
    image = np.flipud(image.astype(np.float32))
    color = image.ndim == 3 and image.shape[2] == 3
    if not (image.ndim == 2 or color):
        raise ValueError("PFM needs (H, W) or (H, W, 3)")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        image.tofile(f)


def read_kitti_png_flow(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI 16-bit png flow -> (flow (H, W, 2), valid (H, W)), from the
    array Pillow opens (stitchax reads it through `np.asarray(Image.open)`,
    which keeps the high byte of each 16-bit RGB sample)."""
    from ..io import png
    img = png.read(path).astype(np.float32)
    flow = (img[..., :2] - 2 ** 15) / 64.0
    valid = img[..., 2] > 0
    return flow, valid


def read_gen(path: str) -> np.ndarray:
    """Extension dispatch (reference: frame_utils.py:123-136)."""
    ext = path.rsplit(".", 1)[-1].lower()
    if ext in ("png", "jpeg", "ppm", "jpg", "bmp"):
        from ..io import raster
        return raster.read_rgb(path)
    if ext == "flo":
        return read_flo(path)
    if ext == "pfm":
        f = read_pfm(path)
        return f[..., :2] if f.ndim == 3 else f
    raise ValueError(f"unsupported extension: {path}")
