"""Binary PPM / PGM and uncompressed BMP readers, and `read_rgb`, which
opens any image the flow datasets list (PNG, JPEG, PPM, BMP) as
`np.asarray(Image.open(path).convert("RGB"))` does, choosing the codec by
the file's first bytes as Pillow does.

PPM (P6) and PGM (P5) with a maxval of 255; BMP with a 40-byte or longer
info header, 24 or 32 bits a pixel, uncompressed (BI_RGB), rows bottom-up
or top-down (a negative height). Other variants raise.
"""

from __future__ import annotations

import struct

import numpy as np

from . import jpeg, png


def _netpbm_tokens(data: bytes, n: int):
    """The first n whitespace-separated header tokens (comments skipped)
    and the offset just past the single whitespace after the last."""
    tokens, pos = [], 2
    while len(tokens) < n:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while data[pos:pos + 1] not in (b"\n", b"\r", b""):
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        tokens.append(int(data[start:pos]))
    return tokens, pos + 1


def decode_netpbm(data: bytes) -> np.ndarray:
    """P6 -> (H, W, 3) uint8, P5 -> (H, W) uint8."""
    magic = data[:2]
    if magic not in (b"P5", b"P6"):
        raise ValueError(f"netpbm: {magic!r} is not a binary PGM / PPM")
    (w, h, maxval), pos = _netpbm_tokens(data, 3)
    if maxval != 255:
        raise ValueError(f"netpbm: maxval {maxval} (255 only)")
    ch = 3 if magic == b"P6" else 1
    a = np.frombuffer(data, np.uint8, h * w * ch, pos)
    return a.reshape(h, w, 3) if ch == 3 else a.reshape(h, w)


def decode_bmp(data: bytes) -> np.ndarray:
    """An uncompressed 24- or 32-bit BMP -> (H, W, 3) uint8 RGB."""
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    offset = struct.unpack("<I", data[10:14])[0]
    size = struct.unpack("<I", data[14:18])[0]
    if size < 40:
        raise ValueError("BMP: core headers are not supported")
    w, h, _, bpp, comp = struct.unpack("<iiHHI", data[18:34])
    if comp != 0 or bpp not in (24, 32):
        raise ValueError(f"BMP: {bpp}-bit, compression {comp} is not "
                         "supported")
    bpp_bytes = bpp // 8
    stride = (w * bpp_bytes + 3) & ~3
    rows = np.frombuffer(data, np.uint8, abs(h) * stride, offset)
    px = rows.reshape(abs(h), stride)[:, :w * bpp_bytes]
    px = px.reshape(abs(h), w, bpp_bytes)[..., 2::-1]   # BGR(x) -> RGB
    return np.ascontiguousarray(px[::-1] if h > 0 else px)


def read_rgb(path: str) -> np.ndarray:
    """np.asarray(Image.open(path).convert("RGB")): (H, W, 3) uint8."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head.startswith(png.SIGNATURE):
        return png.read_rgb(path)
    if head.startswith(b"\xff\xd8"):
        return jpeg.read_rgb(path)
    with open(path, "rb") as f:
        data = f.read()
    if head[:2] in (b"P5", b"P6"):
        a = decode_netpbm(data)
        return a if a.ndim == 3 else np.repeat(a[..., None], 3, -1)
    if head[:2] == b"BM":
        return decode_bmp(data)
    raise ValueError(f"{path}: not a PNG, JPEG, PPM or BMP image")
