"""PNG decoding in numpy (zlib from the standard library), as Pillow reads
a PNG.

`read(path)` equals `np.asarray(Image.open(path))` and `read_rgb(path)`
equals `np.asarray(Image.open(path).convert("RGB"))` for non-interlaced
PNGs of every color type:

- gray (0): 8 bits -> (H, W) uint8; 1, 2 and 4 bits scaled to 0..255 as
  Pillow's "L;1" (mode "1": bool), "L;2" and "L;4" unpackers do; 16 bits
  -> (H, W) uint16 ("I;16"), whose RGB conversion clips at 255;
- RGB (2) and RGBA (6): 8 bits as they are; 16 bits as Pillow keeps
  them, the high byte of each sample ("RGB;16B", "RGBA;16B");
- palette (3), 1-8 bits: the indices (mode "P"); RGB from the palette;
- gray + alpha (4): (H, W, 2); 16 bits as Pillow opens them, RGBA of
  the high bytes (the gray in R, G and B); RGB from the gray.

The scanline filters (None, Sub, Up, Average, Paeth) are undone row by row:
Sub and Up vectorised, Average and Paeth pixel by pixel over the row.
Transparency chunks change nothing here, as they change nothing in
these conversions.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG: no IEND chunk")


def _unfilter(raw: np.ndarray, rows: int, stride: int, bpp: int
              ) -> np.ndarray:
    """The filtered scanlines (rows x (1 + stride) bytes) -> (rows, stride)
    uint8; `bpp` the bytes per pixel (at least 1)."""
    raw = raw.reshape(rows, stride + 1)
    out = np.zeros((rows, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(rows):
        kind, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:          # Sub: a running sum per byte of a pixel
            cur = np.cumsum(line.reshape(-1, bpp), 0).reshape(-1) & 0xFF
        elif kind == 2:          # Up
            cur = (line + prior) & 0xFF
        elif kind in (3, 4):     # Average, Paeth: left to right
            cur = line.copy()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prior[i]
                if kind == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                else:
                    c = prior[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                    cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"PNG: unknown filter type {kind}")
        out[y] = cur
        prior = cur
    return out


def decode(data: bytes):
    """(samples, color type, bit depth, palette): samples (H, W, channels)
    uint8 or uint16 (sub-byte depths unpacked to one sample a byte),
    palette (n, 3) uint8 or None."""
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError("PNG: interlaced files are not supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG: unknown color type {ctype}")
    ch = _CHANNELS[ctype]
    bits = depth * ch
    stride = (W * bits + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = _unfilter(raw[:H * (stride + 1)], H, stride, max(bits // 8, 1))
    if depth == 16:
        samples = rows.view(">u2").astype(np.uint16).reshape(H, W, ch)
    elif depth == 8:
        samples = rows.reshape(H, W, ch)
    else:                        # 1, 2 or 4 bits: one sample a byte
        bitsplit = np.unpackbits(rows, axis=1).reshape(H, -1, depth)
        weights = 1 << np.arange(depth - 1, -1, -1)
        samples = (bitsplit * weights).sum(-1)[:, :W].astype(np.uint8)
        samples = samples.reshape(H, W, 1)
    return samples, ctype, depth, palette


def _as_pillow_array(samples, ctype, depth):
    """np.asarray(Image.open(...)) of the decoded samples."""
    if ctype == 3:                               # "P": the indices
        return samples[..., 0]
    if depth == 16:
        if ctype == 0:                           # "I;16"
            return samples[..., 0]
        hi = (samples >> 8).astype(np.uint8)     # "RGB;16B", ...
        if ctype == 4:                           # "LA;16B" opens as RGBA
            return hi[..., [0, 0, 0, 1]]
        return hi
    if depth < 8:                                # gray "L;2", "L;4", "1"
        if depth == 1:
            return samples[..., 0] > 0
        return (samples[..., 0] * (255 // ((1 << depth) - 1))
                ).astype(np.uint8)
    return samples[..., 0] if ctype == 0 else samples


def read(path: str) -> np.ndarray:
    """np.asarray(Image.open(path)) of a PNG."""
    with open(path, "rb") as f:
        samples, ctype, depth, _ = decode(f.read())
    return _as_pillow_array(samples, ctype, depth)


def read_rgb(path: str) -> np.ndarray:
    """np.asarray(Image.open(path).convert("RGB")) of a PNG: (H, W, 3)
    uint8."""
    with open(path, "rb") as f:
        samples, ctype, depth, palette = decode(f.read())
    if ctype == 3:
        if palette is None:
            raise ValueError("PNG: palette image without a PLTE chunk")
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(palette)] = palette
        return pal[samples[..., 0]]
    a = _as_pillow_array(samples, ctype, depth)
    if ctype == 0:
        if depth == 16:                          # "I;16" -> "L" clips
            a = np.minimum(a, 255).astype(np.uint8)
        elif depth == 1:
            a = a.astype(np.uint8) * 255
        return np.repeat(a[..., None], 3, -1)
    if ctype == 4:                               # "LA": the gray
        return np.repeat(a[..., :1], 3, -1)
    return np.ascontiguousarray(a[..., :3])
