"""Baseline JPEG in numpy, bit-equal to Pillow (libjpeg-turbo).

The port reads and writes every image through this module, on machines
that have no Pillow and no image decoder. It follows libjpeg-turbo's
integer paths step for step, so a decoded image equals
`np.asarray(Image.open(path))` and an encoded file equals what
`Image.fromarray(a).save(path)` writes for a `.jpg`:

- decoder: baseline Huffman (SOF0/SOF1), one interleaved scan, 1 or 3
  components, sampling 4:2:0 (2x2,1x1,1x1) or 4:4:4, restart markers;
  the `islow` integer IDCT (jidctint.c), h2v2 "fancy" triangular
  upsampling (jdsample.c) and the integer YCbCr->RGB tables (jdcolor.c);
- encoder: quality 75 by default, 4:2:0 YCbCr for (H, W, 3) and one
  component for (H, W), the Annex K tables scaled by
  `jpeg_quality_scaling` (baseline-clamped), the integer RGB->YCbCr tables
  (jccolor.c), `h2v2_downsample` with its alternating 1/2 bias
  (jcsample.c), libjpeg's edge replication and dummy edge blocks
  (jcprepct.c, jccoefct.c), the `islow` forward DCT (jfdctint.c), rounding
  quantization, the standard Huffman tables and a JFIF 1.01 header.

The entropy decoder is a Python loop over coefficients with 16-bit lookup
tables (one lookup gives a code and its magnitude bits where they fit in
16 bits); every other stage runs vectorised over all blocks.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np

# natural (row-major) index of the k-th coefficient in zigzag order
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int64)

# Annex K as libjpeg ships it: the luminance and chrominance quantization
# tables in zigzag order (they are the quality-50 tables), and the DHT
# payloads (16 code counts, then the symbols) of jstdhuff.c
STD_QUANT = (
    bytes.fromhex(
        "100b0c0e0c0a100e0d0e1211101318281a181616183123251d283a333d3c3933"
        "383740485c4e404457453738506d51575f626768673e4d71797064785c656763"),
    bytes.fromhex("1112121815182f1a1a2f6342384263" + "63" * 49),
)
STD_HUFF = {
    ("dc", 0): bytes.fromhex(
        "00010501010101010100000000000000000102030405060708090a0b"),
    ("ac", 0): bytes.fromhex(
        "0002010303020403050504040000017d01020300041105122131410613516107"
        "227114328191a1082342b1c11552d1f02433627282090a161718191a25262728"
        "292a3435363738393a434445464748494a535455565758595a63646566676869"
        "6a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7"
        "a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2"
        "e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    ("dc", 1): bytes.fromhex(
        "00030101010101010101010000000000000102030405060708090a0b"),
    ("ac", 1): bytes.fromhex(
        "0002010204040304070504040001027700010203110405213106124151076171"
        "1322328108144291a1b1c109233352f0156272d10a162434e125f11718191a26"
        "2728292a35363738393a434445464748494a535455565758595a636465666768"
        "696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5"
        "a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da"
        "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"),
}

# islow DCT constants (CONST_BITS = 13) and pass-1 scaling (PASS1_BITS = 2)
CONST_BITS, PASS1_BITS = 13, 2
F0298, F0390, F0541, F0765 = 2446, 3196, 4433, 6270
F0899, F1175, F1501, F1847 = 7373, 9633, 12299, 15137
F1961, F2053, F2562, F3072 = 16069, 16819, 20995, 25172


def _fix16(x: float) -> int:
    """libjpeg's FIX() at SCALEBITS = 16."""
    return int(x * 65536 + 0.5)


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


# ------------------------------- parsing -------------------------------------

class _Frame:
    def __init__(self):
        self.quant: Dict[int, np.ndarray] = {}      # natural order, int64
        self.huff: Dict[Tuple[str, int], bytes] = {}
        self.restart = 0
        self.height = self.width = 0
        self.comps: List[Tuple[int, int, int, int]] = []  # id, h, v, tq
        self.scan: List[Tuple[int, int, int]] = []        # comp idx, td, ta
        self.scan_start = 0


def _parse(data: bytes) -> _Frame:
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    f = _Frame()
    i, n = 2, len(data)
    while i < n:
        if data[i] != 0xFF:
            raise ValueError(f"JPEG: expected a marker at byte {i}")
        while i < n and data[i] == 0xFF:          # fill bytes
            i += 1
        m = data[i]
        i += 1
        if m == 0xD9:
            break
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        length = int.from_bytes(data[i:i + 2], "big")
        seg = data[i + 2:i + length]
        i += length
        if m == 0xDB:
            while seg:
                pq, tq = seg[0] >> 4, seg[0] & 15
                nb = 64 * (pq + 1)
                vals = np.frombuffer(seg[1:1 + nb], ">u2" if pq else "u1")
                q = np.empty(64, np.int64)
                q[ZIGZAG] = vals
                f.quant[tq] = q
                seg = seg[1 + nb:]
        elif m == 0xC4:
            while seg:
                tc, th = seg[0] >> 4, seg[0] & 15
                count = sum(seg[1:17])
                f.huff[("ac" if tc else "dc", th)] = bytes(seg[1:17 + count])
                seg = seg[17 + count:]
        elif m == 0xDD:
            f.restart = int.from_bytes(seg[:2], "big")
        elif m in (0xC0, 0xC1):
            if seg[0] != 8:
                raise NotImplementedError("JPEG: only 8-bit samples")
            f.height = int.from_bytes(seg[1:3], "big")
            f.width = int.from_bytes(seg[3:5], "big")
            f.comps = [(seg[6 + 3 * c], seg[7 + 3 * c] >> 4,
                        seg[7 + 3 * c] & 15, seg[8 + 3 * c])
                       for c in range(seg[5])]
        elif 0xC2 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            raise NotImplementedError(
                f"JPEG: SOF{m - 0xC0} (progressive, lossless or arithmetic) "
                "is not supported; baseline only")
        elif m == 0xDA:
            ids = [c[0] for c in f.comps]
            ns = seg[0]
            f.scan = [(ids.index(seg[1 + 2 * j]), seg[2 + 2 * j] >> 4,
                       seg[2 + 2 * j] & 15) for j in range(ns)]
            f.scan_start = i
            return f
    raise ValueError("JPEG: no scan")


# ------------------------------- entropy decode ------------------------------

def _canonical_codes(spec: bytes):
    """(code, length, symbol) of a DHT payload, in canonical order."""
    counts, syms = spec[:16], spec[16:]
    out, code, k = [], 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out.append((code, length, syms[k]))
            code += 1
            k += 1
        code <<= 1
    return out


def _extend(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    """JPEG's EXTEND: s magnitude bits v -> the signed value."""
    return np.where(v < (1 << np.maximum(s - 1, 0)), v - (1 << s) + 1, v)


@functools.lru_cache(maxsize=32)
def _lookup(spec: bytes, ac: bool):
    """16-bit lookup tables of one Huffman table: for every 16-bit window,
    (bits taken, zero run, value) where the code and its magnitude bits fit
    in 16 bits (AC: EOB and ZRL have value 0; DC: run 0), else bits taken
    0; and (code length, symbol) for the long path."""
    total = np.zeros(1 << 16, np.int64)
    run = np.zeros(1 << 16, np.int64)
    val = np.zeros(1 << 16, np.int64)
    clen = np.zeros(1 << 16, np.int64)
    csym = np.zeros(1 << 16, np.int64)
    for code, length, sym in _canonical_codes(spec):
        lo, hi = code << (16 - length), (code + 1) << (16 - length)
        w = np.arange(lo, hi)
        clen[lo:hi] = length
        csym[lo:hi] = sym
        size = sym & 15 if ac else sym
        if length + size <= 16:
            bits = (w >> (16 - length - size)) & ((1 << size) - 1)
            total[lo:hi] = length + size
            run[lo:hi] = (sym >> 4) if ac else 0
            val[lo:hi] = _extend(bits, np.full_like(bits, size)) if size else 0
    fast = list(zip(total.tolist(), run.tolist(), val.tolist()))
    slow = list(zip(clen.tolist(), csym.tolist()))
    return fast, slow


def _scan_bytes(data: bytes, start: int):
    """The scan's entropy-coded bytes with stuffing removed, and the byte
    offset at which each restart interval starts."""
    buf = np.frombuffer(data, np.uint8)[start:]
    ff = np.flatnonzero(buf[:-1] == 0xFF)
    nxt = buf[ff + 1]
    is_rst = (nxt >= 0xD0) & (nxt <= 0xD7)
    ends = ff[(nxt != 0x00) & ~is_rst & (nxt != 0xFF)]
    end = int(ends[0]) if ends.size else buf.size
    keep = np.ones(end, bool)
    inside = ff < end
    stuffed = ff[inside & (nxt == 0x00)]
    keep[np.minimum(stuffed + 1, end - 1)] = False
    rst = ff[inside & is_rst]
    keep[rst] = False
    keep[np.minimum(rst + 1, end - 1)] = False
    before = np.concatenate([[0], np.cumsum(keep)])
    seg_starts = [0] + before[rst + 2].tolist()
    return buf[:end][keep], seg_starts


def _decode_coefficients(f: _Frame, data: bytes):
    """Huffman-decode the scan: one (n_blocks, 64) int64 array of
    coefficients in natural order, blocks in stream order."""
    comps = f.comps
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    if len(f.scan) != len(comps):
        raise NotImplementedError("JPEG: only one scan holding every "
                                  "component (baseline, interleaved)")
    if len(comps) == 1:
        h, v = comps[0][1], comps[0][2]
        bw = -(-(-(-f.width * h // hmax)) // 8)
        bh = -(-(-(-f.height * v // vmax)) // 8)
        n_mcu, layout = bw * bh, [0]
    else:
        n_mcu = -(-f.width // (8 * hmax)) * -(-f.height // (8 * vmax))
        layout = [ci for ci, _, _ in f.scan
                  for _ in range(comps[ci][1] * comps[ci][2])]
    tables = {ci: (_lookup(f.huff[("dc", td)], False),
                   _lookup(f.huff[("ac", ta)], True))
              for ci, td, ta in f.scan}
    mcu = [(ci, tables[ci][0][0], tables[ci][0][1], tables[ci][1][0],
            tables[ci][1][1]) for ci in layout]

    ent, seg_starts = _scan_bytes(data, f.scan_start)
    e = np.concatenate([ent.astype(np.int64), np.zeros(8, np.int64)])
    windows = ((e[:-3] << 24) | (e[1:-2] << 16) | (e[2:-1] << 8)
               | e[3:]).tolist()
    idx: List[int] = []
    vals: List[int] = []
    add_idx, add_val = idx.append, vals.append
    pred = [0] * len(comps)
    restart = f.restart
    pos, blk = 0, 0
    for m in range(n_mcu):
        if restart and m and m % restart == 0:
            pos = 8 * seg_starts[min(m // restart, len(seg_starts) - 1)]
            pred = [0] * len(comps)
        for ci, dc_fast, dc_slow, ac_fast, ac_slow in mcu:
            w = (windows[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF
            tot, _, diff = dc_fast[w]
            if tot:
                pos += tot
            else:
                length, size = dc_slow[w]
                if not length:
                    raise ValueError("JPEG: corrupt DC code")
                pos += length
                bits = ((windows[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF) \
                    >> (16 - size)
                pos += size
                diff = bits - (1 << size) + 1 if bits < (1 << (size - 1)) \
                    else bits
            pred[ci] += diff
            base = blk << 6
            add_idx(base)
            add_val(pred[ci])
            k = 1
            while k < 64:
                w = (windows[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF
                tot, run, v = ac_fast[w]
                if tot:
                    pos += tot
                    if not v:
                        if run != 15:
                            break                        # EOB
                        k += 16                          # ZRL
                        continue
                else:
                    length, sym = ac_slow[w]
                    if not length:
                        raise ValueError("JPEG: corrupt AC code")
                    pos += length
                    run, size = sym >> 4, sym & 15
                    if not size:
                        if run != 15:
                            break
                        k += 16
                        continue
                    bits = ((windows[pos >> 3] >> (16 - (pos & 7)))
                            & 0xFFFF) >> (16 - size)
                    pos += size
                    v = bits - (1 << size) + 1 if bits < (1 << (size - 1)) \
                        else bits
                k += run
                if k > 63:
                    raise ValueError("JPEG: coefficient index past 63")
                add_idx(base + k)
                add_val(v)
                k += 1
            blk += 1
    zz = np.zeros((blk, 64), np.int64)
    zz.reshape(-1)[np.asarray(idx, np.int64)] = vals
    nat = np.empty_like(zz)
    nat[:, ZIGZAG] = zz
    return nat, layout, n_mcu


# ------------------------------- IDCT ----------------------------------------

def _idct_1d(s):
    """The islow butterfly of jidctint.c on 8 arrays (before descaling)."""
    z2, z3 = s[2], s[6]
    z1 = (z2 + z3) * F0541
    tmp2 = z1 + z3 * -F1847
    tmp3 = z1 + z2 * F0765
    tmp0 = (s[0] + s[4]) << CONST_BITS
    tmp1 = (s[0] - s[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = s[7], s[5], s[3], s[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * F1175
    t0, t1, t2, t3 = t0 * F0298, t1 * F2053, t2 * F3072, t3 * F1501
    z1, z2 = z1 * -F0899, z2 * -F2562
    z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def _idct_range_table() -> np.ndarray:
    """libjpeg's post-IDCT range limit, indexed by (x & 1023)."""
    v = np.arange(1024)
    return np.clip(np.where(v < 512, v, v - 1024) + 128, 0, 255)


_IDCT_LIMIT = _idct_range_table()


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(N, 64) quantized coefficients (natural order) -> (N, 8, 8) samples,
    jpeg_idct_islow with libjpeg's range limiting."""
    x = (coef * quant).reshape(-1, 8, 8)
    cols = _idct_1d([x[:, k, :] for k in range(8)])          # pass 1
    ws = np.stack([_descale(c, CONST_BITS - PASS1_BITS) for c in cols], 1)
    rows = _idct_1d([ws[:, :, k] for k in range(8)])          # pass 2
    out = np.stack([_descale(r, CONST_BITS + PASS1_BITS + 3) for r in rows],
                   2)
    return _IDCT_LIMIT[out & 1023].astype(np.uint8)


# ------------------------------- decode --------------------------------------

def _fancy_h2v2(c: np.ndarray) -> np.ndarray:
    """h2v2_fancy_upsample: (h, w) -> (2h, 2w), triangular weights 9/16,
    3/16, 3/16, 1/16 with libjpeg's 8/7 rounding, edges replicated."""
    c = c.astype(np.int64)
    up = np.concatenate([c[:1], c[:-1]], 0)
    down = np.concatenate([c[1:], c[-1:]], 0)
    cs = np.empty((2 * c.shape[0], c.shape[1]), np.int64)
    cs[0::2] = 3 * c + up
    cs[1::2] = 3 * c + down
    left = np.concatenate([cs[:, :1], cs[:, :-1]], 1)
    right = np.concatenate([cs[:, 1:], cs[:, -1:]], 1)
    out = np.empty((cs.shape[0], 2 * cs.shape[1]), np.int64)
    out[:, 0::2] = (3 * cs + left + 8) >> 4
    out[:, 1::2] = (3 * cs + right + 7) >> 4
    return out


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert with its integer tables."""
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (_fix16(1.40200) * x + 32768) >> 16
    cb_b = (_fix16(1.77200) * x + 32768) >> 16
    cr_g = -_fix16(0.71414) * x
    cb_g = -_fix16(0.34414) * x + 32768
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """A baseline JPEG file's bytes -> (H, W, 3) uint8 RGB, or (H, W)
    uint8 for a one-component file, as Pillow decodes it."""
    f = _parse(data)
    comps = f.comps
    if len(comps) not in (1, 3):
        raise NotImplementedError(f"JPEG: {len(comps)} components")
    sampling = [(c[1], c[2]) for c in comps]
    if len(comps) == 3 and sampling not in ([(2, 2), (1, 1), (1, 1)],
                                            [(1, 1)] * 3):
        raise NotImplementedError(f"JPEG: sampling {sampling}; 4:2:0 and "
                                  "4:4:4 only")
    coef, layout, n_mcu = _decode_coefficients(f, data)
    H, W = f.height, f.width
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    if len(comps) == 1:
        bw = -(-W // 8)
        samples = idct_islow(coef, f.quant[comps[0][3]])
        plane = samples.reshape(-1, bw, 8, 8).transpose(0, 2, 1, 3)
        return plane.reshape(-1, bw * 8)[:H, :W]
    mcux = -(-W // (8 * hmax))
    per_mcu = len(layout)
    layout = np.asarray(layout)
    planes = []
    for ci, (_, h, v, tq) in enumerate(comps):
        sel = (np.arange(n_mcu)[:, None] * per_mcu
               + np.flatnonzero(layout == ci)[None]).reshape(-1)
        samples = idct_islow(coef[sel], f.quant[tq])
        # (mcu_y, mcu_x, v, h, 8, 8) -> plane
        mcuy = n_mcu // mcux
        s = samples.reshape(mcuy, mcux, v, h, 8, 8).transpose(0, 2, 4, 1, 3,
                                                              5)
        plane = s.reshape(mcuy * v * 8, mcux * h * 8)
        ch, cw = -(-H * v // vmax), -(-W * h // hmax)
        plane = plane[:ch, :cw]
        if (h, v) != (hmax, vmax):
            plane = (_fancy_h2v2(plane) if cw > 2
                     else plane.repeat(2, 0).repeat(2, 1))
        planes.append(plane[:H, :W])
    return _ycc_to_rgb(*planes)


def read(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        return decode(fh.read())


def read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8, as Pillow's `Image.open(path).convert("RGB")`:
    a one-component file's gray repeated in R, G and B."""
    img = read(path)
    return np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img


# ------------------------------- encode --------------------------------------

def _quality_tables(quality: int):
    """jpeg_set_quality(quality, force_baseline=TRUE): the Annex K tables
    scaled by jpeg_quality_scaling, in zigzag order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return [np.clip((np.frombuffer(t, np.uint8).astype(np.int64) * scale
                     + 50) // 100, 1, 255) for t in STD_QUANT]


def _rgb_to_ycc(rgb: np.ndarray):
    """jccolor.c's rgb_ycc_convert with its integer tables."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, center = 1 << 15, 128 << 16
    y = (_fix16(0.29900) * r + _fix16(0.58700) * g + _fix16(0.11400) * b
         + half) >> 16
    cb = (-_fix16(0.16874) * r - _fix16(0.33126) * g + _fix16(0.5) * b
          + center + half - 1) >> 16
    cr = (_fix16(0.5) * r - _fix16(0.41869) * g - _fix16(0.08131) * b
          + center + half - 1) >> 16
    return y, cb, cr


def _pad_edges(p: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Replicate the last row and column out to (rows, cols)."""
    return np.pad(p, ((0, rows - p.shape[0]), (0, cols - p.shape[1])),
                  mode="edge")


def _h2v2_downsample(c: np.ndarray, out_cols: int) -> np.ndarray:
    """jcsample.c's h2v2_downsample: the input's right edge replicated to
    2*out_cols and its rows to an even count, then 2x2 sums plus a bias
    of 1, 2, 1, 2, ... along each row, shifted by 2."""
    rows = c.shape[0] + (c.shape[0] & 1)
    c = _pad_edges(c, rows, 2 * out_cols)
    s = c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2]
    bias = np.where(np.arange(out_cols) % 2 == 0, 1, 2)
    return (s + bias) >> 2


def _fdct_1d(d, final: bool):
    """The islow butterfly of jfdctint.c on 8 arrays: pass 1 (rows) scales
    up by PASS1_BITS, pass 2 (columns, `final`) descales it."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    n = CONST_BITS + PASS1_BITS if final else CONST_BITS - PASS1_BITS
    out = [None] * 8
    if final:
        out[0] = _descale(tmp10 + tmp11, PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, PASS1_BITS)
    else:
        out[0] = (tmp10 + tmp11) << PASS1_BITS
        out[4] = (tmp10 - tmp11) << PASS1_BITS
    z1 = (tmp12 + tmp13) * F0541
    out[2] = _descale(z1 + tmp13 * F0765, n)
    out[6] = _descale(z1 + tmp12 * -F1847, n)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * F1175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * F0298, tmp5 * F2053, tmp6 * F3072, \
        tmp7 * F1501
    z1, z2 = z1 * -F0899, z2 * -F2562
    z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
    out[7] = _descale(tmp4 + z1 + z3, n)
    out[5] = _descale(tmp5 + z2 + z4, n)
    out[3] = _descale(tmp6 + z2 + z3, n)
    out[1] = _descale(tmp7 + z1 + z4, n)
    return out


def fdct_quantize(plane: np.ndarray, quant_zz: np.ndarray) -> np.ndarray:
    """(8*bh, 8*bw) samples -> (bh, bw, 64) quantized coefficients in
    zigzag order: jpeg_fdct_islow, then libjpeg's rounding division by
    8 * q (half away from zero)."""
    bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
    x = (plane.astype(np.int64) - 128).reshape(bh, 8, bw, 8)
    x = x.transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    rows = _fdct_1d([x[:, :, k] for k in range(8)], final=False)
    ws = np.stack(rows, 2)
    cols = _fdct_1d([ws[:, k, :] for k in range(8)], final=True)
    coef = np.stack(cols, 1).reshape(-1, 64)[:, ZIGZAG]
    div = quant_zz[None] << 3
    mag = (np.abs(coef) + (div >> 1)) // div
    return np.where(coef < 0, -mag, mag).reshape(bh, bw, 64)


def _huff_encoder(spec: bytes):
    """symbol -> (code, length) arrays of a DHT payload."""
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    for c, n, sym in _canonical_codes(spec):
        code[sym], length[sym] = c, n
    return code, length


def _bit_length(v: np.ndarray) -> np.ndarray:
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _entropy_encode(blocks: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Huffman-code blocks (N, 64) zigzag order, in stream order, each with
    its table index (0 luminance, 1 chrominance) in `table` and its DC
    already differenced. Returns the events as (value, nbits) arrays in
    stream order."""
    N = blocks.shape[0]
    dc_tabs = [_huff_encoder(STD_HUFF[("dc", t)]) for t in (0, 1)]
    ac_tabs = [_huff_encoder(STD_HUFF[("ac", t)]) for t in (0, 1)]

    def coded(sym, extra, size, tab, kind):
        tabs = dc_tabs if kind == "dc" else ac_tabs
        code = np.where(tab == 0, tabs[0][0][sym], tabs[1][0][sym])
        length = np.where(tab == 0, tabs[0][1][sym], tabs[1][1][sym])
        mask = (np.int64(1) << size) - 1
        bits = np.where(extra < 0, extra - 1, extra) & mask
        return (code << size) | bits, length + size

    keys, values, nbits = [], [], []
    # DC
    dc = blocks[:, 0]
    s = np.where(dc == 0, 0, _bit_length(dc))
    v, n = coded(s, dc, s, table, "dc")
    keys.append(np.arange(N) * 256)
    values.append(v)
    nbits.append(n)
    # AC: each nonzero coefficient, the ZRLs before it, and EOB
    ac = blocks[:, 1:]
    b, k = np.nonzero(ac)
    k = k + 1
    first = np.ones(b.size, bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    coef = ac[b, k - 1]
    size = _bit_length(coef)
    v, n = coded((run & 15) * 16 + size, coef, size, table[b], "ac")
    keys.append(b * 256 + 4 * k + 2)
    values.append(v)
    nbits.append(n)
    n_zrl = run >> 4
    zb = np.repeat(b, n_zrl)
    zk = np.repeat(k, n_zrl)
    v, n = coded(np.full(zb.size, 0xF0), np.zeros(zb.size, np.int64),
                 np.zeros(zb.size, np.int64), table[zb], "ac")
    keys.append(zb * 256 + 4 * zk + 1)
    values.append(v)
    nbits.append(n)
    last = np.zeros(N, np.int64)
    has = np.zeros(N, bool)
    if b.size:
        ends = np.flatnonzero(np.concatenate([b[1:] != b[:-1], [True]]))
        last[b[ends]] = k[ends]
        has[b[ends]] = True
    eob = np.flatnonzero(~has | (last < 63))
    v, n = coded(np.zeros(eob.size, np.int64), np.zeros(eob.size, np.int64),
                 np.zeros(eob.size, np.int64), table[eob], "ac")
    keys.append(eob * 256 + 255)
    values.append(v)
    nbits.append(n)
    order = np.argsort(np.concatenate(keys), kind="stable")
    return np.concatenate(values)[order], np.concatenate(nbits)[order]


def _pack_bits(values: np.ndarray, nbits: np.ndarray) -> bytes:
    """Concatenate the codes MSB first, pad the last byte with 1 bits and
    stuff a zero byte after every 0xFF."""
    total = int(nbits.sum())
    ev = np.repeat(np.arange(values.size), nbits)
    start = np.concatenate([[0], np.cumsum(nbits)[:-1]])
    shift = nbits[ev] - 1 - (np.arange(total) - start[ev])
    bits = ((values[ev] >> shift) & 1).astype(np.uint8)
    pad = -total % 8
    bits = np.concatenate([bits, np.ones(pad, np.uint8)])
    out = np.packbits(bits)
    ff = np.flatnonzero(out == 0xFF)
    return np.insert(out, ff + 1, 0).tobytes()


def _marker(code: int, payload: bytes) -> bytes:
    return bytes([0xFF, code]) + (len(payload) + 2).to_bytes(2, "big") + \
        payload


def encode(img: np.ndarray, quality: int = 75) -> bytes:
    """(H, W, 3) or (H, W) uint8 -> the bytes Pillow writes for
    `Image.fromarray(img).save(path)` as a `.jpg` (`quality` 75 is its
    default)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"encode: (H, W) or (H, W, 3) uint8, got "
                         f"{img.dtype} {img.shape}")
    H, W = img.shape[:2]
    if not (0 < H < 65536 and 0 < W < 65536):
        raise ValueError(f"encode: size {W}x{H} outside baseline JPEG")
    q_zz = _quality_tables(quality)
    bw, bh = -(-W // 8), -(-H // 8)
    if img.ndim == 2:
        plane = _pad_edges(img.astype(np.int64), bh * 8, bw * 8)
        blocks = fdct_quantize(plane, q_zz[0]).reshape(-1, 64)
        tables = np.zeros(blocks.shape[0], np.int64)
        comp_of = np.zeros(blocks.shape[0], np.int64)
        sof = b"\x01\x01\x11\x00"
        sos = b"\x01\x01\x00"
        n_tables = 1
    else:
        y, cb, cr = _rgb_to_ycc(img)
        mx, my = -(-W // 16), -(-H // 16)
        ycoef = np.zeros((2 * my, 2 * mx, 64), np.int64)
        ycoef[:bh, :bw] = fdct_quantize(_pad_edges(y, bh * 8, bw * 8),
                                        q_zz[0])
        # dummy blocks (jccoefct.c): zero AC, the DC of the block before
        # it in the MCU -- right of the image the one to its left, below it
        # the last block of the MCU's row above
        if bw % 2:
            ycoef[:bh, bw, 0] = ycoef[:bh, bw - 1, 0]
        if bh % 2:
            ycoef[bh, :, 0] = np.repeat(ycoef[bh - 1, 1::2, 0], 2)
        chroma = []
        for c in (cb, cr):
            d = _h2v2_downsample(c, mx * 8)
            chroma.append(fdct_quantize(_pad_edges(d, my * 8, mx * 8),
                                        q_zz[1]))
        yb = ycoef.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4)
        mcus = np.concatenate([yb.reshape(my, mx, 4, 64),
                               chroma[0][:, :, None], chroma[1][:, :, None]],
                              2)
        blocks = mcus.reshape(-1, 64)
        comp_of = np.tile(np.array([0, 0, 0, 0, 1, 2]), my * mx)
        tables = np.minimum(comp_of, 1)
        sof = b"\x03\x01\x22\x00\x02\x11\x01\x03\x11\x01"
        sos = b"\x03\x01\x00\x02\x11\x03\x11"
        n_tables = 2
    # DC differences per component, in stream order
    blocks = blocks.copy()
    for ci in np.unique(comp_of):
        sel = np.flatnonzero(comp_of == ci)
        dc = blocks[sel, 0]
        blocks[sel, 0] = dc - np.concatenate([[0], dc[:-1]])
    scan = _pack_bits(*_entropy_encode(blocks, tables))

    out = [b"\xff\xd8",
           _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t in range(n_tables):
        out.append(_marker(0xDB, bytes([t]) + q_zz[t].astype(np.uint8)
                           .tobytes()))
    out.append(_marker(0xC0, b"\x08" + H.to_bytes(2, "big")
                       + W.to_bytes(2, "big") + sof))
    for t in range(n_tables):
        out.append(_marker(0xC4, bytes([t]) + STD_HUFF[("dc", t)]))
        out.append(_marker(0xC4, bytes([0x10 + t]) + STD_HUFF[("ac", t)]))
    out.append(_marker(0xDA, sos + b"\x00\x3f\x00"))
    out.append(scan)
    out.append(b"\xff\xd9")
    return b"".join(out)


def write(path: str, img: np.ndarray, quality: int = 75) -> None:
    with open(path, "wb") as fh:
        fh.write(encode(img, quality))
