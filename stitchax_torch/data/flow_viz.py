"""Optical-flow visualization (Baker et al. color wheel), numpy only.

Port of stitchax/data/flow_viz.py: a 55-color wheel spanning
RY/YG/GC/CB/BM/MR sectors, hue = flow angle, saturation = normalized
magnitude.
"""

from __future__ import annotations

import numpy as np


def _make_colorwheel() -> np.ndarray:
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((RY + YG + GC + CB + BM + MR, 3))
    col = 0
    ramps = [
        (RY, [255, None, 0], +1, 1),   # R->Y: G ramps up
        (YG, [None, 255, 0], -1, 0),   # Y->G: R ramps down
        (GC, [0, 255, None], +1, 2),   # G->C: B ramps up
        (CB, [0, None, 255], -1, 1),   # C->B: G ramps down
        (BM, [None, 0, 255], +1, 0),   # B->M: R ramps up
        (MR, [255, 0, None], -1, 2),   # M->R: B ramps down
    ]
    for n, base, sign, ramp_ch in ramps:
        ramp = np.floor(255 * np.arange(n) / n)
        if sign < 0:
            ramp = 255 - ramp
        for ch, v in enumerate(base):
            wheel[col:col + n, ch] = ramp if v is None else v
        col += n
    return wheel


_WHEEL = _make_colorwheel()


def flow_to_image(flow: np.ndarray, clip_flow: float | None = None
                  ) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 visualization."""
    u, v = flow[..., 0].astype(np.float64), flow[..., 1].astype(np.float64)
    if clip_flow is not None:
        u = np.clip(u, -clip_flow, clip_flow)
        v = np.clip(v, -clip_flow, clip_flow)
    rad = np.sqrt(u * u + v * v)
    rad_max = max(rad.max(), 1e-5)
    u, v = u / rad_max, v / rad_max
    rad = rad / rad_max

    ncols = _WHEEL.shape[0]
    a = np.arctan2(-v, -u) / np.pi          # [-1, 1]
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros(u.shape + (3,), np.uint8)
    for ch in range(3):
        c0 = _WHEEL[k0, ch] / 255.0
        c1 = _WHEEL[k1, ch] / 255.0
        col = (1 - f) * c0 + f * c1
        col = 1 - rad * (1 - col)           # saturate with magnitude
        img[..., ch] = np.floor(255 * col)
    return img
