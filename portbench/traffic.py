"""The one traffic generator: seeded image pairs from a mix's parameters.

Each pair is UDIS-D's size. img1 is a crop of a smooth multi-scale random
texture (the pattern of the port's smoke test, `seeded_pair`); img2 is the
same scene under a homography drawn per pair: a horizontal shift of a
share of the width, a small vertical shift, a rotation and a slight
perspective, so overlaps and canvases vary as UDIS-D's do. Pixels are
whole gray levels in [0, 255] (decoded 8-bit photos), float32 HWC.

The homographies come from `numpy.random.default_rng(seed)`, the textures
from a `torch.Generator` on the device seeded with the same number, made
in a few large calls. The same seed and device give the same arrays, and
the program and the reference are handed the same ones.
"""

from __future__ import annotations

import math
from typing import Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def homographies(pairs: Mapping, n: int, hw: Tuple[int, int],
                 rng: np.random.Generator, margin: int) -> np.ndarray:
    """(n, 3, 3) maps from img2's pixels to texture pixels: img1 sits at
    (margin, margin) of the texture, img2 shifted right by
    `shift_frac` of the width, by `vshift_frac` of the height, rotated by
    up to `rotation_deg` about its centre, with perspective terms up to
    `perspective` per pixel."""
    H, W = hw
    lo, hi = pairs["shift_frac"]
    vlo, vhi = pairs["vshift_frac"]
    dx = rng.uniform(lo, hi, n) * W
    dy = rng.uniform(vlo, vhi, n) * H
    th = np.deg2rad(rng.uniform(-1.0, 1.0, n) * pairs["rotation_deg"])
    px, py = (rng.uniform(-1.0, 1.0, (2, n)) * pairs["perspective"])
    out = np.empty((n, 3, 3))
    cx, cy = W / 2.0, H / 2.0
    for i in range(n):
        c, s = math.cos(th[i]), math.sin(th[i])
        to_c = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.0]])
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        persp = np.array([[1, 0, 0], [0, 1, 0], [px[i], py[i], 1.0]])
        back = np.array([[1, 0, cx + margin + dx[i]],
                         [0, 1, cy + margin + dy[i]], [0, 0, 1.0]])
        out[i] = back @ rot @ persp @ to_c
    return out


def make_pairs(mix: Mapping, seed: int, n: int, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """n pairs (img1, img2), each (n, H, W, 3) float32 on `device`."""
    H, W = mix["size"]
    pairs = mix["pairs"]
    margin = int(pairs["margin"])
    rng = np.random.default_rng(seed)
    Hm = homographies(pairs, n, (H, W), rng, margin)
    big_h = H + 2 * margin + int(math.ceil(pairs["vshift_frac"][1] * H))
    big_w = W + 2 * margin + int(math.ceil(pairs["shift_frac"][1] * W))
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    tex = torch.zeros((n, 3, big_h, big_w), device=device)
    for scale, amp in pairs["texture_scales"]:
        gh, gw = big_h // scale + 2, big_w // scale + 2
        noise = torch.randn((n, 3, gh, gw), generator=g, device=device)
        tex += amp * F.interpolate(noise, size=(big_h, big_w),
                                   mode="bilinear", align_corners=True)
    lo = tex.amin((1, 2, 3), keepdim=True)
    hi = tex.amax((1, 2, 3), keepdim=True)
    tex = (tex - lo) / (hi - lo) * 255.0
    img1 = tex[:, :, margin:margin + H, margin:margin + W]
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float64),
                            torch.arange(W, dtype=torch.float64),
                            indexing="ij")
    pts = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    src = torch.einsum("nij,pj->npi", torch.from_numpy(Hm), pts)
    sx = src[..., 0] / src[..., 2]
    sy = src[..., 1] / src[..., 2]
    grid = torch.stack([sx / (big_w - 1) * 2 - 1, sy / (big_h - 1) * 2 - 1],
                       -1).reshape(n, H, W, 2).float().to(device)
    img2 = F.grid_sample(tex, grid, mode="bilinear", padding_mode="border",
                         align_corners=True)
    to_hwc = lambda t: torch.round(t.permute(0, 2, 3, 1)).clamp(
        0, 255).contiguous()
    return to_hwc(img1), to_hwc(img2)
