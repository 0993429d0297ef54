"""RAFT-style flow-training augmentation, host-side numpy (port of
stitchax/data/augmentor.py).

stitchax jitters colour with Pillow's ImageEnhance and resizes with
Pillow's BILINEAR (uint8 images, float32 "F" flow planes); the port does
the same arithmetic in numpy (`io.enhance`, `io.resize`), bit-equal, and
draws from numpy's default_rng(seed) in stitchax's order, so that an
augmented sample equals stitchax's. The UDIS training path runs without
augmentation; these serve the optical-flow pretraining datasets.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..io import enhance
from ..io.resize import resize_bilinear, resize_bilinear_float


@dataclass
class AugmentorConfig:
    crop_size: Tuple[int, int] = (368, 496)
    min_scale: float = -0.2
    max_scale: float = 0.5
    spatial_aug_prob: float = 0.8
    stretch_prob: float = 0.8
    max_stretch: float = 0.2
    do_flip: bool = True
    h_flip_prob: float = 0.5
    v_flip_prob: float = 0.1
    asymmetric_color_aug_prob: float = 0.2
    eraser_aug_prob: float = 0.5


def _resize_img(img: np.ndarray, sx: float, sy: float) -> np.ndarray:
    h, w = img.shape[:2]
    nw, nh = int(round(w * sx)), int(round(h * sy))
    return resize_bilinear(img.astype(np.uint8), nh, nw).astype(img.dtype)


def _resize_flow(flow: np.ndarray, sx: float, sy: float) -> np.ndarray:
    h, w = flow.shape[:2]
    nw, nh = int(round(w * sx)), int(round(h * sy))
    fx = resize_bilinear_float(np.ascontiguousarray(flow[..., 0]), nh, nw)
    fy = resize_bilinear_float(np.ascontiguousarray(flow[..., 1]), nh, nw)
    return np.stack([fx * sx, fy * sy], -1)


class FlowAugmentor:
    """Photometric + spatial augmentation for dense-flow pairs."""

    def __init__(self, cfg: AugmentorConfig = AugmentorConfig(),
                 seed: int = 0):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)

    # ------------------------- photometric ---------------------------------
    def _jitter(self, img: np.ndarray) -> np.ndarray:
        x = img.astype(np.uint8)
        r = self.rng
        x = enhance.brightness(x, r.uniform(0.6, 1.4))
        x = enhance.contrast(x, r.uniform(0.6, 1.4))
        x = enhance.color(x, r.uniform(0.6, 1.4))
        out = x.astype(np.float32)
        # hue-ish channel roll substitute for cv2 hue jitter
        if r.random() < 0.2:
            out = out[..., list(r.permutation(3))]
        return out

    def color_transform(self, img1, img2):
        if self.rng.random() < self.cfg.asymmetric_color_aug_prob:
            return self._jitter(img1), self._jitter(img2)
        stacked = np.concatenate([img1, img2], axis=0)
        j = self._jitter(stacked)
        return j[: img1.shape[0]], j[img1.shape[0]:]

    def eraser_transform(self, img1, img2, bounds=(50, 100)):
        """Occlusion simulation: random rectangles in img2 replaced by its
        mean color (reference augmentor.py eraser_transform)."""
        h, w = img1.shape[:2]
        if self.rng.random() < self.cfg.eraser_aug_prob:
            mean_color = img2.reshape(-1, 3).mean(0)
            for _ in range(self.rng.integers(1, 3)):
                x0 = self.rng.integers(0, w)
                y0 = self.rng.integers(0, h)
                dx = self.rng.integers(bounds[0], bounds[1])
                dy = self.rng.integers(bounds[0], bounds[1])
                img2[y0:y0 + dy, x0:x0 + dx] = mean_color
        return img1, img2

    # --------------------------- spatial ------------------------------------
    def spatial_transform(self, img1, img2, flow):
        c = self.cfg
        ch, cw = c.crop_size
        h, w = img1.shape[:2]
        min_scale = max((ch + 8) / h, (cw + 8) / w)
        scale = 2 ** self.rng.uniform(c.min_scale, c.max_scale)
        sx = sy = scale
        if self.rng.random() < c.stretch_prob:
            sx *= 2 ** self.rng.uniform(-c.max_stretch, c.max_stretch)
            sy *= 2 ** self.rng.uniform(-c.max_stretch, c.max_stretch)
        sx, sy = max(sx, min_scale), max(sy, min_scale)

        if self.rng.random() < c.spatial_aug_prob:
            img1 = _resize_img(img1, sx, sy)
            img2 = _resize_img(img2, sx, sy)
            flow = _resize_flow(flow, sx, sy)

        if c.do_flip:
            if self.rng.random() < c.h_flip_prob:
                img1, img2 = img1[:, ::-1], img2[:, ::-1]
                flow = flow[:, ::-1] * [-1.0, 1.0]
            if self.rng.random() < c.v_flip_prob:
                img1, img2 = img1[::-1], img2[::-1]
                flow = flow[::-1] * [1.0, -1.0]

        h, w = img1.shape[:2]
        y0 = self.rng.integers(0, h - ch + 1)
        x0 = self.rng.integers(0, w - cw + 1)
        sl = np.s_[y0:y0 + ch, x0:x0 + cw]
        return img1[sl], img2[sl], flow[sl]

    def __call__(self, img1, img2, flow):
        img1 = np.ascontiguousarray(img1, np.float32)
        img2 = np.ascontiguousarray(img2, np.float32)
        flow = np.ascontiguousarray(flow, np.float32)
        img1, img2 = self.color_transform(img1, img2)
        img1, img2 = self.eraser_transform(img1, img2)
        img1, img2, flow = self.spatial_transform(img1, img2, flow)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow))


class SparseFlowAugmentor(FlowAugmentor):
    """Augmentation for sparse GT flow (KITTI/HD1K), where resizing must
    splat valid flow vectors to their new integer positions instead of
    interpolating (reference: core/utils/augmentor.py:165-303).

    Differences from the dense augmentor, per the reference: color jitter is
    always symmetric across the pair; no aspect stretch; no vertical flip;
    inputs smaller than the crop are zero-padded bottom/right; the crop
    origin is sampled with a (20, 50) pixel margin then clipped.
    """

    def color_transform(self, img1, img2):
        stacked = np.concatenate([img1, img2], axis=0)
        j = self._jitter(stacked)
        return j[: img1.shape[0]], j[img1.shape[0]:]

    def resize_sparse_flow_map(self, flow, valid, sx=1.0, sy=1.0):
        """Nearest-splat resize of a sparse flow map: scale the coordinates
        of valid vectors, round to the new grid, rebuild flow + validity."""
        h, w = flow.shape[:2]
        coords = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)
        coords = coords.reshape(-1, 2).astype(np.float32)
        flow = flow.reshape(-1, 2).astype(np.float32)
        valid = valid.reshape(-1) >= 1

        coords1 = coords[valid] * [sx, sy]
        flow1 = flow[valid] * [sx, sy]
        h1, w1 = int(round(h * sy)), int(round(w * sx))

        xx = np.round(coords1[:, 0]).astype(np.int32)
        yy = np.round(coords1[:, 1]).astype(np.int32)
        keep = (xx > 0) & (xx < w1) & (yy > 0) & (yy < h1)

        flow_img = np.zeros((h1, w1, 2), np.float32)
        valid_img = np.zeros((h1, w1), np.int32)
        flow_img[yy[keep], xx[keep]] = flow1[keep]
        valid_img[yy[keep], xx[keep]] = 1
        return flow_img, valid_img

    def spatial_transform(self, img1, img2, flow, valid):
        c = self.cfg
        ch, cw = c.crop_size
        pad_b = max(ch - img1.shape[0], 0)
        pad_r = max(cw - img1.shape[1], 0)
        if pad_b or pad_r:
            pad3 = ((0, pad_b), (0, pad_r), (0, 0))
            img1 = np.pad(img1, pad3)
            img2 = np.pad(img2, pad3)
            flow = np.pad(flow, pad3)
            valid = np.pad(valid, ((0, pad_b), (0, pad_r)))

        h, w = img1.shape[:2]
        min_scale = max((ch + 1) / h, (cw + 1) / w)
        scale = max(2 ** self.rng.uniform(c.min_scale, c.max_scale),
                    min_scale)
        if self.rng.random() < c.spatial_aug_prob:
            img1 = _resize_img(img1, scale, scale)
            img2 = _resize_img(img2, scale, scale)
            flow, valid = self.resize_sparse_flow_map(flow, valid,
                                                      scale, scale)

        if c.do_flip and self.rng.random() < 0.5:  # h-flip only (sparse)
            img1, img2 = img1[:, ::-1], img2[:, ::-1]
            flow = flow[:, ::-1] * [-1.0, 1.0]
            valid = valid[:, ::-1]

        margin_y, margin_x = 20, 50
        h, w = img1.shape[:2]
        y0 = self.rng.integers(0, h - ch + margin_y)
        x0 = self.rng.integers(-margin_x, w - cw + margin_x)
        y0 = int(np.clip(y0, 0, h - ch))
        x0 = int(np.clip(x0, 0, w - cw))
        sl = np.s_[y0:y0 + ch, x0:x0 + cw]
        return img1[sl], img2[sl], flow[sl], valid[sl]

    def __call__(self, img1, img2, flow, valid):
        img1 = np.ascontiguousarray(img1, np.float32)
        img2 = np.ascontiguousarray(img2, np.float32)
        flow = np.ascontiguousarray(flow, np.float32)
        valid = np.ascontiguousarray(valid, np.float32)
        img1, img2 = self.color_transform(img1, img2)
        img1, img2 = self.eraser_transform(img1, img2)
        img1, img2, flow, valid = self.spatial_transform(img1, img2, flow,
                                                         valid)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow), np.ascontiguousarray(valid))


# --------------------- chromatic / PCA transforms ----------------------------
# (reference: core/utils/flow_transforms.py:15-438 — the RAFT-era chromatic
#  suite; unused by the UDIS path but part of the pretraining toolbox)


def chromatic_transform(rng: np.random.Generator, img1: np.ndarray,
                        img2: np.ndarray, brightness: float = 0.2,
                        contrast: float = 0.4, gamma_range=(0.7, 1.5)):
    """Shared chromatic jitter: gamma, brightness, contrast per pair."""
    gamma = rng.uniform(*gamma_range)
    bright = 1.0 + rng.uniform(-brightness, brightness)
    contr = 1.0 + rng.uniform(-contrast, contrast)

    def apply(img):
        x = np.clip(img / 255.0, 0, 1) ** gamma
        x = x * bright
        mean = x.mean((0, 1), keepdims=True)
        x = (x - mean) * contr + mean
        return np.clip(x * 255.0, 0, 255).astype(np.float32)

    return apply(img1), apply(img2)


def pca_lighting(rng: np.random.Generator, img: np.ndarray,
                 alpha_std: float = 0.1) -> np.ndarray:
    """AlexNet-style PCA color lighting noise along the image's own RGB
    principal components (the eigen transform of flow_transforms.py)."""
    flat = img.reshape(-1, 3) / 255.0
    cov = np.cov(flat, rowvar=False)
    eigval, eigvec = np.linalg.eigh(cov)
    alpha = rng.normal(0, alpha_std, 3)
    shift = eigvec @ (alpha * np.sqrt(np.maximum(eigval, 0)))
    return np.clip(img + shift[None, None] * 255.0, 0, 255).astype(np.float32)
