"""Binary morphology and pooling on NHWC masks.

Port of stitchax/ops/morphology.py. Rectangular structuring elements are
separable min/max pools; inputs are (B, H, W, C) or (H, W, C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_INF = float("inf")


def _nchw(x: torch.Tensor):
    """(B, H, W, C) or (H, W, C) -> (B, C, H, W) and the inverse."""
    if x.dim() == 3:
        return x.permute(2, 0, 1)[None], lambda y: y[0].permute(1, 2, 0)
    return x.permute(0, 3, 1, 2), lambda y: y.permute(0, 2, 3, 1)


def _max_valid(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """Separable VALID max pool over NCHW."""
    if kh > 1:
        x = F.max_pool2d(x, (kh, 1), stride=1)
    if kw > 1:
        x = F.max_pool2d(x, (1, kw), stride=1)
    return x


def _same_pads(kh: int, kw: int):
    # F.pad order (W_lo, W_hi, H_lo, H_hi); SAME puts the extra on the high side
    return ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2)


def dilate(mask: torch.Tensor, kernel_size=(3, 3)) -> torch.Tensor:
    kh, kw = kernel_size
    x, back = _nchw(mask)
    x = F.pad(x, _same_pads(kh, kw), value=-_INF)
    return back(_max_valid(x, kh, kw))


def erode(mask: torch.Tensor, kernel_size=(3, 3)) -> torch.Tensor:
    kh, kw = kernel_size
    x, back = _nchw(mask)
    x = F.pad(-x, _same_pads(kh, kw), value=-_INF)
    return back(-_max_valid(x, kh, kw))


def morph_open(mask: torch.Tensor, kernel_size=(3, 3)) -> torch.Tensor:
    """Erosion followed by dilation."""
    return dilate(erode(mask, kernel_size), kernel_size)


def preprocess_occlusion_mask(occ: torch.Tensor,
                              kernel_size=(19, 19)) -> torch.Tensor:
    """Binarize at 0.5, then a 19x19 open whose erosion zero-pads the
    border (the reference's all-ones conv erosion: borders always erode)."""
    kh, kw = kernel_size
    m = (occ >= 0.5).to(occ.dtype)
    x, back = _nchw(m)
    x = F.pad(-x, _same_pads(kh, kw), value=0.0)   # zero pad, then min-pool
    eroded = back(-_max_valid(x, kh, kw))
    return (dilate(eroded, kernel_size) >= 0.5).to(occ.dtype)


def avg_pool_same(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Stride-1 average pool with zero-padded SAME borders
    (F.avg_pool2d count_include_pad=True parity)."""
    k = kernel_size
    y, back = _nchw(x)
    y = F.pad(y, _same_pads(k, k), value=0.0)
    return back(F.avg_pool2d(y, k, stride=1))


def _even_pool(x: torch.Tensor, k: int, op: str) -> torch.Tensor:
    """Even-kernel pool matching conv2d(padding=k//2) + crop: the window at
    i covers [i - k//2, i + k//2 - 1]; borders are zero-padded."""
    y, back = _nchw(x)
    pads = (k // 2, k - 1 - k // 2, k // 2, k - 1 - k // 2)
    if op == "max":
        return back(_max_valid(F.pad(y, pads, value=0.0), k, k))
    return back(-_max_valid(F.pad(-y, pads, value=0.0), k, k))


def dilate_thin_area(mask: torch.Tensor, dilation_kernel_size: int = 8,
                     thickening_kernel_size: int = 8) -> torch.Tensor:
    """Split a hole mask into thick/thin parts and dilate only the thin part
    (reference core/inference/utils.py:124-160). Uses channel 0 and
    broadcasts back to the input's channels."""
    m = mask[..., 0:1]
    k = dilation_kernel_size
    eroded = _even_pool(m, k, "min")
    opened = (_even_pool((eroded == 1.0).to(m.dtype), k, "max")
              >= 1.0).to(m.dtype)
    thick = (m * opened).clamp(0, 1)
    thin = m * (1.0 - thick)
    thin_d = (_even_pool(thin, thickening_kernel_size, "max")
              >= 1.0).to(m.dtype)
    return (thick + thin_d).clamp(0, 1).expand(mask.shape)


def dilate_binary(mask: torch.Tensor, kernel_size: int = 3,
                  iterations: int = 1) -> torch.Tensor:
    """cv2.dilate parity on a binary mask (odd all-ones kernel)."""
    out = mask
    for _ in range(iterations):
        out = dilate(out, (kernel_size, kernel_size))
    return out
