"""K6: the evaluation's per-pair PSNR / SSIM sums (csrc/pair_scores.cu).

It replaces no TPU kernel: stitchax scores its evaluation in numpy on the
host. For B pairs of img1 and warped img2 (B, H, W, 3) and the warp's
coverage (B, H, W, 1), each formed into a masked uint8 pair as
`evaluate.masked_pairs` forms it, `pair_scores` returns a (B, 4) float64
tensor on the inputs' device: the squared error summed over every pixel
and channel (an integer, exact), and, for each of the three channels, the
sum of SSIM's map S (`metrics._ssim_channel`: 7x7 uniform window, K1 =
0.01, K2 = 0.03, data range 255) over the cropped interior [3, H-3) x
[3, W-3). `psnr_ssim` finishes them on the host as `metrics.psnr` and
`metrics.ssim` do. The window sums are integers (exact, as numpy's
float64 summed-area tables hold them) and S takes numpy's float64
operations in numpy's order, so PSNR is bit-equal to the numpy path and
SSIM differs only by the order of the interior's sum (~1e-16).

`pair_scores` launches the kernel for CUDA tensors (fp32; read through
their strides, so the channel slice of the evaluation step's 6-channel
warp output is not copied) and takes `pair_scores_plain`, the same
integer sums and float64 formula in PyTorch, for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import library

WIN = 7
DATA_RANGE = 255.0
CHANNELS = 3
TILE = 32       # the kernel's tile side (csrc/pair_scores.cu, kTile)


def ssim_constants(win: int = WIN, data_range: float = DATA_RANGE):
    """(cov_norm, C1, C2) as `metrics._ssim_channel` computes them."""
    NP = win * win
    return NP / (NP - 1), (0.01 * data_range) ** 2, (0.03 * data_range) ** 2


def masked_levels(img: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """`masked_pairs`' uint8 image as int32: the levels clipped to [0, 255]
    and truncated (NaN to 0), times the coverage truncated to an integer
    (NaN and values outside int32 to 0), mod 256 as numpy's uint8
    product."""
    lv = torch.nan_to_num(img, nan=0.0).clamp(0, 255).to(torch.int32)
    v = torch.nan_to_num(valid, nan=0.0)
    m = torch.where(v.abs() < 2.0 ** 31, v, torch.zeros_like(v))
    return (lv * (m.to(torch.int64) & 255).to(torch.int32)) & 255


def _window_sums(x: torch.Tensor) -> torch.Tensor:
    """(C, H, W) integers -> their WIN x WIN window sums at the interior
    pixels, (C, H - WIN + 1, W - WIN + 1), exact in int64."""
    c = F.pad(x.to(torch.int64).cumsum(1).cumsum(2), (1, 0, 1, 0))
    return (c[:, WIN:, WIN:] - c[:, :-WIN, WIN:] - c[:, WIN:, :-WIN]
            + c[:, :-WIN, :-WIN])


def _ssim_map(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """S of `metrics._ssim_channel` at the interior pixels of (C, H, W)
    integer images, in float64, in numpy's order of operations."""
    cov_norm, c1, c2 = ssim_constants()
    n = float(WIN * WIN)
    ux, uy, uxx, uyy, uxy = (_window_sums(t).double() / n
                             for t in (a, b, a * a, b * b, a * b))
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    return ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux * ux + uy * uy + c1) * (vx + vy + c2))


def _check(img1, warped, valid) -> Tuple[int, int, int]:
    B, H, W, C = img1.shape
    if (C != CHANNELS or warped.shape != img1.shape
            or valid.shape != (B, H, W, 1)):
        raise ValueError(f"pair_scores: expected img1 and warped (B, H, W, 3)"
                         f" and valid (B, H, W, 1), got {tuple(img1.shape)}, "
                         f"{tuple(warped.shape)}, {tuple(valid.shape)}")
    if H < WIN or W < WIN:
        raise ValueError(f"pair_scores: SSIM's {WIN}x{WIN} window needs "
                         f"images of at least {WIN}x{WIN}, got {H}x{W}")
    return B, H, W


def pair_scores_plain(img1: torch.Tensor, warped: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """The (B, 4) float64 scores (squared error, SSIM sums of channels 0,
    1, 2) of each pair, one pair at a time, in PyTorch."""
    B, H, W = _check(img1, warped, valid)
    out = torch.empty(B, 1 + CHANNELS, dtype=torch.float64,
                      device=img1.device)
    for i in range(B):
        a = masked_levels(img1[i], valid[i]).permute(2, 0, 1)
        b = masked_levels(warped[i], valid[i]).permute(2, 0, 1)
        out[i, 0] = ((a - b).to(torch.int64) ** 2).sum().double()
        out[i, 1:] = _ssim_map(a, b).sum((1, 2))
    return out


def pair_scores(img1: torch.Tensor, warped: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """The (B, 4) float64 scores of each pair (see the module's docstring):
    K6 for CUDA tensors, `pair_scores_plain` for CPU tensors."""
    if img1.device.type == "cpu":
        return pair_scores_plain(img1, warped, valid)
    return _launch(img1, warped, valid)


def psnr_ssim(scores: np.ndarray, H: int, W: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(B,) PSNR and (B,) SSIM from the (B, 4) scores of H x W pairs, as
    `metrics.psnr` (inf where the squared error is 0) and `metrics.ssim`
    (the mean of the channels' means over the cropped interior) finish
    them, in float64."""
    n, interior = H * W * CHANNELS, (H - WIN + 1) * (W - WIN + 1)
    psnr, ssim = [], []
    for sse, *sums in np.asarray(scores, np.float64):
        mse = sse / n
        psnr.append(float("inf") if mse == 0
                    else float(10 * np.log10(DATA_RANGE ** 2 / mse)))
        ssim.append(float(np.mean([float(s / interior) for s in sums])))
    return np.array(psnr, np.float64), np.array(ssim, np.float64)


def _launch(img1, warped, valid) -> torch.Tensor:
    B, H, W = _check(img1, warped, valid)
    tensors = (img1, warped, valid)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"pair_scores: takes float32, got "
                        f"{[t.dtype for t in tensors]}")
    dev = img1.device
    if any(t.device != dev or t.device.type != "cuda" for t in tensors):
        raise ValueError("pair_scores: tensors must share one CUDA device")
    tiles = -(-H // TILE) * -(-W // TILE)
    part_sse = torch.empty(B * tiles, dtype=torch.int64, device=dev)
    part_ssim = torch.empty(B * tiles * CHANNELS, dtype=torch.float64,
                            device=dev)
    out = torch.empty(B, 1 + CHANNELS, dtype=torch.float64, device=dev)
    err = library.load_library().stx_pair_scores(
        img1.data_ptr(), *img1.stride(), warped.data_ptr(), *warped.stride(),
        valid.data_ptr(), *valid.stride()[:3], B, H, W, *ssim_constants(),
        part_sse.data_ptr(), part_ssim.data_ptr(), out.data_ptr(),
        library.stream_of(img1))
    library.check(err, "pair_scores")
    library.launches["pair_scores"] += 1
    return out
