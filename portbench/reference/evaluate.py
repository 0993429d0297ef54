"""The reference's evaluation of a batch of pairs: the alignment forward
(`train_eval_forward`), the warped img2 and its coverage, and each pair's
PSNR and SSIM in the fully covered overlap, as the port's evaluation
forms them (`masked_pairs`: clip and truncate to uint8, the coverage
truncated too, so only pixels covered exactly count)."""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from .align import AlignConfig, train_eval_forward
from .scores import psnr_batch, ssim_batch


@torch.no_grad()
def eval_outputs(nets: Mapping[str, torch.nn.Module], img1: torch.Tensor,
                 img2: torch.Tensor, align: AlignConfig, micro: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(B, H, W, 3) fp32 [0, 255] tensors -> numpy (warped img2 (B, H, W,
    3), coverage (B, H, W, 1)), `micro` pairs at a time."""
    homo, flow = nets["homo"], nets["flow"]
    warped, valid = [], []
    for i in range(0, img1.shape[0], micro):
        out = train_eval_forward(homo, flow, img1[i:i + micro],
                                 img2[i:i + micro], align)
        w = out["final_warp_output"]
        warped.append(w[..., 0:3].cpu().numpy())
        valid.append(w[..., 3:6].mean(-1, keepdim=True).cpu().numpy())
    return np.concatenate(warped), np.concatenate(valid)


def masked_pairs(img1: np.ndarray, warped: np.ndarray, valid: np.ndarray):
    i1 = np.clip(img1, 0, 255).astype(np.uint8)
    w = np.clip(warped, 0, 255).astype(np.uint8)
    m = valid.astype(np.uint8)
    return i1 * m, w * m


def pair_scores(img1: np.ndarray, warped: np.ndarray, valid: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Each pair's (PSNR, SSIM) of img1 against the warped img2 in the
    fully covered overlap (uint8, data range 255, SSIM window 7)."""
    a, b = masked_pairs(img1, warped, valid)
    return psnr_batch(a, b, 255.0), ssim_batch(a, b, 7, 255.0)
