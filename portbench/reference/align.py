"""The fixed-resolution alignment forward of the evaluation and of
training, frozen: a copy of the port's `align/adapter.py`
(`train_eval_forward`) and `train/trainer.py` (`align_train_forward`,
`occlusion_mask`), on the reference's own ops."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from .flow import flow_warp_b
from .homography import dlt_solve, scale_matrix
from .occlusion import compute_occlusion_b
from .sampling import homography_warp_b


@dataclass(frozen=True)
class AlignConfig:
    use_fb_consistency_mask: bool = True
    occlusion_estimation: str = "wang"
    occlusion_kernel: Tuple[int, int] = (19, 19)
    model_size: int = 512
    canvas_bucket: int = 256
    max_canvas: int = 4096


def _corners(h: float, w: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([[0.0, 0.0], [w, 0.0], [0.0, h], [w, h]],
                        device=like.device, dtype=like.dtype)


def predict_homography_matrix(homo_offsets: torch.Tensor, img_h: int,
                              img_w: int, scale_div: float = 1.0) -> torch.Tensor:
    """Corner offsets (B, 8) -> pixel homography (B, 3, 3)."""
    motion = homo_offsets.reshape(-1, 4, 2)
    src = _corners(img_h, img_w, homo_offsets)[None].expand(motion.shape[0], -1, -1)
    return dlt_solve(src / scale_div, (src + motion) / scale_div)


def _normalized(H: torch.Tensor, h: float, w: float) -> torch.Tensor:
    """M^-1 @ H @ M for a square (h, w) frame on both sides."""
    M = scale_matrix(h, w, device=H.device, dtype=H.dtype)
    return torch.linalg.inv(M) @ H @ M


def train_eval_forward(homo_fn: Callable, flow_fn: Callable,
                       input1: torch.Tensor, input2: torch.Tensor,
                       cfg: AlignConfig) -> Dict[str, Any]:
    """The fixed-resolution alignment forward of training and evaluation
    (stitchax/align/adapter.py:71): the homography at coordinates / 8, the
    warp of img2 and its coverage (ones) into img1's frame, the forward
    flow, and with the consistency mask a second flow call backwards whose
    range-map occlusion (>= 0.5) masks the warp.

    homo_fn(a, b) -> (B, 8) offsets on [-1, 1] inputs; flow_fn(a, b) ->
    ([flows], lr) on [0, 255] inputs."""
    B, img_h, img_w, _ = input1.shape
    offsets = homo_fn(input1 / 127.5 - 1.0, input2 / 127.5 - 1.0)
    H = predict_homography_matrix(offsets, img_h, img_w, scale_div=8.0)
    H_mat = _normalized(H, img_h / 8.0, img_w / 8.0)
    H_inv_mat = _normalized(torch.linalg.inv(H), img_h / 8.0, img_w / 8.0)

    ones3 = torch.ones_like(input2)
    output_H = homography_warp_b(torch.cat([input2, ones3], -1), H_mat,
                                 img_h, img_w)
    output_H_inv = homography_warp_b(torch.cat([input1, ones3], -1),
                                     H_inv_mat, img_h, img_w)

    warp2 = output_H[..., 0:3]
    flow_predictions, _ = flow_fn(input1, warp2)
    final_flow = flow_predictions[-1]

    final_warp_output = flow_warp_b(output_H, final_flow)
    overlap = (final_warp_output[..., 3:6].mean(-1) < 0.9).to(input1.dtype)

    out = dict(output_H=output_H, output_H_inv=output_H_inv,
               flow_predictions=flow_predictions, H=H)
    if cfg.use_fb_consistency_mask:
        back_predictions, _ = flow_fn(warp2, input1)
        occ = compute_occlusion_b(final_flow, back_predictions[-1],
                                  cfg.occlusion_estimation,
                                  occlusion_are_zeros=True,
                                  boundaries_occluded=True)
        occ = (occ >= 0.5).to(input1.dtype)
        final_warp_output = final_warp_output * occ
        out["origin_occlusion_mask"] = occ[..., 0]

    out.update(final_warp_output=final_warp_output, overlap=overlap)
    return out


def align_train_forward(homo_fn: Callable, flow_fn: Callable,
                        img1: torch.Tensor, img2: torch.Tensor,
                        align_cfg: AlignConfig,
                        detach_H: bool = False) -> Dict[str, object]:
    """Homography -> H-warp of img2 and its ones -> residual flow
    predictions (stitchax trainer.py:42). homo_fn(a, b) on [-1, 1]
    inputs -> (B, 8) offsets; flow_fn(a, b) on [0, 255] -> ([flows], lr)."""
    B, H, W, _ = img1.shape
    offsets = homo_fn(img1 / 127.5 - 1.0, img2 / 127.5 - 1.0)
    if detach_H:
        offsets = offsets.detach()
    Hm = predict_homography_matrix(offsets, H, W, scale_div=8.0)
    H_mat = _normalized(Hm, H / 8.0, W / 8.0)
    output_H = homography_warp_b(torch.cat([img2, torch.ones_like(img2)], -1),
                                 H_mat, H, W)
    flow_predictions, _ = flow_fn(img1, output_H[..., 0:3])
    return dict(output_H=output_H, flow_predictions=flow_predictions,
                H=Hm, offsets=offsets)


@torch.no_grad()
def occlusion_mask(flow: Callable, fwd: Dict[str, object],
                   img1: torch.Tensor, align_cfg: AlignConfig) -> torch.Tensor:
    """The sequence loss's occlusion mask (B, H, W, 1): the backward flow
    call (warp2 -> img1) without gradient, the forward-backward range-map
    occlusion of the last predictions, thresholded at 0.5 (stitchax
    trainer.py:84-92, under stop_gradient). Only the backward call's last
    prediction is read, so only it is upsampled."""
    back_preds, _ = flow(fwd["output_H"][..., 0:3].detach(), img1,
                         upsample_all=False)
    occ = compute_occlusion_b(
        fwd["flow_predictions"][-1].detach(), back_preds[-1],
        align_cfg.occlusion_estimation, occlusion_are_zeros=True,
        boundaries_occluded=True)
    return (occ >= 0.5).to(img1.dtype)
