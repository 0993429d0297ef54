"""Alignment core of the stitch (port of stitchax/align/adapter.py).

`stitch_model_step` runs the homography net and FlowFormer++ at
`model_size`, solves the full-resolution homography and the canvas bounds;
`stitch_render` warps both images, the residual flow and the occlusion mask
into the (out_h, out_w) canvas, whose size `bucket_canvas` rounds up.
Kept on purpose, as stitchax pins them: the canvas mesh goes through H^-1
(H2Mesh), mask2 is squared in the overlap algebra, and the occlusion mask
takes the 19x19 open twice (at native resolution and on the canvas).
All tensors NHWC in [0, 255], geometry in fp32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..ops.flow import flow_warp_b, resize_flow_b
from ..ops.grid import get_rigid_mesh, h2mesh
from ..ops.homography import dlt_solve, scale_matrix
from ..ops.morphology import preprocess_occlusion_mask
from ..ops.occlusion import compute_occlusion_b
from ..ops.sampling import homography_warp_b, resize_image_b
from ..utils.tracing import count_sync, span


@dataclass(frozen=True)
class AlignConfig:
    use_fb_consistency_mask: bool = True
    occlusion_estimation: str = "wang"
    occlusion_kernel: Tuple[int, int] = (19, 19)
    model_size: int = 512
    canvas_bucket: int = 256
    max_canvas: int = 4096


def _corners(h: float, w: float, like: torch.Tensor) -> torch.Tensor:
    count_sync(like.device)         # a blocking host-to-device copy
    return torch.tensor([[0.0, 0.0], [w, 0.0], [0.0, h], [w, h]],
                        device=like.device, dtype=like.dtype)


def predict_homography_matrix(homo_offsets: torch.Tensor, img_h: int,
                              img_w: int, scale_div: float = 1.0) -> torch.Tensor:
    """Corner offsets (B, 8) -> pixel homography (B, 3, 3)."""
    motion = homo_offsets.reshape(-1, 4, 2)
    src = _corners(img_h, img_w, homo_offsets)[None].expand(motion.shape[0], -1, -1)
    return dlt_solve(src / scale_div, (src + motion) / scale_div)


def canvas_box(H: torch.Tensor, img_h: int, img_w: int) -> torch.Tensor:
    """(B, 4) canvas bounds (width_min, height_min, width_max, height_max)
    of each pair, from its H^-1-projected full-resolution 64x64 mesh."""
    B = H.shape[0]
    mesh = get_rigid_mesh(img_h, img_w, 63, 63, device=H.device,
                          dtype=H.dtype)
    mesh_p = h2mesh(H, mesh[None].expand(B, -1, -1, -1))
    width_max = torch.trunc(torch.clamp(mesh_p[..., 0].amax((1, 2)), min=img_w))
    width_min = torch.trunc(torch.clamp(mesh_p[..., 0].amin((1, 2)), max=0.0))
    height_max = torch.trunc(torch.clamp(mesh_p[..., 1].amax((1, 2)), min=img_h))
    height_min = torch.trunc(torch.clamp(mesh_p[..., 1].amin((1, 2)), max=0.0))
    return torch.stack([width_min, height_min, width_max, height_max], -1)


def _normalized(H: torch.Tensor, h: float, w: float) -> torch.Tensor:
    """M^-1 @ H @ M for a square (h, w) frame on both sides."""
    M = scale_matrix(h, w, device=H.device, dtype=H.dtype)
    count_sync(H.device)            # linalg.inv checks its result on the host
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
    with span("align.homography"):
        offsets = homo_fn(input1 / 127.5 - 1.0, input2 / 127.5 - 1.0)
        H = predict_homography_matrix(offsets, img_h, img_w, scale_div=8.0)
        H_mat = _normalized(H, img_h / 8.0, img_w / 8.0)
        count_sync(H.device)        # linalg.inv checks its result on the host
        H_inv_mat = _normalized(torch.linalg.inv(H), img_h / 8.0, img_w / 8.0)

    ones3 = torch.ones_like(input2)
    output_H = homography_warp_b(torch.cat([input2, ones3], -1), H_mat,
                                 img_h, img_w)
    output_H_inv = homography_warp_b(torch.cat([input1, ones3], -1),
                                     H_inv_mat, img_h, img_w)

    warp2 = output_H[..., 0:3]
    with span("align.flow"):
        flow_predictions, _ = flow_fn(input1, warp2)
    final_flow = flow_predictions[-1]

    final_warp_output = flow_warp_b(output_H, final_flow)
    overlap = (final_warp_output[..., 3:6].mean(-1) < 0.9).to(input1.dtype)

    out = dict(output_H=output_H, output_H_inv=output_H_inv,
               flow_predictions=flow_predictions, H=H)
    if cfg.use_fb_consistency_mask:
        with span("align.flow"):
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


def stitch_model_step(homo_fn: Callable, flow_fn: Callable,
                      input1: torch.Tensor, input2: torch.Tensor,
                      cfg: AlignConfig,
                      flow_pair_fn: Optional[Callable] = None) -> Dict[str, Any]:
    """Homography + flow at model_size, full-res H and canvas bounds.

    homo_fn(a, b) -> (B, 8) offsets on [-1, 1] inputs; flow_fn(a, b) ->
    ([flows], lr) on [0, 255] inputs; flow_pair_fn(a, b) -> both
    directions in one call (FlowFormer.bidirectional)."""
    B, img_h, img_w, _ = input1.shape
    S = cfg.model_size
    in1 = resize_image_b(input1, S, S)
    in2 = resize_image_b(input2, S, S)

    offsets = homo_fn(in1 / 127.5 - 1.0, in2 / 127.5 - 1.0)
    motion_512 = offsets.reshape(-1, 4, 2)
    H_512 = predict_homography_matrix(offsets, S, S)
    M = scale_matrix(S, S, device=input1.device, dtype=input1.dtype)
    count_sync(M.device)            # linalg.inv checks its result on the host
    H_mat = torch.linalg.inv(M) @ H_512 @ M

    output_H = homography_warp_b(torch.cat([in2, torch.ones_like(in2)], -1),
                                 H_mat, S, S)
    warp2_512 = output_H[..., 0:3]

    back_preds = None
    if flow_pair_fn is not None and cfg.use_fb_consistency_mask:
        (flow_preds, _), (back_preds, _) = flow_pair_fn(in1, warp2_512)
    else:
        flow_preds, _ = flow_fn(in1, warp2_512)
    flow = resize_flow_b(flow_preds[-1], img_h, img_w)

    motion = torch.stack([motion_512[..., 0] * img_w / S,
                          motion_512[..., 1] * img_h / S], -1)
    src = _corners(img_h, img_w, input1)[None].expand(B, -1, -1)
    H = dlt_solve(src, src + motion)

    out = dict(H=H, flow=flow, warp2_512=warp2_512, in1_512=in1,
               canvas_box=canvas_box(H, img_h, img_w))
    if cfg.use_fb_consistency_mask:
        if back_preds is None:
            back_preds, _ = flow_fn(warp2_512, in1)
        back_flow = resize_flow_b(back_preds[-1], img_h, img_w)
        occ = compute_occlusion_b(flow, back_flow, cfg.occlusion_estimation,
                                  occlusion_are_zeros=True,
                                  boundaries_occluded=True)
        out["origin_occlusion_mask"] = preprocess_occlusion_mask(
            occ, cfg.occlusion_kernel)
    return out


def stitch_render(input1: torch.Tensor, input2: torch.Tensor, H: torch.Tensor,
                  flow: torch.Tensor,
                  origin_occlusion_mask: Optional[torch.Tensor],
                  width_min: torch.Tensor, height_min: torch.Tensor,
                  out_h: int, out_w: int, cfg: AlignConfig) -> Dict[str, Any]:
    """Render the warps into the (out_h, out_w) canvas; width_min and
    height_min are (B,) canvas origins (<= 0)."""
    B, img_h, img_w, _ = input1.shape
    dev, dtype = input1.device, input1.dtype
    M = scale_matrix(out_h, out_w, device=dev, dtype=dtype)
    count_sync(dev)                 # linalg.inv checks its result on the host
    N_inv = torch.linalg.inv(scale_matrix(img_h, img_w, device=dev,
                                          dtype=dtype))
    I_ = torch.eye(3, device=dev, dtype=dtype).repeat(B, 1, 1)
    I_[:, 0, 2] = width_min.to(dtype).reshape(-1).expand(B)
    I_[:, 1, 2] = height_min.to(dtype).reshape(-1).expand(B)
    I_mat = N_inv @ I_ @ M

    ones3 = torch.ones_like(input1)
    homo_output = homography_warp_b(torch.cat([input1, ones3], -1), I_mat,
                                    out_h, out_w)
    H_canvas = N_inv @ (H @ I_) @ M
    homo_output2 = homography_warp_b(torch.cat([input2, ones3], -1),
                                     H_canvas, out_h, out_w)
    flow_canvas = homography_warp_b(
        torch.cat([flow, torch.ones_like(flow[..., :1])], -1), I_mat,
        out_h, out_w)
    residual_flow_c, flow_mask_c = flow_canvas[..., 0:2], flow_canvas[..., 2:3]

    final_warp = flow_warp_b(homo_output2, residual_flow_c) * flow_mask_c

    occlusion_mask = None
    if origin_occlusion_mask is not None:
        occ_c = homography_warp_b(origin_occlusion_mask, I_mat, out_h, out_w)
        occ_c = preprocess_occlusion_mask(occ_c, cfg.occlusion_kernel)
        final_warp = final_warp * occ_c
        occlusion_mask = occ_c

    output1, mask1 = homo_output[..., 0:3], homo_output[..., 3:6]
    output2, mask2 = final_warp[..., 0:3], final_warp[..., 3:6]
    keep = (1.0 - mask1) if origin_occlusion_mask is not None else 1.0
    output2 = homo_output2[..., 0:3] * (1 - mask2) * keep + output2 * mask2
    mask2 = homo_output2[..., 3:6] * (1 - mask2) * keep + mask2 * mask2

    blend = ((output1 * mask1 + output2 * mask2)
             / torch.clamp(mask1 + mask2, min=1e-6)).clamp(0, 255)
    return dict(
        H_warp=homo_output2[..., 0:3],
        H_warp_mask=homo_output2[..., 3:6].mean(-1, keepdim=True),
        final_warp=final_warp[..., 0:3],
        output1=output1, output2=output2,
        mask1=mask1.mean(-1, keepdim=True).clamp(0, 1),
        mask2=mask2.mean(-1, keepdim=True).clamp(0, 1),
        blend_image=blend, residual_flow=residual_flow_c,
        occlusion_mask=occlusion_mask)


def bucket_canvas(extent: float, bucket: int, max_canvas: int) -> int:
    b = int(-(-int(extent) // bucket) * bucket)
    return min(max(b, bucket), max_canvas)
