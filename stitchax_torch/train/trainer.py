"""Train state, the alignment train step and checkpoints (port of
stitchax/train/trainer.py).

The trained tensors are the models' own parameters, keyed "homo.<name>" /
"flow.<name>" by their state_dict names, with the homography net's
BatchNorm statistics among them as stitchax trains them
(`models.layers.train_batch_statistics`). A step runs the forward under
autograd (the homography, the warp of img2 and FlowFormer++'s 12
predictions, K1 / K3 / K4 inside their autograd Functions), the backward
flow call under `torch.no_grad()` for the occlusion mask, the sequence
loss, one backward pass, then clip + AdamW, updating the tensors in place.
Checkpoints are `torch.save` files of the step, the trained tensors and
the optimizer state (stitchax writes orbax directories).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..align.adapter import AlignConfig, _normalized, predict_homography_matrix
from ..models.layers import train_batch_statistics
from ..ops.occlusion import compute_occlusion_b
from ..ops.sampling import homography_warp_b
from ..utils.tracing import span
from .losses import LossConfig, sequence_alignment_loss
from .optim import (OptimConfig, OptState, Optimizer, apply_updates,
                    fetch_optimizer, global_norm)


@dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    opt_state: OptState


def stitchax_tree(tensors: Dict[str, torch.Tensor]) -> Dict[str, dict]:
    """Trained tensors (or their gradients), keyed as `create_train_state`
    keys them -> {model: stitchax variables} of float32 numpy arrays, e.g.
    {"flow": {"params": ...}, "homo": {"params": ..., "batch_stats": ...}}
    (convert.params_to_jax per model)."""
    from ..convert import params_to_jax
    by_model: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, t in tensors.items():
        model, rest = name.split(".", 1)
        by_model.setdefault(model, {})[rest] = t
    return {k: params_to_jax(v) for k, v in by_model.items()}


def create_train_state(models: Dict[str, nn.Module], optim_cfg: OptimConfig
                       ) -> Tuple[TrainState, Optimizer]:
    """The state over `models` ({"homo": ..., "flow": ...}, already on their
    device), whose BatchNorm statistics become trained parameters; the
    trained tensors are keyed "<model>.<parameter name>"."""
    for m in models.values():
        train_batch_statistics(m)
    params = {f"{k}.{n}": p for k, m in models.items()
              for n, p in m.named_parameters()}
    tx = fetch_optimizer(optim_cfg)
    return TrainState(step=0, params=params, opt_state=tx.init(params)), tx


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


def make_train_step(homo: nn.Module, flow: nn.Module, tx: Optimizer,
                    align_cfg: AlignConfig, loss_cfg: LossConfig,
                    use_fb_consistency_mask: bool = True,
                    remat: bool = False):
    """Returns train_step(state, img1, img2, timings=None) -> (state,
    metrics): metrics total / photometric / rigid / border / grad_norm (the
    raw gradients' global norm), 0-dim tensors on the device. `remat`
    recomputes each backbone's forward in the backward pass
    (torch.utils.checkpoint) instead of holding its activations. With a
    `timings` dict the step adds ms of its forward, no-grad backward flow,
    backward pass and update (synchronizing between them)."""
    homo_fn, flow_fn = homo, flow
    if remat:
        homo_fn = lambda a, b: checkpoint(homo, a, b, use_reentrant=False)
        flow_fn = lambda a, b: checkpoint(flow, a, b, use_reentrant=False)

    def loss_and_grads(state: TrainState, img1: torch.Tensor,
                       img2: torch.Tensor, timings: Optional[dict] = None,
                       world=None):
        """(losses, {name: gradient}) at the state's tensors; their .grad
        is left None. With a `world`, img1 / img2 are this rank's block of
        the global batch (`parallel.make_parallel_train_step`)."""
        dev = img1.device
        with span("train.forward", timings, "forward_ms", dev):
            fwd = align_train_forward(homo_fn, flow_fn, img1, img2,
                                      align_cfg)
        occ = None
        if use_fb_consistency_mask:
            with span("train.backward_flow", timings, "backward_flow_ms",
                      dev):
                occ = occlusion_mask(flow, fwd, img1, align_cfg)
        # the loss and the backward pass share "backward_ms"
        with span("train.loss", timings, "backward_ms", dev):
            losses = sequence_alignment_loss(img1, fwd["output_H"],
                                             fwd["flow_predictions"], occ,
                                             loss_cfg, world)
        with span("train.backward", timings, "backward_ms", dev):
            for p in state.params.values():
                p.grad = None
            losses["total"].backward()
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in state.params.items()}
            for p in state.params.values():
                p.grad = None
        return {k: v.detach() for k, v in losses.items()}, grads

    def apply_gradients(state: TrainState, metrics: dict, grads: dict,
                        timings: Optional[dict] = None):
        """Clip + AdamW with `grads`; metrics gain grad_norm, the raw
        gradients' global norm."""
        dev = next(iter(state.params.values())).device
        with span("train.update", timings, "update_ms", dev):
            with torch.no_grad():
                grad_norm = global_norm(list(grads.values()))
            updates, opt_state = tx.update(grads, state.opt_state,
                                           state.params)
            apply_updates(state.params, updates)
        metrics["grad_norm"] = grad_norm
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=opt_state), metrics

    def train_step(state: TrainState, img1: torch.Tensor, img2: torch.Tensor,
                   timings: Optional[dict] = None):
        with span("train.step", root=state.step):
            metrics, grads = loss_and_grads(state, img1, img2, timings)
            return apply_gradients(state, metrics, grads, timings)

    train_step.loss_and_grads = loss_and_grads
    train_step.apply_gradients = apply_gradients
    return train_step


# ------------------------------ checkpointing -------------------------------


def save_checkpoint(path: str, state: TrainState) -> None:
    """One torch.save file: step, trained tensors, optimizer state (CPU)."""
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
    torch.save({"step": state.step, "params": cpu(state.params),
                "opt_state": {"count": state.opt_state.count,
                              "mu": cpu(state.opt_state.mu),
                              "nu": cpu(state.opt_state.nu)}}, path)


def restore_checkpoint(path: str, template: TrainState) -> TrainState:
    """The saved state, its tensors copied into `template`'s (the models'
    parameters, in place) and its moments onto their device; raises unless
    the saved tensors are exactly the template's, by name and shape."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    saved = blob["params"]
    if sorted(saved) != sorted(template.params) or any(
            saved[k].shape != p.shape for k, p in template.params.items()):
        raise KeyError(f"{path}: its trained tensors are not the model's")
    with torch.no_grad():
        for k, p in template.params.items():
            p.copy_(saved[k])
    dev = lambda d: {k: d[k].to(template.params[k].device)
                     for k in template.params}
    o = blob["opt_state"]
    return TrainState(step=int(blob["step"]), params=template.params,
                      opt_state=OptState(count=int(o["count"]),
                                         mu=dev(o["mu"]), nu=dev(o["nu"])))
