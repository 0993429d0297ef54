"""TransRef training (port of stitchax/train/transref_trainer.py).

The objective is 1 L1 + 0.04 VGG-perceptual + 250 style-Gram on the raw
model output against the ground-truth image (`TransRefLossConfig`, passed
to `models.vgg.transref_total_loss` in place of its 0.1 default), then
optax.adam(lr) (`optim.Adam`). The masked input is prepared as stitchax's
`set_input` does (`prepare_inputs`: hole pixels take the image's mean over
its visible pixels). Holes are rectangles: `rect_masks` rasterises given
boxes as stitchax's `random_rect_masks` does, and `draw_rect_boxes` draws
the boxes with stitchax's bounds from a `torch.Generator` (stitchax draws
them with `jax.random`, which the port does not reproduce).

A step keeps the trained tensors in a dict keyed by TransRef's state_dict
names (`TrainState`), runs the forward under autograd, the VGG on the
target without gradient, one backward and the Adam update in place. The
checkpoint (`save_checkpoint`) and the weights export (`export_msgpack`)
keep the tensors under stitchax's key strings in flax's layouts, so the
export is a flax msgpack that stitchax's `make_default_transref_apply` and
the port's `StitchModels.from_npz(..., transref=...)` both load.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from .. import convert
from ..models.vgg import transref_total_loss
from .optim import Adam, OptState, apply_updates
from ..utils.tracing import span
from .trainer import TrainState


@dataclass(frozen=True)
class TransRefLossConfig:
    lambda_l1: float = 1.0
    lambda_perceptual: float = 0.04
    lambda_style: float = 250.0


def draw_rect_boxes(generator: torch.Generator, batch: int, size: int,
                    num_rects: int = 3, max_frac: float = 0.5
                    ) -> Tuple[torch.Tensor, ...]:
    """(x0, y0, w, h), each (batch, num_rects) int64 on the generator's
    device: x0 and y0 in [0, size - 8), w and h in [8, int(size max_frac)),
    stitchax's bounds."""
    max_side = int(size * max_frac)
    shape = (batch, num_rects)
    dev = generator.device
    x0 = torch.randint(0, size - 8, shape, generator=generator, device=dev)
    y0 = torch.randint(0, size - 8, shape, generator=generator, device=dev)
    w = torch.randint(8, max_side, shape, generator=generator, device=dev)
    h = torch.randint(8, max_side, shape, generator=generator, device=dev)
    return x0, y0, w, h


def rect_masks(x0: torch.Tensor, y0: torch.Tensor, w: torch.Tensor,
               h: torch.Tensor, size: int) -> torch.Tensor:
    """The union of the boxes of each batch item as a (B, S, S, 1) float32
    mask, 1 = hole (stitchax's random_rect_masks:44-51)."""
    xs = torch.arange(size, device=x0.device)
    mask = torch.zeros(x0.shape[0], size, size, device=x0.device)
    for r in range(x0.shape[1]):
        in_x = ((xs[None, None, :] >= x0[:, r, None, None])
                & (xs[None, None, :] < (x0 + w)[:, r, None, None]))
        in_y = ((xs[None, :, None] >= y0[:, r, None, None])
                & (xs[None, :, None] < (y0 + h)[:, r, None, None]))
        mask = torch.maximum(mask, (in_x & in_y).float())
    return mask[..., None]


def prepare_inputs(gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Hole pixels replaced by the image's mean over its visible pixels
    (the divisor at least 1, for a mask that covers the whole image); gt in
    [-1, 1] (B, H, W, 3), mask (B, H, W, 1)."""
    vis = 1.0 - mask
    mean = (gt * vis).sum((1, 2)) / vis.sum((1, 2)).clamp(min=1.0)
    return gt * vis + mean[:, None, None, :] * mask


def create_train_state(model: nn.Module, lr: float
                       ) -> Tuple[TrainState, Adam]:
    """The state over `model`'s parameters (already on their device) and
    optax.adam(lr)."""
    params = dict(model.named_parameters())
    tx = Adam(lr)
    return TrainState(step=0, params=params, opt_state=tx.init(params)), tx


def make_transref_train_step(model: nn.Module, vgg: Callable, tx: Adam,
                             cfg: TransRefLossConfig = TransRefLossConfig(),
                             total_loss: Callable = transref_total_loss):
    """Returns train_step(state, gt, ref, mask, timings=None) -> (state,
    metrics): gt / ref in [-1, 1] NHWC, mask (B, S, S, 1); metrics total /
    l1 / perceptual / style, 0-dim tensors on the device. With a `timings`
    dict the step adds ms of its forward, loss (the VGG's two forwards),
    backward and Adam (synchronizing between them). The step forces no
    host-device sync: with the tracer on it is the root span
    `transref.step` (root = the state's step) over `transref.forward`,
    `.loss`, `.backward` and `.adam`."""

    def loss_and_grads(state: TrainState, gt, ref, mask,
                       timings: Optional[dict] = None, world=None):
        """(losses, {name: gradient}) at the state's tensors. The losses
        are means over the batch, so a rank's block needs nothing of the
        other ranks' (`world` is not read): averaging the blocks'
        gradients gives the global batch's."""
        dev = gt.device
        with span("transref.forward", timings, "forward_ms", dev):
            out = model(prepare_inputs(gt, mask), mask, ref)
        with span("transref.loss", timings, "loss_ms", dev):
            losses = total_loss(vgg, out, gt, mask, l1_weight=cfg.lambda_l1,
                                perc_weight=cfg.lambda_perceptual,
                                style_weight=cfg.lambda_style)
        with span("transref.backward", timings, "backward_ms", dev):
            names = list(state.params)
            grads = torch.autograd.grad(
                losses["total"], [state.params[n] for n in names],
                allow_unused=True)
            grads = {n: torch.zeros_like(state.params[n]) if g is None
                     else g for n, g in zip(names, grads)}
        return {k: v.detach() for k, v in losses.items()}, grads

    def apply_gradients(state: TrainState, metrics: dict, grads: dict,
                        timings: Optional[dict] = None):
        with span("transref.adam", timings, "adam_ms",
                  metrics["total"].device):
            updates, opt_state = tx.update(grads, state.opt_state,
                                           state.params)
            apply_updates(state.params, updates)
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=opt_state), metrics

    def train_step(state: TrainState, gt, ref, mask,
                   timings: Optional[dict] = None):
        with span("transref.step", root=state.step):
            metrics, grads = loss_and_grads(state, gt, ref, mask, timings)
            return apply_gradients(state, metrics, grads, timings)

    train_step.loss_and_grads = loss_and_grads
    train_step.apply_gradients = apply_gradients
    return train_step


# -------------------- stitchax's names, checkpoints, export -----------------


def conv_transpose_names(model: nn.Module):
    return {n for n, m in model.named_modules()
            if isinstance(m, nn.ConvTranspose2d)}


def to_stitchax(tensors: Dict[str, torch.Tensor], conv_transpose
                ) -> Dict[str, torch.Tensor]:
    """Port-named tensors -> {stitchax key string: float32 CPU tensor in
    flax's layout} (convert.params_to_jax, flattened)."""
    tree = convert.params_to_jax(tensors, conv_transpose)
    return {convert._keystr(p): torch.from_numpy(a)
            for p, a in convert._flatten(tree)}


def from_stitchax(flat: Dict[str, Any], conv_transpose
                  ) -> Dict[str, torch.Tensor]:
    """The inverse of `to_stitchax`."""
    tree: Dict[str, Any] = {}
    for key, t in flat.items():
        *mods, leaf = convert._key_path(key)
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = t.numpy() if isinstance(t, torch.Tensor) else t
    return convert.params_from_jax(tree, conv_transpose)


def save_checkpoint(path: str, state: TrainState, model: nn.Module,
                    data: Dict[str, int]) -> None:
    """One torch.save file: the step, the trained tensors and Adam's
    moments under stitchax's key strings (flax layouts), the update count,
    and `data` (the data order: seed, batch size, batches taken)."""
    ct = conv_transpose_names(model)
    o = state.opt_state
    torch.save({"step": state.step, "params": to_stitchax(state.params, ct),
                "opt_state": {"count": o.count, "mu": to_stitchax(o.mu, ct),
                              "nu": to_stitchax(o.nu, ct)},
                "data": dict(data)}, path)


def restore_checkpoint(path: str, template: TrainState, model: nn.Module
                       ) -> Tuple[TrainState, Dict[str, int]]:
    """(the saved state, its tensors copied into `template`'s in place and
    its moments onto their device; the saved data order). Raises unless the
    saved tensors are exactly the template's, by name and shape."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    ct = conv_transpose_names(model)
    saved = from_stitchax(blob["params"], ct)
    if sorted(saved) != sorted(template.params) or any(
            saved[k].shape != p.shape for k, p in template.params.items()):
        raise KeyError(f"{path}: its trained tensors are not the model's")
    with torch.no_grad():
        for k, p in template.params.items():
            p.copy_(saved[k])
    o = blob["opt_state"]
    dev = lambda flat: {k: v.to(template.params[k].device)
                        for k, v in from_stitchax(flat, ct).items()}
    state = TrainState(step=int(blob["step"]), params=template.params,
                       opt_state=OptState(count=int(o["count"]),
                                          mu=dev(o["mu"]), nu=dev(o["nu"])))
    return state, blob["data"]


def export_msgpack(path: str, model: nn.Module) -> None:
    """The model's parameters as a flax msgpack of {'params': ...} in
    float32 (stitchax's checkpoint format for TransRef)."""
    convert.save_flax_msgpack(path, convert.params_to_jax(
        dict(model.named_parameters()), conv_transpose_names(model)))
