"""Training steps for the reduced-scale SD inpainting stack (port of
stitchax/train/sd_inpaint_trainer.py).

Two phases, as stitchax trains the stack behind results/sd_ckpt_r05.pt:
the VAE as a deterministic autoencoder (L1 + MSE of `vae(x)` against x in
[-1, 1], through encode_mode and decode), then the UNet and ControlNet
together with the epsilon-prediction objective on inpainting tasks, the
VAE frozen. The conditioning is what the inference pipeline builds
(`models.sd_pipeline.make_sd_inpaint_fn`): the UNet sees [noisy latents |
hole mask latent | masked-image latents], the ControlNet the noisy latents
and the [0, 1] image with its holes at -1. Both steps run Adam
(`optim.Adam`, optax.adam).

Inputs are NHWC as stitchax's (image (B, H, W, 3), hole (B, H, W, 1) with
1 = hole); the nets run NCHW. The diffusion step draws its timesteps in
[1, T) and its noise from a `torch.Generator`, or takes them from the
caller (stitchax draws them with jax.random, which the port does not
reproduce). `save_sd_checkpoint` packs the nets as stitchax's
`save_jax_sd_checkpoint` does: a torch.save container of format
"stitchax_jax" that the port's and stitchax's `load_sd_checkpoint` read.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .. import convert
from ..models.diffusion import ddim_schedule
from ..models.vae import AutoencoderKL
from ..ops.sampling import image_resize
from .optim import Adam, apply_updates
from ..utils.tracing import span
from .trainer import TrainState


def sd_alphas_cumprod(num_train_steps: int = 1000) -> np.ndarray:
    """The SD-1.5 scaled-linear alphas_cumprod, float32: at 1000 steps
    stitchax's own values, carried (`ddim_schedule`)."""
    return ddim_schedule(num_train_steps, 1)[1]


@torch.no_grad()
def init_weights(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """The port's seeded initialisers, in flax's defaults' form: kernels
    ~ N(0, 1 / fan_in), biases 0, norm scales 1, and the ControlNet's
    zero convs (`hint_out`, `zero*`) 0, as stitchax initialises them;
    drawn from `generator` on its device, in parameter order."""
    for name, p in net.named_parameters():
        module = name.rsplit(".", 1)[0]
        if p.dim() == 1:
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        elif module == "hint_out" or module.startswith("zero"):
            p.zero_()
        else:
            w = torch.randn(p.shape, generator=generator,
                            device=generator.device)
            p.copy_(w * p[0].numel() ** -0.5)
    return net


def create_train_state(models: Dict[str, nn.Module], lr: float
                       ) -> Tuple[TrainState, Adam]:
    """The state over the parameters of `models` (already on their
    device), keyed "<model>.<parameter name>", and optax.adam(lr)."""
    params = {f"{k}.{n}": p for k, m in models.items()
              for n, p in m.named_parameters()}
    tx = Adam(lr)
    return TrainState(step=0, params=params, opt_state=tx.init(params)), tx


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _grads(loss: torch.Tensor, state: TrainState) -> Dict[str, torch.Tensor]:
    names = list(state.params)
    grads = torch.autograd.grad(loss, [state.params[n] for n in names],
                                allow_unused=True)
    return {n: torch.zeros_like(state.params[n]) if g is None else g
            for n, g in zip(names, grads)}


def _adam(state: TrainState, tx: Adam, grads, device, timings):
    with span("sd.adam", timings, "adam_ms", device):
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        apply_updates(state.params, updates)
    return TrainState(step=state.step + 1, params=state.params,
                      opt_state=opt_state)


def make_vae_train_step(vae: AutoencoderKL, tx: Adam) -> Callable:
    """train_step(state, x, timings=None) -> (state, metrics): x (B, H, W,
    3) in [-1, 1]; metrics total / l1 / l2, 0-dim tensors on the device.
    `train_step.loss_and_grads(state, x)` -> (metrics, {name: gradient})
    without the update."""

    def loss_and_grads(state: TrainState, x: torch.Tensor,
                       timings: Optional[dict] = None):
        with span("sd.vae_forward", timings, "forward_ms", x.device):
            x = _nchw(x)
            diff = vae(x) - x
            l1 = diff.abs().mean()
            l2 = diff.square().mean()
            total = l1 + l2
        with span("sd.vae_backward", timings, "backward_ms", x.device):
            grads = _grads(total, state)
        return {"total": total.detach(), "l1": l1.detach(),
                "l2": l2.detach()}, grads

    def train_step(state: TrainState, x: torch.Tensor,
                   timings: Optional[dict] = None):
        metrics, grads = loss_and_grads(state, x, timings)
        return _adam(state, tx, grads, x.device, timings), metrics

    train_step.loss_and_grads = loss_and_grads
    return train_step


def inpaint_model_inputs(vae: AutoencoderKL, image01: torch.Tensor,
                         hole: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The conditioning the inference pipeline builds, NCHW: (z0,
    masked-image latents, mask latent, control image) from image01 (B, H,
    W, 3) in [0, 1] and hole (B, H, W, 1), 1 = hole. The mask latent is
    jax.image.resize's "nearest" of the hole (source pixel 8i + 4 of a 1/8
    downscale, `ops.sampling.image_resize`)."""
    init = image01 * 2.0 - 1.0
    masked = init * (1.0 - hole)
    z0 = vae.encode_mode(_nchw(init))
    z_masked = vae.encode_mode(_nchw(masked))
    h8, w8 = z0.shape[2], z0.shape[3]
    mask_lat = image_resize(hole[..., 0].permute(1, 2, 0), h8, w8,
                            "nearest").permute(2, 0, 1)[:, None]
    control = image01 * (1.0 - hole) + (-1.0) * hole
    return z0, z_masked, mask_lat, _nchw(control)


def draw_t_eps(generator: torch.Generator, batch: int, latent_shape,
               num_train_steps: int = 1000) -> Tuple[torch.Tensor, ...]:
    """(t (B,) int64 in [1, num_train_steps), eps (B, 4, h8, w8) standard
    normal) from `generator`, on its device."""
    dev = generator.device
    t = torch.randint(1, num_train_steps, (batch,), generator=generator,
                      device=dev)
    eps = torch.randn((batch, *latent_shape), generator=generator,
                      device=dev)
    return t, eps


def make_diffusion_train_step(unet: nn.Module, cnet: nn.Module,
                              vae: AutoencoderKL, tx: Adam,
                              context: torch.Tensor,
                              num_train_steps: int = 1000) -> Callable:
    """Epsilon-prediction MSE over UNet and ControlNet jointly, the VAE
    frozen (its latents under no_grad).

    train_step(state, image01, hole, generator=None, t=None, eps=None,
    timings=None) -> (state, metrics {"total", "mse"}): t and eps are drawn
    from `generator` (`draw_t_eps`) unless both are given, t (B,) ints,
    eps (B, 4, H/8, W/8). With a `timings` dict the step adds ms of the
    VAE's encodes, the ControlNet + UNet forward, the backward and Adam,
    synchronizing between them. `train_step.loss_and_grads(state,
    image01, hole, t, eps)` -> (metrics, {name: gradient})."""
    acp_np = sd_alphas_cumprod(num_train_steps)
    acp_by_device: Dict[torch.device, torch.Tensor] = {}

    def loss_and_grads(state: TrainState, image01, hole, t, eps,
                       timings: Optional[dict] = None):
        dev = image01.device
        with span("sd.vae_encode", timings, "vae_encode_ms", dev):
            with torch.no_grad():
                z0, z_masked, mask_lat, control = inpaint_model_inputs(
                    vae, image01, hole)
        with span("sd.forward", timings, "forward_ms", dev):
            if dev not in acp_by_device:
                acp_by_device[dev] = torch.from_numpy(acp_np).to(dev)
            a_t = acp_by_device[dev][t][:, None, None, None]
            lat_t = torch.sqrt(a_t) * z0 + torch.sqrt(1.0 - a_t) * eps
            inp = torch.cat([lat_t, mask_lat, z_masked], 1)
            tb = t.to(torch.float32)
            ctx = context.expand(z0.shape[0], *context.shape[1:])
            res, mid = cnet(lat_t, tb, ctx, control)
            eps_hat = unet(inp, tb, ctx, res, mid)
            mse = (eps_hat - eps).square().mean()
        with span("sd.backward", timings, "backward_ms", dev):
            grads = _grads(mse, state)
        return {"total": mse.detach(), "mse": mse.detach()}, grads

    def train_step(state: TrainState, image01, hole,
                   generator: Optional[torch.Generator] = None, t=None,
                   eps=None, timings: Optional[dict] = None):
        if t is None or eps is None:
            B, H, W, _ = image01.shape
            t, eps = draw_t_eps(generator, B, (vae.latent_channels, H // 8,
                                               W // 8), num_train_steps)
            t, eps = t.to(image01.device), eps.to(image01.device)
        metrics, grads = loss_and_grads(state, image01, hole, t, eps,
                                        timings)
        return _adam(state, tx, grads, image01.device, timings), metrics

    train_step.loss_and_grads = loss_and_grads
    return train_step


def save_sd_checkpoint(path: str, unet: nn.Module, cnet: nn.Module,
                       vae: nn.Module, context: torch.Tensor,
                       unet_kw: Dict[str, Any], vae_kw: Dict[str, Any],
                       preferred_strength: Optional[float] = None) -> None:
    """The nets packed as stitchax's save_jax_sd_checkpoint packs them: a
    torch.save dict of format "stitchax_jax" with the configs, each net's
    variables in flax's layout as float32 numpy arrays, the (1, 77, C)
    context and, when given, the preferred strength."""
    tree = lambda m: convert.params_to_jax(m.state_dict())
    blob = {
        "format": "stitchax_jax",
        "configs": {"unet": dict(unet_kw), "vae": dict(vae_kw)},
        "unet_vars": tree(unet),
        "controlnet_vars": tree(cnet),
        "vae_vars": tree(vae),
        "context": context.detach().to("cpu", torch.float32).numpy(),
    }
    if preferred_strength is not None:
        blob["preferred_strength"] = float(preferred_strength)
    torch.save(blob, path)
