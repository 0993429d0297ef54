"""Optimizer and schedule (port of stitchax/train/optim.py, which is optax).

`fetch_optimizer` returns an `Optimizer` that computes what stitchax's
optax chain does, value for value where it can: clip by global norm
(`t / norm * clip` when norm >= clip), then AdamW (eps outside the square
root, bias correction at count + 1, decoupled weight decay on every
trained tensor, the learning rate of the schedule at the update count),
with the reference's lower-rate group for pretrained encoders
(`twins_lr_factor`: optax's `multi_transform`, so each group is clipped by
its own norm). `Adam` is `optax.adam(lr)` (the TransRef trainer's), on the
same moments code (`adam_moments`). They work on dicts of tensors, as optax
works on trees, and `apply_updates` adds the updates in place.
`onecycle_schedule` gives optax's float32 one-cycle values as the jitted
train step computes them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.tracing import count_sync, span

B1, B2 = 0.9, 0.999         # optax.adamw's defaults

f32 = np.float32


@dataclass(frozen=True)
class OptimConfig:
    """Defaults = reference trainer block (configs/last_config.py)."""
    canonical_lr: float = 3.125e-6
    num_steps: int = 31323
    adamw_decay: float = 1e-4
    epsilon: float = 1e-8
    clip: float = 1.0
    pct_start: float = 0.05
    anneal_strategy: str = "linear"
    twins_lr_factor: Optional[float] = None
    batch_scale: int = 1  # lr scales with global batch like the reference CLI


def onecycle_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """count -> learning rate: optax's `linear_onecycle_schedule` (pct_final
    1.0) or `cosine_onecycle_schedule` over num_steps + 100 steps, div 25,
    final div 1e4.

    optax interpolates between the cumulative products of the boundary
    scales (float64 numpy, rounded to float32). Inside stitchax's jitted
    train step (a scalar count) XLA folds the linear piece to
    fma((end - start) * (1 / size), count - b, start) in float32, which is
    emulated here: the shipped schedule's counts give optax's float32
    values. The cosine piece takes float32's cos."""
    lr = cfg.canonical_lr * cfg.batch_scale
    T = cfg.num_steps + 100
    if cfg.anneal_strategy == "linear":
        # optax's dict {int(pct_start T): 25, int(1.0 T): 1/25, T: 1e-4}
        # holds T once, with the last scale
        scales = {int(cfg.pct_start * T): 25.0, int(1.0 * T): 1.0 / 25.0}
        scales[T] = 1.0 / 1e4
    else:
        scales = {int(cfg.pct_start * T): 25.0, T: 1.0 / (25.0 * 1e4)}
    bounds = [0, *sorted(scales)]
    values = np.cumprod([lr / 25.0, *(scales[b] for b in bounds[1:])])
    cosine = cfg.anneal_strategy != "linear"

    def schedule(count: int) -> float:
        if count >= bounds[-1]:
            return float(f32(values[-1]))
        i = max(j for j in range(len(bounds) - 1) if bounds[j] <= count)
        start, end = f32(values[i]), f32(values[i + 1])
        recip = f32(1.0) / f32(bounds[i + 1] - bounds[i])
        if cosine:
            pct = f32(count - bounds[i]) * recip
            c = f32(np.cos(f32(math.pi) * pct))
            return float(end + (start - end) / f32(2.0) * (c + f32(1.0)))
        # the slope: float32(end - start) of the float64 values times the
        # rounded reciprocal; then one FMA (exact product in float64)
        slope = f32(f32(values[i + 1] - values[i]) * recip)
        return float(f32(np.float64(slope) * np.float64(count - bounds[i])
                         + np.float64(start)))

    return schedule


@dataclass
class OptState:
    """AdamW's moments of each trained tensor and the update count."""
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    if not tensors:
        return torch.zeros(())
    return torch.stack([(t * t).sum() for t in tensors]).sum().sqrt()


def clip_by_global_norm(tensors: List[torch.Tensor], clip: float
                        ) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: the tensors as they are when their global
    norm is below `clip`, else each `t / norm * clip`."""
    norm = global_norm(tensors)
    count_sync(norm.device)             # bool() waits for the norm
    if bool(norm < clip):
        return list(tensors)
    return list(torch._foreach_mul(torch._foreach_div(tensors, norm), clip))


def init_state(params: Dict[str, torch.Tensor]) -> OptState:
    """Zero moments for every tensor, count 0."""
    zeros = lambda: {k: torch.zeros_like(
        p, memory_format=torch.preserve_format) for k, p in params.items()}
    return OptState(count=0, mu=zeros(), nu=zeros())


def adam_moments(g: List[torch.Tensor], mu: List[torch.Tensor],
                 nu: List[torch.Tensor], count_inc: int, eps: float):
    """optax.scale_by_adam on lists of tensors: the new first and second
    moments and the direction m_hat / (sqrt(v_hat) + eps), bias-corrected
    at `count_inc` (eps outside the root, as optax's eps_root = 0)."""
    bc1 = float(f32(1.0) - f32(B1) ** f32(count_inc))
    bc2 = float(f32(1.0) - f32(B2) ** f32(count_inc))
    m = torch._foreach_add(torch._foreach_mul(g, 1.0 - B1),
                           torch._foreach_mul(mu, B1))
    v = torch._foreach_add(
        torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - B2),
        torch._foreach_mul(nu, B2))
    m_hat = torch._foreach_div(m, bc1)
    v_hat = torch._foreach_div(v, bc2)
    u = torch._foreach_div(
        m_hat, torch._foreach_add(torch._foreach_sqrt(v_hat), eps))
    return m, v, u


class Optimizer:
    """clip_by_global_norm -> adamw, per group of trained tensors: "rest"
    at the schedule's rate and, with `twins_lr_factor` and an
    `encoder_mask`, "encoder" at that factor of it."""

    def __init__(self, cfg: OptimConfig,
                 encoder_mask: Optional[Callable[[str], bool]] = None):
        self.cfg = cfg
        self.schedule = onecycle_schedule(cfg)
        self.encoder_mask = (encoder_mask if cfg.twins_lr_factor is not None
                             else None)

    def groups(self, names) -> List[Tuple[List[str], float]]:
        """[(names, lr factor)] in the order given."""
        if self.encoder_mask is None:
            return [(list(names), 1.0)]
        enc = [n for n in names if self.encoder_mask(n)]
        rest = [n for n in names if not self.encoder_mask(n)]
        return [(g, f) for g, f in ((enc, self.cfg.twins_lr_factor),
                                    (rest, 1.0)) if g]

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        return init_state(params)

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: OptState,
               params: Dict[str, torch.Tensor]
               ) -> Tuple[Dict[str, torch.Tensor], OptState]:
        """(updates to add to the params, the next state), as optax's
        `tx.update(grads, opt_state, params)`."""
        cfg = self.cfg
        count_inc = state.count + 1
        lr = self.schedule(state.count)
        mu, nu, updates = dict(state.mu), dict(state.nu), {}
        for names, factor in self.groups(list(grads)):
            with span("train.clip"):
                g = clip_by_global_norm([grads[n] for n in names], cfg.clip)
            with span("train.adamw"):
                m, v, u = adam_moments(g, [mu[n] for n in names],
                                       [nu[n] for n in names], count_inc,
                                       cfg.epsilon)
                u = torch._foreach_add(u, torch._foreach_mul(
                    [params[n] for n in names], cfg.adamw_decay))
                step = -float(f32(lr) * f32(factor))
                u = torch._foreach_mul(u, step)
            for n, mi, vi, ui in zip(names, m, v, u):
                mu[n], nu[n], updates[n] = mi, vi, ui
        return updates, OptState(count=count_inc, mu=mu, nu=nu)


class Adam:
    """optax.adam(lr) (b1 0.9, b2 0.999, eps 1e-8 outside the root): the
    updates are -lr times `adam_moments`' direction."""

    def __init__(self, lr: float, eps: float = 1e-8):
        self.lr, self.eps = lr, eps

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        return init_state(params)

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: OptState,
               params: Optional[Dict[str, torch.Tensor]] = None
               ) -> Tuple[Dict[str, torch.Tensor], OptState]:
        names = list(grads)
        m, v, u = adam_moments([grads[n] for n in names],
                               [state.mu[n] for n in names],
                               [state.nu[n] for n in names],
                               state.count + 1, self.eps)
        u = torch._foreach_mul(u, -float(f32(self.lr)))
        return (dict(zip(names, u)),
                OptState(count=state.count + 1, mu=dict(zip(names, m)),
                         nu=dict(zip(names, v))))


def apply_updates(params: Dict[str, torch.Tensor],
                  updates: Dict[str, torch.Tensor]) -> None:
    """params += updates, in place (optax.apply_updates)."""
    with torch.no_grad():
        names = list(updates)
        torch._foreach_add_([params[n] for n in names],
                            [updates[n] for n in names])


def fetch_optimizer(cfg: OptimConfig,
                    encoder_mask: Optional[Callable[[str], bool]] = None
                    ) -> Optimizer:
    """AdamW + OneCycle + clip; `encoder_mask(name) -> bool` selects the
    pretrained-encoder tensors of the lower-rate group (the reference's
    twins_lr_factor split, core/optimizer/__init__.py:22-33)."""
    return Optimizer(cfg, encoder_mask)
