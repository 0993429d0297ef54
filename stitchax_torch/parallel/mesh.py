"""The process group, batch sharding and the data-parallel step wrappers
(port of stitchax/parallel/mesh.py).

stitchax replicates the parameters over a 1-D device mesh, shards the pair
batch on its leading axis, and lets XLA insert the gradient psum inside
one jitted program over the global batch. Here each rank is a process
(torchrun's RANK / WORLD_SIZE / LOCAL_RANK, or explicit arguments) with
the whole model on its device. Rank r takes the contiguous block
[r B/R, (r+1) B/R) of the global batch, as NamedSharding(P("data")) lays
it out. The train step all-reduces the gradient before the optimizer's
update, so that clip-by-global-norm sees the global gradient; the losses
that normalize by a batch-wide count take it from all ranks
(`train.losses`). The evaluation and the stitch gather their per-pair
outputs in the global order. R ranks of B/R pairs thus equal one process
on B pairs.

The backend is `nccl` on the card by default and `gloo` on the CPU. NCCL
refuses two ranks on one device; gloo runs them, all-reducing CUDA tensors
as they are and gathering through the host (gloo gathers CPU tensors
only).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class World:
    """The data axis: `size` ranks, this process `rank` on `device`;
    `backend` None for one process without a process group."""
    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def any(self, flag: bool) -> bool:
        """True on every rank if it is true on any (e.g. a stop signal)."""
        if self.backend is None:
            return flag
        dev = self.device if self.backend == "nccl" else "cpu"
        t = torch.tensor([1.0 if flag else 0.0], device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def barrier(self) -> None:
        if self.backend is not None:
            dist.barrier()


def world_requested() -> bool:
    """True when the process was started as a rank (torchrun sets
    WORLD_SIZE)."""
    return "WORLD_SIZE" in os.environ


def make_mesh(backend: Optional[str] = None, device=None,
              init_method: Optional[str] = None, rank: Optional[int] = None,
              world_size: Optional[int] = None) -> World:
    """Join (or set up) the process group and return this rank's World.

    rank / world_size default to torchrun's RANK / WORLD_SIZE; the device
    to cuda:<LOCAL_RANK> (LOCAL_RANK defaults to the rank); the backend to
    nccl on a CUDA device and gloo on the CPU; init_method to env://
    (MASTER_ADDR / MASTER_PORT). A CUDA device that does not exist raises:
    a rank never carries on on the CPU."""
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", 1) if world_size is None
                     else world_size)
    rank = int(env.get("RANK", 0) if rank is None else rank)
    local_rank = int(env.get("LOCAL_RANK", rank))
    dev = torch.device(device if device is not None else f"cuda:{local_rank}")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if dev.index >= n:
            raise RuntimeError(f"rank {rank}: device {dev} does not exist "
                               f"({n} CUDA devices); pass --device")
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend nccl needs a CUDA device, not {dev}")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size)
    elif (dist.get_rank(), dist.get_world_size()) != (rank, world_size):
        raise RuntimeError("the process group is another world")
    return World(rank=rank, size=world_size, device=dev,
                 backend=dist.get_backend())


def cli_world(device: Optional[str], backend: Optional[str]) -> World:
    """A CLI's World from its --device / --backend: this rank's, with the
    process group joined, when the process runs as a rank (WORLD_SIZE
    set); else one process on `device` (default cuda:0), which must
    exist. TF32 goes off on a card (utils.precision.fp32_exact)."""
    from ..utils.precision import fp32_exact

    if world_requested():
        world = make_mesh(backend=backend, device=device)
    else:
        world = World(device=torch.device(device or "cuda:0"))
        if world.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"--device {world.device}: no CUDA device "
                                   "(pass --device cpu to run on the CPU)")
            torch.cuda.set_device(world.device)
    if world.device.type == "cuda":
        fp32_exact()
    return world


def _block(x, world: World):
    n = len(x)
    if n % world.size:
        raise ValueError(f"a batch of {n} does not split over {world.size} "
                         "ranks")
    b = n // world.size
    return x[world.rank * b:(world.rank + 1) * b]


def shard_batch(batch: Any, world: World) -> Any:
    """This rank's contiguous block of every leaf's leading axis (tensors,
    arrays and lists; dicts and tuples are walked). The global batch must
    be a multiple of the world size."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, world) for k, v in batch.items()}
    if isinstance(batch, tuple):
        return tuple(shard_batch(v, world) for v in batch)
    return _block(batch, world)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], world: World) -> None:
    """Average `tensors` over the ranks, in place, through one flat
    buffer (one collective). Nothing to do without a process group."""
    if world.backend is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= world.size
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def all_sum(t: torch.Tensor, world: World) -> torch.Tensor:
    """The sum of `t` over the ranks (a new tensor; `t` at one process)."""
    if world.backend is None:
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def all_gather_batch(x: torch.Tensor, world: World) -> torch.Tensor:
    """Every rank's block of a batch, concatenated in rank order: the
    global batch, on x's device."""
    if world.backend is None:
        return x
    t = (x.cpu() if world.backend == "gloo" else x).contiguous()
    parts = [torch.empty_like(t) for _ in range(world.size)]
    dist.all_gather(parts, t)
    return torch.cat(parts).to(x.device)


def _gather_tree(out: Any, world: World) -> Any:
    if isinstance(out, dict):
        return {k: _gather_tree(v, world) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_gather_tree(v, world) for v in out)
    return all_gather_batch(out, world)


def make_parallel_train_step(train_step: Callable, world: World) -> Callable:
    """A step over this rank's block of the global batch that takes the
    global batch's step: `train_step.loss_and_grads(state, *block,
    timings=, world=)` (the loss takes batch-wide counts from every rank),
    then the gradient averaged over the ranks, then
    `train_step.apply_gradients` (clip and optimizer on the global
    gradient). The metrics are the global batch's: averaged over the
    ranks before they are returned. Call it with this rank's block
    (`shard_batch`)."""

    def step(state, *block, timings: Optional[dict] = None):
        metrics, grads = train_step.loss_and_grads(state, *block,
                                                   timings=timings,
                                                   world=world)
        all_reduce_mean_(list(grads.values()), world)
        names = sorted(metrics)
        vec = torch.stack([metrics[k] for k in names])
        all_reduce_mean_([vec], world)
        metrics = dict(zip(names, vec.unbind(0)))
        return train_step.apply_gradients(state, metrics, grads, timings)

    return step


def make_parallel_eval_step(eval_step: Callable, world: World) -> Callable:
    """`eval_step(*block) -> tensor, or a tuple / dict of tensors, per
    pair` run on this rank's block of the global batch given (a multiple
    of the world size: pad first), its outputs gathered from every rank in
    the global order."""

    def step(*batch):
        return _gather_tree(eval_step(*shard_batch(batch, world)), world)

    return step


def make_parallel_stitch_step(step_fn: Callable, world: World) -> Callable:
    """The stitch path's per-pair step (`align.adapter.stitch_model_step`
    with its nets bound: (img1, img2) -> dict of per-pair leaves) over the
    ranks: each stitches its block, the leaves gathered in the global
    order. The step is per-pair independent, so no other collective is
    needed (stitchax/parallel/mesh.py:66)."""
    return make_parallel_eval_step(step_fn, world)


def pad_to_world(tensors: List[torch.Tensor], world: World):
    """Pad each tensor's leading axis to a multiple of the world size by
    repeating its last row (stitchax's evaluate.py:84-90); returns (the
    padded tensors, the true length)."""
    n = tensors[0].shape[0]
    pad = -n % world.size
    return [torch.cat([t, t[-1:].expand(pad, *t.shape[1:])]) if pad else t
            for t in tensors], n
