"""stitchax_torch.parallel: data parallelism over torch.distributed (port
of stitchax/parallel/). One process per rank; the parameters are
replicated, each rank takes a contiguous block of the global batch, the
train step all-reduces the gradient before the optimizer's update, and
the evaluation and the stitch gather the per-pair outputs in the global
order."""

from .mesh import (World, all_gather_batch, all_reduce_mean_, all_sum,
                   cli_world,
                   make_mesh, make_parallel_eval_step,
                   make_parallel_stitch_step, make_parallel_train_step,
                   pad_to_world, shard_batch, world_requested)

__all__ = [k for k in dir() if not k.startswith("_")]
