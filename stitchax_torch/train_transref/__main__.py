"""The TransRef trainer's CLI: train_transref.py.

    python -m stitchax_torch.train_transref --data_dir UDIS-D/

Under `python -m torch.distributed.run --nproc_per_node R` it trains
data-parallel, as train_transref.py does over its devices: every rank reads
the same global batch and draws the same holes, takes its block of
`batch_size / R` pairs, and averages the gradient over the ranks before
Adam (`parallel.make_parallel_train_step`; the losses are batch means, so
equal blocks give the global batch's gradient). Only rank 0 writes files.
Each rank runs on cuda:<LOCAL_RANK> (or `--device`); `--backend` as
`python -m stitchax_torch.train`'s.

Trains TransRef (reference-guided inpainting) on
`{data_dir}/training/input{1,2}/*.jpg`: input1 is the ground truth, input2
the reference (`--ref_from self`: the ground truth itself), holes are
random rectangles, the objective 1 L1 + 0.04 VGG-perceptual + 250
style-Gram, Adam at `--lr`; 512^2, batch 4 by default, in fp32 with TF32
off. train_transref.py's flags, plus `--device` (default cuda:0; `cpu` for
tests) and `--backend`. Writes `{ckpt_dir}/transref_metrics.jsonl`, a resumable
`step_<8 digits>.pt` every `save_every` steps, at the end and on a first
SIGTERM / SIGINT (the step in flight finishes first; a second signal stops
at once), and at the end `final_transref.msgpack`: the weights as a flax
msgpack of float32 leaves, which `StitchModels.from_npz(...,
transref=...)`, stitchax's `make_default_transref_apply(ckpt=...)` and
`python -m stitchax_torch.out --transref_ckpt` read.

Where it departs from train_transref.py: TransRef starts from the port's
initialisers and, without `--vgg_ckpt`, the VGG from flax's default
initialisers (kernels ~ N(0, 1 / fan_in)), both seeded with `--seed`, not
from flax's draws; the hole rectangles are drawn from a torch.Generator
seeded with seed + 1, within stitchax's bounds; checkpoints are `.pt`
files, not orbax directories; a resumed run continues the data order and
the rectangle draws where the saved run stood (train_transref.py restarts
both). `--vgg_ckpt` is a torchvision vgg16 state dict, loaded natively.
"""

from __future__ import annotations

import argparse
import os
import signal
from typing import List, Optional

import numpy as np


def get_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m stitchax_torch.train_transref")
    p.add_argument("--data_dir", type=str, required=True,
                   help="UDIS-D-layout root ({training|testing}/input{1,2})")
    p.add_argument("--num_steps", type=int, default=100000)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--image_size", type=int, default=512,
                   help="square resize; the reference trains at 512")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--ckpt_dir", type=str, default="./checkpoints/transref")
    p.add_argument("--save_every", type=int, default=5000)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--resume", type=str, default=None,
                   help="a step_<N>.pt checkpoint of this trainer")
    p.add_argument("--vgg_ckpt", type=str, default=None,
                   help="torchvision vgg16 state dict (.pth) for the "
                        "perceptual/style loss; random VGG if absent")
    p.add_argument("--ref_from", choices=["pair", "self"], default="pair")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda:0, a rank's "
                        "cuda:<LOCAL_RANK>; 'cpu' for tests)")
    p.add_argument("--backend", type=str, default=None,
                   choices=["nccl", "gloo"],
                   help="process group backend of a data-parallel run "
                        "(default nccl on the card, gloo on the CPU)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = get_args(argv)
    import torch

    from ..data.udis import PrefetchLoader, UDISDataset
    from ..models.transref import TransRefBase
    from ..models.vgg import VGG16Features, load_torchvision_features
    from ..train.transref_trainer import (TransRefLossConfig,
                                          create_train_state,
                                          draw_rect_boxes, export_msgpack,
                                          make_transref_train_step,
                                          rect_masks, restore_checkpoint,
                                          save_checkpoint)
    from ..parallel import cli_world, make_parallel_train_step, shard_batch
    from ..utils.logger import Logger, NullLogger

    world = cli_world(args.device, args.backend)
    device = world.device
    if args.batch_size % world.size:
        raise ValueError(f"batch {args.batch_size} does not split over "
                         f"{world.size} ranks")
    S = args.image_size
    torch.manual_seed(args.seed)
    model = TransRefBase()
    vgg = VGG16Features()
    if args.vgg_ckpt:
        sd = torch.load(args.vgg_ckpt, map_location="cpu", weights_only=True)
        load_torchvision_features(vgg, sd)
        print(f"loaded VGG16 features from {args.vgg_ckpt}")
    else:
        vgg.reset_parameters(torch.Generator().manual_seed(args.seed))
        print("WARNING: random-init VGG16 — perceptual/style terms are "
              "untrained-feature losses (supply --vgg_ckpt for the "
              "reference objective)")
    model.to(device)
    vgg.to(device).requires_grad_(False)

    state, tx = create_train_state(model, args.lr)
    data = {"seed": args.seed, "batch_size": args.batch_size, "batches": 0}
    if args.resume:
        state, data = restore_checkpoint(os.path.abspath(args.resume), state,
                                         model)
        if data["batch_size"] != args.batch_size:
            raise ValueError(f"--resume {args.resume}: saved at batch "
                             f"{data['batch_size']}, not {args.batch_size}")
        print(f"resumed from {args.resume} at step {state.step}")
    step_fn = make_transref_train_step(model, vgg, tx, TransRefLossConfig())
    if world.backend is not None:
        step_fn = make_parallel_train_step(step_fn, world)

    ds = UDISDataset(args.data_dir, phase="training", is_test=True,
                     size=(S, S))
    loader = PrefetchLoader(ds, batch_size=args.batch_size, shuffle=True,
                            num_workers=8, drop_last=True, seed=data["seed"])
    if len(loader) == 0:
        raise ValueError(f"{args.data_dir}: {len(ds)} training pairs make "
                         f"no batch of {args.batch_size}")
    if world.is_main:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        logger = Logger(log_dir=args.ckpt_dir, name="transref",
                        sum_freq=args.log_every)
    else:
        logger = NullLogger()
    where = (f"{world.size} ranks ({world.backend}; rank 0 on {device})"
             if world.backend else f"1 device ({device})")
    logger.info(f"TransRef training: {args.num_steps} steps, batch "
                f"{args.batch_size} at {S}², {len(ds)} pairs, {where}")

    stop_requested = []

    def _request_stop(signum, frame):
        stop_requested.append(signum)
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        signal.signal(signal.SIGINT, signal.default_int_handler)
        logger.info(f"signal {signum}: stopping after the current step "
                    "(next signal kills immediately)")

    signal.signal(signal.SIGTERM, _request_stop)
    signal.signal(signal.SIGINT, _request_stop)

    step = state.step
    boxes = torch.Generator().manual_seed(data["seed"] + 1)
    if data["batches"]:            # continue where the saved run stood
        loader.skip(data["batches"])
        for _ in range(data["batches"]):
            draw_rect_boxes(boxes, args.batch_size, S)
    to_unit = lambda x: torch.from_numpy(np.asarray(x, np.uint8)).to(
        device).float() / 127.5 - 1.0
    # a signal to any rank stops every rank after the same step
    stop = lambda: world.any(bool(stop_requested))
    while step < args.num_steps and not stop():
        for batch in loader:
            if step >= args.num_steps or stop():
                break
            # every rank draws the global batch's holes, then takes its
            # block of pairs and holes
            drawn = draw_rect_boxes(boxes, len(batch["image1"]), S)
            im1, im2 = batch["image1"], batch["image2"]
            if world.backend is not None:
                im1, im2, drawn = shard_batch((im1, im2, drawn), world)
            gt = to_unit(im1)
            ref = gt if args.ref_from == "self" else to_unit(im2)
            mask = rect_masks(*(t.to(device) for t in drawn), S)
            state, metrics = step_fn(state, gt, ref, mask)
            step += 1
            data["batches"] += 1
            names = sorted(metrics)
            vec = torch.stack([metrics[k] for k in names]).cpu().numpy()
            logger.push(dict(zip(names, vec)), step=step)
            stopping = stop()
            if world.is_main and (
                    step % args.save_every == 0 or step == args.num_steps
                    or stopping):
                path = os.path.abspath(os.path.join(
                    args.ckpt_dir, f"step_{step:08d}.pt"))
                save_checkpoint(path, state, model, data)
                logger.info(f"saved checkpoint {path}")

    if stop_requested:
        logger.info(f"stopped early at step {step} on signal "
                    f"{stop_requested[0]}")
    if world.is_main:
        final = os.path.abspath(os.path.join(args.ckpt_dir,
                                             "final_transref.msgpack"))
        export_msgpack(final, model)
        logger.info(f"exported flax msgpack weights {final}")
    logger.info("training complete")
    logger.close()
    world.barrier()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
