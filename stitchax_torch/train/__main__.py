"""The training CLI of the port: train.py's alignment trainer.

    python -m stitchax_torch.train --data_dir UDIS-D/ \
        --init_npz results/ckpt_r05_bf16.npz

Under `python -m torch.distributed.run --nproc_per_node R -m
stitchax_torch.train ...` it trains data-parallel, as train.py does over
its devices: every rank reads the same global batches and swap draws, takes
its block of `batch_size / R` pairs (`parallel.shard_batch`; the batch must
split evenly) on cuda:<LOCAL_RANK> (or `--device`), and the step
all-reduces the gradient before the clip and AdamW
(`parallel.make_parallel_train_step`), so that R ranks take the global
batch's step. Only rank 0 writes the metrics, checkpoints, dashboards and
the final npz. `--backend` picks the process group's (nccl on the card,
gloo on the CPU by default; gloo runs two ranks on one card, which nccl
refuses). Without WORLD_SIZE in the environment it runs one process.

Trains the UDIS2 homography net and FlowFormer++ together, unsupervised,
on `{data_dir}/training/input{1,2}/*.jpg` with `configs.<model_config_name>`
(configs/last_config.py: 512^2, batch 1, AdamW + one-cycle, clip 1,
sequence gamma 0.8), in fp32 with TF32 off. train.py's flags, plus
`--device` (default cuda:0, or cuda:<LOCAL_RANK> for a rank; `cpu` for
tests) and `--backend`. Writes
`{ckpt_dir}/train_metrics.jsonl`, a resumable `step_<8 digits>.pt` every
`save_every` steps, at the end and on a first SIGTERM / SIGINT (the step in
flight finishes first; a second signal stops at once), a dashboard figure
every `panel_every` steps (0: none; needs matplotlib), and at the end
`final_ckpt.npz`: the flow and homo trees as float32 leaves under
stitchax's key strings, which `StitchModels.from_npz` and stitchax's
`convert.load_params_npz` both read.

Where it departs from train.py: a resumed run continues the data order and
the img1/img2 swap draws where the saved run stood (train.py restarts
both), and an unset `--batch_size` takes the model config's (train.py's
config assembly leaves it None, which its optimizer cannot scale by).
Without `--init_npz` or `--resume` the nets start from the port's own
initializers, seeded with `--seed`, not flax's.
"""

from __future__ import annotations

import argparse
import os
import signal
from typing import List, Optional

import numpy as np


def get_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m stitchax_torch.train")
    p.add_argument("--model_config_name", type=str, default="last_config")
    p.add_argument("--data_dir", type=str, default=None,
                   help="overrides udis_dataset.data_dir from the config")
    p.add_argument("--num_steps", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--ckpt_dir", type=str, default="./checkpoints/train")
    p.add_argument("--save_every", type=int, default=5000)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--panel_every", type=int, default=5000,
                   help="emit a figure dashboard (inputs/flow/warp/blend) "
                        "every N steps; 0 disables")
    p.add_argument("--resume", type=str, default=None,
                   help="a step_<N>.pt checkpoint of this trainer")
    p.add_argument("--init_npz", type=str, default=None,
                   help="warm-start the flow and homo weights from an npz "
                        "snapshot (e.g. results/ckpt_r05_bf16.npz); the "
                        "optimizer state and step count start fresh")
    p.add_argument("--lr", type=float, default=None,
                   help="override trainer.canonical_lr")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--image_size", type=int, default=None,
                   help="override cfg.image_size (square)")
    p.add_argument("--remat", action="store_true", default=False,
                   help="recompute the backbones' forwards in the backward "
                        "pass (less device memory)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda:0, a rank's "
                        "cuda:<LOCAL_RANK>; 'cpu' for tests)")
    p.add_argument("--backend", type=str, default=None,
                   choices=["nccl", "gloo"],
                   help="process group backend of a data-parallel run "
                        "(default nccl on the card, gloo on the CPU)")
    return p.parse_args(argv)



def build_config(args):
    """configs.<model_config_name> merged with the flags that are set."""
    from ..run.config import _load_module_attr, build_eval_config

    cfg = build_eval_config(args)
    if args.data_dir:
        cfg.udis_dataset.data_dir = args.data_dir
    cfg.batch_size = args.batch_size or _load_module_attr(
        f"configs.{args.model_config_name}", "config_dict").get(
            "batch_size", 1)
    if args.image_size:
        cfg.image_size = [args.image_size, args.image_size]
    return cfg


def main(argv: Optional[List[str]] = None) -> int:
    args = get_args(argv)
    import torch

    from .. import convert
    from ..align.adapter import AlignConfig
    from ..data.udis import fetch_dataloader
    from ..models.flowformer import FlowFormer, FlowFormerConfig
    from ..models.udis2 import UDIS2HomographyNet
    from ..parallel import cli_world, make_parallel_train_step, shard_batch
    from ..utils.logger import Logger, NullLogger
    from . import (LossConfig, OptimConfig, create_train_state,
                   make_train_step, restore_checkpoint, save_checkpoint,
                   stitchax_tree)

    world = cli_world(args.device, args.backend)
    device = world.device
    cfg = build_config(args)
    if cfg.batch_size % world.size:
        raise ValueError(f"batch {cfg.batch_size} does not split over "
                         f"{world.size} ranks")
    trainer = cfg.trainer
    num_steps = args.num_steps or trainer.num_steps
    S = cfg.image_size[0]
    ff = cfg.percostformer3
    flow_cfg = FlowFormerConfig(
        cost_heads_num=ff.cost_heads_num,
        cost_latent_input_dim=ff.cost_latent_input_dim,
        cost_latent_token_num=ff.cost_latent_token_num,
        cost_latent_dim=ff.cost_latent_dim,
        encoder_latent_dim=ff.encoder_latent_dim,
        query_latent_dim=ff.query_latent_dim,
        encoder_depth=ff.encoder_depth, decoder_depth=ff.decoder_depth,
        patch_size=ff.patch_size, vert_c_dim=ff.vert_c_dim,
        upsample_all=True)
    if ff.get("gma", "GMA") != "GMA":
        raise ValueError(f"percostformer3.gma {ff.gma!r}: the port has GMA")
    torch.manual_seed(args.seed)
    models = {"homo": UDIS2HomographyNet(input_size=S),
              "flow": FlowFormer(flow_cfg)}
    if args.init_npz:
        tree = convert.load_npz(os.path.abspath(args.init_npz))
        for k, m in models.items():
            convert.load_jax_params(m, tree[k])
        print(f"warm-started params from {args.init_npz}")
    for m in models.values():
        m.to(device)

    optim_cfg = OptimConfig(
        canonical_lr=(args.lr if args.lr is not None
                      else trainer.canonical_lr), num_steps=num_steps,
        adamw_decay=trainer.adamw_decay, epsilon=trainer.epsilon,
        clip=trainer.clip, anneal_strategy=trainer.anneal_strategy,
        batch_scale=cfg.batch_size)
    state, tx = create_train_state(models, optim_cfg)
    if args.resume:
        state = restore_checkpoint(os.path.abspath(args.resume), state)
        print(f"resumed from {args.resume} at step {state.step}")

    align_cfg = AlignConfig(
        use_fb_consistency_mask=cfg.get("use_fb_consistency_mask", True))
    loss_cfg = LossConfig(
        gamma=cfg.gamma,
        rigid_motion_weight=cfg.get("rigid_motion_loss_weight", 0.3),
        border_weight=cfg.get("border_loss_weight", 0.5),
        max_flow=cfg.get("max_flow", 500))
    step_fn = make_train_step(
        models["homo"], models["flow"], tx, align_cfg, loss_cfg,
        use_fb_consistency_mask=cfg.get("use_fb_consistency_mask", True),
        remat=args.remat)
    if world.backend is not None:
        step_fn = make_parallel_train_step(step_fn, world)

    if world.is_main:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        logger = Logger(log_dir=args.ckpt_dir, name="train",
                        sum_freq=args.log_every)
    else:
        logger = NullLogger()
    loader = fetch_dataloader(cfg, phase="training")
    where = (f"{world.size} ranks ({world.backend}; rank 0 on {device})"
             if world.backend else f"1 device ({device})")
    logger.info(f"training {num_steps} steps, batch {cfg.batch_size}, "
                f"{len(loader.ds)} pairs, {where}")

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
    random_swap = cfg.get("random_img12", True)
    rng = np.random.default_rng(args.seed)
    if step:                          # continue where the saved run stood
        loader.skip(step)
        if random_swap:
            rng.random(step)
    # a signal to any rank stops every rank after the same step
    stop = lambda: world.any(bool(stop_requested))
    while step < num_steps and not stop():
        for batch in loader:
            if step >= num_steps or stop():
                break
            img1, img2 = batch["image1"], batch["image2"]
            if random_swap and rng.random() < 0.5:
                img1, img2 = img2, img1   # the reference's random_img12
            if world.backend is not None:     # this rank's block
                img1, img2 = shard_batch((img1, img2), world)
            # uint8 upload (the decoded pixels are whole gray levels),
            # float32 on the device
            img1, img2 = (torch.from_numpy(np.asarray(x, np.uint8)).to(
                device).float() for x in (img1, img2))
            state, metrics = step_fn(state, img1, img2)
            step += 1
            names = sorted(metrics)
            vec = torch.stack([metrics[k] for k in names]).cpu().numpy()
            logger.push(dict(zip(names, vec)), step=step)
            stopping = stop()
            if not world.is_main:
                continue
            if args.panel_every and (step % args.panel_every == 0
                                     or step == num_steps):
                from ..utils.logger import save_train_dashboard
                with torch.no_grad():
                    pred = models["flow"](img1[:1], img2[:1])[0][-1]
                path = os.path.join(args.ckpt_dir, f"panel_{step:08d}.png")
                save_train_dashboard(path, img1[0].cpu().numpy(),
                                     img2[0].cpu().numpy(),
                                     pred[0].cpu().numpy())
                logger.info(f"saved dashboard {path}")
            if (step % args.save_every == 0 or step == num_steps
                    or stopping):
                path = os.path.abspath(os.path.join(
                    args.ckpt_dir, f"step_{step:08d}.pt"))
                save_checkpoint(path, state)
                logger.info(f"saved checkpoint {path}")

    if stop_requested:
        logger.info(f"stopped early at step {step} on signal "
                    f"{stop_requested[0]}")
    if world.is_main:
        # {flow, homo} as float32 leaves under stitchax's key strings
        final = os.path.abspath(os.path.join(args.ckpt_dir,
                                             "final_ckpt.npz"))
        convert.save_params_npz(final, stitchax_tree(state.params),
                                bf16=False)
        logger.info(f"exported eval-format checkpoint {final}")
    logger.info("training complete")
    logger.close()
    world.barrier()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
