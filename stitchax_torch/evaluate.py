"""The evaluation CLI of the port: stitchax's evaluate.py on the card.

    python -m stitchax_torch.evaluate --data_dir UDIS-D/ \
        --ckpt_path results/ckpt_r05_bf16.npz

PSNR and SSIM of img1 against the aligned img2 over a UDIS-D-layout
testing split (`{data_dir}/testing/input{1,2}/*.jpg`), in the overlap the
alignment covers fully, with the paper's bucketed report: the top 30%,
30-60% and 60-100% of the sorted per-pair scores, cut at round(0.3 n) and
round(0.6 n). The report goes to stdout and to eval_result.json in the
working directory (run it from a scratch directory: the repo tracks an
eval_result.json of stitchax's).

The alignment is `train_eval_forward` at `image_size` (512^2 by default)
with the homography net and FlowFormer++ in fp32, as stitchax's
evaluation calls them, and TF32 off on the card. Batches of `batch_size`
pairs run on one card (`cuda:<gpu>`; `--device cpu` for tests).

Under `python -m torch.distributed.run --nproc_per_node R` the evaluation
runs data-parallel, as stitchax's does over its devices (evaluate.py:69-95):
each batch is padded to a multiple of R by repeating its last pair, each
rank aligns its block on cuda:<LOCAL_RANK> (or `--device`), the outputs
are gathered in the batch's order (`parallel.make_parallel_eval_step`) and
the padded rows dropped; rank 0 scores them and writes the report.
`--backend` picks the process group's (nccl on the card, gloo on the CPU by
default; gloo runs two ranks on one card).
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, List, Optional

import numpy as np


def get_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m stitchax_torch.evaluate")
    p.add_argument("--ckpt_path", type=str, default="./checkpoints/final_ckpt",
                   help="npz snapshot of the flow and homo weights, e.g. "
                        "results/ckpt_r05_bf16.npz")
    p.add_argument("--model_config_name", type=str, default="last_config")
    p.add_argument("--data_dir", type=str, default="./UDIS-D/")
    p.add_argument("--batch_size", type=int, default=12)
    p.add_argument("--gpu", type=str, default="0",
                   help="index of the CUDA card")
    p.add_argument("--max_pairs", type=int, default=-1,
                   help="evaluate only the first N pairs")
    p.add_argument("--image_size", type=int, default=None,
                   help="square evaluation size; default the model "
                        "config's (512, the paper's protocol)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default cuda:<gpu>, a rank's "
                        "cuda:<LOCAL_RANK> ('cpu' for tests)")
    p.add_argument("--backend", type=str, default=None,
                   choices=["nccl", "gloo"],
                   help="process group backend of a data-parallel run "
                        "(default nccl on the card, gloo on the CPU)")
    return p.parse_args(argv)


def make_eval_step(models, align_cfg) -> Callable:
    """(img1, img2) (B, H, W, 3) fp32 tensors on the models' device ->
    (warped img2 (B, H, W, 3), its coverage (B, H, W, 1): the mean of the
    warped ones channels, 1 where fully covered). `models` holds
    `homo_model`, `flow_model` (callables on NHWC tensors), `dtype`."""
    import torch

    from .align.adapter import train_eval_forward
    from .utils.precision import call_in

    dt = models.dtype
    homo_fn = lambda a, b: call_in(models.homo_model, dt, a, b)
    flow_fn = lambda a, b: call_in(models.flow_model, dt, a, b)

    @torch.no_grad()
    def eval_step(img1, img2):
        out = train_eval_forward(homo_fn, flow_fn, img1, img2, align_cfg)
        w = out["final_warp_output"]
        return w[..., 0:3], w[..., 3:6].mean(-1, keepdim=True)

    return eval_step


def bucket_report(psnr_list, ssim_list) -> dict:
    """The bucketed report: means of the sorted scores' top 30%, 30-60%
    and 60-100%, and of all, printed as stitchax prints them."""
    n = len(psnr_list)
    c30, c60 = int(round(0.3 * n)), int(round(0.6 * n))

    def bucket(vals):
        s = sorted(vals, reverse=True)
        return (float(np.mean(s[:c30])) if c30 else 0.0,
                float(np.mean(s[c30:c60])) if c60 > c30 else 0.0,
                float(np.mean(s[c60:])) if n > c60 else 0.0,
                float(np.mean(s)))

    p30, p60, p100, pavg = bucket(psnr_list)
    s30, s60, s100, savg = bucket(ssim_list)
    print("=================== Analysis ==================")
    print(f"Number of Test {n}")
    print(f"[psnr] top 30%: {p30:.6f}  30~60%: {p60:.6f}  "
          f"60~100%: {p100:.6f}  average: {pavg:.6f}")
    print(f"[ssim] top 30%: {s30:.6f}  30~60%: {s60:.6f}  "
          f"60~100%: {s100:.6f}  average: {savg:.6f}")
    return {
        "avg_psnr": pavg, "avg_ssim": savg,
        "easy_psnr": p30, "mid_psnr": p60, "hard_psnr": p100,
        "easy_ssim": s30, "mid_ssim": s60, "hard_ssim": s100,
        "num_pairs": n,
    }


def masked_pairs(img1: np.ndarray, warped: np.ndarray, valid: np.ndarray):
    """uint8 img1 and warped img2 inside the fully covered overlap, as
    stitchax forms them: clip and truncate, and the coverage truncated to
    uint8 (1 only where it is exactly 1)."""
    i1 = np.clip(img1, 0, 255).astype(np.uint8)
    w = np.clip(warped, 0, 255).astype(np.uint8)
    m = valid.astype(np.uint8)
    return i1 * m, w * m


def validate_with_model(cfg, loader, models, align_cfg, eval_step=None,
                        per_pair: Optional[list] = None,
                        world=None) -> Optional[dict]:
    """PSNR/SSIM over the loader's batches and the bucketed report.
    `models.device` takes the batches. With `per_pair`, each pair's
    (name, psnr, ssim) is appended to it. With a `world` of ranks, every
    rank passes the same batches and aligns its block of each; rank 0
    returns the report, the others None."""
    import torch

    from .metrics import psnr_batch, ssim_batch
    from .parallel import make_parallel_eval_step, pad_to_world
    from .utils.tracing import count_sync, span

    if eval_step is None:
        eval_step = make_eval_step(models, align_cfg)
    parallel = world is not None and world.backend is not None
    if parallel:
        eval_step = make_parallel_eval_step(eval_step, world)
    main = world is None or world.is_main
    psnr_list, ssim_list = [], []
    seen = 0
    for batch in loader:
        with span("eval.batch"):
            with span("eval.upload"):
                # two blocking host-to-device copies
                count_sync(models.device, 2)
                img1 = torch.from_numpy(batch["image1"]).to(models.device)
                img2 = torch.from_numpy(batch["image2"]).to(models.device)
                n = img1.shape[0]
                if parallel:
                    (img1, img2), n = pad_to_world([img1, img2], world)
            with span("eval.align"):
                warped, valid = eval_step(img1, img2)
            if not main:
                continue
            with span("eval.download"):
                count_sync(warped.device, 2)  # two device-to-host copies
                warped = warped[:n].cpu().numpy()
                valid = valid[:n].cpu().numpy()
            with span("eval.score"):
                a, b = masked_pairs(batch["image1"], warped, valid)
                p, s = psnr_batch(a, b, 255.0), ssim_batch(a, b, 7, 255.0)
        psnr_list += list(p)
        ssim_list += list(s)
        if per_pair is not None:
            per_pair += list(zip(batch["name"], p.tolist(), s.tolist()))
        seen += a.shape[0]
        print(f"evaluated {seen} pairs; last psnr "
              f"{psnr_list[-1]:.4f} ssim {ssim_list[-1]:.4f}", flush=True)
    return bucket_report(psnr_list, ssim_list) if main else None


def load_models(ckpt_path: str, device):
    """The homography net and FlowFormer++ in fp32 from an npz snapshot;
    TF32 off on the card."""
    import os

    import torch

    from .run.stitcher import StitchModels
    from .utils.precision import fp32_exact

    if not (ckpt_path.endswith(".npz") and os.path.isfile(ckpt_path)):
        raise SystemExit(f"--ckpt_path {ckpt_path!r}: expected an npz "
                         "snapshot of stitchax's weights "
                         "(results/ckpt_r05_bf16.npz)")
    fp32_exact()
    return StitchModels.from_npz(ckpt_path, device, torch.float32)


def main(argv: Optional[List[str]] = None) -> int:
    from .align.adapter import AlignConfig
    from .data.udis import PrefetchLoader, UDISDataset
    from .parallel import cli_world, world_requested
    from .run.config import build_eval_config

    args = get_args(argv)
    world = cli_world(args.device or (None if world_requested()
                                      else f"cuda:{int(args.gpu)}"),
                      args.backend)
    cfg = build_eval_config(args)
    if args.image_size:
        cfg.image_size = [args.image_size, args.image_size]
    size = tuple(cfg.get("image_size", [512, 512]))
    ds = UDISDataset(args.data_dir, phase="testing", size=size)
    if args.max_pairs > 0:
        ds.pairs = ds.pairs[:args.max_pairs]
    loader = PrefetchLoader(ds, batch_size=args.batch_size, num_workers=12)
    models = load_models(args.ckpt_path, world.device)
    align_cfg = AlignConfig(
        use_fb_consistency_mask=cfg.get("use_fb_consistency_mask", True))
    result = validate_with_model(cfg, loader, models, align_cfg,
                                 world=world)
    if world.is_main:
        with open("eval_result.json", "w") as f:
            json.dump(result, f, indent=2)
    world.barrier()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
