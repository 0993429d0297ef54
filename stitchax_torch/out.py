"""The stitch CLI of the port: stitchax's out.py on the card.

    python -m stitchax_torch.out --data_root_path demo_data/ \
        --ckpt_path results/ckpt_r05_bf16.npz \
        --transref_ckpt results/transref_ckpt_r05_bf16.msgpack
    python -m stitchax_torch.out --data_root_path demo_data/ \
        --ckpt_path results/ckpt_r05_bf16.npz \
        --inf_cfg inpaint_all_area_g12_diffusion

Stitches every pair of `{data_root_path}/{txt_file}` with the settings of
`inf_configs.<inf_cfg>` and writes stitchax's per-pair JPEGs (input1/2,
H_warp, flow_warp, warp1/2, mask1/2, ave_fusion, and with the composition
net composition and learned_mask1/2) under
`{result_dir}/{inf_cfg}_g{gh}x{gw}_{tps_method}/<pair>/`, beside the
resolved config (config.txt) and the logger's metrics file. A pair that
fails is logged and the sweep goes on; then errors.json lists the
failures and the exit code is 1.

The flags are out.py's, with `--ckpt_path` an npz snapshot of stitchax's
weights (no random initialisation). Not carried over: `--input_bucket`
and `--align_batch`, TPU workarounds (the port stitches at native
resolution, one pair at a time); config.txt records them at stitchax's
defaults, so that it is byte-equal to stitchax's for the same flags. The
nets run in bf16 as stitchax runs them, on `cuda:<gpu>`; `--fp32` runs
them in fp32 (TF32 off), and `--device cpu` runs on the CPU. The SD
inpainter of the `*_diffusion` configuration always runs in fp32; its
checkpoint is `--sd_ckpt`, else STITCHAX_SD_CKPT, else the repository's
results/sd_ckpt_r05.pt (stitchax's resolution; without one the stitch
refuses to start).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback
from typing import List, Optional, Tuple

# stitchax's TPU flags, recorded in config.txt at its defaults
STITCHAX_ONLY_FLAGS = {"input_bucket": None, "align_batch": 4}
# the port's own flags, which stitchax's config.txt does not hold
PORT_FLAGS = ("device", "fp32", "sd_ckpt")


def get_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m stitchax_torch.out")
    p.add_argument("--ckpt_path", type=str, default="./checkpoints/final_ckpt",
                   help="npz snapshot of the flow, homo (and comp) weights, "
                        "e.g. results/ckpt_r05_bf16.npz")
    p.add_argument("--model_config_name", type=str, default="last_config")
    p.add_argument("--data_root_path", type=str, default="./demo/")
    p.add_argument("--txt_file", type=str, default="demo.txt")
    p.add_argument("--gpu", type=str, default="0",
                   help="index of the CUDA card")
    p.add_argument("--inf_cfg", type=str,
                   default="all_img1_with_inpaint_g12_transRef")
    p.add_argument("--result_dir", type=str, default="results")
    p.add_argument("--skip_if_avg_fusion_exists", action="store_true",
                   default=False)
    p.add_argument("--num_shards", type=int, default=1,
                   help="partition the pair list across N processes")
    p.add_argument("--shard_id", type=int, default=0,
                   help="this process's shard index in [0, num_shards)")
    p.add_argument("--transref_ckpt", type=str, default=None,
                   help="TransRef weights (flax msgpack), e.g. "
                        "results/transref_ckpt_r05_bf16.msgpack; needed by "
                        "configurations with the TransRef inpainter")
    p.add_argument("--sd_ckpt", type=str, default=None,
                   help="packed SD checkpoint of the diffusion inpainter; "
                        "default STITCHAX_SD_CKPT, else the repository's "
                        "results/sd_ckpt_r05.pt")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default cuda:<gpu> ('cpu' for tests)")
    p.add_argument("--fp32", action="store_true", default=False,
                   help="run the nets in fp32 (default bf16, as stitchax)")
    return p.parse_args(argv)


def config_args(args: argparse.Namespace) -> argparse.Namespace:
    """The flags as stitchax's out.py holds them: the port's own dropped,
    stitchax's TPU flags at their defaults."""
    d = {k: v for k, v in vars(args).items() if k not in PORT_FLAGS}
    d.update(STITCHAX_ONLY_FLAGS)
    return argparse.Namespace(**d)


def setup(args: argparse.Namespace):
    """Resolve the config, write config.txt, load the models and list the
    jobs. Returns (save_root, logger, stitcher, jobs), jobs being
    (data_dict, result_path) pairs."""
    import torch

    from .compose.inpainters import INPAINTERS, resolve_sd_ckpt
    from .compose.mix_methods import MIX_METHODS
    from .run.config import build_out_config
    from .run.stitcher import Stitcher, StitchModels, load_pair_list
    from .utils.logger import Logger
    from .utils.precision import fp32_exact

    cfg = build_out_config(config_args(args))
    tps = cfg.TPS_PIPELINE_CONFIG
    if tps.inpainter not in INPAINTERS or tps.mix_method not in MIX_METHODS:
        raise SystemExit(f"--inf_cfg {args.inf_cfg}: inpainter "
                         f"{tps.inpainter!r} / mix method {tps.mix_method!r} "
                         "are not ported yet")
    if not 0 <= args.shard_id < args.num_shards:
        raise SystemExit(f"--shard_id {args.shard_id} outside "
                         f"[0, {args.num_shards})")
    if not (args.ckpt_path.endswith(".npz")
            and os.path.isfile(args.ckpt_path)):
        raise SystemExit(f"--ckpt_path {args.ckpt_path!r}: expected an npz "
                         "snapshot of stitchax's weights "
                         "(results/ckpt_r05_bf16.npz)")
    sd_ckpt = None
    if tps.inpainter == "inpainter":
        try:
            sd_ckpt = resolve_sd_ckpt(args.sd_ckpt)
        except (ValueError, FileNotFoundError) as e:
            raise SystemExit(f"--inf_cfg {args.inf_cfg}: {e}") from None

    save_root = os.path.join(
        args.result_dir,
        f"{args.inf_cfg}_g{tps.grid_h}x{tps.grid_w}_{tps.tps_method}")
    os.makedirs(save_root, exist_ok=True)
    with open(os.path.join(save_root, "config.txt"), "w") as f:
        f.write(cfg.dump())
    logger = Logger(log_dir=save_root, name="out")

    device = args.device or f"cuda:{int(args.gpu)}"
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    if args.fp32:
        fp32_exact()
    models = StitchModels.from_npz(args.ckpt_path, device, dtype, config=cfg,
                                   transref=args.transref_ckpt, sd=sd_ckpt)
    stitcher = Stitcher(models, device=device, config=cfg)

    pairs = load_pair_list(args.data_root_path, args.txt_file)
    if args.num_shards > 1:
        pairs = pairs[args.shard_id::args.num_shards]
        logger.info(f"shard {args.shard_id}/{args.num_shards}: "
                    f"{len(pairs)} pairs")
    jobs: List[Tuple[dict, str]] = []
    for data_dict in pairs:
        rel = os.path.relpath(data_dict["DATA_PATH"], args.data_root_path)
        result_path = os.path.join(save_root, rel)
        if (args.skip_if_avg_fusion_exists and os.path.exists(
                os.path.join(result_path, "ave_fusion.jpg"))):
            logger.info(f"skip {rel} (ave_fusion exists)")
            continue
        logger.info(f"queueing {rel}")
        jobs.append((data_dict, result_path))
    return save_root, logger, stitcher, jobs


def main(argv: Optional[List[str]] = None) -> int:
    args = get_args(argv)
    save_root, logger, stitcher, jobs = setup(args)
    try:
        errors = []
        for result_path, _, err, t in stitcher.stitch_and_save_many(jobs):
            rel = os.path.relpath(result_path, save_root)
            if err is None:
                logger.info(f"stitched {rel} (read {t['read_s']:.3f} s, "
                            f"stitch {t['stitch_s']:.3f} s, "
                            f"write {t['write_s']:.3f} s)")
            else:
                traceback.print_exception(type(err), err, err.__traceback__)
                errors.append({"pair": rel, "error": repr(err)})
        if errors:
            with open(os.path.join(save_root, "errors.json"), "w") as f:
                json.dump(errors, f, indent=2)
            logger.info(f"{len(errors)} pairs failed; see errors.json")
            return 1
        logger.info(f"done: {len(jobs)} pairs -> {save_root}")
        return 0
    finally:
        logger.close()


if __name__ == "__main__":
    sys.exit(main())
