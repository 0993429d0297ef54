"""The readings that a cell's limits are set from, apart from the program's
own runs: the control (the plain reference computed with TF32 on, the
nearest precision below the configuration's float32, put in the
program's place) and, for training, the planted faults, each held to the
fp32 reference by the cell's own comparison, at the cell's own size.

    python3 -m portbench.control --workload eval.ffpp_udis2.b12 \
        --seeds 11,12,13 [--out control.jsonl]

One JSON line per seed and reading: {workload, seed, reading, checks}.
The benchmark's runs never run this. On the CPU (`device="cpu"`, the
tests) TF32 is emulated by rounding the products' operands.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List


def readings(root: str, workload: str, seed: int, device,
             overrides=None) -> List[Dict]:
    """[{reading, checks {name: value}}] of one seed: "control" and, for a
    training cell, "half_batch" (the first half of each batch alone, the
    mean over it)."""
    from .harness import make_context

    ctx = make_context(root, workload, seed, 0.0, False, device,
                       time.perf_counter(), overrides)
    out = []
    if ctx.traffic["loop"] == "eval":
        from .loops import eval as drv
        _, img1, img2 = drv.pool(ctx)
        k, B = drv.sample_index(ctx), ctx.traffic["batch"]
        a, b = img1[k * B:(k + 1) * B], img2[k * B:(k + 1) * B]
        keys = ("warped", "valid", "psnr", "ssim")
        ref = dict(zip(keys, drv.reference_eval(ctx, a, b)))
        ctl = dict(zip(keys, drv.reference_eval(ctx, a, b, tf32=True)))
        out.append({"reading": "control",
                    "checks": {c.name: c.value
                               for c in drv.compare(ctx, ctl, ref)}})
    else:
        from .loops import train as drv
        from .traffic import make_pairs
        B, K = ctx.traffic["batch"], ctx.config["reference"]["train_steps"]
        img1, img2 = make_pairs(ctx.traffic, seed,
                                B * ctx.traffic["pool_batches"], device)
        batches = [(img1[i * B:(i + 1) * B], img2[i * B:(i + 1) * B])
                   for i in range(K)]
        ref = drv.reference_steps(ctx, batches)
        for name, kw in (("control", {"tf32": True}),
                         ("half_batch", {"half": True})):
            got = drv.reference_steps(ctx, batches, **kw)
            out.append({"reading": name,
                        "checks": {c.name: c.value
                                   for c in drv.compare(ctx, got, ref)}})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 3
    root = os.getcwd()
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        for r in readings(root, args.workload, seed, torch.device("cuda:0")):
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "seconds": time.perf_counter() - t, **r})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
