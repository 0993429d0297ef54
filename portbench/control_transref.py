"""The readings that the TransRef training cell's limits are set from,
apart from the program's own runs: the control (the plain reference
computed with TF32 on, the nearest precision below the configuration's
float32, put in the program's place) and the planted faults (the first
half of each batch alone; a state left unchanged, the losses and
gradients taken but no update made), each held to the fp32 reference by
the cell's own comparison, at the cell's own size and on its inputs.

    python3 -m portbench.control_transref --workload train_transref.b32 \
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

READINGS = (("control", {"tf32": True}), ("half_batch", {"half": True}),
            ("unchanged", {"unchanged": True}))


def readings(root: str, workload: str, seed: int, device,
             overrides=None) -> List[Dict]:
    """[{reading, checks {name: value}}] of one seed, for each of
    READINGS."""
    from .harness import make_context
    from .loops import train_transref as drv

    ctx = make_context(root, workload, seed, 0.0, False, device,
                       time.perf_counter(), overrides)
    _, _, batch = drv.pool(ctx)
    draw = drv.holes(ctx)
    batches = [(*batch(i), draw())
               for i in range(ctx.config["reference"]["train_steps"])]
    ref = drv.reference_steps(ctx, batches)
    out = []
    for name, kw in READINGS:
        got = drv.reference_steps(ctx, batches, **kw)
        out.append({"reading": name,
                    "checks": {c.name: c.value
                               for c in drv.compare(ctx, got, ref)}})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control_transref")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("portbench.control_transref: no CUDA card", file=sys.stderr)
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
    raise SystemExit(main(sys.argv[1:]))
