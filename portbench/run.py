"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload eval.ffpp_udis2.b12 --seed 7 \
        --seconds 30 --trace 0

From the root of a checkout that holds BENCHMARK.json, `portbench/` and
the program under test (`stitchax_torch`). Needs as many CUDA cards as
the cell asks for; exits non-zero without a result otherwise, and where
JAX or the JAX package got loaded. With --trace 0 the line holds the
cell's end-to-end metrics, with --trace 1 its per-layer metrics. The last
lines on standard error, and the line's last key, `checks`, give each
number compared with the reference beside its limit.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's nvcc build is `stitchax_torch/_build/`, fixed by the program)."""
    base = os.path.join(root, ".portbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device, overrides=None):
    """(context, outcome) of one run; `overrides` may replace the cell's
    configuration, traffic or limits by dicts (tests at small sizes)."""
    from .harness import make_context

    ctx = make_context(root, workload, seed, seconds, trace, device, T0,
                       overrides)
    loop = importlib.import_module(f"portbench.loops.{ctx.traffic['loop']}")
    return ctx, loop.run(ctx)


def main(argv=None) -> int:
    args = parse(argv)
    root = os.getcwd()
    cache_dirs(root)
    if not os.path.isfile(os.path.join(root, "BENCHMARK.json")):
        print("portbench: no BENCHMARK.json here", file=sys.stderr)
        return 2
    import torch

    from .harness import banned_loaded, load_json, result_line

    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if cell is None:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              "card(s)", file=sys.stderr)
        return 3
    ctx, outcome = run_cell(root, args.workload, args.seed, args.seconds,
                            bool(args.trace), torch.device("cuda:0"))
    line = result_line(ctx, outcome)
    found = banned_loaded()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
