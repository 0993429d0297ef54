"""Run one cell of the benchmark (`portbench`) with the port's tracer on
over its measured window, and print the cell's result line with the
per-layer numbers read from the tracer's spans and counters.

    python3 tools/trace_cell.py --workload eval.ffpp_udis2.b12 --seed 7 \
        --seconds 51 --trace 1

From the root of a checkout, on a CUDA card, as `python3 -m portbench.run`
with the same arguments. `stitchax_torch.utils.tracing.enable()` is called
just before the window opens, and `snapshot()` then `disable()` just after
it closes, so the profiled slice of a traced run and the reference run
with the tracer off. The line gains `program_metrics` (the numbers below,
each None where the snapshot holds nothing to read), `program_spans` (for
each span name under a batch or step, the median over the window's
batches or steps of its summed host ms and device ms: the breakdown of
PERF.md section 5) and `program` (the snapshot's counters and `dropped`).
The same run through `python3 -m portbench.run` is the tracer off;
comparing the two rates gives the tracer's cost.

This is a stand-in for the hook the benchmark's loops lack: once
`portbench/loops/` enable the tracer over the window of a traced run and
`portbench/metrics/` read READERS' numbers, this file goes, with its tests.

The numbers, each a median over the window's batches or steps (the spans
each batch's or step's root span holds):

- align_device_ms.eval: device ms of `eval.align` (the alignment step).
- motion_encoder_ms.eval: summed device ms of `flow.motion_encoder`.
- score_ms.eval: host ms of `eval.score`: the launch of the batch's
  PSNR / SSIM scorer (K6) on a card, not its device time (the scores'
  copy to the host and the host's finish are `eval.download`).
- host_syncs.eval: the `host_syncs` counter's increase.
- forward_device_ms.train: device ms of `train.forward` +
  `train.backward_flow` + `train.loss`.
- backward_device_ms.train: device ms of `train.backward`.
- update_device_ms.train: device ms of `train.update` (clip + AdamW).
- host_syncs.train: the `host_syncs` counter's increase.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from typing import Dict, Iterable, List, Mapping, Optional

EVAL_ROOT, TRAIN_ROOT = "eval.batch", "train.step"


def _roots(program: Mapping, root_name: str) -> List[int]:
    """The root ids of the closed root spans named `root_name`."""
    return [s["root"] for s in program.get("spans", [])
            if s["name"] == root_name and s["parent"] is None]


def per_root(program: Optional[Mapping], root_name: str,
             names: Iterable[str], field: str) -> List[float]:
    """For each closed root span `root_name`, the sum of `field` over its
    spans named in `names` (roots holding none of them are left out)."""
    if not program:
        return []
    names = set(names)
    sums: Dict[int, float] = {}
    for s in program.get("spans", []):
        if s["name"] in names and s[field] is not None:
            sums[s["root"]] = sums.get(s["root"], 0.0) + s[field]
    return [sums[r] for r in _roots(program, root_name) if r in sums]


def counter_per_root(program: Optional[Mapping], root_name: str,
                     counter: str) -> List[float]:
    """For each closed root span `root_name`, the increase of `counter`
    under it (0 where it was not bumped)."""
    if not program:
        return []
    sums: Dict[int, float] = {}
    for c in program.get("counts", []):
        if c["name"] == counter and c["root"] is not None:
            sums[c["root"]] = sums.get(c["root"], 0) + c["n"]
    return [sums.get(r, 0) for r in _roots(program, root_name)]


def _median(values: List[float]) -> Optional[float]:
    return statistics.median(values) if values else None


READERS = {
    "align_device_ms.eval": lambda p: _median(
        per_root(p, EVAL_ROOT, ["eval.align"], "device_ms")),
    "motion_encoder_ms.eval": lambda p: _median(
        per_root(p, EVAL_ROOT, ["flow.motion_encoder"], "device_ms")),
    "score_ms.eval": lambda p: _median(
        per_root(p, EVAL_ROOT, ["eval.score"], "host_ms")),
    "host_syncs.eval": lambda p: _median(
        counter_per_root(p, EVAL_ROOT, "host_syncs")),
    "forward_device_ms.train": lambda p: _median(per_root(
        p, TRAIN_ROOT, ["train.forward", "train.backward_flow",
                        "train.loss"], "device_ms")),
    "backward_device_ms.train": lambda p: _median(
        per_root(p, TRAIN_ROOT, ["train.backward"], "device_ms")),
    "update_device_ms.train": lambda p: _median(
        per_root(p, TRAIN_ROOT, ["train.update"], "device_ms")),
    "host_syncs.train": lambda p: _median(
        counter_per_root(p, TRAIN_ROOT, "host_syncs")),
}


def read_program(program: Optional[Mapping]) -> Dict[str, Optional[float]]:
    """Every number of READERS from one snapshot."""
    return {name: read(program) for name, read in READERS.items()}


def span_table(program: Optional[Mapping], root_name: str
               ) -> Dict[str, Dict[str, Optional[float]]]:
    """{span name: {"host_ms", "device_ms"}} for every span name under the
    closed root spans `root_name` (the root's own name included): the
    median over those roots of the name's summed ms (None where no span
    of that name has a device reading)."""
    if not program:
        return {}
    roots = set(_roots(program, root_name))
    names = sorted({s["name"] for s in program.get("spans", [])
                    if s["root"] in roots})
    return {n: {f: _median(per_root(program, root_name, [n], f))
                for f in ("host_ms", "device_ms")} for n in names}


def main(argv=None) -> int:
    from portbench import run as prun

    p = argparse.ArgumentParser(prog="python3 tools/trace_cell.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    root = os.getcwd()
    prun.cache_dirs(root)
    import torch

    from portbench.harness import Window, banned_loaded, result_line
    from stitchax_torch.utils import tracing

    if not torch.cuda.is_available():
        print("trace_cell: needs a CUDA card", file=sys.stderr)
        return 3
    box: Dict[str, object] = {}
    window_open, window_close = Window.open, Window.close

    def open_(self):
        tracing.enable()
        window_open(self)

    def close_(self):
        window_close(self)
        box["program"] = tracing.snapshot()
        tracing.disable()

    Window.open, Window.close = open_, close_
    ctx, outcome = prun.run_cell(root, args.workload, args.seed,
                                 args.seconds, bool(args.trace),
                                 torch.device("cuda:0"))
    line = result_line(ctx, outcome)
    program = box.get("program")
    line["program_metrics"] = read_program(program)
    tables = {r: span_table(program, r) for r in (EVAL_ROOT, TRAIN_ROOT)}
    line["program_spans"] = {r: t for r, t in tables.items() if t}
    if program is not None:
        line["program"] = {"counters": program["counters"],
                           "dropped": program["dropped"],
                           "spans": len(program["spans"])}
    found = banned_loaded()
    if found:
        print(f"trace_cell: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    raise SystemExit(main())
