"""What every cell's run shares: finding the cell and its files by name,
the window's clock, the checks that decide `correct`, the profiled slice,
the per-layer readers, the result line and the guard against JAX."""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
# top-level modules that may not be loaded in the process that prints the
# result: JAX, its libraries and the JAX package the port came from
BANNED = ("jax", "jaxlib", "flax", "optax", "stitchax")


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclass
class Context:
    """One run of one cell."""
    root: str                    # the checkout (BENCHMARK.json's folder)
    cell: Mapping                # the workload entry of BENCHMARK.json
    bench: Mapping               # BENCHMARK.json
    config: Mapping              # configs/<config>.json
    traffic: Mapping             # traffic/<traffic>.json
    limits: Mapping              # limits/<cell>.json
    seed: int
    seconds: float
    trace: bool
    device: Any                  # torch.device
    t0: float                    # perf_counter at process start


@dataclass
class Outcome:
    """What a loop hands back: counts, the end-to-end values it measured
    ({metric name: value}), the numbers compared with their limits, the
    peak memory of the program, and for a traced run what the per-layer
    readers read (`layer`)."""
    attempted: int
    failed: int
    setup_s: float
    end_to_end: Dict[str, float]
    checks: List["Check"]
    memory_peak_bytes: int
    layer: Dict[str, Any] = field(default_factory=dict)
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[Dict[str, list]] = None


@dataclass
class Check:
    """A number compared with its limit: `correct` needs value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def make_context(root: str, workload: str, seed: int, seconds: float,
                 trace: bool, device, t0: float, overrides=None) -> Context:
    """The run's context: the workload's entry in BENCHMARK.json and its
    configuration, traffic and limits files, found by name; `overrides`
    may replace the last three by dicts (tests at small sizes)."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    pb = os.path.join(root, "portbench")
    o = overrides or {}
    return Context(
        root=root, cell=cell, bench=bench,
        config=o.get("config") or load_json(os.path.join(root, conf["file"])),
        traffic=o.get("traffic") or load_json(
            os.path.join(pb, "traffic", f"{cell['traffic']}.json")),
        limits=o.get("limits") or load_json(
            os.path.join(pb, "limits", f"{workload}.json")),
        seed=seed, seconds=seconds, trace=trace, device=device, t0=t0)


class Window:
    """The measured window: items are taken while the clock is inside it;
    the item in flight when it closes is finished and counted, and the
    rate divides by the time to its end."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.start = self.end = None
        self.items = 0

    def open(self) -> None:
        self.start = time.perf_counter()

    def is_open(self) -> bool:
        return time.perf_counter() - self.start < self.seconds

    def done(self, n: int) -> None:
        self.items += n

    def close(self) -> None:
        self.end = time.perf_counter()

    @property
    def elapsed(self) -> float:
        return self.end - self.start

    @property
    def rate(self) -> float:
        return self.items / self.elapsed


def leaf_gap(prog: Mapping[str, float], ref: Mapping[str, float],
             keep: Optional[Callable[[str], bool]] = None) -> float:
    """The worst leaf's gap of norms |prog - ref| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    names = [n for n in ref if keep is None or keep(n)]
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def device_names(device) -> Dict[str, Any]:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def sm_info(device):
    """(SM count, maximum SM clock in Hz) of the card."""
    import subprocess

    import torch
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits",
                          f"--id={device.index or 0}"],
                         capture_output=True, text=True, timeout=60)
    return n_sm, float(out.stdout.strip().splitlines()[0]) * 1e6


def profiled_slice(run_once: Callable[[], None], device,
                   counters: Callable[[], Dict[str, int]]) -> Dict[str, Any]:
    """Run `run_once` under torch.profiler (after a synchronise) and reduce
    the trace (yardstick.trace). Adds window_s (host clock around the
    synchronised slice) and launches (the counters' increase)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .yardstick.kernels import SYMBOLS
    from .yardstick.trace import profile_events, reduce_events

    torch.cuda.synchronize(device)
    before = dict(counters())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t = time.perf_counter()
        run_once()
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t
    after = counters()
    out = reduce_events(*profile_events(prof), SYMBOLS)
    out["window_s"] = window_s
    out["launches"] = {k: after[k] - before.get(k, 0) for k in after}
    return out


def kernel_share(layer: Mapping) -> Optional[float]:
    """K1, K3 and K4's summed least time over their summed device time in
    the profiled slice, in %, or None where the trace did not keep every
    launch the counters saw (or the counters saw other launches than the
    yardstick expects)."""
    sl = layer.get("slice")
    if not sl:
        return None
    kernels = ("gsa_attention", "cost_lookup", "window_attention")
    for k in kernels:
        want = layer["expected_launches"].get(k, 0)
        seen, traced = sl["launches"].get(k, 0), sl["kernel_count"].get(k, 0)
        if not (want == seen == traced):
            print(f"portbench: {k}: {traced} activities in the trace, "
                  f"{seen} launches counted, {want} expected; no roofline "
                  "share from this trace", file=sys.stderr)
            return None
    spent = sum(sl["kernel_s"][k] for k in kernels)
    bound = sum(layer["bound_s"].get(k, 0.0) for k in kernels)
    return 100.0 * bound / spent if spent > 0 else None


def read_layer_metrics(ctx: Context, layer: Mapping) -> Dict[str, dict]:
    """Each per-layer metric of BENCHMARK.json that this cell reports,
    read by its own file, metrics/<name>.py (`read(layer) -> value or
    None`); a metric read as None is left out."""
    cell = ctx.cell["name"]
    own = {m["name"] for m in ctx.bench["end_to_end"]
           if cell in m.get("workloads", [cell])}
    out = {}
    for m in ctx.bench["per_layer"]:
        if cell not in m.get("workloads", [cell]) or m["moves"] not in own:
            continue
        path = os.path.join(HERE, "metrics", f"{m['name']}.py")
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{len(out)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(layer)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def end_to_end_metrics(ctx: Context, outcome: Outcome) -> Dict[str, dict]:
    cell = ctx.cell["name"]
    vals = dict(outcome.end_to_end, setup_s=outcome.setup_s)
    out = {}
    for m in ctx.bench["end_to_end"]:
        if cell in m.get("workloads", [cell]):
            out[m["name"]] = {"value": float(vals[m["name"]]),
                              "unit": m["unit"]}
    return out


def banned_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def result_line(ctx: Context, outcome: Outcome) -> Dict[str, Any]:
    correct = all(c.ok for c in outcome.checks) and outcome.failed == 0
    dev = dict(device_names(ctx.device),
               memory_peak_bytes=int(outcome.memory_peak_bytes))
    if ctx.trace:
        dev.update(busy_s=outcome.busy_s, window_s=outcome.window_s)
        metrics = read_layer_metrics(ctx, outcome.layer)
    else:
        metrics = end_to_end_metrics(ctx, outcome)
    line = {"correct": correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": dev}
    if ctx.trace and outcome.breakdown:
        line["breakdown"] = outcome.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in outcome.checks}
    return line
