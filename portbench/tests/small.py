"""A cell's files cut to a size the CPU runs in seconds, for the tests:
128^2 pairs, batches of 2, two decoder iterations and seeded weights (the
tracked snapshot is for 512^2 inputs). Widths are the configuration's."""

from __future__ import annotations

import copy
import json
import os

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load(rel):
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def overrides(cell: str) -> dict:
    bench = load("BENCHMARK.json")
    w = {c["name"]: c for c in bench["workloads"]}[cell]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = copy.deepcopy(load(conf["file"]))
    cfg["image_size"] = 128
    cfg["homography"]["input_size"] = 128
    cfg["flowformer"]["decoder_depth"] = 2
    cfg["weights"] = {"seeded": 0}
    cfg["reference"] = dict(cfg["reference"], micro_batch=1)
    tr = copy.deepcopy(load(f"portbench/traffic/{w['traffic']}.json"))
    tr["batch"] = 2
    tr["pool_batches"] = 3
    tr["warmup_batches"] = 1
    tr["size"] = [128, 128]
    tr["pairs"]["margin"] = 12
    tr["pairs"]["texture_scales"] = [[16, 1.0], [6, 0.6], [2, 0.35]]
    return {"config": cfg, "traffic": tr,
            "limits": load(f"portbench/limits/{cell}.json")}


def run_small(cell: str, seed: int = 5, seconds: float = 0.0,
              trace: bool = False, **changes):
    """(context, outcome) of a CPU run of `cell` at the small size."""
    from portbench.run import run_cell
    torch.set_num_threads(2)
    o = overrides(cell)
    for key, value in changes.items():
        o[key] = value
    return run_cell(ROOT, cell, seed, seconds, trace, torch.device("cpu"), o)
