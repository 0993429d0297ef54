"""The TransRef training cell (`train_transref.b32`) on the CPU at a small
size, past the harness's look for a card: a sound run is `correct`; a step
that returns its state unchanged and a step on half of the batch (the mean
taken over the rest) make `correct` false; the control (the reference in
TF32, emulated on the CPU) and the planted faults of
`portbench.control_transref` fail the cell's limits; the frozen FLOP count
is the sum of its parts; the tracer's spans reach the per-layer readers;
and the new reference modules load neither the program nor JAX.

The small size: 128^2 (TransRef's smallest), batches of 2 from a pool of
3, the reference taking one image at a time, seeded random weights (the
reference's initialisers, handed to the program) and the cell's widths."""

import copy
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from portbench.harness import result_line
from portbench.tests.small import ROOT, load

CELL = "train_transref.b32"
BANNED = {"jax", "jaxlib", "flax", "optax", "stitchax", "stitchax_torch"}


def overrides() -> dict:
    bench = load("BENCHMARK.json")
    w = {c["name"]: c for c in bench["workloads"]}[CELL]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = copy.deepcopy(load(conf["file"]))
    cfg["image_size"] = 128
    cfg["weights"] = {"seeded": 0}
    cfg["reference"] = dict(cfg["reference"], micro_batch=1)
    tr = copy.deepcopy(load(f"portbench/traffic/{w['traffic']}.json"))
    tr.update(batch=2, pool_batches=3, warmup_steps=1, size=[128, 128])
    tr["pairs"]["margin"] = 12
    tr["pairs"]["texture_scales"] = [[16, 1.0], [6, 0.6], [2, 0.35]]
    return {"config": cfg, "traffic": tr,
            "limits": load(f"portbench/limits/{CELL}.json")}


def run_small(trace=False):
    from portbench.run import run_cell
    torch.set_num_threads(2)
    ctx, out = run_cell(ROOT, CELL, 5, 0.0, trace, torch.device("cpu"),
                        overrides())
    return result_line(ctx, out), out


def test_a_sound_run_is_correct():
    line, out = run_small()
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"setup_s", "train_pairs_per_s"}


def _break_step(monkeypatch, fault):
    import stitchax_torch.train.transref_trainer as tt
    make = tt.make_transref_train_step

    def broken(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(state, gt, ref, mask, timings=None):
            if fault == "unchanged":          # losses taken, nothing updated
                metrics, _ = step.loss_and_grads(state, gt, ref, mask)
                return state, metrics
            h = gt.shape[0] // 2
            return step(state, gt[:h], ref[:h], mask[:h], timings)
        return run

    monkeypatch.setattr(tt, "make_transref_train_step", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_faults_are_not_correct(monkeypatch, fault):
    _break_step(monkeypatch, fault)
    line, _ = run_small()
    assert not line["correct"], line["checks"]


def test_the_control_and_the_planted_faults_fail_the_limits():
    from portbench.control_transref import READINGS, readings
    torch.set_num_threads(2)
    o = overrides()
    got = {r["reading"]: r["checks"]
           for r in readings(ROOT, CELL, 5, torch.device("cpu"), o)}
    assert set(got) == {name for name, _ in READINGS}
    for name, checks in got.items():
        assert any(v > o["limits"][k] for k, v in checks.items()), \
            (name, checks)


def test_a_traced_run_feeds_the_span_readers():
    line, out = run_small(trace=True)
    prog = out.layer["program"]
    assert prog["counters"]["deform.calls"] == 3 * len(
        [s for s in prog["spans"] if s["name"] == "transref.step"])
    # off a card spans carry no device ms, so only the host-clock share
    # is read; the span readers find their steps but no device reading
    assert set(line["metrics"]) == {"mfu.train_transref"}
    from portbench.yardstick.spans import per_root
    assert per_root(prog, "transref.step", ["transref.refpa"],
                    "host_ms")


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "portbench", "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(i, name, parent, root, ms):
    return {"id": i, "name": name, "parent": parent, "root": root,
            "start_ns": 0, "end_ns": 1, "host_ms": ms, "device_ms": ms}


@pytest.mark.parametrize("name,want", [
    ("forward_device_ms.train_transref", 30.0),
    ("refpa_device_ms.train_transref", 6.0),
    ("loss_device_ms.train_transref", 20.0),
    ("backward_device_ms.train_transref", 50.0),
    ("adam_device_ms.train_transref", 4.0)])
def test_span_readers_take_the_median_step(name, want):
    spans = []
    for step, scale in ((0, 1.0), (1, 1.5), (2, 0.5)):
        b = 100 * step
        spans += [_span(b, "transref.step", None, step, 110 * scale),
                  _span(b + 1, "transref.forward", b, step, 30 * scale)]
        spans += [_span(b + 2 + k, "transref.refpa", b + 1, step, 2 * scale)
                  for k in range(3)]
        spans += [_span(b + 5, "transref.loss", b, step, 20 * scale),
                  _span(b + 6, "transref.backward", b, step, 50 * scale),
                  _span(b + 7, "transref.adam", b, step, 4 * scale)]
    assert _reader(name)({"program": {"spans": spans}}) == \
        pytest.approx(want)
    # the parent commit's program has no root span `transref.step`
    flat = [dict(s, parent=None, root=s["id"]) for s in spans
            if s["name"] != "transref.step"]
    assert _reader(name)({"program": {"spans": flat}}) is None
    assert _reader(name)({}) is None


def test_frozen_model_flops_are_the_sum_of_their_parts():
    from portbench.yardstick.flops_transref import load as load_flops
    f = load_flops("transref_vgg16_fp32")
    assert f["train_pair"] == f["forward"] + f["vgg"] + f["backward"]
    assert f["vgg"] > f["forward"] > 0


REFERENCE = """
import json, sys, torch
sys.path.insert(0, %r)
from portbench.reference.transref import TransRef
from portbench.reference.transref_train import Adam, loss_and_grads
from portbench.reference.vgg import seeded_vgg
torch.set_num_threads(2)
torch.manual_seed(0)
model, vgg = TransRef(), seeded_vgg(1)
gt = torch.rand(1, 128, 128, 3) * 2 - 1
mask = torch.zeros(1, 128, 128, 1)
losses, grads = loss_and_grads(model, vgg, gt, gt.flip(2), mask,
                               {"l1": 1, "perceptual": 0.04, "style": 250}, 1)
Adam(1e-4).step(dict(model.named_parameters()), grads)
print(json.dumps(sorted(sys.modules)))
"""


def test_the_new_reference_loads_nothing_of_the_program():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", REFERENCE % ROOT], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = {m.split(".")[0]
            for m in json.loads(out.stdout.strip().splitlines()[-1])}
    assert not tops & BANNED, tops & BANNED
