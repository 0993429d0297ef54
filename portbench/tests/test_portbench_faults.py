"""Runs of each cell on the CPU at a small size, past the harness's look
for a card, with the timed path broken underneath: `correct` must come out
false for every fault the cell can have (a step that returns its state
unchanged, half of the batch left out with the mean taken over the rest,
an answer altered where it is produced; no cell here exchanges anything
between chips). And the control, the reference in TF32 (emulated on the
CPU), must fail the cell's limits."""

import pytest
import torch

from portbench.harness import result_line
from portbench.tests.small import ROOT, overrides, run_small

EVAL, TRAIN = "eval.ffpp_udis2.b12", "train.ffpp_udis2.b8"


def _correct(cell, **kw):
    ctx, out = run_small(cell, **kw)
    return result_line(ctx, out)["correct"], out


def test_sound_runs_are_correct():
    for cell in (EVAL, TRAIN):
        ok, out = _correct(cell)
        assert ok, [(c.name, c.value, c.limit) for c in out.checks]


def _break_eval_step(monkeypatch, fault):
    import stitchax_torch.evaluate as ev
    make = ev.make_eval_step

    def broken(models, align_cfg):
        step = make(models, align_cfg)

        def run(img1, img2):
            if fault == "unchanged":          # img2 as it came, all covered
                return img2.clone(), torch.ones_like(img2[..., :1])
            if fault == "half":
                h = img1.shape[0] // 2
                w, v = step(img1[:h], img2[:h])
                return torch.cat([w, w]), torch.cat([v, v])
            w, v = step(img1, img2)           # one pair's answer altered
            w = w.clone()
            w[0] += 1.0
            return w, v
        return run

    monkeypatch.setattr(ev, "make_eval_step", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_eval_faults_are_not_correct(monkeypatch, fault):
    _break_eval_step(monkeypatch, fault)
    ok, _ = _correct(EVAL)
    assert not ok


def _break_train_step(monkeypatch, fault):
    import stitchax_torch.train as tr
    make = tr.make_train_step

    def broken(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(state, img1, img2, timings=None):
            if fault == "unchanged":          # losses taken, nothing updated
                metrics, _ = step.loss_and_grads(state, img1, img2)
                return state, metrics
            if fault == "half":
                h = img1.shape[0] // 2
                return step(state, img1[:h], img2[:h], timings)
            state, metrics = step(state, img1, img2, timings)
            metrics = dict(metrics, total=metrics["total"] * 1.01)
            return state, metrics
        return run

    monkeypatch.setattr(tr, "make_train_step", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_train_faults_are_not_correct(monkeypatch, fault):
    _break_train_step(monkeypatch, fault)
    ok, _ = _correct(TRAIN)
    assert not ok


@pytest.mark.parametrize("cell", [EVAL, TRAIN])
def test_the_control_fails_the_limits(cell):
    from portbench.control import readings
    torch.set_num_threads(2)
    o = overrides(cell)
    got = [r for r in readings(ROOT, cell, 5, torch.device("cpu"), o)
           if r["reading"] == "control"][0]["checks"]
    assert any(v > o["limits"][k] for k, v in got.items()), got
