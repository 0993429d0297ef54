"""The port's tracer on the card: device ms from its CUDA events, its
clock against torch.profiler's, `host_syncs` against CUDA's own sync
check, no synchronisation outside `timings` mode, nothing in the
profiler's trace.

Marked `gpu`; each test skips without a CUDA device. The file imports no
JAX and is run on the card without the suite's conftest.py:

    python3 -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_tracing_gpu.py
"""

import warnings

import pytest
import torch

from stitchax_torch.utils import tracing
from stitchax_torch.utils.precision import fp32_exact
from test_torch_tracing import (EVAL_SYNCS, TRAIN_SYNCS, SmallModels,
                                by_name, evaluate, small_batches, small_pair,
                                small_train)

TRAIN_SPANS = ("train.forward", "train.backward_flow", "train.loss",
               "train.backward", "train.update")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fp32_exact()
    tracing.disable()
    yield torch.device("cuda")
    tracing.disable()


@pytest.fixture
def train(cuda):
    state, step = small_train(cuda)
    a, b = small_pair(device=cuda)
    state, _ = step(state, a, b)             # warm: kernels built, cuDNN
    torch.cuda.synchronize()
    return state, step, a, b


@pytest.fixture
def models(cuda):
    m = SmallModels(cuda)
    evaluate(m, small_batches(1))            # warm
    torch.cuda.synchronize()
    return m


def sync_warnings(fn) -> int:
    """The synchronising CUDA calls `fn` makes, by CUDA's sync debug
    mode."""
    # the process's first switch into the mode warns once by itself
    torch.cuda.set_sync_debug_mode("warn")
    torch.cuda.set_sync_debug_mode(0)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in seen)


@pytest.mark.gpu
def test_device_ms_come_from_the_device(cuda):
    cycles = int(4e7)                        # ~20 ms at the card's clock
    torch.cuda._sleep(cycles)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    torch.cuda.synchronize()
    want = a.elapsed_time(b)
    tracing.enable()
    with tracing.span("probe", device=cuda):
        torch.cuda._sleep(cycles)
    s = by_name(tracing.snapshot(), "probe")[0]
    # the host leaves the span as soon as the spin is queued
    assert s["host_ms"] < 0.5 * want
    assert abs(s["device_ms"] - want) < 0.1 * want, (s, want)


@pytest.mark.gpu
def test_a_steps_spans_fit_in_its_device_time(train):
    state, step, a, b = train
    tracing.enable()
    step(state, a, b)
    snap = tracing.snapshot()
    root = by_name(snap, "train.step")[0]
    kids = [s for s in snap["spans"] if s["parent"] == root["id"]]
    assert tuple(s["name"] for s in kids) == TRAIN_SPANS
    assert all(s["device_ms"] > 0 for s in snap["spans"])
    assert sum(s["device_ms"] for s in kids) <= root["device_ms"] * 1.01


@pytest.mark.gpu
def test_spans_share_the_profilers_clock(cuda):
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(2048, 2048, device=cuda)
    torch.cuda.synchronize()
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with tracing.span("probe", device=cuda):
            x @ x
        torch.cuda.synchronize()
    start = prof.profiler.kineto_results.trace_start_ns()
    mm = [e for e in prof.events() if e.name == "aten::mm"
          and e.device_type == torch.autograd.DeviceType.CPU]
    s = by_name(tracing.snapshot(), "probe")[0]
    assert len(mm) == 1
    a = start + int(mm[0].time_range.start * 1e3)
    b = start + int(mm[0].time_range.end * 1e3)
    # the span encloses the op's host event, within 1 ms
    assert s["start_ns"] - 1e6 <= a <= b <= s["end_ns"] + 1e6


@pytest.mark.gpu
def test_host_syncs_equal_cudas_sync_warnings(train, models):
    state, step, a, b = train
    batches = small_batches(1)
    tracing.enable()
    n_train = sync_warnings(lambda: step(state, a, b))
    after_train = tracing.snapshot()["counters"]["host_syncs"]
    n_eval = sync_warnings(lambda: evaluate(models, batches))
    after_eval = tracing.snapshot()["counters"]["host_syncs"]
    assert (n_train, n_eval) == (after_train, after_eval - after_train)
    assert (n_train, n_eval) == (TRAIN_SYNCS, EVAL_SYNCS)


@pytest.mark.gpu
def test_only_timings_mode_synchronises(train, models, monkeypatch):
    state, step, a, b = train
    calls = []
    sync = torch.cuda.synchronize

    def counted(*args, **kw):
        calls.append(1)
        return sync(*args, **kw)

    batches = small_batches(1)
    tracing.enable()
    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    step(state, a, b)
    evaluate(models, batches)
    untimed = len(calls)
    step(state, a, b, {})
    timed = len(calls) - untimed
    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    assert untimed == 0
    assert timed == 2 * len(TRAIN_SPANS)     # both ends of each timed span


@pytest.mark.gpu
def test_off_records_no_event(train, models, monkeypatch):
    state, step, a, b = train

    def refuse(*args, **kw):
        raise AssertionError("a CUDA event with the tracer off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    step(state, a, b)
    evaluate(models, small_batches(1))


@pytest.mark.gpu
def test_a_profiled_step_holds_no_user_annotation(train, models):
    from torch.profiler import ProfilerActivity, profile

    state, step, a, b = train
    batches = small_batches(1)
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, a, b)
        evaluate(models, batches)
        torch.cuda.synchronize()
    events = prof.events()
    assert any(e.device_type == torch.autograd.DeviceType.CUDA
               for e in events)
    assert not [e.name for e in events if e.is_user_annotation]
    spans = {s["name"] for s in tracing.snapshot()["spans"]}
    assert "flow.motion_encoder" in spans
    assert not spans & {e.name for e in events}
