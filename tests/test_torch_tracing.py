"""The port's tracer (stitchax_torch.utils.tracing) on the CPU.

Off, a span is one shared no-op and the train step and the evaluation make
no CUDA call; on, spans nest under one root per batch or step, the bounded
buffer drops its oldest records, `host_syncs` counts the program's forced
host-device syncs, and the spans share torch.profiler's clock without
adding anything to its trace; with a `timings` dict every step and the
stitcher keep their per-stage keys. Also the numbers `tools/trace_cell.py`
reads from a snapshot (these tests go with that file, once the benchmark's
own loops and metrics read the tracer). The card's side:
tests/test_torch_tracing_gpu.py.

The small nets here are seeded, not trained: the homography net at 128^2
and FlowFormer++ at decoder depth 2, encoder depth 1.
"""

import importlib.util
import os
import time
import tracemalloc

import numpy as np
import pytest
import torch

from stitchax_torch.utils import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_trace_cell():
    spec = importlib.util.spec_from_file_location(
        "trace_cell", os.path.join(REPO, "tools", "trace_cell.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


trace_cell = _load_trace_cell()

SIZE = 128
# forced syncs of one step / batch at this size, by site: the train step's
# corners, DLT solve, the normalising matrix and its inverse, the warp's two
# grids and the clip (one parameter group); the evaluation's two uploads,
# the same homography work (the inverse homography and its normalisation
# too), the two warps' four grids and the one download of the batch's
# scores (the pairs are scored on the device). They are counted
# on a CUDA device only; the tests that count them here on the CPU count
# the CPU's sites as the card's (`cpu_counts_syncs`).
TRAIN_SYNCS, EVAL_SYNCS = 7, 14


@pytest.fixture(autouse=True)
def _tracer_off():
    """Each test starts and ends with the tracer off."""
    tracing.disable()
    yield
    tracing.disable()


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_nets(device="cpu", upsample_all=True):
    from stitchax_torch.models.flowformer import FlowFormer, FlowFormerConfig
    from stitchax_torch.models.udis2 import UDIS2HomographyNet

    torch.manual_seed(0)
    homo = UDIS2HomographyNet(SIZE)
    flow = FlowFormer(FlowFormerConfig(decoder_depth=2, encoder_depth=1,
                                       upsample_all=upsample_all))
    return homo.to(device), flow.to(device)


def small_pair(batch=1, device="cpu"):
    g = torch.Generator().manual_seed(1)
    a = torch.floor(torch.rand(batch, SIZE, SIZE, 3, generator=g) * 255)
    b = torch.roll(a, 7, 2)
    return a.to(device), b.to(device)


def small_train(device="cpu", **optim):
    """(state, step) of the alignment trainer on the small nets."""
    from stitchax_torch.align.adapter import AlignConfig
    from stitchax_torch.train import (LossConfig, OptimConfig,
                                      create_train_state, make_train_step)

    homo, flow = small_nets(device)
    state, tx = create_train_state({"homo": homo, "flow": flow},
                                   OptimConfig(**optim))
    return state, make_train_step(homo, flow, tx, AlignConfig(), LossConfig())


class SmallModels:
    """What `validate_with_model` reads of `StitchModels`."""

    def __init__(self, device="cpu"):
        self.homo_model, self.flow_model = (
            m.eval() for m in small_nets(device, upsample_all=False))
        self.dtype, self.device = torch.float32, torch.device(device)


def small_batches(n, device="cpu"):
    a, b = small_pair(2)
    return [{"image1": a.numpy(), "image2": b.numpy(), "name": ["0", "1"]}
            for _ in range(n)]


def evaluate(models, batches):
    from stitchax_torch.align.adapter import AlignConfig
    from stitchax_torch.evaluate import validate_with_model
    return validate_with_model(None, batches, models, AlignConfig())


@pytest.fixture
def cpu_counts_syncs(monkeypatch):
    """Count the forced-sync sites of work on the CPU as on a card."""
    monkeypatch.setattr(tracing, "SYNC_DEVICES", ("cuda", "cpu"))


@pytest.fixture(scope="module")
def train():
    return small_train()


@pytest.fixture(scope="module")
def models():
    return SmallModels()


def by_name(snap, name):
    return [s for s in snap["spans"] if s["name"] == name]


# ----------------------------------- off -------------------------------------

def test_off_span_is_one_shared_noop():
    a, b = tracing.span("a"), tracing.span("b")
    assert a is b
    with a:
        tracing.count("host_syncs")
    tracing.enable()
    tracing.disable()
    with tracing.span("c"):
        tracing.count("host_syncs")
    snap = tracing.snapshot()
    assert snap["spans"] == [] and snap["counts"] == []
    assert snap["counters"] == {} and not snap["on"]


def test_off_span_allocates_nothing():
    span = tracing.span
    for _ in range(100):                  # warm: interned names, frames
        with span("eval.align"):
            pass
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        for _ in range(10000):
            with span("eval.align"):
                pass
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak - base < 1024, peak - base


def test_off_train_step_and_eval_batch_touch_no_cuda(monkeypatch, train,
                                                     models):
    def refuse(*a, **k):
        raise AssertionError("a CUDA call with the tracer off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    tracing.enable(device="cpu")
    tracing.disable()
    state, step = train
    state, _ = step(state, *small_pair())
    evaluate(models, small_batches(1))
    snap = tracing.snapshot()
    assert snap["spans"] == [] and snap["counts"] == []


# ------------------------------------ on -------------------------------------

def test_train_spans_nest_under_the_step():
    state, step = small_train()
    tracing.enable()
    for _ in range(2):
        state, _ = step(state, *small_pair())
    snap = tracing.snapshot()
    roots = by_name(snap, "train.step")
    assert [r["root"] for r in roots] == [0, 1]     # the state's steps
    assert all(r["parent"] is None for r in roots)
    for r in roots:
        kids = [s for s in snap["spans"] if s["parent"] == r["id"]]
        assert [s["name"] for s in kids] == [
            "train.forward", "train.backward_flow", "train.loss",
            "train.backward", "train.update"]
        upd = kids[-1]
        assert [s["name"] for s in snap["spans"]
                if s["parent"] == upd["id"]] == ["train.clip", "train.adamw"]
    ids = {s["id"]: s for s in snap["spans"]}
    enc = by_name(snap, "flow.motion_encoder")
    # two decoder iterations in each of the two flow calls of a step
    assert len(enc) == 8
    assert {ids[s["parent"]]["name"] for s in enc} == {
        "train.forward", "train.backward_flow"}
    for s in snap["spans"]:
        assert s["parent"] is None or s["root"] == ids[s["parent"]]["root"]
        assert s["start_ns"] <= s["end_ns"] and s["device_ms"] is None
        if s["parent"] is not None:
            p = ids[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]


def test_eval_spans_nest_under_the_batch(models):
    tracing.enable()
    evaluate(models, small_batches(2))
    snap = tracing.snapshot()
    roots = by_name(snap, "eval.batch")
    assert len(roots) == 2 and len({r["root"] for r in roots}) == 2
    ids = {s["id"]: s for s in snap["spans"]}
    for r in roots:
        assert r["root"] == r["id"] and r["parent"] is None
        kids = [s for s in snap["spans"] if s["parent"] == r["id"]]
        assert [s["name"] for s in kids] == [
            "eval.upload", "eval.align", "eval.score", "eval.download"]
        align = [s for s in snap["spans"] if s["parent"] == kids[1]["id"]]
        assert [s["name"] for s in align] == [
            "align.homography", "align.flow", "align.flow"]
        enc = [s for s in by_name(snap, "flow.motion_encoder")
               if s["root"] == r["root"]]
        assert len(enc) == 4
        assert {ids[s["parent"]]["name"] for s in enc} == {"align.flow"}
    # every pair of each batch scored, counted under `eval.score`
    assert trace_cell.counter_per_root(snap, "eval.batch",
                                       "score.pairs") == [2, 2]
    assert {ids[c["span"]]["name"] for c in snap["counts"]
            if c["name"] == "score.pairs"} == {"eval.score"}


def test_buffer_keeps_the_newest_and_counts_what_it_dropped():
    tracing.enable(capacity=4, device="cpu")
    for i in range(5):
        with tracing.span(f"s{i}"):
            pass
    tracing.count("c", 3)
    snap = tracing.snapshot()
    assert snap["dropped"] == 2
    assert [s["name"] for s in snap["spans"]] == ["s2", "s3", "s4"]
    assert [(c["name"], c["n"]) for c in snap["counts"]] == [("c", 3)]
    assert snap["counters"] == {"c": 3}


def test_a_parent_overwritten_while_open_is_dropped():
    tracing.enable(capacity=3, device="cpu")
    with tracing.span("outer"):
        for i in range(3):
            with tracing.span(f"inner{i}"):
                tracing.count("n")
    snap = tracing.snapshot()
    # seven records (a span and a count per inner) through three slots
    assert [s["name"] for s in snap["spans"]] == ["inner2"]
    assert snap["dropped"] == 4 and len(snap["counts"]) == 2
    # the counters' totals outlive the records
    assert snap["counters"] == {"n": 3}


def test_counts_land_under_the_innermost_span():
    tracing.enable(device="cpu")
    tracing.count("free")
    with tracing.span("a", root=41):
        with tracing.span("b"):
            tracing.count("host_syncs", 2)
    snap = tracing.snapshot()
    b = by_name(snap, "b")[0]
    free, inner = snap["counts"]
    assert free["span"] is None and free["root"] is None
    assert inner["span"] == b["id"] and inner["root"] == 41 == b["root"]
    assert tracing.disable() == {"on": False}


def test_host_syncs_per_step_and_per_batch(models, cpu_counts_syncs):
    state, step = small_train()
    tracing.enable()
    state, _ = step(state, *small_pair())
    evaluate(models, small_batches(2))
    snap = tracing.snapshot()
    counter_per_root = trace_cell.counter_per_root
    assert counter_per_root(snap, "train.step", "host_syncs") == [
        TRAIN_SYNCS]
    assert counter_per_root(snap, "eval.batch", "host_syncs") == [
        EVAL_SYNCS] * 2
    assert snap["counters"]["host_syncs"] == TRAIN_SYNCS + 2 * EVAL_SYNCS


def test_host_syncs_are_not_counted_on_the_cpu(train, models):
    state, step = train
    tracing.enable()
    step(state, *small_pair())
    evaluate(models, small_batches(1))
    tracing.count_sync(torch.device("cpu"))
    tracing.count_sync(None)
    tracing.count_sync("cuda:0", 2)           # names the card: counted
    snap = tracing.snapshot()
    assert snap["counters"] == {"host_syncs": 2, "score.pairs": 2}
    assert [c["n"] for c in snap["counts"]
            if c["name"] == "host_syncs"] == [2]


def test_host_syncs_count_one_clip_per_parameter_group(cpu_counts_syncs):
    from stitchax_torch.train.optim import clip_by_global_norm, \
        fetch_optimizer, OptimConfig

    tx = fetch_optimizer(OptimConfig(twins_lr_factor=0.5),
                         encoder_mask=lambda n: n.startswith("enc"))
    params = {"enc.w": torch.ones(3), "dec.w": torch.ones(2)}
    grads = {k: torch.full_like(v, 0.1) for k, v in params.items()}
    tracing.enable(device="cpu")
    tx.update(grads, tx.init(params), params)
    clip_by_global_norm([torch.ones(2)], 1.0)
    snap = tracing.snapshot()
    assert snap["counters"] == {"host_syncs": 3}
    assert [s["name"] for s in snap["spans"]] == [
        "train.clip", "train.adamw", "train.clip", "train.adamw"]


# ---------------------------------- timings ----------------------------------

@pytest.mark.parametrize("fb", [True, False])
def test_alignment_step_timings_keep_their_keys(fb):
    from stitchax_torch.align.adapter import AlignConfig
    from stitchax_torch.train import (LossConfig, OptimConfig,
                                      create_train_state, make_train_step)

    homo, flow = small_nets()
    state, tx = create_train_state({"homo": homo, "flow": flow},
                                   OptimConfig())
    step = make_train_step(homo, flow, tx, AlignConfig(), LossConfig(),
                           use_fb_consistency_mask=fb)
    timings = {}
    t = time.perf_counter()
    step(state, *small_pair(), timings)
    wall = (time.perf_counter() - t) * 1e3
    want = {"forward_ms", "backward_ms", "update_ms"}
    assert set(timings) == (want | {"backward_flow_ms"} if fb else want)
    assert all(v > 0 for v in timings.values())
    assert sum(timings.values()) <= wall


def test_timings_and_tracing_together(train):
    state, step = train
    tracing.enable()
    timings = {}
    step(state, *small_pair(), timings)
    snap = tracing.snapshot()
    fwd = by_name(snap, "train.forward")[0]["host_ms"]
    assert set(timings) == {"forward_ms", "backward_flow_ms", "backward_ms",
                            "update_ms"}
    assert abs(fwd - timings["forward_ms"]) < 0.2 * timings["forward_ms"]
    back = sum(by_name(snap, n)[0]["host_ms"]
               for n in ("train.loss", "train.backward"))
    assert back <= timings["backward_ms"] * 1.2


def test_transref_step_timings_keep_their_keys():
    from stitchax_torch.train.transref_trainer import (
        create_train_state, make_transref_train_step)

    torch.manual_seed(0)
    net = torch.nn.Conv2d(4, 3, 3, padding=1)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = net

        def forward(self, inp, mask, ref):
            x = torch.cat([inp[..., :3], mask], -1).permute(0, 3, 1, 2)
            return self.net(x).permute(0, 2, 3, 1) + ref

    model = Net()
    state, tx = create_train_state(model, 1e-3)
    step = make_transref_train_step(
        model, None, tx,
        total_loss=lambda vgg, out, gt, mask, **kw: {
            "total": ((out - gt) ** 2).mean()})
    gt = torch.rand(2, 16, 16, 3) * 2 - 1
    mask = torch.zeros(2, 16, 16, 1)
    timings = {}
    tracing.enable()
    step(state, gt, gt.flip(1), mask, timings)
    snap = tracing.snapshot()
    assert set(timings) == {"forward_ms", "loss_ms", "backward_ms",
                            "adam_ms"}
    assert [s["name"] for s in snap["spans"]] == [
        "transref.step", "transref.forward", "transref.loss",
        "transref.backward", "transref.adam"]


def test_sd_steps_timings_keep_their_keys():
    from stitchax_torch.models.diffusion import (ControlNet,
                                                 UNet2DCondition, UNetConfig)
    from stitchax_torch.models.vae import AutoencoderKL
    from stitchax_torch.train.sd_inpaint_trainer import (
        create_train_state, make_diffusion_train_step, make_vae_train_step)

    w = 8
    torch.manual_seed(0)
    cfg = UNetConfig(in_channels=9, out_channels=4, block_channels=(w, 2 * w),
                     layers_per_block=1, attention_resolutions=(0, 1),
                     context_dim=2 * w, num_heads=2, num_train_timesteps=1000,
                     norm_groups=4)
    unet, cnet = UNet2DCondition(cfg), ControlNet(cfg)
    vae = AutoencoderKL(block_channels=(w,) * 4, latent_channels=4, groups=4)
    x = torch.rand(2, 32, 32, 3)
    hole = torch.zeros(2, 32, 32, 1)
    hole[:, 8:20, 8:20] = 1.0

    state, tx = create_train_state({"vae": vae}, 1e-4)
    timings = {}
    make_vae_train_step(vae, tx)(state, x * 2 - 1, timings)
    assert set(timings) == {"forward_ms", "backward_ms", "adam_ms"}

    state, tx = create_train_state({"unet": unet, "controlnet": cnet}, 1e-4)
    step = make_diffusion_train_step(unet, cnet, vae, tx,
                                     torch.randn(1, 77, 2 * w))
    timings = {}
    step(state, x, hole, generator=torch.Generator().manual_seed(0),
         timings=timings)
    assert set(timings) == {"vae_encode_ms", "forward_ms", "backward_ms",
                            "adam_ms"}


def stub_homo(a, b):
    off = torch.tensor([3.0, 2.0, -4.0, 1.0, 2.0, -3.0, -1.0, 4.0])
    return off.to(a)[None].expand(a.shape[0], 8)


def stub_flow(a, b):
    return [torch.tanh((a - b)[..., :2] / 255.0) * 2.0], None


@pytest.mark.parametrize("config,extra", [
    ("fast_cv_g8", set()), ("fast_cv_g8_comp", {"composition_ms"})])
def test_stitcher_timings_keep_their_keys(config, extra, cpu_counts_syncs):
    from stitchax_torch.align.adapter import AlignConfig
    from stitchax_torch.models import CompositionNet
    from stitchax_torch.run.stitcher import Stitcher

    models = None
    if extra:
        class Models:
            comp_model, dtype = CompositionNet().eval(), torch.float32
        models = Models()
    st = Stitcher(models, None, AlignConfig(model_size=128, canvas_bucket=64),
                  device="cpu", homo_fn=stub_homo, flow_fn=stub_flow,
                  config=config)
    rng = np.random.default_rng(0)
    img1 = rng.integers(0, 256, (160, 192, 3)).astype(np.float32)
    img2 = np.roll(img1, 9, 1)
    keys = {"align_ms", "render_ms", "inpaint_ms", "tps_mix_ms"} | extra
    first, timings = {}, {}
    tracing.enable()
    t = time.perf_counter()
    st.stitch(img1, img2, timings=first)
    wall = (time.perf_counter() - t) * 1e3
    st.stitch(img1, img2, timings=timings)
    snap = tracing.snapshot()
    assert set(first) == set(timings) == keys
    assert all(v >= 0 for v in timings.values())
    assert sum(v for k, v in first.items() if k != "inpaint_ms") <= wall
    assert timings["inpaint_ms"] <= timings["tps_mix_ms"]
    names = [s["name"] for s in snap["spans"]]
    assert names.count("stitch.render") == 2
    assert names.count("stitch.inpaint") == names.count("stitch.tps_mix")
    render = by_name(snap, "stitch.render")[0]
    # canvas_box's download, under the render span
    assert any(c["span"] == render["id"] for c in snap["counts"])


# ----------------------------- the profiler's clock ---------------------------

def test_spans_share_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(256, 256)
    tracing.enable(device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("probe"):
            torch.mm(x, x)
    start = prof.profiler.kineto_results.trace_start_ns()
    mm = [e for e in prof.events() if e.name == "aten::mm"]
    s = by_name(tracing.snapshot(), "probe")[0]
    assert len(mm) == 1
    a = start + int(mm[0].time_range.start * 1e3)
    b = start + int(mm[0].time_range.end * 1e3)
    # the span encloses the op's host event, within 1 ms
    assert s["start_ns"] - 1e6 <= a <= b <= s["end_ns"] + 1e6


def test_a_profiled_step_holds_no_user_annotation(train):
    from torch.profiler import ProfilerActivity, profile

    state, step = train
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, *small_pair())
    names = {e.name for e in prof.events()}
    assert "aten::convolution" in names
    assert not [e.name for e in prof.events() if e.is_user_annotation]
    spans = {s["name"] for s in tracing.snapshot()["spans"]}
    assert not names & spans


def test_the_port_emits_no_profiler_annotation():
    pkg = os.path.join(REPO, "stitchax_torch")
    found = []
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(root, f)).read()
                for bad in ("record_function(", "nvtx.", "profiler.profile",
                            "_record_function"):
                    if bad in text:
                        found.append((f, bad))
    assert not found


# ------------------------- the numbers tools/trace_cell.py reads --------------

def span(i, name, parent, root, host, device):
    return {"id": i, "name": name, "parent": parent, "root": root,
            "start_ns": 0, "end_ns": 1, "host_ms": host, "device_ms": device}


def synthetic_program():
    """Three evaluation batches and three train steps, with readings
    whose medians are known; one batch root left open (not reported)."""
    spans, counts = [], []
    i = 0
    for b, (align, enc, score, syncs) in enumerate(
            [(100.0, (30.0, 20.0), 9.0, 4), (300.0, (60.0, 70.0), 7.0, 2),
             (200.0, (40.0, 45.0), 8.0, 3)]):
        root = i
        spans.append(span(i, "eval.batch", None, root, 500.0, 400.0))
        spans.append(span(i + 1, "eval.align", root, root, 1.0, align))
        spans.append(span(i + 2, "flow.motion_encoder", i + 1, root, 0.1,
                          enc[0]))
        spans.append(span(i + 3, "flow.motion_encoder", i + 1, root, 0.1,
                          enc[1]))
        spans.append(span(i + 4, "eval.score", root, root, score, 0.0))
        counts.append({"id": i + 5, "name": "host_syncs", "span": i + 1,
                       "root": root, "t_ns": 0, "n": syncs})
        i += 6
    counts.append({"id": i, "name": "host_syncs", "span": None,
                   "root": None, "t_ns": 0, "n": 50})
    for step, (f, bf, lo, bw, up, syncs) in enumerate(
            [(10.0, 5.0, 1.0, 30.0, 4.0, 1), (20.0, 6.0, 1.0, 10.0, 2.0, 1),
             (30.0, 7.0, 2.0, 20.0, 3.0, 3)], start=7):
        spans.append(span(1000 + step, "train.step", None, step, 90.0, 80.0))
        for j, (n, v) in enumerate([("train.forward", f),
                                    ("train.backward_flow", bf),
                                    ("train.loss", lo),
                                    ("train.backward", bw),
                                    ("train.update", up)]):
            spans.append(span(2000 + 10 * step + j, n, 1000 + step, step,
                              v + 1.0, v))
        counts.append({"id": 3000 + step, "name": "host_syncs",
                       "span": 2000 + 10 * step + 4, "root": step,
                       "t_ns": 0, "n": syncs})
    # an open batch root: its children are not read
    spans.append(span(5000, "eval.align", 4999, 4999, 1.0, 1e6))
    return {"spans": spans, "counts": counts,
            "counters": {"host_syncs": 68}, "dropped": 0}


READINGS = {"align_device_ms.eval": 200.0, "motion_encoder_ms.eval": 85.0,
            "score_ms.eval": 8.0, "host_syncs.eval": 3,
            "forward_device_ms.train": 27.0,
            "backward_device_ms.train": 20.0,
            "update_device_ms.train": 3.0, "host_syncs.train": 1}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_trace_cell_reads_its_median(name):
    assert trace_cell.READERS[name](synthetic_program()) == pytest.approx(
        READINGS[name])


@pytest.mark.parametrize("name", sorted(READINGS))
def test_trace_cell_reads_nothing_without_a_program(name):
    read = trace_cell.READERS[name]
    assert read(None) is None
    assert read({"spans": [], "counts": []}) is None


def test_trace_cell_span_table():
    table = trace_cell.span_table(synthetic_program(), "eval.batch")
    assert set(table) == {"eval.batch", "eval.align", "flow.motion_encoder",
                          "eval.score"}
    assert table["eval.batch"] == {"host_ms": 500.0, "device_ms": 400.0}
    assert table["eval.align"]["device_ms"] == pytest.approx(200.0)
    # two encoder spans a batch: summed, then the median over the batches
    assert table["flow.motion_encoder"] == pytest.approx(
        {"host_ms": 0.2, "device_ms": 85.0})
    train = trace_cell.span_table(synthetic_program(), "train.step")
    assert train["train.update"] == {"host_ms": 4.0, "device_ms": 3.0}
    assert trace_cell.span_table(None, "eval.batch") == {}
    assert trace_cell.span_table({"spans": []}, "train.step") == {}
