"""The port's TransRef train step against the benchmark's plain reference
(portbench/reference/transref.py, vgg.py, transref_train.py: plain PyTorch,
no JAX, nothing of stitchax_torch), and the step's tracing, on the CPU.

Both sides start from the same seeded random weights (the reference's
initialisers, loaded into the port's TransRefBase by name) and the VGG16
the trainer's CLI draws from a seed, at 128^2 (TransRef's smallest size),
batch 2, on the same pairs and holes: the losses of two steps, every
leaf's first gradient, and every leaf after two Adam steps. The reference
takes the batch whole here (one micro-batch), so both sides run the same
operations in the same order; tolerances are stated where they are used.
The tracing: one step's spans nest as `transref.step` (root: the state's
step) > forward (> encoder > three RefPA calls, decoder), loss, backward,
adam, and `deform.calls` / `deform.taps_gathered` count one forward's
three deformable convolutions.
"""

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

SIZE, BATCH, LR, VGG_SEED = 128, 2, 1e-4, 11
LOSS = {"l1": 1.0, "perceptual": 0.04, "style": 250.0}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def inputs(seed=3):
    """(gt, ref, mask): two seeded images in [-1, 1] with a shifted view as
    the reference, and the trainer's three rectangles an image."""
    from stitchax_torch.train.transref_trainer import (draw_rect_boxes,
                                                       rect_masks)

    g = torch.Generator().manual_seed(seed)
    base = torch.rand(BATCH, SIZE // 8, SIZE // 8, 3, generator=g)
    gt = torch.nn.functional.interpolate(
        base.permute(0, 3, 1, 2), size=(SIZE, SIZE), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1) * 2 - 1
    ref = torch.roll(gt, 9, 2)
    mask = rect_masks(*draw_rect_boxes(g, BATCH, SIZE), SIZE)
    return gt.contiguous(), ref.contiguous(), mask


def seeded_models():
    """(reference TransRef, port TransRefBase) with the same seeded weights,
    and (reference VGG, port VGG) drawn as the CLI draws them."""
    from portbench.reference.transref import TransRef
    from portbench.reference.vgg import seeded_vgg
    from stitchax_torch.models.transref import TransRefBase
    from stitchax_torch.models.vgg import VGG16Features

    torch.manual_seed(0)
    ref_model = TransRef()
    port_model = TransRefBase()
    port_model.load_state_dict(ref_model.state_dict())
    port_vgg = VGG16Features()
    port_vgg.reset_parameters(torch.Generator().manual_seed(VGG_SEED))
    return ref_model, port_model, seeded_vgg(VGG_SEED), \
        port_vgg.requires_grad_(False)


@pytest.fixture(scope="module")
def two_steps():
    """Both sides' two steps: {losses, grads (first step), params}."""
    from portbench.reference.transref_train import Adam, loss_and_grads
    from stitchax_torch.train.transref_trainer import (
        TransRefLossConfig, create_train_state, make_transref_train_step)

    ref_model, port_model, ref_vgg, port_vgg = seeded_models()
    batches = [inputs(3), inputs(4)]

    state, tx = create_train_state(port_model, LR)
    step = make_transref_train_step(port_model, port_vgg, tx,
                                    TransRefLossConfig())
    port = {"losses": []}
    for i, (gt, ref, mask) in enumerate(batches):
        metrics, grads = step.loss_and_grads(state, gt, ref, mask)
        port["losses"].append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            port["grads"] = {n: g.clone() for n, g in grads.items()}
        state, _ = step.apply_gradients(state, metrics, grads)
    port["params"] = {n: p.detach().clone() for n, p in state.params.items()}

    params = dict(ref_model.named_parameters())
    opt = Adam(LR)
    ref = {"losses": []}
    for i, (gt, r, mask) in enumerate(batches):
        losses, grads = loss_and_grads(ref_model, ref_vgg, gt, r, mask, LOSS,
                                       BATCH)
        ref["losses"].append(losses)
        if i == 0:
            ref["grads"] = grads
        opt.step(params, grads)
    ref["params"] = {n: p.detach().clone() for n, p in params.items()}
    return port, ref


def test_the_vgg_draws_equal():
    ref_model, port_model, ref_vgg, port_vgg = seeded_models()
    port_sd = port_vgg.state_dict()
    for n, t in ref_vgg.state_dict().items():
        assert torch.equal(t, port_sd[n]), n


def test_the_forward_equals_the_reference():
    ref_model, port_model, _, _ = seeded_models()
    gt, ref, mask = inputs()
    with torch.no_grad():
        a = port_model(gt, mask, ref)
        b = ref_model(gt, mask, ref)
    # the same operations in the same order (read 0 with two threads; the
    # bound leaves room for another CPU's reduction order)
    assert (a - b).abs().max() <= 1e-6


@pytest.mark.parametrize("step", [0, 1])
def test_losses_equal_the_reference(two_steps, step):
    port, ref = two_steps
    for k in ("total", "l1", "perceptual", "style"):
        a, b = port["losses"][step][k], ref["losses"][step][k]
        # one batch, the same sums (read 0): float32 round-off at most
        assert abs(a - b) <= 1e-5 * abs(b), (k, a, b)


def test_first_gradients_equal_the_reference(two_steps):
    port, ref = two_steps
    assert set(port["grads"]) == set(ref["grads"])
    norms = {n: float(g.norm()) for n, g in ref["grads"].items()}
    median = sorted(norms.values())[len(norms) // 2]
    worst = max(float((port["grads"][n] - g).norm()) / max(norms[n], median)
                for n, g in ref["grads"].items())
    # each leaf's gap over the larger of its norm and the median leaf's,
    # as the benchmark's grad_leaf_gap (read 0): float32 round-off of one
    # backward at most
    assert worst <= 1e-4, worst


def test_parameters_after_two_adam_steps_equal_the_reference(two_steps):
    port, ref = two_steps
    worst = max(float((port["params"][n] - p).abs().max())
                for n, p in ref["params"].items())
    # Adam moves an element by about lr a step whatever its gradient, so
    # an element whose gradient is round-off alone could move apart by up
    # to 2 lr. The reference's Adam rounds in the port's order and the
    # gradients are equal (read 0), so no element moves apart
    assert worst <= 1e-3 * LR, worst


def test_step_spans_nest_and_deform_counters_count_a_forward():
    from stitchax_torch.train.transref_trainer import (
        TransRefLossConfig, create_train_state, make_transref_train_step)
    from stitchax_torch.utils import tracing

    _, model, _, vgg = seeded_models()
    state, tx = create_train_state(model, LR)
    state.step = 5
    step = make_transref_train_step(model, vgg, tx, TransRefLossConfig())
    tracing.enable(device="cpu")
    try:
        step(state, *inputs())
        snap = tracing.snapshot()
    finally:
        tracing.disable()
    spans = snap["spans"]
    by_id = {s["id"]: s for s in spans}
    kids = lambda s: [k["name"] for k in spans if k["parent"] == s["id"]]
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "transref.step" and root["root"] == 5
    assert kids(root) == ["transref.forward", "transref.loss",
                          "transref.backward", "transref.adam"]
    (fwd,) = [s for s in spans if s["name"] == "transref.forward"]
    assert kids(fwd) == ["transref.encoder", "transref.decoder"]
    (enc,) = [s for s in spans if s["name"] == "transref.encoder"]
    assert kids(enc) == ["transref.refpa"] * 3
    assert all(s["root"] == 5 for s in spans)
    # one deformable 3x3 convolution a RefPA call, at stages 1-3 (1/4,
    # 1/8, 1/16 of the side; 64, 128, 320 channels): B*H*W*9*C taps each
    sides, chans = (SIZE // 4, SIZE // 8, SIZE // 16), (64, 128, 320)
    assert snap["counters"] == {
        "deform.calls": 3,
        "deform.taps_gathered": sum(BATCH * s * s * 9 * c
                                    for s, c in zip(sides, chans))}
    refpa = {s["id"] for s in spans if s["name"] == "transref.refpa"}
    assert {c["span"] for c in snap["counts"]} <= refpa
    for s in spans:
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]


def test_off_the_step_records_nothing_and_touches_no_cuda(monkeypatch):
    from stitchax_torch.train.transref_trainer import (
        TransRefLossConfig, create_train_state, make_transref_train_step)
    from stitchax_torch.utils import tracing

    def refuse(*a, **k):
        raise AssertionError("the tracer touched CUDA while off")

    _, model, _, vgg = seeded_models()
    state, tx = create_train_state(model, LR)
    step = make_transref_train_step(model, vgg, tx, TransRefLossConfig())
    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    tracing.enable(device="cpu")
    tracing.disable()
    step(state, *inputs())
    snap = tracing.snapshot()
    assert snap["spans"] == [] and snap["counts"] == [] \
        and snap["counters"] == {}
