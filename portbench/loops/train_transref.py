"""The TransRef training loop: steps of the port's TransRef train step
(`make_transref_train_step`: the masked input, TransRef's forward under
autograd, the L1 + VGG16 perceptual + style objective, one backward and
Adam) as `python -m stitchax_torch.train_transref --batch_size B --seed
<seed>` builds it, starting from the tracked TransRef snapshot, on seeded
pairs already on the device, back to back.

Each step takes a batch of the pool (the ground truth is each pair's
img1, the reference its img2: `--ref_from pair`) and fresh holes, three
seeded rectangles an image drawn by the trainer's `draw_rect_boxes` from
a generator on the device seeded with the run's seed, rasterised by
`rect_masks`. Set-up takes the first `train_steps` steps (the
configuration's `reference.train_steps`) on distinct batches from the
loaded weights and keeps each step's loss, each leaf's norm of the first
gradient (Adam's first moment after one step over 1 - b1) and each leaf's
norm of the change of the parameters over the steps; then the traffic's
warm-up steps; then the window. Once the window has closed and the program
is freed, the plain reference (`reference/transref_train.py`) takes the
same steps from the same weights on the same batches and holes, and the
alignment loop's `compare` holds the two.

A traced run turns the program's tracer on over the window and keeps its
snapshot in `layer["program"]` for the per-layer readers, then profiles
one more step with the tracer off.
"""

from __future__ import annotations

import gc
import os
import sys
import time
from typing import Dict, List

import torch

from ..harness import Context, Outcome, Window, profiled_slice
from ..traffic import make_pairs
from ..yardstick import spans
from .train import compare, norms

B1 = 0.9                      # Adam's first-moment decay
ROOT = "transref.step"
STEP_SPANS = ("transref.forward", "transref.loss", "transref.backward",
              "transref.adam", "transref.encoder", "transref.refpa",
              "transref.decoder")


def pool(ctx: Context):
    """(gt, ref, batch(i)): the pool's pairs in [-1, 1] on the device and
    the (gt, ref) of the i-th batch (batches taken in turn)."""
    tr = ctx.traffic
    B, n = tr["batch"], tr["pool_batches"]
    img1, img2 = make_pairs(tr, ctx.seed, B * n, ctx.device)
    gt, ref = img1 / 127.5 - 1.0, img2 / 127.5 - 1.0
    del img1, img2
    k = lambda i: slice((i % n) * B, (i % n + 1) * B)
    return gt, ref, lambda i: (gt[k(i)], ref[k(i)])


def holes(ctx: Context):
    """draw() -> a fresh (B, S, S, 1) hole mask a call: the trainer's
    rectangles from a generator on the device seeded with the run's seed."""
    from stitchax_torch.train.transref_trainer import (draw_rect_boxes,
                                                       rect_masks)

    h, S, B = ctx.config["holes"], ctx.config["image_size"], \
        ctx.traffic["batch"]
    g = torch.Generator(device=ctx.device)
    g.manual_seed(int(ctx.seed) % (2 ** 63))
    return lambda: rect_masks(*draw_rect_boxes(
        g, B, S, num_rects=h["num_rects"], max_frac=h["max_frac"]), S)


def weights_state(ctx: Context) -> Dict[str, torch.Tensor]:
    """The state dict both sides start from: the configuration's msgpack,
    read by the reference's own reader, or (tests at small sizes) the
    reference's initialisers seeded with `weights.seeded`."""
    from ..reference.transref import TransRef, load_transref

    w = ctx.config["weights"]
    if "msgpack" in w:
        return load_transref(os.path.join(ctx.root, w["msgpack"])).state_dict()
    torch.manual_seed(int(w["seeded"]))
    return TransRef().state_dict()


def program_step(ctx: Context):
    """(state, step_fn) of the program, built as its training CLI builds
    them: TransRef (the msgpack through the port's own reader), the VGG16
    seeded by the run's seed and frozen, fp32 with TF32 off, Adam at the
    configuration's rate and the objective's weights."""
    from stitchax_torch import convert
    from stitchax_torch.models import transref as tm
    from stitchax_torch.models.vgg import VGG16Features
    from stitchax_torch.train.transref_trainer import (
        TransRefLossConfig, create_train_state, make_transref_train_step)
    from stitchax_torch.utils.precision import fp32_exact

    cfg = ctx.config
    t = cfg["transref"]
    widths = {"embed_dims": tm.EMBED_DIMS, "num_heads": tm.NUM_HEADS,
              "mlp_ratios": tm.MLP_RATIOS, "depths": tm.DEPTHS,
              "sr_ratios": tm.SR_RATIOS}
    for k, v in widths.items():
        if tuple(t[k]) != tuple(v):
            raise ValueError(f"configuration {k} {t[k]} is not the "
                             f"program's {list(v)}")
    fp32_exact()
    model = tm.TransRefBase()
    w = cfg["weights"]
    if "msgpack" in w:
        convert.load_jax_params(model, convert.load_flax_msgpack(
            os.path.join(ctx.root, w["msgpack"])))
    else:
        model.load_state_dict(weights_state(ctx))
    vgg = VGG16Features()
    vgg.reset_parameters(torch.Generator().manual_seed(int(ctx.seed)))
    model.to(ctx.device)
    vgg.to(ctx.device).requires_grad_(False)
    state, tx = create_train_state(model, cfg["optim"]["lr"])
    l = cfg["loss"]
    step_fn = make_transref_train_step(model, vgg, tx, TransRefLossConfig(
        lambda_l1=l["l1"], lambda_perceptual=l["perceptual"],
        lambda_style=l["style"]))
    return state, step_fn


def reference_steps(ctx: Context, batches, tf32: bool = False,
                    half: bool = False, unchanged: bool = False
                    ) -> Dict[str, object]:
    """The plain reference's steps on `batches` [(gt, ref, mask)]: {losses,
    grad (leaf norms of the first gradient), change (leaf norms of the
    parameters' change)}. `tf32` computes them with TF32 on (the control);
    `half` on the first half of each batch alone and `unchanged` without
    Adam's updates (the planted faults)."""
    from ..reference.precision import precision
    from ..reference.transref import TransRef
    from ..reference.transref_train import Adam, loss_and_grads
    from ..reference.vgg import seeded_vgg

    cfg = ctx.config
    model = TransRef()
    model.load_state_dict(weights_state(ctx))
    model.to(ctx.device)
    vgg = seeded_vgg(ctx.seed).to(ctx.device)
    params = dict(model.named_parameters())
    p0 = {n: p.detach().clone() for n, p in params.items()}
    opt = Adam(cfg["optim"]["lr"], cfg["optim"]["eps"])
    losses: List[float] = []
    grad: Dict[str, float] = {}
    with precision(tf32, ctx.device):
        for i, (gt, ref, mask) in enumerate(batches):
            if half:
                h = gt.shape[0] // 2
                gt, ref, mask = gt[:h], ref[:h], mask[:h]
            loss, grads = loss_and_grads(model, vgg, gt, ref, mask,
                                         cfg["loss"],
                                         cfg["reference"]["micro_batch"])
            losses.append(loss["total"])
            if i == 0:
                grad = norms(grads)
            if not unchanged:
                opt.step(params, grads)
            del grads
    change = {n: float((p.detach() - p0[n]).double().norm())
              for n, p in params.items()}
    del model, vgg, params, p0, opt
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "grad": grad, "change": change}


def run(ctx: Context) -> Outcome:
    from stitchax_torch.utils import tracing

    from ..yardstick.flops_transref import load as load_flops
    from ..yardstick.peaks import model_peak

    cfg, tr = ctx.config, ctx.traffic
    B, K = tr["batch"], cfg["reference"]["train_steps"]
    cuda = ctx.device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(ctx.device)) if cuda else \
        (lambda: None)
    gt, ref, batch = pool(ctx)
    draw = holes(ctx)
    state, step_fn = program_step(ctx)

    # the first K steps, through the window's own call, on distinct batches
    p0 = {n: p.detach().clone() for n, p in state.params.items()}
    prog = {"losses": [], "grad": {}, "change": {}}
    taken = []
    for i in range(K):
        mask = draw()
        taken.append((*batch(i), mask))
        state, metrics = step_fn(state, *batch(i), mask)
        prog["losses"].append(float(metrics["total"]))
        if i == 0:
            prog["grad"] = norms(state.opt_state.mu, 1.0 / (1.0 - B1))
    prog["change"] = {n: float((p.detach() - p0[n]).double().norm())
                      for n, p in state.params.items()}
    del p0
    i = K
    for _ in range(tr["warmup_steps"]):
        state, metrics = step_fn(state, *batch(i), draw())
        i += 1
    sync()
    setup_s = time.perf_counter() - ctx.t0

    window = Window(ctx.seconds)
    totals = []
    marks = []
    if ctx.trace:
        tracing.enable(device=ctx.device)
    window.open()
    while not totals or window.is_open():
        marks.append(time.perf_counter())
        state, metrics = step_fn(state, *batch(i), draw())
        totals.append(metrics["total"])
        i += 1
    sync()
    window.close()
    program = tracing.snapshot() if ctx.trace else None
    tracing.disable()
    window.done(len(totals) * B)
    marks.append(window.end)
    print("portbench: step s " + " ".join(
        f"{b - a:.3f}" for a, b in zip(marks, marks[1:])), file=sys.stderr)
    failed = int((~torch.isfinite(torch.stack(totals))).sum()) * B
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0

    out = Outcome(attempted=len(totals) * B, failed=failed, setup_s=setup_s,
                  end_to_end={tr["rate_metric"]: window.rate}, checks=[],
                  memory_peak_bytes=peak)
    if ctx.trace:
        table = {n: spans.median(spans.per_root(program, ROOT, [n],
                                                "device_ms"))
                 for n in (ROOT, *STEP_SPANS)}
        print(f"portbench: device ms a step {table}; counters "
              f"{program['counters']}, dropped {program['dropped']}",
              file=sys.stderr)
        out.layer = {"program": program, "items_per_s": window.rate,
                     "flops_per_item": load_flops(cfg["name"])["train_pair"],
                     "peak_flops": model_peak(cfg["precision"]),
                     "memory_peak_bytes": peak}
        out.breakdown = {"program_spans": [[n, v] for n, v in table.items()
                                           if v is not None]}
        if cuda:
            box = [state]

            def one_step():
                box[0], _ = step_fn(box[0], *batch(i), draw())

            # a full garbage collection inside the profiled step would
            # read as device idle: take it before the slice
            gc.collect()
            sl = profiled_slice(one_step, ctx.device, lambda: {})
            out.layer["slice"] = sl
            out.busy_s, out.window_s = sl["busy_s"], sl["window_s"]
            out.breakdown.update(device_ops=sl["device_ops"],
                                 idle_gaps=sl["idle_gaps"])
            del box
    del state, step_fn, metrics, totals
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref_out = reference_steps(ctx, taken)
    out.checks = compare(ctx, prog, ref_out)
    return out
