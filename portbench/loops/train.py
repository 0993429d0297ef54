"""The alignment training loop: steps of the port's train step
(`make_train_step`: the forward under autograd with K1, K3 and K4 in their
Functions, the sequence loss, the backward, the global-norm clip and
AdamW on the one-cycle schedule) as `python -m stitchax_torch.train
--batch_size B --init_npz ...` takes them, on seeded pairs already on the
device, back to back.

Set-up builds the one train state, takes its first `train_steps` steps
(the configuration's `reference.train_steps`) on distinct batches and
hands the same state to the window. From those steps it keeps each step's
loss, each leaf's norm of the first gradient as AdamW got it (its first
moment after one step over 1 - b1) and each leaf's norm of the change of
the parameters over the steps. Once the window has closed and the program
is freed, the plain reference takes the same steps from the same weights
on the same batches, and `compare` holds the two.
"""

from __future__ import annotations

import gc
import os
import statistics
import sys
import time
from typing import Dict, List, Mapping

import torch

from ..harness import Check, Context, Outcome, Window, leaf_gap, \
    profiled_slice, sm_info
from ..traffic import make_pairs

B1 = 0.9                      # AdamW's first-moment decay


def program_step(ctx: Context):
    """(state, step_fn) of the program, built as its training CLI builds
    them: the nets from the configuration's npz (or the benchmark's seeded
    state), fp32 with TF32 off, the trainer block's AdamW with the
    learning rate scaled by the batch."""
    from stitchax_torch import convert
    from stitchax_torch.align.adapter import AlignConfig
    from stitchax_torch.models.flowformer import FlowFormer, FlowFormerConfig
    from stitchax_torch.models.udis2 import UDIS2HomographyNet
    from stitchax_torch.train import (LossConfig, OptimConfig,
                                      create_train_state, make_train_step)
    from stitchax_torch.utils.precision import fp32_exact

    from ..reference.nets import seeded_state

    cfg = ctx.config
    fp32_exact()
    models = {"homo": UDIS2HomographyNet(input_size=cfg["image_size"]),
              "flow": FlowFormer(FlowFormerConfig(**cfg["flowformer"],
                                                  upsample_all=True))}
    if "npz" in cfg["weights"]:
        tree = convert.load_npz(os.path.join(ctx.root,
                                             cfg["weights"]["npz"]))
        for k, m in models.items():
            convert.load_jax_params(m, tree[k])
    else:
        state = seeded_state(cfg)
        for k, m in models.items():
            m.load_state_dict(state[k])
    for m in models.values():
        m.to(ctx.device)
    o = cfg["optim"]
    optim_cfg = OptimConfig(
        canonical_lr=o["canonical_lr"], num_steps=o["num_steps"],
        adamw_decay=o["adamw_decay"], epsilon=o["epsilon"], clip=o["clip"],
        pct_start=o["pct_start"], anneal_strategy=o["anneal_strategy"],
        batch_scale=ctx.traffic["batch"])
    state, tx = create_train_state(models, optim_cfg)
    a, l = cfg["align"], cfg["loss"]
    step_fn = make_train_step(
        models["homo"], models["flow"], tx,
        AlignConfig(use_fb_consistency_mask=a["use_fb_consistency_mask"],
                    occlusion_estimation=a["occlusion_estimation"]),
        LossConfig(gamma=l["gamma"],
                   rigid_motion_weight=l["rigid_motion_weight"],
                   border_weight=l["border_weight"], max_flow=l["max_flow"],
                   border_px=l["border_px"],
                   charbonnier_eps=l["charbonnier_eps"]),
        use_fb_consistency_mask=a["use_fb_consistency_mask"], remat=False)
    return state, step_fn


def norms(tensors: Mapping[str, torch.Tensor], scale: float = 1.0
          ) -> Dict[str, float]:
    return {n: float(t.detach().double().norm()) * scale
            for n, t in tensors.items()}


def reference_steps(ctx: Context, batches, tf32: bool = False,
                    half: bool = False) -> Dict[str, object]:
    """The plain reference's steps on `batches` [(img1, img2)]: {losses,
    grad (leaf norms of the first clipped gradient), change (leaf norms of
    the parameters' change)}. `tf32` computes them with TF32 on (the
    control), `half` on the first half of each batch alone (a fault)."""
    from ..reference.align import AlignConfig
    from ..reference.nets import build_nets, trained_params
    from ..reference.precision import precision
    from ..reference.train import AdamW, loss_and_grads

    cfg = ctx.config
    nets = {k: m.to(ctx.device) for k, m in
            build_nets(cfg, ctx.root, upsample_all=True).items()}
    params = trained_params(nets)
    p0 = {n: p.detach().clone() for n, p in params.items()}
    opt = AdamW(cfg["optim"], batch_scale=ctx.traffic["batch"])
    a = cfg["align"]
    align = AlignConfig(use_fb_consistency_mask=a["use_fb_consistency_mask"],
                        occlusion_estimation=a["occlusion_estimation"])
    losses: List[float] = []
    grad = {}
    with precision(tf32, ctx.device):
        for i, (img1, img2) in enumerate(batches):
            if half:
                img1, img2 = img1[:img1.shape[0] // 2], img2[:img2.shape[0] // 2]
            loss, grads = loss_and_grads(
                nets, params, img1, img2, align, cfg["loss"],
                a["use_fb_consistency_mask"], cfg["reference"]["micro_batch"])
            losses.append(loss["total"])
            opt.step(params, grads)
            del grads
            if i == 0:
                grad = norms(opt.last_grads)
    change = {n: float((p.detach() - p0[n]).double().norm())
              for n, p in params.items()}
    del nets, params, p0, opt
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "grad": grad, "change": change}


def compare(ctx: Context, prog: Mapping, ref: Mapping) -> List[Check]:
    """The numbers that decide `correct`, each with its limit: the worst
    step's loss gap over the reference's loss; the worst leaf's gap of
    first-gradient norms; the worst leaf's gap of the parameters' change
    over the steps, leaving out the leaves whose reference gradient is
    under a thousandth of the median leaf's (they move under Adam by
    round-off alone). A leaf's gap is over the larger of the reference's
    norm of that leaf and of the median leaf."""
    lim = ctx.limits
    g_med = statistics.median(ref["grad"].values())
    moved = lambda n: ref["grad"][n] >= 1e-3 * g_med
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    for key, keep in (("grad", None), ("change", moved)):
        names = [n for n in ref[key] if keep is None or keep(n)]
        med = statistics.median(ref[key][n] for n in names)
        worst = max(names, key=lambda n: abs(prog[key][n] - ref[key][n])
                    / max(ref[key][n], med))
        print(f"portbench: worst {key} leaf {worst}: program "
              f"{prog[key][worst]!r} reference {ref[key][worst]!r} median "
              f"{med!r} reference gradient {ref['grad'][worst]!r}",
              file=sys.stderr)
    return [
        Check("loss_gap", float(loss_gap), lim["loss_gap"]),
        Check("grad_leaf_gap", leaf_gap(prog["grad"], ref["grad"]),
              lim["grad_leaf_gap"]),
        Check("change_leaf_gap", leaf_gap(prog["change"], ref["change"],
                                          moved), lim["change_leaf_gap"]),
    ]


def run(ctx: Context) -> Outcome:
    from stitchax_torch.ops.kernels import library

    from ..yardstick.flops import load as load_flops
    from ..yardstick.kernels import flow_call, slice_bounds
    from ..yardstick.peaks import model_peak

    cfg, tr = ctx.config, ctx.traffic
    B, n_pool = tr["batch"], tr["pool_batches"]
    K = cfg["reference"]["train_steps"]
    cuda = ctx.device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(ctx.device)) if cuda else \
        (lambda: None)
    img1, img2 = make_pairs(tr, ctx.seed, B * n_pool, ctx.device)
    batch = lambda i: (img1[(i % n_pool) * B:(i % n_pool + 1) * B],
                       img2[(i % n_pool) * B:(i % n_pool + 1) * B])
    state, step_fn = program_step(ctx)

    # the first K steps, through the window's own call, on distinct batches
    p0 = {n: p.detach().clone() for n, p in state.params.items()}
    prog = {"losses": [], "grad": {}, "change": {}}
    for i in range(K):
        state, metrics = step_fn(state, *batch(i))
        prog["losses"].append(float(metrics["total"]))
        if i == 0:
            prog["grad"] = norms(state.opt_state.mu, 1.0 / (1.0 - B1))
    prog["change"] = {n: float((p.detach() - p0[n]).double().norm())
                      for n, p in state.params.items()}
    del p0
    sync()
    setup_s = time.perf_counter() - ctx.t0

    spans = {"grad_ms": [], "update_ms": []}
    window = Window(ctx.seconds)
    totals = []
    i = K
    marks, events = [], []
    window.open()
    while not totals or window.is_open():
        marks.append(time.perf_counter())
        timings = {} if ctx.trace else None
        if cuda:
            events.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()
        state, metrics = step_fn(state, *batch(i), timings)
        if cuda:
            events[-1][1].record()
        totals.append(metrics["total"])
        if ctx.trace:
            spans["grad_ms"].append(timings["forward_ms"]
                                    + timings.get("backward_flow_ms", 0.0)
                                    + timings["backward_ms"])
            spans["update_ms"].append(timings["update_ms"])
        i += 1
    sync()
    window.close()
    window.done(len(totals) * B)
    marks.append(window.end)
    print("portbench: step s " + " ".join(
        f"{b - a:.3f}" for a, b in zip(marks, marks[1:])), file=sys.stderr)
    print("portbench: step device s " + " ".join(
        f"{a.elapsed_time(b) / 1e3:.3f}" for a, b in events), file=sys.stderr)
    failed = int((~torch.isfinite(torch.stack(totals))).sum()) * B
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0

    out = Outcome(attempted=len(totals) * B, failed=failed, setup_s=setup_s,
                  end_to_end={tr["rate_metric"]: window.rate}, checks=[],
                  memory_peak_bytes=peak)
    if ctx.trace and cuda:
        flow_calls = 2 if cfg["align"]["use_fb_consistency_mask"] else 1
        calls = flow_call(B, cfg["image_size"], cfg["precision"],
                          cfg["flowformer"]["decoder_depth"]) * flow_calls
        n_sm, sm_hz = sm_info(ctx.device)
        bound, expected = slice_bounds(calls, n_sm, sm_hz, cfg["precision"])
        box = [state]

        def one_step():
            box[0], _ = step_fn(box[0], *batch(i))

        sl = profiled_slice(one_step, ctx.device, lambda: library.launches)
        flops = load_flops(cfg["name"])
        out.layer = {"spans": spans, "slice": sl, "bound_s": bound,
                     "expected_launches": expected,
                     "items_per_s": window.rate,
                     "flops_per_item": flops["train_pair"],
                     "peak_flops": model_peak(cfg["precision"]),
                     "memory_peak_bytes": peak}
        out.busy_s, out.window_s = sl["busy_s"], sl["window_s"]
        out.breakdown = {"device_ops": sl["device_ops"],
                         "idle_gaps": sl["idle_gaps"]}
        del box
    del state, step_fn, metrics, totals
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_steps(ctx, [batch(j) for j in range(K)])
    out.checks = compare(ctx, prog, ref)
    return out
