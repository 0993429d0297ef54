"""The evaluation loop: batches of seeded pairs back to back in a closed
loop through the port's `validate_with_model` (upload, `make_eval_step`,
download, PSNR/SSIM on the host), as `python -m stitchax_torch.evaluate`
runs them over UDIS-D's testing split.

The mix's `pool_batches` batches of `batch` pairs are made at set-up and
served in turn. One of them, drawn from the seed, is judged: its first
serving in the window is kept (warped img2 and coverage, and the
program's per-pair PSNR and SSIM) and compared, once the window has closed
and the program is freed, with the plain reference's evaluation of the
same pairs (`compare`). The loop runs on past the window's end only until
that batch has been served.
"""

from __future__ import annotations

import gc
import os
import sys
import time
from typing import Dict, List, Mapping, Tuple

import numpy as np

from ..harness import Check, Context, Outcome, Window, profiled_slice, \
    sm_info
from ..traffic import make_pairs


def program_models(ctx: Context):
    """The program's nets as the evaluation CLI loads them (`load_models`
    on the configuration's npz), or, for seeded weights, the benchmark's
    seeded state in the program's own nets."""
    import torch

    from stitchax_torch.evaluate import load_models

    cfg = ctx.config
    if "npz" in cfg["weights"]:
        return load_models(os.path.join(ctx.root, cfg["weights"]["npz"]),
                           ctx.device)
    from stitchax_torch.models.flowformer import FlowFormer, FlowFormerConfig
    from stitchax_torch.models.udis2 import UDIS2HomographyNet
    from stitchax_torch.run.stitcher import StitchModels
    from stitchax_torch.utils.precision import fp32_exact

    from ..reference.nets import seeded_state

    fp32_exact()
    state = seeded_state(cfg)
    flow = FlowFormer(FlowFormerConfig(**cfg["flowformer"]))
    homo = UDIS2HomographyNet(input_size=cfg["image_size"])
    flow.load_state_dict(state["flow"])
    homo.load_state_dict(state["homo"])
    return StitchModels(flow, homo, ctx.device, torch.float32)


def pool(ctx: Context) -> Tuple[List[dict], "torch.Tensor", "torch.Tensor"]:
    """The mix's batches as host arrays, as a loader hands them over, and
    the pairs as made (on the device)."""
    tr = ctx.traffic
    B = tr["batch"]
    img1, img2 = make_pairs(tr, ctx.seed, B * tr["pool_batches"], ctx.device)
    a, b = img1.cpu().numpy(), img2.cpu().numpy()
    batches = [{"image1": a[i:i + B], "image2": b[i:i + B],
                "name": [f"{i + j}" for j in range(B)]}
               for i in range(0, a.shape[0], B)]
    return batches, img1, img2


def sample_index(ctx: Context) -> int:
    """The pool batch judged in this run, drawn from the seed."""
    rng = np.random.default_rng([ctx.seed, 1])
    return int(rng.integers(ctx.traffic["pool_batches"]))


def reference_eval(ctx: Context, img1, img2, tf32: bool = False):
    """The plain reference's (warped, coverage, psnr, ssim) of the pairs;
    `tf32` computes it with TF32 on (the control; on the CPU, which has no
    TF32, by rounding every product's operands to TF32)."""
    import torch

    from ..reference.align import AlignConfig
    from ..reference.evaluate import eval_outputs, pair_scores
    from ..reference.nets import build_nets
    from ..reference.precision import precision

    cfg = ctx.config
    nets = {k: m.to(ctx.device).eval() for k, m in
            build_nets(cfg, ctx.root, upsample_all=False).items()}
    align = AlignConfig(
        use_fb_consistency_mask=cfg["align"]["use_fb_consistency_mask"],
        occlusion_estimation=cfg["align"]["occlusion_estimation"])
    with precision(tf32, ctx.device):
        warped, valid = eval_outputs(nets, img1, img2, align,
                                     cfg["reference"]["micro_batch"])
    del nets
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    p, s = pair_scores(img1.cpu().numpy(), warped, valid)
    return warped, valid, p, s


def compare(ctx: Context, prog: Mapping, ref: Mapping) -> List[Check]:
    """The numbers that decide `correct`, each with its limit: the worst
    pair's PSNR gap, and the mean gap of the warped img2 (gray levels)
    where both cover fully. The worst SSIM gap and the share of pixels
    whose full coverage differs go to stderr only: the control (TF32)
    reads them no higher than sound runs do, so no limit between the two
    can hold (the coverage hangs on hard thresholds that one ulp flips)."""
    lim = ctx.limits
    full_p, full_r = prog["valid"] >= 1.0, ref["valid"] >= 1.0
    both = (full_p & full_r)[..., 0]
    gap = np.abs(prog["warped"] - ref["warped"])[both]
    per_pair = [float(np.abs(pw - rw)[b].mean()) if b.any() else 0.0
                for pw, rw, b in zip(prog["warped"], ref["warped"], both)]
    print("portbench: warp gap by pair " + " ".join(
        f"{g:.3g}" for g in per_pair), file=sys.stderr)
    print(f"portbench: ssim gap {np.max(np.abs(prog['ssim'] - ref['ssim']))!r}"
          f" coverage flips {np.mean(full_p != full_r)!r}", file=sys.stderr)
    return [
        Check("psnr_gap_db", float(np.max(np.where(
            prog["psnr"] == ref["psnr"], 0.0,
            np.abs(prog["psnr"] - ref["psnr"])))), lim["psnr_gap_db"]),
        Check("warp_gap_levels", float(gap.mean()) if gap.size else 0.0,
              lim["warp_gap_levels"]),
    ]


def run(ctx: Context) -> Outcome:
    import torch

    from stitchax_torch.align.adapter import AlignConfig
    from stitchax_torch.evaluate import make_eval_step, validate_with_model
    from stitchax_torch.ops.kernels import library

    from ..yardstick.flops import load as load_flops
    from ..yardstick.kernels import flow_call, slice_bounds
    from ..yardstick.peaks import model_peak

    cfg, tr = ctx.config, ctx.traffic
    B = tr["batch"]
    cuda = ctx.device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(ctx.device)) if cuda else \
        (lambda: None)
    models = program_models(ctx)
    align_cfg = AlignConfig(
        use_fb_consistency_mask=cfg["align"]["use_fb_consistency_mask"],
        occlusion_estimation=cfg["align"]["occlusion_estimation"])
    step = make_eval_step(models, align_cfg)
    batches, img1_all, img2_all = pool(ctx)
    k = sample_index(ctx)

    validate_with_model(None, batches[:tr["warmup_batches"]], models,
                        align_cfg, eval_step=step)       # warm-up
    sync()
    setup_s = time.perf_counter() - ctx.t0

    spans: List[float] = []
    kept: Dict[str, object] = {}
    calls = [0]

    events: list = []

    def timed_step(img1, img2):
        if ctx.trace:
            sync()
            t = time.perf_counter()
        if cuda:
            events.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()
        out = step(img1, img2)
        if cuda:
            events[-1][1].record()
        if ctx.trace:
            sync()
            spans.append((time.perf_counter() - t) * 1e3)
        if calls[0] == k:
            kept["warped"], kept["valid"] = out
        calls[0] += 1
        return out

    window = Window(ctx.seconds)

    marks: List[float] = []

    def feed():
        i = 0
        while window.is_open() or i <= k:
            marks.append(time.perf_counter())
            yield batches[i % len(batches)]
            i += 1

    per_pair: list = []
    window.open()
    validate_with_model(None, feed(), models, align_cfg,
                        eval_step=timed_step, per_pair=per_pair)
    window.close()
    window.done(len(per_pair))
    marks.append(window.end)
    print("portbench: batch s " + " ".join(
        f"{b - a:.3f}" for a, b in zip(marks, marks[1:])), file=sys.stderr)
    print("portbench: step device s " + " ".join(
        f"{a.elapsed_time(b) / 1e3:.3f}" for a, b in events), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    psnr = np.array([p for _, p, _ in per_pair])
    ssim = np.array([s for _, _, s in per_pair])
    # a pair with no fully covered pixel scores an infinite PSNR, as the
    # evaluation reports it; only NaN is a failure
    failed = int(np.sum(np.isnan(psnr)) + np.sum(np.isnan(ssim)))

    layer: Dict[str, object] = {}
    out = Outcome(attempted=len(per_pair), failed=failed, setup_s=setup_s,
                  end_to_end={tr["rate_metric"]: window.rate}, checks=[],
                  memory_peak_bytes=peak)
    if ctx.trace and cuda:
        flow_calls = 2 if cfg["align"]["use_fb_consistency_mask"] else 1
        calls_list = flow_call(B, cfg["image_size"], cfg["precision"],
                               cfg["flowformer"]["decoder_depth"]) * flow_calls
        n_sm, sm_hz = sm_info(ctx.device)
        bound, expected = slice_bounds(calls_list, n_sm, sm_hz,
                                       cfg["precision"])
        sl = profiled_slice(
            lambda: validate_with_model(None, batches[:1], models, align_cfg,
                                        eval_step=step),
            ctx.device, lambda: library.launches)
        flops = load_flops(cfg["name"])
        layer = {"spans": {"eval_step_ms": spans}, "slice": sl,
                 "bound_s": bound, "expected_launches": expected,
                 "items_per_s": window.rate,
                 "flops_per_item": flops["eval_pair"],
                 "peak_flops": model_peak(cfg["precision"])}
        out.busy_s, out.window_s = sl["busy_s"], sl["window_s"]
        out.breakdown = {"device_ops": sl["device_ops"],
                         "idle_gaps": sl["idle_gaps"]}
    out.layer = layer

    prog = {"warped": kept["warped"].cpu().numpy(),
            "valid": kept["valid"].cpu().numpy(),
            "psnr": psnr[k * B:(k + 1) * B], "ssim": ssim[k * B:(k + 1) * B]}
    img1, img2 = img1_all[k * B:(k + 1) * B], img2_all[k * B:(k + 1) * B]
    del models, step, kept, timed_step, img1_all, img2_all
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    warped, valid, p, s = reference_eval(ctx, img1, img2)
    out.checks = compare(ctx, prog, {"warped": warped, "valid": valid,
                                     "psnr": p, "ssim": s})
    return out
