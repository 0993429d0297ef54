"""On-card smoke of the PyTorch/H100 port (stitchax_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line before the next begins:

  device                 card name, count, nvidia-smi name and power limit
  build                  the single nvcc call that builds every csrc/*.cu
                         kernel
  stitch                 Stitcher.stitch with `inf_configs/fast_cv_g8` on a
                         seeded 384x448 pair, bf16, on the card: per-stage
                         ms, peak memory, canvas, kernel launches per stitch
  stitch_default         the same with the default configuration
                         `all_img1_with_inpaint_g12_transRef` (TransRef
                         inpainter, grid 12, the composition net), which
                         also times the inpainter and the composition
  stitch_diffusion       the same with `inpaint_all_area_g12_diffusion`
                         (every hole to the SD + ControlNet inpainter of
                         results/sd_ckpt_r05.pt, in fp32, beside bf16
                         nets): also ms per DDIM step, in the stitch and
                         alone, and the VAE's encode and decode
  kernels                each kernel against its plain PyTorch version at
                         the shapes the stitches gave it: max |diff|, kernel
                         / plain / library ms by CUDA events, the kernel's
                         and the library call's device time per call (CUDA
                         events around it, queued while a spin holds the
                         device, so that no host gap counts; every kernel
                         phase times each call after writing 128 MiB, so
                         that the 50 MB L2 holds none of its inputs), and
                         the least time the card could take (bound_ms)
  stitch_vs_cpu          the fast_cv_g8 stitch in fp32 on the card and on
                         the CPU, compared
  stitch_vs_cpu_default  the same for the default configuration, down to
                         the composition and the learned masks
  kernels_evaluation     K1, K3 and K4 against their plain versions at the
                         evaluation's shapes (fp32, batch 12), timed beside
                         their bounds and library yardsticks (K1's and K4's
                         at fp32 accuracy on the tensor cores, 3xTF32, and
                         at the CUDA cores' fp32 rate)
  stitch_vs_stitchax     the fast_cv_g8 stitch of demo_data/demo1 and demo2
                         in fp32 on the card against stitchax's own outputs
                         (its jitted Stitcher on the CPU), committed in
                         tests/torch_reference/demo_stitchax_fp32.npz with
                         the decoded input images
  stitch_vs_stitchax_bf16
                         the same pairs stitched in bf16 on the card
                         against stitchax's jitted bf16 stitch on the CPU
                         (tests/torch_reference/demo_stitchax_bf16.npz)
  sd_vs_stitchax         the SD inpainter alone, fp32 on the card, on the
                         input and hole stitchax's inpainter got in its
                         demo1 stitch, and the diffusion configuration's
                         demo1 stitch in fp32, against stitchax's outputs
                         (tests/torch_reference/sd_stitchax_fp32.npz)
  jpeg                   the port's JPEG codec on the card's host: the demo
                         inputs decode to Pillow's pixels and encode to
                         Pillow's bytes; ms per decode and encode
  cli                    the stitch CLI (python -m stitchax_torch.out) over
                         demo_data/ into a temporary directory: fast_cv_g8
                         in bf16, the default configuration and
                         fast_cv_g8_comp in fp32 and the diffusion
                         configuration in bf16 (SD fp32) through its sweep
                         (files, value path, launches, s per pair; demo1's
                         arrays of the two composition configurations
                         against stitchax's), then the command itself
  evaluate               validate_with_model on the committed 12-pair split
                         (tests/torch_reference/udis_synth), batch 12, fp32,
                         against stitchax's evaluation of it
  sd15_widths            the port's UNet, ControlNet and VAE at the SD-1.5
                         widths (320/640/1280/1280, context 768, 8 heads),
                         seeded weights: 3 DDIM steps and a VAE round trip
                         at the 512x768 canvas in fp32 (TF32 off), ms per
                         step, peak memory, finite; not held to stitchax
                         (no such weights in the repository)
  kernels_backward       K1, K3 and K4 inside autograd at the train step's
                         shapes (fp32): the autograd Function's output and
                         every input gradient against the plain version's
                         autograd, forward and backward ms by events, the
                         forward's device time
  train_vs_stitchax      one fp32 train step (TF32 off) from the trained
                         npz on the first committed pair at 512^2 against
                         stitchax's jitted step on the CPU
                         (tests/torch_reference/train_stitchax_fp32.npz):
                         losses, grad_norm, every gradient leaf's norm, kept
                         leaves whole, and after the update
  train                  python -m stitchax_torch.train for 4 steps on the
                         committed split (checkpoints in a temporary
                         directory outside the repository), --resume from
                         step 2, --remat, final_ckpt.npz stitching a demo
                         pair, and a warm step's split
  transref_train_vs_stitchax
                         one fp32 TransRef train step (TF32 off) from the
                         committed TransRef checkpoint with a seeded VGG on
                         the first committed pair at 512^2 against
                         stitchax's jitted step on the CPU
                         (tests/torch_reference/
                         transref_train_stitchax_fp32.npz): losses,
                         gradient norms, kept leaves whole and after Adam
  transref_train         python -m stitchax_torch.train_transref at its
                         defaults (512^2, batch 4) for 3 steps on the
                         committed split (in a temporary directory outside
                         the repository): s per step, peak memory, its
                         export stitching demo1 through the default
                         configuration, and a warm step's split
  sd_train_vs_stitchax   one fp32 diffusion step and one VAE step (TF32
                         off) from results/sd_ckpt_r05.pt at 128^2, batch
                         8, on demo crops with stitchax's t and eps,
                         against stitchax's jitted steps on the CPU
                         (tests/torch_reference/sd_train_stitchax_fp32.npz):
                         losses, gradient norms, kept leaves whole and
                         after Adam
  sd_train               python -m stitchax_torch.train_sd_inpaint at its
                         defaults' widths for a few steps of each phase (in
                         a temporary directory outside the repository): its
                         files and history, peak memory, its sd_ckpt.pt
                         stitching demo1 through the diffusion
                         configuration; s per warm VAE and diffusion step,
                         their splits, peak memory and device kernels
  na_flowformer          FlowFormer++ with the NA vertical layer (seeded;
                         the trained npz for the shared leaves) at 512^2 in
                         fp32: finite, K1 / K3 / K4 launched, ms a forward;
                         card against CPU at 128^2
  pretrain_vs_stitchax   the MAE pretrain model (FlowFormerPretrain, the
                         shipped widths, the trained npz's FlowFormer++
                         leaves and a seeded pretrain head) at 368x496,
                         batch 2, fp32 (TF32 off): its loss and every
                         gradient leaf's norm against stitchax's on the same
                         inputs and noise (tests/torch_reference/
                         pretrain_stitchax_fp32.npz)
  pretrain               the same model's step (forward, backward, AdamW) on
                         a batch from CADataset + FlowAugmentor over
                         demo_data: warm ms and its split, peak memory, the
                         launches of K1 / K3 (r = 7 and r = 4 apart) / K4;
                         each kernel held against its plain version and
                         timed at the step's shapes (rows "...@pretrain")
  dp_train               two ranks on the card (torch.distributed.run,
                         gloo), one pair each, through the alignment step at
                         512^2 (make_parallel_train_step): the all-reduced
                         gradient, grad_norm and the updated tensors against
                         one process's batch-2 step; then one rank over nccl
  dp_evaluate            python -m stitchax_torch.evaluate under
                         torch.distributed.run, two ranks on the card
                         (gloo), over the committed 12-pair split: the
                         one-card report, and every pair's PSNR / SSIM in
                         the one-card order

Then the kernel table (one JSON object), the nvidia-smi line, and the final
`{"ok": true, "device": ...}` line. Any failed phase exits non-zero without
the final line. Imports nothing of JAX or of the JAX package.

    python3 chip_smoke.py --profile [TRACE.json] [--config NAME]

instead traces one warm bf16 stitch of the same pair (with fast_cv_g8, or
the named configuration; `--config evaluate`: one warm batch of the
evaluation, 12 pairs in fp32; `--config train`: one warm fp32 train step;
`--config transref_train`: one warm fp32 TransRef train step, batch 4;
`--config sd_train`: one warm fp32 SD diffusion step, 128^2, batch 8)
with torch.profiler and prints where the
device time goes (top kernels by device time, the device's busy share),
optionally writing a Chrome trace.
"""

from __future__ import annotations

import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = "results/ckpt_r05_bf16.npz"
CKPT = os.path.join(REPO, WEIGHTS)
TRANSREF_WEIGHTS = "results/transref_ckpt_r05_bf16.msgpack"
TRANSREF_CKPT = os.path.join(REPO, TRANSREF_WEIGHTS)
SD_WEIGHTS = "results/sd_ckpt_r05.pt"
SD_CKPT = os.path.join(REPO, SD_WEIGHTS)
FAST, DEFAULT = "fast_cv_g8", "all_img1_with_inpaint_g12_transRef"
DIFFUSION = "inpaint_all_area_g12_diffusion"
# fast_cv_g8 with the composition net (the push-pull inpainter feeding it)
COMP = "fast_cv_g8_comp"
PHASE = {FAST: "stitch", DEFAULT: "stitch_default",
         DIFFUSION: "stitch_diffusion"}
SD_REFERENCE = "tests/torch_reference/sd_stitchax_fp32.npz"
REFERENCE = "tests/torch_reference/demo_stitchax_fp32.npz"
COMP_REFERENCE = "tests/torch_reference/demo_stitchax_comp_fp32.npz"
DEMO_PAIRS = ("demo1", "demo2")
SEED = 0
PAIR_HW = (384, 448)            # the demo pair's size

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and flop/s by type
# (tf32 on the tensor cores, fp32 on the CUDA cores)
HBM_BPS = 3.35e12
PEAK = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
# special-function-unit ops (lg2, ex2) per clock per SM on Hopper
SFU_PER_CLOCK_SM = 16

# kernel vs plain version on the same inputs, at main-path shapes. K1
# (gsa_attention) and K4 (window_attention, in bf16) are held to one bf16
# ulp of their largest |output| (`bf16_ulp`): both versions take the
# logits, the softmax and the sums in fp32 and round the output once to
# bf16; the kernels also round P to bf16 for the tensor cores' P V product,
# which their CPU emulations (tests/test_torch_kernels.py) hold within
# that ulp.
TOL = {
    # K1 in fp32 (3xTF32 on the tensor cores, ~22-bit products): summation
    # order and the split's last bits (its CPU emulation reads ~1e-6,
    # tests/test_torch_kernels.py)
    "gsa_attention_fp32": 2e-5,
    # K4 in fp32 (3xTF32, as K1)
    "window_attention_fp32": 2e-5,
    # every product and sum rounded on its own in both: bit-equal
    "cost_lookup": 0.0,
    # log and accumulation over N centers: the kernel's log on the
    # special-function unit (lg2.approx, a few fp32 ulps), order and fma
    # differences (a few fp32 ulps of the [0, 1] map; an H100 read 3.6e-7
    # with the precise logf, PERF.md)
    "tps_grid": 5e-6,
}
# stitch in fp32 on the card (TF32 off) vs on the CPU, with the trained
# weights: about 10x or more of what an H100 read (PERF.md section 2)
STITCH_TOL = {
    "H_max_abs": 1e-3,           # homography entries (pixel-space H)
    "flow_max_px": 5e-3,         # native-res forward flow, max |diff|
    "flow_mean_px": 5e-4,        # ... and mean |diff|
    "canvas_box_px": 0.0,        # canvas bounds, truncated to integers
    "blend_psnr_db": 80.0,       # new_blend_image PSNR, card vs CPU
}
# the default configuration's stitch in fp32, card vs CPU, with the trained
# weights: about 10x of what an H100 read (PERF.md section 2). A canvas
# mask that flips at a threshold tie moves the learned masks by up to 1 at
# that pixel (an H100 read a 0.17 max), so they are held by their mean and
# by the share of values that moved by more than 1e-2, as the CPU tests
# hold thresholded masks
STITCH_DEFAULT_TOL = {
    "composition_psnr_db": 85.0,       # read 105.27 dB
    "learned_mask_mean_abs": 1e-4,     # read 1.04e-5
    "learned_mask_moved_share": 1e-3,  # share with |diff| > 1e-2
    "blend_psnr_db": 85.0,             # ave_fusion, read 105.75 dB
}


# the fast_cv_g8 stitch of demo1 and demo2 in fp32 on the card (TF32 off)
# against stitchax's outputs (REFERENCE), the worse pair of the two: about
# 10x of what an H100 read (PERF.md section 2), and the equalities it read
# kept as equalities; canvas images compared as stitchax's exact-RGB pack
# rounds them to uint8
STITCHAX_TOL = {
    "H_max_abs": 1e-3,               # homography entries, read 6.1e-5
    "flow_max_px": 5e-3,             # native-res forward flow, read 8.4e-4
    "canvas_box_px": 0.0,            # canvas bounds, read equal
    "control_valid_moved": 0,        # control points valid on one side only
    "control_dst_max_px": 5e-3,      # their targets (flow samples), 4.3e-4
    "mask1_moved_px": 0,             # mask1 values that differ, read 0
    "warp2_psnr_db": 70.0,           # read 81.71 dB
    "warp2_px_off_gt1": 0,           # uint8 values off by more than 1
    "ave_fusion_psnr_db": 70.0,      # read 81.89 dB
    "ave_fusion_px_off_gt1": 0,
}


# the fast_cv_g8 stitch of demo1 and demo2 in bf16 on the card against
# stitchax's bf16 stitch on the CPU (BF16_REFERENCE), the worse pair: about
# 10x of what an H100 read (10x the squared error for the PSNRs; PERF.md
# section 2), the canvas bounds equal, as read. Two bf16 programs round in
# other places, and the homography net's bf16 moves H's translation by
# ~0.4 px, which shifts whole canvases: the gap is of the order of
# stitchax's own bf16-to-fp32 one (H 0.61 / 0.39, flow 9.0 / 8.2 px on
# demo1 / demo2). The hard thresholds' flips (mask1, control validity;
# ROADMAP C1 / C5) are recorded, not gated
BF16_REFERENCE = "tests/torch_reference/demo_stitchax_bf16.npz"
STITCHAX_BF16_TOL = {
    "H_max_abs": 4.0,             # read 0.437 (demo2)
    "flow_max_px": 40.0,          # read 4.62
    "flow_mean_px": 4.0,          # read 0.377
    "canvas_box_px": 0.0,         # read equal
    "control_dst_max_px": 10.0,   # read 1.12, where both are valid
    "warp2_psnr_db": 8.0,         # read 18.04 dB
    "ave_fusion_psnr_db": 9.0,    # read 19.60 dB
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# bytes written before each timed repetition of a kernel, so that it finds
# its inputs in device memory and not in the 50 MB L2 (as the main path's
# calls do, with other work between them)
L2_FLUSH_BYTES = 128 << 20
_cache = {}   # the flush buffer, the spin kernel's names


def flush_l2() -> None:
    import torch
    if "buf" not in _cache:
        _cache["buf"] = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                    device="cuda")
    _cache["buf"].fill_(1)


# a spin of about 5 ms on the device (`torch.cuda._sleep`): longer than the
# host takes to queue any call timed here
SPIN_CYCLES = 10_000_000


def _spin() -> None:
    import torch
    torch.cuda._sleep(SPIN_CYCLES)


def device_events(run):
    """The device activities (kernels, copies, sets) the profiler records
    while `run()` runs, between two spins and without them: late in a long
    process the profiler drops activities (a chip run read 5 of 5 kernels
    of a 5-call profile at the start and 1 of 5 after `train_vs_stitchax`).
    None if the spin's own name could not be read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if "spin" not in _cache:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        if not names:
            return None
        _cache["spin"] = names
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _spin()
        run()
        _spin()
        torch.cuda.synchronize()
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in _cache["spin"]]


def cuda_time(fn, iters: int = 20, warmup: int = 3,
              flush: bool = True) -> float:
    """Mean ms of one fn() over `iters` calls, by CUDA events: each call
    between its own pair of events, after an L2 flush (`flush_l2`, not
    timed) unless `flush` is false."""
    import torch
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        if flush:
            flush_l2()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of one fn() call in ms: each of `iters` calls after
    an L2 flush and a spin on the device, between its own pair of CUDA
    events. The spin holds the device while the host queues the call, so
    the events span its device work alone (with the device's few
    microseconds between an event and a kernel), without the host's gaps
    that `cuda_time` counts. The profiler's sum of device activities is
    not used: late in a long process it drops the port's kernels
    (`device_events`)."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush_l2()
        _spin()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def bound_ms(nbytes: float, nflops: float, peak: float):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = nflops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


@functools.lru_cache(maxsize=None)
def sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def fp32_attention_bound(nbytes, nflops, n_exp):
    """K1's and K4's least time in fp32 at fp32's accuracy, as their fp32
    paths reach it (3xTF32): the larger of the bytes (each input read once,
    the output written once) over the memory rate, the flops three times
    over (three TF32 products a product) at the TF32 rate, and the
    exponentials (one per logit) on the special-function units at the
    maximum SM clock; and, beside it, the bound at the CUDA cores' fp32
    rate that earlier readings were held to. Returns {bound_ms, bound_by,
    bound_unit ("hbm", "tf32" or "sfu"), fp32_core_bound_ms}."""
    import torch
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    times = {"hbm": nbytes / HBM_BPS * 1e3,
             "tf32": 3.0 * nflops / PEAK["tf32"] * 1e3,
             "sfu": n_exp / (SFU_PER_CLOCK_SM * n_sm * sm_clock_hz()) * 1e3}
    unit = max(times, key=times.get)
    return {"bound_ms": times[unit],
            "bound_by": "bytes" if unit == "hbm" else "operations",
            "bound_unit": unit,
            "fp32_core_bound_ms": bound_ms(nbytes, nflops, PEAK["fp32"])[0]}


def tps_bound_ms(N, out_h, out_w):
    """K2's least time: the larger of its bytes (centers read once, the
    (H, W, 2) map written once), its fp32 flops per (pixel, center) pair
    (dx 1, d2 2, max 1, times ln 2 1, times d2 1, select 1, two FMAs 4:
    11, at the fp32 peak) and its one log per pair on the special-function
    unit, as built (`lg2.approx`: 16 per clock per SM at the maximum SM
    clock). Returns (ms, "bytes" or "operations", the unit that
    binds: "hbm", "fp32" or "sfu")."""
    import torch
    pairs = float(out_h) * out_w * N
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    times = {"hbm": (N * 16 + 24 + out_h * out_w * 8) / HBM_BPS * 1e3,
             "fp32": 11.0 * pairs / PEAK["fp32"] * 1e3,
             "sfu": pairs / (SFU_PER_CLOCK_SM * n_sm * sm_clock_hz()) * 1e3}
    unit = max(times, key=times.get)
    return times[unit], ("bytes" if unit == "hbm" else "operations"), unit


# ------------------------------- inputs --------------------------------------

def seeded_pair(seed: int = SEED, hw=PAIR_HW):
    """A smooth multi-scale random texture; img1 is a crop of it, img2 an
    overlapping crop shifted by ~1/4 of the width under a mild homography.
    float32 HWC in [0, 255]."""
    rng = np.random.default_rng(seed)
    H, W = hw
    big_h, big_w = H + 64, int(W * 1.25) + 64
    tex = np.zeros((big_h, big_w, 3), np.float32)
    for scale, amp in ((64, 1.0), (24, 0.6), (8, 0.35), (3, 0.2)):
        gh, gw = big_h // scale + 2, big_w // scale + 2
        g = rng.standard_normal((gh, gw, 3)).astype(np.float32)
        ys = np.linspace(0, gh - 1.001, big_h)
        xs = np.linspace(0, gw - 1.001, big_w)
        y0, x0 = ys.astype(int), xs.astype(int)
        fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
        tex += amp * ((1 - fy) * ((1 - fx) * g[y0][:, x0] + fx * g[y0][:, x0 + 1])
                      + fy * ((1 - fx) * g[y0 + 1][:, x0]
                              + fx * g[y0 + 1][:, x0 + 1]))
    tex = (tex - tex.min()) / (tex.max() - tex.min()) * 255.0
    img1 = tex[32:32 + H, 32:32 + W].copy()
    dx = W // 4
    # mild homography: img2(p) = tex(Hm p) with a small rotation/perspective
    c, s = np.cos(0.03), np.sin(0.03)
    Hm = np.array([[c, -s, 32 + dx], [s, c, 30], [1e-5, -1e-5, 1.0]])
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    pts = np.stack([xx, yy, np.ones_like(xx)], -1) @ Hm.T
    sx = np.clip(pts[..., 0] / pts[..., 2], 0, big_w - 1.001)
    sy = np.clip(pts[..., 1] / pts[..., 2], 0, big_h - 1.001)
    x0, y0 = sx.astype(int), sy.astype(int)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    img2 = ((1 - fy) * ((1 - fx) * tex[y0, x0] + fx * tex[y0, x0 + 1])
            + fy * ((1 - fx) * tex[y0 + 1, x0] + fx * tex[y0 + 1, x0 + 1]))
    return img1.astype(np.float32), img2.astype(np.float32)


# ------------------------------- kernels -------------------------------------

# K1 calls per stitch at the 512^2 model input (B, N, C, heads, calls):
# context encoder on both images (B=2), feature encoder per image (B=1), and
# the cost perceiver's three vertical global blocks (2 directions x 8 latents)
GSA_CALLS = [(2, 128 * 128, 128, 4, 1), (2, 64 * 64, 256, 8, 1),
             (1, 128 * 128, 128, 4, 2), (1, 64 * 64, 256, 8, 2),
             (16, 64 * 64, 128, 8, 3)]
GSA_KEYS = 256
# K3 per decoder iteration: P = 2 directions x 64 x 64 pixels, 64x64 maps
COST_P, COST_HW, COST_R, DECODER_ITERS = 2 * 64 * 64, 64, 4, 12
# K4 calls per stitch (B, H, W, C, heads, fused, calls): the LSA blocks of
# stage 1 and 2 of the context encoder (both images, B=2) and the feature
# encoder (per image, B=1), whose q/k/v are strided thirds of one fused
# qkv product with broadcast biases; and the cost perceiver's three
# vertical local blocks (2 directions x 8 latents), contiguous streams
WINDOW_CALLS = [(2, 128, 128, 128, 4, True, 1), (2, 64, 64, 256, 8, True, 1),
                (1, 128, 128, 128, 4, True, 2), (1, 64, 64, 256, 8, True, 2),
                (16, 64, 64, 128, 8, False, 3)]
WINDOW_WS = 7
# launches per stitch of each configuration: all three run the same 512^2
# align, where K1, K3 and K4 (the twins encoders' LSA blocks and the cost
# perceiver's local blocks) launch; the inpainters and the composition net
# launch none. The TPS grid (K2) launches at least once
ALIGN_LAUNCHES = {"gsa_attention": 9, "cost_lookup": 12,
                  "window_attention": 9}
EXPECT_LAUNCHES = {FAST: ALIGN_LAUNCHES, DEFAULT: ALIGN_LAUNCHES,
                   COMP: ALIGN_LAUNCHES, DIFFUSION: ALIGN_LAUNCHES}

# the evaluation: `validate_with_model` over the committed 12-pair split
# (tests/test_torch_eval.py) at 512^2, one batch of 12, fp32 nets. Each
# batch runs FlowFormer++ twice (forward, then backward), not batched in
# one call: per call K1 at the context encoder (B), the feature encoder
# (B, twice) and the cost perceiver (8B, three times), K3 in each of the 12
# decoder iterations at P = B x 64 x 64, K4 in the same LSA blocks as K1
SYNTH = "tests/torch_reference/udis_synth"
EVAL_REFERENCE = "tests/torch_reference/eval_stitchax_fp32.npz"
EVAL_BATCH = 12
EVAL_GSA_CALLS = [(EVAL_BATCH, 128 * 128, 128, 4, 6),
                  (EVAL_BATCH, 64 * 64, 256, 8, 6),
                  (8 * EVAL_BATCH, 64 * 64, 128, 8, 6)]
EVAL_WINDOW_CALLS = [(EVAL_BATCH, 128, 128, 128, 4, True, 6),
                     (EVAL_BATCH, 64, 64, 256, 8, True, 6),
                     (8 * EVAL_BATCH, 64, 64, 128, 8, False, 6)]
EVAL_COST_P, EVAL_COST_CALLS = EVAL_BATCH * 64 * 64, 24
EXPECT_EVAL_LAUNCHES = {"gsa_attention": 18, "cost_lookup": 24,
                        "window_attention": 18, "tps_grid": 0}
EVAL_REPORT_KEYS = ("avg_psnr", "avg_ssim", "easy_psnr", "mid_psnr",
                    "hard_psnr", "easy_ssim", "mid_ssim", "hard_ssim",
                    "num_pairs")
# the card's evaluation of the split against stitchax's (EVAL_REFERENCE):
# the worst per-pair and report differences, the share of the two saved
# pairs' coverage pixels that differ and the mean uint8 difference of
# their warps where both cover. The coverage counts only where it is
# exactly 1.0 (stitchax's `valid.astype(uint8)`, evaluate.py:99), so tiny
# flow differences flip its pixels. An H100 read 0.0155 dB, 1.46e-3,
# report 0.0041 dB / 4.4e-4, 3.40%, 3.5e-4 levels (PERF.md section 6; the
# CPU reads about the same, tests/test_torch_eval.py): limits about 10x,
# the share of flipped coverage pixels 3x
EVAL_STITCHAX_TOL = {"psnr_abs_diff": 0.15, "ssim_abs_diff": 0.015,
                     "report_psnr_abs_diff": 0.04,
                     "report_ssim_abs_diff": 0.0045,
                     "valid_moved_share": 0.1,
                     "warped_mean_level": 0.0035}

# the stitch CLI's files: each holds exactly the uint8 image of the
# writer's value path (its bytes are the encoder's for that image), and
# decodes within JPEG's loss of it (quality 75: an H100's host read
# >= 35.2 dB on the demo canvases, 47.2 dB on the inputs)
JPEG_LOSS_DB = 30.0
# the default configuration's CLI stitch of demo1 in fp32 on the card
# against stitchax's (tests/torch_reference/demo_stitchax_fp32.npz,
# "all_img1_with_inpaint_g12_transRef/demo1/..."): PSNR on the uint8
# canvases, the learned masks' mean |diff|, mask1 values that differ. An
# H100 read 82.99 / 83.23 / 83.06 dB, 5.3e-7, 0 (the CPU 83.62 / 83.79 /
# 83.64, 8.3e-7, tests/test_torch_parity.py): limits about 20x in squared
# error and in the masks' mean. The same limits hold fast_cv_g8_comp's
# demo1 against COMP_REFERENCE (an H100 read 82.31 / 82.50 / 82.33 dB,
# 1.97e-6, 0; the CPU 83.37 / 83.69 / 83.40 dB, 1.49e-6)
CLI_DEFAULT_TOL = {"warp2_psnr_db": 70.0, "ave_fusion_psnr_db": 70.0,
                   "composition_psnr_db": 70.0,
                   "learned_mask_mean_abs": 1e-5, "mask1_moved_px": 0}
# the diffusion configuration in fp32 on the card (TF32 off) against
# stitchax's (SD_REFERENCE): the SD inpainter alone on stitchax's own input
# and hole (512x768, 18 DDIM steps), then the demo1 stitch. Equalities stay
# equalities (an H100 read them equal); the PSNR limits sit 10 dB (10x in
# squared error) under what an H100 read first, 127.40 dB for the
# inpainter, 80.73 / 81.57 / 80.67 dB for warp2 / ave_fusion / composition,
# the learned masks' mean |diff| 10x of its 1.00e-6 (PERF.md section 2)
SD_STITCHAX_TOL = {"inpaint_outside_moved_px": 0,
                   "inpaint_hole_psnr_db": 117.0,
                   "canvas_moved_px": 0.0, "mask1_moved_px": 0,
                   "hole_moved_px": 0, "warp2_psnr_db": 70.0,
                   "ave_fusion_psnr_db": 71.0, "composition_psnr_db": 70.0,
                   "learned_mask_mean_abs": 1e-5}
# sha256 of Pillow's JPEG (quality 75) of each decoded demo input: the
# encoder must write these bytes on the card's host too
DEMO_JPEG_SHA256 = {
    "demo1/input1": "6340493d71c15ba91a8faaebb16a9264"
                    "330eaa1bc212930333e8f34f4a5b3488",
    "demo1/input2": "3cdbcde390130ad989a1c5833222ab79"
                    "39bd7095c22d6bc8bddd26f61a422fcb",
    "demo2/input1": "6340493d71c15ba91a8faaebb16a9264"
                    "330eaa1bc212930333e8f34f4a5b3488",
    "demo2/input2": "dda5a2dc12ea5b7e4ffff7eb7d238be9"
                    "7317caeaae9fdd35dcc1edb5b8d752bf",
}


def window_inputs(B, H, W, C, heads, fused, dtype, g):
    """K4's inputs as the main path gives them: with `fused` the streams
    are the strided thirds of one (B, H, W, 3C) tensor and the q/k biases
    one row broadcast over the window (stride 0)."""
    import torch
    dev = torch.device("cuda")
    T = WINDOW_WS * WINDOW_WS
    if fused:
        qkv = torch.randn(B, H, W, 3 * C, device=dev, generator=g).to(dtype)
        qx, kx, vx = qkv.split(C, -1)
        bias = (torch.randn(3 * C, device=dev, generator=g) * .3).to(dtype)
        qb, kb, vb = bias.split(C)
        return qx, kx, vx, qb.expand(T, C), kb.expand(T, C), vb[None]
    qx, kx, vx = (torch.randn(B, H, W, C, device=dev, generator=g).to(dtype)
                  for _ in range(3))
    qb, kb = ((torch.randn(T, C, device=dev, generator=g) * .3).to(dtype)
              for _ in range(2))
    vb = (torch.randn(1, C, device=dev, generator=g) * .3).to(dtype)
    return qx, kx, vx, qb, kb, vb


def window_rows(g, launches):
    """K4 against its plain version at each main-path shape, in fp32 and
    bf16, and timed in bf16 beside its bound, its plain version and
    F.scaled_dot_product_attention on the already partitioned and biased
    (B*nW, heads, 49, d) tensors (the yardstick; the port never calls it)."""
    import torch
    import torch.nn.functional as F

    from stitchax_torch.ops.kernels import window_attention as wa

    ws, T = WINDOW_WS, WINDOW_WS * WINDOW_WS
    detail = []
    err = ms = plain = lib = bnd = 0.0
    dev_ms = lib_dev_ms = 0.0
    bound_share = {"bytes": 0.0, "operations": 0.0}
    for B, H, W, C, heads, fused, calls in WINDOW_CALLS:
        for dtype in (torch.float32, torch.bfloat16):
            args = window_inputs(B, H, W, C, heads, fused, dtype, g)
            got = wa.window_attention(*args, heads=heads, ws=ws)
            want = wa.window_attention_plain(*args, heads=heads, ws=ws)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            tol = (TOL["window_attention_fp32"] if dtype == torch.float32
                   else bf16_ulp(want.float().abs().max().item()))
            entry = {"kernel": "window_attention", "B": B, "H": H, "W": W,
                     "C": C, "heads": heads, "fused_qkv": fused,
                     "calls": calls, "dtype": str(dtype).split(".")[-1],
                     "max_abs_err": e, "tol": tol}
            if dtype == torch.bfloat16:
                d = C // heads
                q, k, v = wa.biased_windows(*args, ws)
                qh, kh, vh = (t.reshape(-1, T, heads, d).transpose(1, 2)
                              .contiguous() for t in (q, k, v))
                t_k = cuda_time(lambda: wa.window_attention(
                    *args, heads=heads, ws=ws))
                t_p = cuda_time(lambda: wa.window_attention_plain(
                    *args, heads=heads, ws=ws), iters=5)
                t_l = cuda_time(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh))
                d_k = device_ms(lambda: wa.window_attention(
                    *args, heads=heads, ws=ws))
                d_l = device_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh))
                n_win = q.shape[0] * q.shape[1]
                # q, k, v read once, out written once (bf16), biases once
                nbytes = 2 * (4 * B * H * W * C + 2 * T * C + C)
                b, by = bound_ms(nbytes, 4.0 * n_win * T * T * C,
                                 PEAK["bf16"])
                entry.update(ms=t_k, device_ms=d_k, plain_ms=t_p,
                             library_ms=t_l, library_device_ms=d_l,
                             bound_ms=b, bound_by=by)
                dev_ms += calls * d_k
                lib_dev_ms += calls * d_l
                ms += calls * t_k
                plain += calls * t_p
                lib += calls * t_l
                bnd += calls * b
                bound_share[by] += calls * b
            err = max(err, e)
            detail.append(entry)
    row = {"name": "window_attention", "route": "cuda",
           "source": "stitchax_torch/csrc/window_attention.cu",
           "replaces": "tools/exp_window_attn.py:96",
           "launches": launches["window_attention"], "max_abs_err": err,
           "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
           "bound_ms": bnd,
           "bound_by": max(bound_share, key=bound_share.get),
           "library_ms": lib, "library_device_ms": lib_dev_ms}
    return row, detail


def kernel_rows(tps_inputs, launches):
    """Hold each kernel against its plain version on the card at the
    main-path shapes and time it. `tps_inputs` maps each configuration to
    the (ctrl, kernel_w, affine_w, out_h, out_w) its stitch gave K2; the
    K2 row is the default configuration's. `launches` maps each
    configuration to its launches per stitch: a row's "launches" are the
    default configuration's, "launches_by_config" every configuration's.
    Returns the kernel table rows and one entry per call shape, each with
    its tolerance."""
    import torch
    import torch.nn.functional as F

    from stitchax_torch.ops.kernels import (cost_lookup, gsa_attention,
                                            tps_grid)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows, detail = [], []

    # K1
    err = ms = plain = lib = bnd = 0.0
    dev_ms = lib_dev_ms = 0.0
    bound_share = {"bytes": 0.0, "operations": 0.0}
    for B, N, C, heads, calls in GSA_CALLS:
        q = torch.randn(B, N, C, device=dev, generator=g).bfloat16()
        k = torch.randn(B, GSA_KEYS, C, device=dev, generator=g).bfloat16()
        v = torch.randn(B, GSA_KEYS, C, device=dev, generator=g).bfloat16()
        got = gsa_attention.gsa_attention(q, k, v, heads=heads)
        want = gsa_attention.gsa_attention_plain(q, k, v, heads=heads)
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        tol = bf16_ulp(want.float().abs().max().item())
        d = C // heads
        qh, kh, vh = (t.view(B, -1, heads, d).transpose(1, 2).contiguous()
                      for t in (q, k, v))
        t_k = cuda_time(lambda: gsa_attention.gsa_attention(q, k, v,
                                                            heads=heads))
        t_p = cuda_time(lambda: gsa_attention.gsa_attention_plain(
            q, k, v, heads=heads), iters=5)
        t_l = cuda_time(lambda: F.scaled_dot_product_attention(qh, kh, vh))
        d_k = device_ms(lambda: gsa_attention.gsa_attention(q, k, v,
                                                            heads=heads))
        d_l = device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
        nbytes = 2 * (2 * B * N * C + 2 * B * GSA_KEYS * C)
        b, by = bound_ms(nbytes, 4.0 * B * N * GSA_KEYS * C, PEAK["bf16"])
        # the fp32 path (the card-vs-CPU stitches take it) against the same
        # plain version
        q32, k32, v32 = q.float(), k.float(), v.float()
        e32 = (gsa_attention.gsa_attention(q32, k32, v32, heads=heads)
               - gsa_attention.gsa_attention_plain(q32, k32, v32,
                                                   heads=heads)
               ).abs().max().item()
        detail.append({"kernel": "gsa_attention", "B": B, "N": N, "C": C,
                       "heads": heads, "calls": calls, "dtype": "bfloat16",
                       "max_abs_err": e, "tol": tol, "ms": t_k,
                       "device_ms": d_k, "plain_ms": t_p, "library_ms": t_l,
                       "library_device_ms": d_l, "bound_ms": b,
                       "bound_by": by})
        detail.append({"kernel": "gsa_attention", "B": B, "N": N, "C": C,
                       "heads": heads, "calls": calls, "dtype": "float32",
                       "max_abs_err": e32, "tol": TOL["gsa_attention_fp32"]})
        err = max(err, e)
        dev_ms += calls * d_k
        lib_dev_ms += calls * d_l
        ms += calls * t_k
        plain += calls * t_p
        lib += calls * t_l
        bnd += calls * b
        bound_share[by] += calls * b
    rows.append({"name": "gsa_attention", "route": "cuda",
                 "source": "stitchax_torch/csrc/gsa_attention.cu",
                 "replaces": "stitchax/ops/pallas/gsa_attention.py:51",
                 "launches": launches[DEFAULT]["gsa_attention"],
                 "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                 "plain_ms": plain, "bound_ms": bnd,
                 "bound_by": max(bound_share, key=bound_share.get),
                 "library_ms": lib, "library_device_ms": lib_dev_ms})

    # K3, with the main path's bf16 coordinates (timed) and fp32 ones
    cm = torch.randn(COST_P, COST_HW, COST_HW, device=dev,
                     generator=g).bfloat16()
    coords = (torch.rand(COST_P, 2, device=dev, generator=g)
              * (COST_HW + 12) - 6)
    coords_bf16 = coords.bfloat16()
    e = 0.0
    for c in (coords_bf16, coords):
        got = cost_lookup.cost_lookup(cm, c, COST_R)
        want = cost_lookup.cost_lookup_plain(cm, c, COST_R)
        torch.cuda.synchronize()
        e = max(e, (got - want).abs().max().item())
    coords = coords_bf16.float()           # the same points, for grid_sample
    t_k = cuda_time(lambda: cost_lookup.cost_lookup(cm, coords_bf16, COST_R))
    d_k = device_ms(lambda: cost_lookup.cost_lookup(cm, coords_bf16, COST_R))
    t_k32 = cuda_time(lambda: cost_lookup.cost_lookup(cm, coords, COST_R))
    t_p = cuda_time(lambda: cost_lookup.cost_lookup_plain(cm, coords_bf16,
                                                          COST_R))
    # library yardstick: F.grid_sample (bilinear, zero padding,
    # align_corners) of each pixel's own map at its 81 taps, x offset outer.
    # In fp32: grid_sample takes the grid in the maps' dtype, and a bf16 grid
    # would round the coordinates. It does not round the weights to bf16.
    off = torch.arange(-COST_R, COST_R + 1, device=dev, dtype=torch.float32)
    win = off.numel()
    gx = (coords[:, 0, None, None] + off[:, None]).expand(-1, -1, win)
    gy = (coords[:, 1, None, None] + off[None, :]).expand(-1, win, -1)
    grid = torch.stack([gx, gy], -1) * (2.0 / (COST_HW - 1)) - 1.0  # P,a,t,2
    cm32 = cm.float()[:, None]

    def library_call():
        return F.grid_sample(cm32, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    lib_diff = (library_call().reshape(COST_P, -1) - want).abs().max().item()
    t_l = cuda_time(library_call)
    d_l = device_ms(library_call)
    # bytes this data needs: the in-bounds (2r+2)^2 patch of each map
    steps = torch.arange(2 * COST_R + 2, device=dev)
    f0 = torch.floor(coords).long() - COST_R
    inb = [((f0[:, i:i + 1] + steps >= 0) & (f0[:, i:i + 1] + steps < COST_HW)
            ).sum(1) for i in (0, 1)]
    touched = float((inb[0] * inb[1]).sum().item())
    win2 = (2 * COST_R + 1) ** 2
    nbytes = touched * 2 + COST_P * 2 * 2 + COST_P * win2 * 4
    nflops = COST_P * (3 * (2 * COST_R + 1) * (2 * COST_R + 2) + 3 * win2)
    b, by = bound_ms(nbytes, nflops, PEAK["fp32"])
    detail.append({"kernel": "cost_lookup", "P": COST_P, "H2": COST_HW,
                   "W2": COST_HW, "r": COST_R, "calls": DECODER_ITERS,
                   "coords": "bfloat16", "max_abs_err": e,
                   "tol": TOL["cost_lookup"], "ms": t_k, "device_ms": d_k,
                   "ms_fp32_coords": t_k32, "plain_ms": t_p,
                   "library_ms": t_l, "library_device_ms": d_l,
                   "library_max_abs_diff": lib_diff, "bound_ms": b,
                   "bound_by": by})
    rows.append({"name": "cost_lookup", "route": "cuda",
                 "source": "stitchax_torch/csrc/cost_lookup.cu",
                 "replaces": "stitchax/ops/pallas/cost_lookup.py:121",
                 "launches": launches[DEFAULT]["cost_lookup"],
                 "max_abs_err": e,
                 "ms": DECODER_ITERS * t_k,
                 "device_ms": DECODER_ITERS * d_k,
                 "plain_ms": DECODER_ITERS * t_p,
                 "bound_ms": DECODER_ITERS * b, "bound_by": by,
                 "library_ms": DECODER_ITERS * t_l,
                 "library_device_ms": DECODER_ITERS * d_l})

    # K2, at each configuration's canvas and control points
    k2 = {}
    for config, (ctrl, kw, aw, out_h, out_w) in tps_inputs.items():
        N = ctrl.shape[0]
        got = tps_grid.tps_grid(ctrl, kw, aw, out_h, out_w)
        want = tps_grid.tps_grid_plain(ctrl, kw, aw, out_h, out_w)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        t_k = cuda_time(lambda: tps_grid.tps_grid(ctrl, kw, aw, out_h,
                                                  out_w))
        t_p = cuda_time(lambda: tps_grid.tps_grid_plain(ctrl, kw, aw, out_h,
                                                        out_w), iters=5)
        d_k = device_ms(lambda: tps_grid.tps_grid(ctrl, kw, aw, out_h,
                                                  out_w))
        b, by, unit = tps_bound_ms(N, out_h, out_w)
        k2[config] = {"kernel": "tps_grid", "config": config, "N": N,
                      "out_h": out_h, "out_w": out_w, "calls": 1,
                      "max_abs_err": e, "tol": TOL["tps_grid"], "ms": t_k,
                      "device_ms": d_k, "plain_ms": t_p, "bound_ms": b,
                      "bound_by": by, "bound_unit": unit}
        detail.append(k2[config])
    d = k2[DEFAULT]
    rows.append({"name": "tps_grid", "route": "cuda",
                 "source": "stitchax_torch/csrc/tps_grid.cu",
                 "replaces": "stitchax/ops/pallas/tps_kernel.py:53",
                 "launches": launches[DEFAULT]["tps_grid"],
                 "max_abs_err": max(v["max_abs_err"] for v in k2.values()),
                 "ms": d["ms"], "device_ms": d["device_ms"],
                 "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
                 "bound_by": d["bound_by"], "bound_unit": d["bound_unit"],
                 "library_ms": None, "library_device_ms": None})

    # K4
    row, more = window_rows(g, launches[DEFAULT])
    rows.append(row)
    detail += more
    for row in rows:
        row["launches_by_config"] = {c: n[row["name"]]
                                     for c, n in launches.items()}
    return rows, detail


def eval_kernel_rows():
    """K1, K3 and K4 against their plain versions on the card at the
    evaluation's shapes (fp32, batch 12), timed beside their bounds at the
    fp32 peak and their library yardsticks. Returns {kernel: summary per
    evaluation batch} and one entry per call shape."""
    import torch
    import torch.nn.functional as F

    from stitchax_torch.ops.kernels import (cost_lookup, gsa_attention,
                                            window_attention as wa)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    f32 = torch.float32
    rows, detail = {}, []

    def add(name, entry, calls):
        r = rows.setdefault(name, {"launches_per_batch": 0, "ms": 0.0,
                                   "device_ms": 0.0, "plain_ms": 0.0,
                                   "bound_ms": 0.0, "library_ms": 0.0,
                                   "library_device_ms": 0.0,
                                   "max_abs_err": 0.0, "bound_by": {}})
        r["launches_per_batch"] += calls
        for k in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                  "library_device_ms"):
            r[k] += calls * entry[k]
        if "fp32_core_bound_ms" in entry:
            r["fp32_core_bound_ms"] = (r.get("fp32_core_bound_ms", 0.0)
                                       + calls * entry["fp32_core_bound_ms"])
        r["max_abs_err"] = max(r["max_abs_err"], entry["max_abs_err"])
        by = r["bound_by"]
        by[entry["bound_by"]] = by.get(entry["bound_by"], 0.0) + \
            calls * entry["bound_ms"]
        detail.append({"phase_shapes": "evaluation", **entry,
                       "calls": calls})

    for B, N, C, heads, calls in EVAL_GSA_CALLS:
        q = torch.randn(B, N, C, device=dev, generator=g)
        k = torch.randn(B, GSA_KEYS, C, device=dev, generator=g)
        v = torch.randn(B, GSA_KEYS, C, device=dev, generator=g)
        e = (gsa_attention.gsa_attention(q, k, v, heads=heads)
             - gsa_attention.gsa_attention_plain(q, k, v, heads=heads)
             ).abs().max().item()
        d = C // heads
        qh, kh, vh = (t.view(B, -1, heads, d).transpose(1, 2).contiguous()
                      for t in (q, k, v))
        bound = fp32_attention_bound(
            4 * (2 * B * N * C + 2 * B * GSA_KEYS * C),
            4.0 * B * N * GSA_KEYS * C, B * N * GSA_KEYS * heads)
        add("gsa_attention", {
            "kernel": "gsa_attention", "B": B, "N": N, "C": C,
            "heads": heads, "dtype": "float32", "max_abs_err": e,
            "tol": TOL["gsa_attention_fp32"],
            "ms": cuda_time(lambda: gsa_attention.gsa_attention(
                q, k, v, heads=heads), iters=5),
            "device_ms": device_ms(lambda: gsa_attention.gsa_attention(
                q, k, v, heads=heads), iters=5),
            "plain_ms": cuda_time(lambda: gsa_attention.gsa_attention_plain(
                q, k, v, heads=heads), iters=3, warmup=1),
            "library_ms": cuda_time(
                lambda: F.scaled_dot_product_attention(qh, kh, vh), iters=5),
            "library_device_ms": device_ms(
                lambda: F.scaled_dot_product_attention(qh, kh, vh), iters=5),
            **bound}, calls)
        del q, k, v, qh, kh, vh

    cm = torch.randn(EVAL_COST_P, COST_HW, COST_HW, device=dev, generator=g)
    coords = (torch.rand(EVAL_COST_P, 2, device=dev, generator=g)
              * (COST_HW + 12) - 6)
    e = (cost_lookup.cost_lookup(cm, coords, COST_R)
         - cost_lookup.cost_lookup_plain(cm, coords, COST_R)
         ).abs().max().item()
    off = torch.arange(-COST_R, COST_R + 1, device=dev, dtype=f32)
    win = off.numel()
    gx = (coords[:, 0, None, None] + off[:, None]).expand(-1, -1, win)
    gy = (coords[:, 1, None, None] + off[None, :]).expand(-1, win, -1)
    grid = torch.stack([gx, gy], -1) * (2.0 / (COST_HW - 1)) - 1.0
    library_call = lambda: F.grid_sample(cm[:, None], grid, mode="bilinear",
                                         padding_mode="zeros",
                                         align_corners=True)
    steps = torch.arange(2 * COST_R + 2, device=dev)
    f0 = torch.floor(coords).long() - COST_R
    inb = [((f0[:, i:i + 1] + steps >= 0) & (f0[:, i:i + 1] + steps < COST_HW)
            ).sum(1) for i in (0, 1)]
    touched = float((inb[0] * inb[1]).sum().item())
    b, by = bound_ms(touched * 4 + EVAL_COST_P * 2 * 4
                     + EVAL_COST_P * win * win * 4,
                     EVAL_COST_P * (3 * win * (win + 1) + 3 * win * win),
                     PEAK["fp32"])
    add("cost_lookup", {
        "kernel": "cost_lookup", "P": EVAL_COST_P, "H2": COST_HW,
        "W2": COST_HW, "r": COST_R, "dtype": "float32", "max_abs_err": e,
        "tol": TOL["cost_lookup"],
        "ms": cuda_time(lambda: cost_lookup.cost_lookup(cm, coords, COST_R)),
        "device_ms": device_ms(lambda: cost_lookup.cost_lookup(
            cm, coords, COST_R)),
        "plain_ms": cuda_time(lambda: cost_lookup.cost_lookup_plain(
            cm, coords, COST_R), iters=5),
        "library_ms": cuda_time(library_call),
        "library_device_ms": device_ms(library_call),
        "bound_ms": b, "bound_by": by}, EVAL_COST_CALLS)
    del cm, coords, grid

    ws, T = WINDOW_WS, WINDOW_WS * WINDOW_WS
    for B, H, W, C, heads, fused, calls in EVAL_WINDOW_CALLS:
        args = window_inputs(B, H, W, C, heads, fused, f32, g)
        e = (wa.window_attention(*args, heads=heads, ws=ws)
             - wa.window_attention_plain(*args, heads=heads, ws=ws)
             ).abs().max().item()
        d = C // heads
        q, k, v = wa.biased_windows(*args, ws)
        qh, kh, vh = (t.reshape(-1, T, heads, d).transpose(1, 2).contiguous()
                      for t in (q, k, v))
        n_win = q.shape[0] * q.shape[1]
        bound = fp32_attention_bound(
            4 * (4 * B * H * W * C + 2 * T * C + C),
            4.0 * n_win * T * T * C, n_win * T * T * heads)
        add("window_attention", {
            "kernel": "window_attention", "B": B, "H": H, "W": W, "C": C,
            "heads": heads, "fused_qkv": fused, "dtype": "float32",
            "max_abs_err": e, "tol": TOL["window_attention_fp32"],
            "ms": cuda_time(lambda: wa.window_attention(
                *args, heads=heads, ws=ws), iters=5),
            "device_ms": device_ms(lambda: wa.window_attention(
                *args, heads=heads, ws=ws), iters=5),
            "plain_ms": cuda_time(lambda: wa.window_attention_plain(
                *args, heads=heads, ws=ws), iters=3, warmup=1),
            "library_ms": cuda_time(
                lambda: F.scaled_dot_product_attention(qh, kh, vh), iters=5),
            "library_device_ms": device_ms(
                lambda: F.scaled_dot_product_attention(qh, kh, vh), iters=5),
            **bound}, calls)
        del args, q, k, v, qh, kh, vh
    for r in rows.values():
        r["bound_by"] = max(r["bound_by"], key=r["bound_by"].get)
    torch.cuda.empty_cache()
    return rows, detail


# ------------------------------- stitch --------------------------------------

def build_models(dtype, device, config=FAST):
    """The configuration's models with trained weights (tracked in the
    repo): ckpt_r05's flow and homo nets, and where the configuration uses
    them its comp net, the TransRef checkpoint or the SD checkpoint.
    Raises if the checkout lacks them."""
    from stitchax_torch.run.stitcher import StitchModels
    extra = {DEFAULT: [TRANSREF_CKPT], DIFFUSION: [SD_CKPT]}.get(config, [])
    for path in [CKPT] + extra:
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{path} is missing: the smoke stitches "
                                    "with the trained weights")
    return StitchModels.from_npz(
        CKPT, device, dtype, config,
        transref=TRANSREF_CKPT if config == DEFAULT else None,
        sd=SD_CKPT if config == DIFFUSION else None)


def check_finite(out) -> None:
    for k, v in out.items():
        if v.dtype.kind == "f" and not np.isfinite(v).all():
            raise RuntimeError(f"stitch output {k} is not finite")


def sd_part_ms(sd, canvas_h, canvas_w, iters=5):
    """ms by CUDA events of the SD plugin's parts at a canvas: one DDIM
    step (ControlNet on the 4-channel latents, then the UNet on the
    9-channel concat with its residuals), the VAE's encode of the canvas
    and its decode of the latents; on seeded inputs."""
    import torch

    dev = sd.device
    g = torch.Generator(device=dev).manual_seed(SEED)
    h8, w8 = int(canvas_h) // 8, int(canvas_w) // 8
    lat = torch.randn(1, 4, h8, w8, device=dev, generator=g)
    lat9 = torch.randn(1, 9, h8, w8, device=dev, generator=g)
    ctrl = torch.rand(1, 3, 8 * h8, 8 * w8, device=dev, generator=g)
    t = torch.full((1,), 601.0, device=dev)

    @torch.no_grad()
    def step():
        res, mid = sd.controlnet(lat, t, sd.context, ctrl)
        return sd.unet(lat9, t, sd.context, res, mid)

    with torch.no_grad():
        return {"ddim_step_ms": cuda_time(step, iters, 1, flush=False),
                "vae_encode_ms": cuda_time(
                    lambda: sd.vae.encode_mode(ctrl), iters, 1, False),
                "vae_decode_ms": cuda_time(lambda: sd.vae.decode(lat),
                                           iters, 1, False)}


def stitch_phase(img1, img2, config=FAST):
    """One warm-up stitch, then the launch counts set to 0, one timed bf16
    stitch, the counts read. Returns the counts and K2's inputs."""
    import torch

    from stitchax_torch.ops.kernels import library
    from stitchax_torch.run.stitcher import Stitcher
    from stitchax_torch.tps.solve import tps_fit

    t0 = time.perf_counter()
    models = build_models(torch.bfloat16, "cuda", config)
    load_s = time.perf_counter() - t0
    stitcher = Stitcher(models, device="cuda", config=config)
    warm = {}
    stitcher.stitch(img1, img2, timings=warm)          # first call, warm-up
    torch.cuda.synchronize()
    library.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    t0 = time.perf_counter()
    out = stitcher.stitch(img1, img2, timings=timings)
    total_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(library.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_finite(out)
    want = EXPECT_LAUNCHES[config]
    if (launches["tps_grid"] < 1
            or any(launches[k] != n for k, n in want.items())):
        raise RuntimeError(f"{config}: kernel launches per stitch "
                           f"{launches}, expected {want} and tps_grid >= 1")
    res = {"phase": PHASE[config],
           "config": config, "dtype": "bfloat16", "weights": WEIGHTS,
           "weights_load_s": load_s, "pair_hw": list(PAIR_HW),
           "stitch_ms": total_ms, **timings, "first_call": warm,
           "peak_mem_gib": peak,
           "canvas_hw": out["canvas_hw"].tolist(),
           "true_hw": out["true_hw"].tolist(),
           "control_points": int(out["control_valid"].size),
           "control_valid": int(out["control_valid"].sum()),
           "mask2_mean": float(out["mask2"].mean()),
           "launches_per_stitch": launches}
    if config != FAST:
        res["composition_hw"] = list(out["composition"].shape[:2])
        res["learned_mask1_mean"] = float(out["learned_mask1"].mean())
    if config == DEFAULT:
        res["transref_weights"] = TRANSREF_WEIGHTS
    if config == DIFFUSION:
        ip = stitcher.inpainter
        steps = ip.denoise_fn.steps
        res.update(sd_weights=SD_WEIGHTS, sd_dtype="float32",
                   sd_strength=ip.strength, ddim_steps=steps,
                   inpaint_ms_per_step=timings["inpaint_ms"] / steps,
                   tf32_convolutions=torch.backends.cudnn.allow_tf32,
                   hole_share=float((out["inpaint_area_mask"] > 0.5).mean()),
                   **sd_part_ms(models.sd_models, *out["canvas_hw"]))
    emit(res)
    # K2's inputs as tps_backward_warp forms them from this stitch's
    # control points, at this stitch's (bucketed) canvas
    out_h, out_w = (int(v) for v in out["canvas_hw"])
    dev = torch.device("cuda")
    scale = torch.tensor([out_w, out_h], device=dev, dtype=torch.float32)
    src = torch.from_numpy(out["control_src"]).to(dev) / scale
    dst = torch.from_numpy(out["control_dst"]).to(dev) / scale
    valid = torch.from_numpy(out["control_valid"]).to(dev)
    kw, aw = tps_fit(dst, src, valid)
    kw = kw * valid.float()[:, None]
    tps_inputs = (dst.contiguous(), kw.contiguous(), aw.contiguous(), out_h,
                  out_w)
    return launches, tps_inputs


def _psnr(a, b) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _fp32_stitches(img1, img2, config):
    """The configuration's stitch in fp32 on the card (TF32 off) and on the
    CPU, from one set of weights. Returns (card, cpu, card_s, cpu_s)."""
    import copy

    import torch

    from stitchax_torch.run.stitcher import Stitcher, StitchModels
    from stitchax_torch.utils.precision import fp32_exact

    fp32_exact()
    cpu_models = build_models(torch.float32, "cpu", config)
    gpu_models = StitchModels(
        *(copy.deepcopy(m) for m in (cpu_models.flow_model,
                                     cpu_models.homo_model)),
        "cuda", torch.float32,
        *(copy.deepcopy(m) for m in (cpu_models.comp_model,
                                     cpu_models.transref_model)))
    t0 = time.perf_counter()
    g = Stitcher(gpu_models, device="cuda", config=config).stitch(img1, img2)
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    c = Stitcher(cpu_models, device="cpu", config=config).stitch(img1, img2)
    cpu_s = time.perf_counter() - t0
    check_finite(g)
    check_finite(c)
    return g, c, gpu_s, cpu_s


def _check(res, tol, phase) -> None:
    res["tol"] = tol
    misses = [k for k, t in tol.items()
              if (res[k] < t if k.endswith("_db") else res[k] > t)]
    res["ok"] = not misses
    emit(res)
    if misses:
        raise RuntimeError(f"{phase}: outside tolerance: {misses}")


def stitch_vs_cpu_default_phase(img1, img2):
    """The default configuration's stitch in fp32, card vs CPU: the
    composition, the learned masks and ave_fusion."""
    g, c, gpu_s, cpu_s = _fp32_stitches(img1, img2, DEFAULT)
    res = {"phase": "stitch_vs_cpu_default", "config": DEFAULT,
           "dtype": "float32", "gpu_s": gpu_s, "cpu_s": cpu_s,
           "true_hw": [g["true_hw"].tolist(), c["true_hw"].tolist()],
           "composition_hw": [list(g["composition"].shape[:2]),
                              list(c["composition"].shape[:2])]}
    if (g["true_hw"].tolist() != c["true_hw"].tolist()
            or g["composition"].shape != c["composition"].shape):
        raise RuntimeError(f"card and CPU canvases differ: {res}")
    lm = np.concatenate([np.abs(g[k] - c[k]).ravel()
                         for k in ("learned_mask1", "learned_mask2")])
    res.update(composition_psnr_db=_psnr(g["composition"], c["composition"]),
               learned_mask_max_abs=float(lm.max()),
               learned_mask_mean_abs=float(lm.mean()),
               learned_mask_moved_share=float(np.mean(lm > 1e-2)),
               canvas_mask_flip_share=float(np.mean(np.concatenate([
                   np.abs(g[k] - c[k]).ravel() > 1e-3
                   for k in ("mask1", "mask2")]))),
               blend_psnr_db=_psnr(g["new_blend_image"],
                                   c["new_blend_image"]),
               flow_max_px=float(np.abs(g["flow"] - c["flow"]).max()),
               control_valid=[int(g["control_valid"].sum()),
                              int(c["control_valid"].sum())])
    _check(res, STITCH_DEFAULT_TOL, "stitch_vs_cpu_default")


def stitch_vs_cpu_phase(img1, img2):
    """The fast_cv_g8 stitch in fp32 on the card (TF32 off) and on the
    CPU."""
    g, c, gpu_s, cpu_s = _fp32_stitches(img1, img2, FAST)
    fd = np.abs(g["flow"] - c["flow"])
    res = {"phase": "stitch_vs_cpu", "dtype": "float32", "weights": WEIGHTS,
           "gpu_s": gpu_s, "cpu_s": cpu_s,
           "H_max_abs": float(np.abs(g["H"] - c["H"]).max()),
           "flow_max_px": float(fd.max()), "flow_mean_px": float(fd.mean()),
           "canvas_box_px": float(np.abs(g["canvas_box"]
                                         - c["canvas_box"]).max()),
           "true_hw": [g["true_hw"].tolist(), c["true_hw"].tolist()]}
    res["blend_psnr_db"] = (
        _psnr(g["new_blend_image"], c["new_blend_image"])
        if g["true_hw"].tolist() == c["true_hw"].tolist() else float("-inf"))
    _check(res, STITCH_TOL, "stitch_vs_cpu")


def _u8(x):
    return np.rint(np.clip(x, 0, 255)).astype(np.uint8)


def stitch_vs_stitchax_phase():
    """The port's fast_cv_g8 stitch of demo_data/demo1 and demo2 in fp32 on
    the card against stitchax's own outputs for the same pairs (its jitted
    Stitcher, fp32 nets, on the CPU; REFERENCE, which also holds the decoded
    input images)."""
    import torch

    from stitchax_torch.run.stitcher import Stitcher
    from stitchax_torch.utils.precision import fp32_exact

    path = os.path.join(REPO, REFERENCE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{path} is missing: stitchax's outputs for "
                                "the demo pairs")
    fp32_exact()
    st = Stitcher(build_models(torch.float32, "cuda", FAST), device="cuda",
                  config=FAST)
    worst, pairs = {}, {}
    with np.load(path) as data:
        for name in DEMO_PAIRS:
            ref = {k.split("/", 1)[1]: data[k] for k in data.files
                   if k.startswith(name + "/")}
            out = st.stitch(ref["img1"].astype(np.float32),
                            ref["img2"].astype(np.float32))
            check_finite(out)
            th, tw = ref["warp2"].shape[:2]
            if (out["canvas_hw"].tolist() != ref["canvas_hw"].tolist()
                    or out["true_hw"].tolist() != [th, tw]):
                raise RuntimeError(f"{name}: canvas {out['canvas_hw']} / "
                                   f"{out['true_hw']}, stitchax "
                                   f"{ref['canvas_hw']} / {[th, tw]}")
            r = {"H_max_abs": float(np.abs(out["H"] - ref["H"]).max()),
                 "flow_max_px": float(np.abs(out["flow"]
                                             - ref["flow"]).max()),
                 "canvas_box_px": float(np.abs(out["canvas_box"]
                                               - ref["canvas_box"]).max()),
                 "control_valid_moved": int((out["control_valid"]
                                             != ref["control_valid"]).sum()),
                 "control_dst_max_px": float(np.abs(
                     out["control_dst"] - ref["control_dst"]).max()),
                 "mask1_moved_px": int((out["mask1"]
                                        != ref["mask1"][:th, :tw]).sum())}
            for key, ours in (("warp2", "output2"),
                              ("ave_fusion", "new_blend_image")):
                a = _u8(out[ours])
                d = np.abs(a.astype(int) - ref[key].astype(int))
                r[f"{key}_psnr_db"] = _psnr(a, ref[key])
                r[f"{key}_max_level"] = int(d.max())
                r[f"{key}_px_off_gt1"] = int((d > 1).sum())
            pairs[name] = r
            for k, v in r.items():
                worse = min if k.endswith("_db") else max
                worst[k] = worse(worst.get(k, v), v)
    res = {"phase": "stitch_vs_stitchax", "config": FAST, "dtype": "float32",
           "reference": REFERENCE, "pairs": pairs, **worst}
    _check(res, STITCHAX_TOL, "stitch_vs_stitchax")


def stitch_vs_stitchax_bf16_phase():
    """The port's fast_cv_g8 stitch of demo1 and demo2 in bf16 on the card
    (the smoke's precision, as out.py runs stitchax) against stitchax's
    jitted bf16 stitch of the same decoded pairs on the CPU (BF16_REFERENCE,
    the inputs from REFERENCE). Hard thresholds (mask1's erosion, the
    control points' validity; ROADMAP C1 / C5) are recorded, not gated:
    the PSNRs gate what they move."""
    import torch

    from stitchax_torch.run.stitcher import Stitcher

    st = Stitcher(build_models(torch.bfloat16, "cuda", FAST), device="cuda",
                  config=FAST)
    worst, pairs, card = {}, {}, {}
    with np.load(os.path.join(REPO, REFERENCE)) as inputs, \
            np.load(os.path.join(REPO, BF16_REFERENCE)) as data:
        for name in DEMO_PAIRS:
            ref = {k.split("/", 1)[1]: data[k] for k in data.files
                   if k.startswith(name + "/")}
            out = st.stitch(inputs[f"{name}/img1"].astype(np.float32),
                            inputs[f"{name}/img2"].astype(np.float32))
            check_finite(out)
            card[name] = {k: out[k] for k in ("H", "flow")}
            th, tw = ref["warp2"].shape[:2]
            if (out["canvas_hw"].tolist() != ref["canvas_hw"].tolist()
                    or out["true_hw"].tolist() != [th, tw]):
                raise RuntimeError(f"{name}: canvas {out['canvas_hw']} / "
                                   f"{out['true_hw']}, stitchax "
                                   f"{ref['canvas_hw']} / {[th, tw]}")
            fd = np.abs(out["flow"] - ref["flow"])
            valid = out["control_valid"] & ref["control_valid"]
            r = {"H_max_abs": float(np.abs(out["H"] - ref["H"]).max()),
                 "flow_max_px": float(fd.max()),
                 "flow_mean_px": float(fd.mean()),
                 "canvas_box_px": float(np.abs(out["canvas_box"]
                                               - ref["canvas_box"]).max()),
                 "control_valid_moved": int((out["control_valid"]
                                             != ref["control_valid"]).sum()),
                 "control_dst_max_px": float(np.abs(
                     out["control_dst"] - ref["control_dst"])[valid].max()),
                 "mask1_moved_px": int((out["mask1"]
                                        != ref["mask1"][:th, :tw]).sum())}
            for key, ours in (("warp2", "output2"),
                              ("ave_fusion", "new_blend_image")):
                a = _u8(out[ours])
                d = np.abs(a.astype(int) - ref[key].astype(int))
                r[f"{key}_psnr_db"] = _psnr(a, ref[key])
                r[f"{key}_max_level"] = int(d.max())
                r[f"{key}_px_off_gt1"] = int((d > 1).sum())
            pairs[name] = r
            for k, v in r.items():
                worse = min if k.endswith("_db") else max
                worst[k] = worse(worst.get(k, v), v)
    # context, not gated: the same numbers for the card's bf16 against
    # stitchax's fp32 stitch and for stitchax's bf16 against its fp32
    context = {}
    with np.load(os.path.join(REPO, REFERENCE)) as fp32, \
            np.load(os.path.join(REPO, BF16_REFERENCE)) as bf16:
        for name in DEMO_PAIRS:
            d = lambda k: np.abs(bf16[f"{name}/{k}"] - fp32[f"{name}/{k}"])
            context[f"stitchax_bf16_vs_fp32/{name}"] = {
                "H_max_abs": float(d("H").max()),
                "flow_max_px": float(d("flow").max()),
                "flow_mean_px": float(d("flow").mean())}
            context[f"card_bf16_vs_stitchax_fp32/{name}"] = {
                "H_max_abs": float(np.abs(card[name]["H"]
                                          - fp32[f"{name}/H"]).max()),
                "flow_max_px": float(np.abs(card[name]["flow"]
                                            - fp32[f"{name}/flow"]).max())}
    res = {"phase": "stitch_vs_stitchax_bf16", "config": FAST,
           "dtype": "bfloat16", "reference": BF16_REFERENCE,
           "pairs": pairs, "context": context, **worst}
    _check(res, STITCHAX_BF16_TOL, "stitch_vs_stitchax_bf16")


def sd_vs_stitchax_phase():
    """The diffusion configuration in fp32 on the card (TF32 off) against
    stitchax's outputs on the CPU (SD_REFERENCE): the SD inpainter alone on
    the input and hole stitchax's inpainter got in its demo1 stitch, then
    the demo1 stitch itself (the decoded pair from REFERENCE)."""
    import torch

    from stitchax_torch.compose.inpainters import StableDiffusionInpainter
    from stitchax_torch.run.stitcher import Stitcher, output_images
    from stitchax_torch.utils.precision import fp32_exact

    for path in (SD_REFERENCE, REFERENCE):
        if not os.path.isfile(os.path.join(REPO, path)):
            raise FileNotFoundError(f"{path} is missing: stitchax's outputs")
    with np.load(os.path.join(REPO, SD_REFERENCE)) as d:
        ref = {k.split("/", 1)[1]: d[k] for k in d.files}
    with np.load(os.path.join(REPO, REFERENCE)) as d:
        pair = [d[f"demo1/img{i}"].astype(np.float32) for i in (1, 2)]
    fp32_exact()
    models = build_models(torch.float32, "cuda", DIFFUSION)

    ip = StableDiffusionInpainter(models=models.sd_models)
    hole = ref["inpaint_mask"][..., 0] > 0.5
    t0 = time.perf_counter()
    out = ip.inpaint(torch.from_numpy(ref["inpaint_in"]).cuda(),
                     torch.from_numpy(ref["inpaint_mask"]).cuda())
    out = out.cpu().numpy()
    inpaint_s = time.perf_counter() - t0
    res = {"phase": "sd_vs_stitchax", "config": DIFFUSION,
           "dtype": "float32", "reference": SD_REFERENCE,
           "sd_weights": SD_WEIGHTS, "inpaint_hw": list(hole.shape),
           "ddim_steps": ip.denoise_fn.steps, "inpaint_s": inpaint_s,
           "inpaint_outside_moved_px": int(
               (out[~hole] != ref["inpaint_in"][~hole]).sum()),
           "inpaint_hole_psnr_db": _psnr(out[hole],
                                         ref["inpaint_out_hole"][hole])}
    if not np.isfinite(out).all():
        raise RuntimeError("sd_vs_stitchax: the inpainter's output is not "
                           "finite")

    t0 = time.perf_counter()
    got = Stitcher(models, device="cuda", config=DIFFUSION).stitch(*pair)
    res["stitch_s"] = time.perf_counter() - t0
    check_finite(got)
    th, tw = (int(v) for v in ref["true_hw"])
    if [int(v) for v in got["true_hw"]] != [th, tw]:
        emit(res)
        raise RuntimeError(f"sd_vs_stitchax: canvas {got['true_hw']}, "
                           f"stitchax {[th, tw]}")
    files = output_images(got, *pair)
    lm = np.concatenate([np.abs(got[k] - ref[k]).ravel()
                         for k in ("learned_mask1", "learned_mask2")])
    res.update({f"{k}_psnr_db": _psnr(files[k], ref[k])
                for k in ("warp2", "ave_fusion", "composition")})
    res.update(
        canvas_moved_px=float(np.abs(np.concatenate([
            got["canvas_box"][:2] - ref["canvas_origin"],
            got["canvas_hw"] - ref["canvas_hw"]])).max()),
        mask1_moved_px=int((got["mask1"] != ref["mask1"][:th, :tw]).sum()),
        hole_moved_px=int((got["inpaint_area_mask"]
                           != ref["hole_mask"][:th, :tw]).sum()),
        hole_share=float(hole.mean()),
        learned_mask_mean_abs=float(lm.mean()),
        learned_mask_max_abs=float(lm.max()))
    _check(res, SD_STITCHAX_TOL, "sd_vs_stitchax")


def jpeg_phase():
    """The port's JPEG decoder on the card's host: the demo inputs decode
    to the pixels Pillow gave (REFERENCE holds them), the encoder writes
    Pillow's bytes for them, and its files decode back within JPEG's loss.
    ms per decode and per encode (448x384, 4:2:0, quality 75)."""
    import hashlib

    from stitchax_torch.io import jpeg

    dec_ms, enc_ms, loss_db = [], [], []
    with np.load(os.path.join(REPO, REFERENCE)) as ref:
        for name in DEMO_PAIRS:
            for i in (1, 2):
                key = f"{name}/input{i}"
                data = open(os.path.join(REPO, "demo_data", name,
                                         f"input{i}.jpg"), "rb").read()
                t0 = time.perf_counter()
                img = jpeg.decode(data)
                dec_ms.append((time.perf_counter() - t0) * 1e3)
                if not np.array_equal(img, ref[f"{name}/img{i}"]):
                    raise RuntimeError(f"jpeg: {key} decodes to other pixels "
                                       "than Pillow's")
                t0 = time.perf_counter()
                out = jpeg.encode(img)
                enc_ms.append((time.perf_counter() - t0) * 1e3)
                if hashlib.sha256(out).hexdigest() != DEMO_JPEG_SHA256[key]:
                    raise RuntimeError(f"jpeg: the encoding of {key} is not "
                                       "Pillow's")
                loss_db.append(_psnr(jpeg.decode(out), img))
    res = {"phase": "jpeg", "images": len(dec_ms), "hw": [384, 448],
           "decode_ms": dec_ms, "encode_ms": enc_ms,
           "decode_ms_median": float(np.median(dec_ms)),
           "encode_ms_median": float(np.median(enc_ms)),
           "roundtrip_min_psnr_db": min(loss_db),
           "decode_equal": True, "encode_equal": True}
    _check(res, {"roundtrip_min_psnr_db": JPEG_LOSS_DB}, "jpeg")


def _value_path(out, img1, img2):
    """The uint8 image of each file as stitchax's writer forms it with its
    exact-RGB pack (stitcher.py:129-134, pack.py:45-119), written out here
    on its own to hold the port's writer to it."""
    f32 = np.float32
    img = lambda x: np.rint(np.clip(x.astype(f32), 0, 255)).astype(np.uint8)
    quant = lambda m: np.rint(np.clip(m.astype(f32), 0, 1) * f32(255)) / \
        f32(255)
    files = {"input1": img1.astype(np.uint8), "input2": img2.astype(np.uint8)}
    for name, key in (("H_warp", "H_warp"), ("flow_warp", "final_warp"),
                      ("warp1", "output1"), ("warp2", "output2")):
        files[name] = img(out[key])
    for name in ("mask1", "mask2"):
        files[name] = np.where(quant(out[name]) > 0.5, 255, 0).astype(
            np.uint8)[..., 0]
    files["ave_fusion"] = img(out["new_blend_image"])
    if "composition" in out:
        files["composition"] = img(out["composition"])
        for name in ("learned_mask1", "learned_mask2"):
            files[name] = (quant(out[name]) * f32(255.0)).astype(
                np.uint8)[..., 0]
    return files


def _cli_files(stitcher, results):
    """Check each pair's files against its stitch's arrays; returns the
    worst JPEG loss in dB and the per-pair seconds."""
    from stitchax_torch.io import jpeg
    from stitchax_torch.run.stitcher import output_images

    worst, pairs = float("inf"), {}
    for (data_dict, result_path), (rp, out, err, t) in results:
        if err is not None:
            raise RuntimeError(f"cli: {rp} failed: {err!r}")
        img1, img2 = stitcher.load_pair(data_dict)
        files = output_images(out, img1, img2)
        want = _value_path(out, img1, img2)
        if list(files) != list(want):
            raise RuntimeError(f"cli: files {list(files)}, expected "
                               f"{list(want)}")
        th, tw = (int(v) for v in out["true_hw"])
        shapes = {"input1": img1.shape[:2], "input2": img2.shape[:2]}
        if "composition" in out:       # at the canvas, or upsized
            shapes.update(dict.fromkeys(
                ("composition", "learned_mask1", "learned_mask2"),
                out["composition"].shape[:2]))
        for name, a in files.items():
            if not np.array_equal(a, want[name]):
                raise RuntimeError(f"cli: {rp}/{name}: the writer's uint8 "
                                   "image is not stitchax's value path")
            data = open(os.path.join(rp, name + ".jpg"), "rb").read()
            if data != jpeg.encode(a):
                raise RuntimeError(f"cli: {rp}/{name}.jpg does not hold the "
                                   "writer's image")
            got = jpeg.decode(data)
            if got.shape[:2] != tuple(shapes.get(name, (th, tw))):
                raise RuntimeError(f"cli: {rp}/{name}.jpg is {got.shape}, "
                                   f"expected {shapes.get(name, (th, tw))}")
            worst = min(worst, _psnr(got, a))
        pairs[os.path.basename(rp)] = {**t, "true_hw": [th, tw]}
    return worst, pairs


def cli_phase():
    """The stitch CLI over demo_data/ on the card, into a temporary result
    directory: fast_cv_g8 in bf16 (stitchax's precision), the default
    configuration in fp32 and the diffusion configuration in bf16 (its SD
    in fp32), each through `out.setup` and the sweep that `python -m
    stitchax_torch.out` runs (kernel launches counted over the sweep), and
    the default configuration once more as the command itself in a child
    process, in bf16."""
    import shutil
    import tempfile

    import torch

    from stitchax_torch import out as cli
    from stitchax_torch.ops.kernels import library

    demo = os.path.join(REPO, "demo_data")
    tmp = tempfile.mkdtemp(prefix="stitchax_cli_")
    res = {"phase": "cli", "data_root_path": "demo_data/", "configs": {}}
    try:
        for config, fp32 in ((FAST, False), (DEFAULT, True), (COMP, True),
                             (DIFFUSION, False)):
            argv = ["--inf_cfg", config, "--data_root_path", demo,
                    "--ckpt_path", CKPT, "--result_dir", tmp]
            if config == DEFAULT:
                argv += ["--transref_ckpt", TRANSREF_CKPT]
            if config == DIFFUSION:
                argv += ["--sd_ckpt", SD_CKPT]
            if fp32:
                argv.append("--fp32")
            t0 = time.perf_counter()
            save_root, logger, stitcher, jobs = cli.setup(cli.get_args(argv))
            setup_s = time.perf_counter() - t0
            library.reset_launches()
            t0 = time.perf_counter()
            results = list(stitcher.stitch_and_save_many(jobs))
            sweep_s = time.perf_counter() - t0
            launches = dict(library.launches)
            logger.close()
            want = {k: n * len(jobs)
                    for k, n in EXPECT_LAUNCHES[config].items()}
            if (any(launches[k] != n for k, n in want.items())
                    or launches["tps_grid"] < len(jobs)):
                raise RuntimeError(f"cli {config}: kernel launches "
                                   f"{launches} over {len(jobs)} pairs, "
                                   f"expected {want} and tps_grid >= 1 "
                                   "per pair")
            worst_db, pairs = _cli_files(stitcher, list(zip(jobs, results)))
            entry = {"dtype": "float32" if fp32 else "bfloat16",
                     "result_dir": os.path.basename(save_root),
                     "setup_s": setup_s, "sweep_s": sweep_s,
                     "s_per_pair": sweep_s / len(jobs), "pairs": pairs,
                     "launches": launches, "jpeg_psnr_db_min": worst_db}
            if worst_db < JPEG_LOSS_DB:
                raise RuntimeError(f"cli {config}: a file decodes "
                                   f"{worst_db} dB from its image")
            if config in (DEFAULT, COMP):
                entry["vs_stitchax"] = _cli_default_vs_stitchax(
                    dict(zip([os.path.basename(r[0]) for r in results],
                             [r[1] for r in results]))["demo1"],
                    stitcher.load_pair(jobs[0][0]), config)
            res["configs"][config] = entry
            del stitcher
            torch.cuda.empty_cache()
        # the command a user runs: the default configuration in bf16
        cwd = os.path.join(tmp, "cmd")
        os.makedirs(cwd)
        env = dict(os.environ, PYTHONPATH=REPO)
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "stitchax_torch.out", "--data_root_path",
             demo, "--ckpt_path", CKPT, "--transref_ckpt", TRANSREF_CKPT,
             "--result_dir", "out"], cwd=cwd, env=env, capture_output=True,
            text=True, timeout=600)
        cmd_s = time.perf_counter() - t0
        root = os.path.join(cwd, "out",
                            f"{DEFAULT}_g12x12_stitchax")
        listing = {p: sorted(os.listdir(os.path.join(root, p)))
                   for p in DEMO_PAIRS if os.path.isdir(os.path.join(root, p))}
        want = sorted(f + ".jpg" for f in
                      ("input1", "input2", "H_warp", "flow_warp", "warp1",
                       "warp2", "mask1", "mask2", "ave_fusion",
                       "composition", "learned_mask1", "learned_mask2"))
        res["command"] = {"rc": run.returncode, "s": cmd_s,
                          "files_per_pair": {p: len(v)
                                             for p, v in listing.items()},
                          "stderr_tail": run.stderr[-600:]}
        if (run.returncode != 0 or sorted(listing) != list(DEMO_PAIRS)
                or any(v != want for v in listing.values())
                or not os.path.isfile(os.path.join(root, "config.txt"))):
            emit(res)
            raise RuntimeError("cli: python -m stitchax_torch.out failed or "
                               "wrote other files")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["ok"] = True
    emit(res)


def _cli_default_vs_stitchax(out, pair, config=DEFAULT):
    """A composition configuration's demo1 arrays (fp32, card) against
    stitchax's committed ones (the default configuration's in REFERENCE,
    fast_cv_g8_comp's in COMP_REFERENCE), within CLI_DEFAULT_TOL."""
    from stitchax_torch.run.stitcher import output_images

    prefix = f"{config}/demo1/"
    path = REFERENCE if config == DEFAULT else COMP_REFERENCE
    with np.load(os.path.join(REPO, path)) as data:
        ref = {k[len(prefix):]: data[k] for k in data.files
               if k.startswith(prefix)}
    th, tw = (int(v) for v in ref["true_hw"])
    if [int(v) for v in out["true_hw"]] != [th, tw]:
        raise RuntimeError(f"cli default: canvas {out['true_hw']}, stitchax "
                           f"{[th, tw]}")
    files = output_images(out, *pair)
    r = {k + "_psnr_db": _psnr(files[k], ref[k])
         for k in ("warp2", "ave_fusion", "composition")}
    lm = np.concatenate([np.abs(out[k] - ref[k]).ravel()
                         for k in ("learned_mask1", "learned_mask2")])
    r.update(learned_mask_mean_abs=float(lm.mean()),
             learned_mask_max_abs=float(lm.max()),
             mask1_moved_px=int((out["mask1"] != ref["mask1"][:th, :tw]).sum()))
    misses = [k for k, t in CLI_DEFAULT_TOL.items()
              if (r[k] < t if k.endswith("_db") else r[k] > t)]
    r["tol"], r["ok"] = CLI_DEFAULT_TOL, not misses
    if misses:
        emit({"phase": "cli", "config": config, "vs_stitchax": r})
        raise RuntimeError(f"cli {config} vs stitchax: outside tolerance: "
                           f"{misses}")
    return r


def evaluate_phase():
    """`validate_with_model` on the committed 12-pair split, batch 12, fp32
    nets (TF32 off) on the card, against stitchax's committed evaluation
    (EVAL_REFERENCE). Kernel launches counted over the evaluation; ms per
    batch of the alignment forward, warm; peak memory; the host's read
    (decode + resize) per image. Returns (the report, the per-pair
    results)."""
    import torch

    from stitchax_torch.align.adapter import AlignConfig
    from stitchax_torch.data.udis import PrefetchLoader, UDISDataset
    from stitchax_torch.evaluate import (load_models, make_eval_step,
                                         validate_with_model)
    from stitchax_torch.ops.kernels import library

    models = load_models(CKPT, "cuda")
    ds = UDISDataset(os.path.join(REPO, SYNTH), phase="testing",
                     size=(512, 512))
    t0 = time.perf_counter()
    for i in range(len(ds)):
        ds[i]
    read_ms = (time.perf_counter() - t0) * 1e3 / (2 * len(ds))
    align_cfg = AlignConfig()
    step = make_eval_step(models, align_cfg)
    outs, times = [], []

    def recording_step(a, b):
        torch.cuda.synchronize()
        t = time.perf_counter()
        w, v = step(a, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        outs.append((w.cpu().numpy(), v.cpu().numpy(), a, b))
        return w, v

    per_pair = []
    library.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = validate_with_model({}, PrefetchLoader(
        ds, batch_size=EVAL_BATCH, num_workers=12), models, align_cfg,
        eval_step=recording_step, per_pair=per_pair)
    total_s = time.perf_counter() - t0
    launches = dict(library.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_batches = len(outs)
    want = {k: n * n_batches for k, n in EXPECT_EVAL_LAUNCHES.items()}
    if launches != want:
        raise RuntimeError(f"evaluate: kernel launches {launches}, expected "
                           f"{want}")
    a, b = outs[0][2], outs[0][3]
    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(a, b)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t) * 1e3)
    warped = np.concatenate([np.clip(w, 0, 255).astype(np.uint8)
                             for w, _, _, _ in outs])
    valid = np.concatenate([v.astype(np.uint8) for _, v, _, _ in outs])
    res = {"phase": "evaluate", "pairs": len(per_pair), "batch": EVAL_BATCH,
           "dtype": "float32", "image_size": [512, 512],
           "reference": EVAL_REFERENCE, "report": report,
           "first_batch_ms": times[0], "warm_batch_ms": warm,
           "pairs_per_s_warm": EVAL_BATCH / (min(warm) / 1e3),
           "total_s": total_s, "read_ms_per_image": read_ms,
           "peak_mem_gib": peak, "launches_per_batch": {
               k: n / n_batches for k, n in launches.items()}}
    if (sorted(report) != sorted(EVAL_REPORT_KEYS)
            or report["num_pairs"] != len(ds)):
        emit(res)
        raise RuntimeError("evaluate: the report's structure is not "
                           "stitchax's")
    res.update(_eval_vs_stitchax(per_pair, report, warped, valid))
    res["per_pair"] = [list(p) for p in per_pair]
    _check(res, EVAL_STITCHAX_TOL, "evaluate")
    return report, per_pair


def _eval_vs_stitchax(per_pair, report, warped, valid):
    """The worst differences from stitchax's evaluation (EVAL_REFERENCE)."""
    with np.load(os.path.join(REPO, EVAL_REFERENCE)) as ref:
        names = [str(n) for n in ref["names"]]
        if [p[0] for p in per_pair] != names:
            raise RuntimeError("evaluate: other pairs than stitchax's")
        got_p = np.array([p[1] for p in per_pair])
        got_s = np.array([p[2] for p in per_pair])
        res = {"psnr_abs_diff": float(np.abs(got_p - ref["psnr"]).max()),
               "ssim_abs_diff": float(np.abs(got_s - ref["ssim"]).max()),
               "report_psnr_abs_diff": max(
                   abs(report[k] - float(ref[f"report/{k}"]))
                   for k in EVAL_REPORT_KEYS if "psnr" in k),
               "report_ssim_abs_diff": max(
                   abs(report[k] - float(ref[f"report/{k}"]))
                   for k in EVAL_REPORT_KEYS if "ssim" in k)}
        moved = level = 0.0
        for key in ref.files:
            if not key.startswith("valid/"):
                continue
            i = int(key.split("/")[1])
            v, w = ref[key], ref[f"warped/{i}"]
            both = ((valid[i] == 1) & (v == 1))[..., 0]
            moved = max(moved, float(np.mean(valid[i] != v)))
            d = np.abs(warped[i].astype(int) - w.astype(int))
            level = max(level, float(d[both].mean()))
    res.update(valid_moved_share=moved, warped_mean_level=level)
    return res


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile_phase(img1, img2, trace_path=None, config=FAST) -> None:
    """One warm bf16 stitch of the configuration under torch.profiler, or
    with config "evaluate" one warm batch of the evaluation (the committed
    split's 12 pairs at 512^2, fp32 nets), with config "train" one warm
    fp32 train step (512^2, batch 1, TF32 off), with config
    "transref_train" one warm fp32 TransRef train step (512^2, batch 4),
    or with config "sd_train" one warm fp32 diffusion step of the SD
    trainer (128^2, batch 8)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if config == "train":
        run = profile_train_step()
    elif config == "transref_train":
        run = profile_transref_train_step()
    elif config == "sd_train":
        run = profile_sd_train_step()
    elif config == "evaluate":
        from stitchax_torch.align.adapter import AlignConfig
        from stitchax_torch.data.udis import PrefetchLoader, UDISDataset
        from stitchax_torch.evaluate import load_models, make_eval_step

        step = make_eval_step(load_models(CKPT, "cuda"), AlignConfig())
        batch = next(iter(PrefetchLoader(
            UDISDataset(os.path.join(REPO, SYNTH), phase="testing",
                        size=(512, 512)), batch_size=EVAL_BATCH)))
        a, b = (torch.from_numpy(batch[k]).cuda()
                for k in ("image1", "image2"))
        run = lambda timings: step(a, b)
    else:
        from stitchax_torch.run.stitcher import Stitcher

        stitcher = Stitcher(build_models(torch.bfloat16, "cuda", config),
                            device="cuda", config=config)
        run = lambda timings: stitcher.stitch(img1, img2, timings=timings)
    run({})                                              # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        timings = {}
        run(timings)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in dev])

    def self_device_us(a):
        return getattr(a, "self_device_time_total",
                       getattr(a, "self_cuda_time_total", 0.0))

    top = sorted(prof.key_averages(), key=lambda a: -self_device_us(a))[:25]
    # the operators, with their input shapes, that own the most device time
    ops = sorted((a for a in prof.key_averages(group_by_input_shape=True)
                  if a.key.startswith("aten::")),
                 key=lambda a: -self_device_us(a))
    top_ops = [{"name": a.key, "shapes": str(a.input_shapes)[:200],
                "count": a.count, "ms": self_device_us(a) / 1e3}
               for a in ops[:10]]
    emit({"phase": "profile", "config": config, "weights": WEIGHTS,
          "wall_ms": wall_us / 1e3,
          **timings, "device_events": len(dev),
          "device_busy_ms": busy / 1e3 if dev else None,
          "device_busy_share": busy / wall_us if dev else None,
          "top_self_device_ms": [
              {"name": a.key[:120], "count": a.count,
               "ms": self_device_us(a) / 1e3} for a in top],
          "top_ops_device_ms": top_ops})
    if trace_path:
        prof.export_chrome_trace(trace_path)


def _seeded_init(net, g) -> None:
    """Weights ~ N(0, 1 / fan_in), biases ~ 0.02 N, norm scales 1, drawn
    from the generator `g` on the card."""
    import torch

    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.dim() > 1:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=g)
            elif name.endswith("weight"):         # GroupNorm / LayerNorm
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=g)


def sd15_widths_phase():
    """The port's UNet, ControlNet and VAE at stitchax's UNetConfig() and
    AutoencoderKL() defaults (the SD-1.5 inpainting widths, with the third
    attention level the committed checkpoint does not have), seeded
    weights, fp32 with TF32 off: make_sd_inpaint_fn with 3 DDIM steps on a
    512x768 canvas with a hole (VAE encode, the steps, VAE decode), timed
    warm; one step and the VAE's parts alone; peak memory; finite."""
    import torch

    from stitchax_torch.models.diffusion import (ControlNet, UNet2DCondition,
                                                 UNetConfig)
    from stitchax_torch.models.sd_pipeline import SDModels, make_sd_inpaint_fn
    from stitchax_torch.models.vae import AutoencoderKL
    from stitchax_torch.utils.precision import fp32_exact

    fp32_exact()
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(SEED)
    cfg = UNetConfig()
    t0 = time.perf_counter()
    with torch.device(dev):
        nets = [UNet2DCondition(cfg), ControlNet(cfg), AutoencoderKL()]
    for n in nets:
        _seeded_init(n, g)
    sd = SDModels(*nets, torch.randn(1, 77, cfg.context_dim, device=dev,
                                     generator=g)).to(dev)
    build_s = time.perf_counter() - t0
    H, W = 512, 768
    img = torch.rand(H, W, 3, device=dev, generator=g) * 255.0
    mask = torch.zeros(H, W, 1, device=dev)
    mask[160:352, 256:512] = 1.0
    fn = make_sd_inpaint_fn(sd, num_steps=3, seed=SEED, strength=1.0)
    out = fn(img, mask)                                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(img, mask)
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    keep = mask[..., 0] < 0.5
    res = {"phase": "sd15_widths", "dtype": "float32", "tf32": False,
           "unet": {"block_channels": list(cfg.block_channels),
                    "layers_per_block": cfg.layers_per_block,
                    "attention_resolutions": list(cfg.attention_resolutions),
                    "context_dim": cfg.context_dim,
                    "num_heads": cfg.num_heads},
           "vae_block_channels": list(nets[2].encoder.block_channels),
           "params_m": {k: sum(p.numel() for p in n.parameters()) / 1e6
                        for k, n in zip(("unet", "controlnet", "vae"),
                                        nets)},
           "weights": "seeded (torch.Generator), not trained",
           "canvas_hw": [H, W], "latent_hw": [H // 8, W // 8],
           "ddim_steps": fn.steps, "build_s": build_s,
           "inpaint_ms": total_ms, **sd_part_ms(sd, H, W, iters=3),
           "peak_mem_gib": peak,
           "finite": bool(torch.isfinite(out).all().item()),
           "outside_hole_kept": bool(torch.equal(out[keep], img[keep]))}
    emit(res)
    if not (res["finite"] and res["outside_hole_kept"]):
        raise RuntimeError("sd15_widths: the output is not finite or the "
                           "pixels outside the hole moved")


# ------------------------------- training ------------------------------------

TRAIN_REFERENCE = "tests/torch_reference/train_stitchax_fp32.npz"
TRAIN_SIZE = 512
# kernel calls of one train step (512^2, batch 1, fp32), per FlowFormer++
# call (B, N, C, heads, calls): the context encoder (img1) and the feature
# encoder (img1, img2), stages 1 and 2, and the cost perceiver's three
# vertical blocks over 8 latents. A step calls FlowFormer++ twice: forward
# under autograd, then backward under no_grad for the occlusion mask
TRAIN_GSA_CALLS = [(1, 128 * 128, 128, 4, 3), (1, 64 * 64, 256, 8, 3),
                   (8, 64 * 64, 128, 8, 3)]
TRAIN_WINDOW_CALLS = [(1, 128, 128, 128, 4, True, 3),
                      (1, 64, 64, 256, 8, True, 3),
                      (8, 64, 64, 128, 8, False, 3)]
TRAIN_COST_P = 64 * 64
FLOW_CALLS_PER_STEP = 2
EXPECT_TRAIN_LAUNCHES = {"gsa_attention": 18, "cost_lookup": 24,
                         "window_attention": 18, "tps_grid": 0}
# of those, the forward under autograd's (the kernels' autograd Functions,
# library.grad_launches): the calls of the tables above, once each. The
# per-step forward / backward ms are weighted by these tables, so the step
# fails unless its counted launches under grad equal their sums
EXPECT_TRAIN_GRAD_LAUNCHES = {
    "gsa_attention": sum(c[-1] for c in TRAIN_GSA_CALLS),
    "cost_lookup": DECODER_ITERS,
    "window_attention": sum(c[-1] for c in TRAIN_WINDOW_CALLS),
    "tps_grid": 0}
# the autograd Function's gradients against the plain version's autograd
# on the same inputs: both differentiate the plain version at the same
# saved inputs, so they differ only by the order of atomic adds (K3's
# scatter of the cost maps' gradient), relative to the largest |gradient|
# (an H100 read 0: equal)
TRAIN_GRAD_TOL = 1e-5
# one fp32 train step (TF32 off) on the card against stitchax's jitted step
# on the CPU (TRAIN_REFERENCE, the same pair and weights); see PERF.md
# section 2 for the readings these hold with ~10x headroom
TRAIN_STITCHAX_TOL = {
    "loss_rel": 3e-5,          # total, photometric, rigid, border: 2.1e-6
    "grad_norm_rel": 5e-3,     # the raw gradients' global norm: 6.8e-4
    "leaf_norm_rel": 2e-2,     # each leaf's gradient norm, floored: 1.3e-3
    "leaf_l2_rel_homo": 2e-2,  # the kept leaves' whole gradients: 1.1e-3
    "leaf_l2_rel_flow": 1e-2,  # 9.9e-4
    # after the update, in units of lr0 (AdamW's first step is ~lr0 sign(g)
    # but where |g| is near eps): the worst element, 0.011 (0.179 on the
    # CPU), and the share off by more than 0.01 lr0, 1.0% (0.6% on the CPU)
    "updated_lr0": 0.5,
    "updated_off_share": 0.1,
}
# --resume from step 2 to 4 against the run that did not stop, and --remat's
# first loss against the plain run's: the card's atomics and convolution
# algorithms make two runs of one step differ by float rounding. After the
# update an element differs by up to a few learning rates (~1.3e-7 at
# these steps) where its gradient is near AdamW's eps, i.e. up to ~1e-3
# of the 1e-3 floor of a tensor's scale (H100 readings 1.7e-5 to 1.8e-4;
# the losses equal to 1.1e-6)
TRAIN_RESUME_TOL = {"param_max_rel": 5e-3, "loss_rel": 1e-4}


def _train_models(device="cuda"):
    """The shipped FlowFormer++ (upsample_all) and homography net at 512^2
    from the trained npz, on the card: (the npz's tree, the train state,
    the train step, (homo, flow))."""
    from stitchax_torch import convert
    from stitchax_torch.align.adapter import AlignConfig
    from stitchax_torch.models.flowformer import FlowFormer, FlowFormerConfig
    from stitchax_torch.models.udis2 import UDIS2HomographyNet
    from stitchax_torch.train import (LossConfig, OptimConfig,
                                      create_train_state, make_train_step)

    tree = convert.load_npz(CKPT)
    homo = convert.load_jax_params(UDIS2HomographyNet(TRAIN_SIZE),
                                   tree["homo"]).to(device)
    flow = convert.load_jax_params(FlowFormer(FlowFormerConfig(
        upsample_all=True)), tree["flow"]).to(device)
    state, tx = create_train_state({"homo": homo, "flow": flow},
                                   OptimConfig())
    step = make_train_step(homo, flow, tx, AlignConfig(), LossConfig())
    return tree, state, step, (homo, flow)


def _train_pair(device="cuda"):
    """The first committed synthetic pair at 512^2, as the loader reads it."""
    import torch

    from stitchax_torch.data.udis import UDISDataset

    item = UDISDataset(os.path.join(REPO, SYNTH), phase="testing",
                       size=(TRAIN_SIZE, TRAIN_SIZE))[0]
    return (item["name"], item["image1"], item["image2"],
            *(torch.from_numpy(item[k][None]).to(device)
              for k in ("image1", "image2")))


def _grad_check(fn, plain, leaves, g_out):
    """(max |out - plain out|, max relative |grad - plain grad| over the
    leaves) for the kernel wrapper `fn` and the plain version, both under
    autograd on the same leaves and upstream gradient."""
    import torch

    out = fn()
    grads = torch.autograd.grad(out, leaves, g_out)
    ref = plain()
    ref_grads = torch.autograd.grad(ref, leaves, g_out)
    e_out = (out - ref).abs().max().item()
    e_grad = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                 for a, b in zip(grads, ref_grads))
    return e_out, e_grad, out


def _fwd_bwd_ms(fn, leaves, g_out, iters=5):
    """(forward ms under autograd, backward ms) by CUDA events."""
    import torch

    fwd = cuda_time(fn, iters=iters, warmup=2)
    out = fn()
    bwd = cuda_time(lambda: torch.autograd.grad(out, leaves, g_out,
                                                retain_graph=True),
                    iters=iters, warmup=2)
    return fwd, bwd


def train_kernel_rows(launches, grad_launches):
    """K1, K3 and K4 inside autograd at the train step's shapes (fp32): the
    autograd Function's output and every input gradient against the plain
    version's autograd on the card for a seeded upstream gradient, and
    forward / backward ms by events, per call and summed over a step by
    the shape tables' calls; `launches` / `grad_launches` are one step's
    counted launches (all / under grad, from `train_vs_stitchax`)."""
    import torch

    from stitchax_torch.ops.kernels import (cost_lookup, gsa_attention,
                                            window_attention as wa)

    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows, detail = {}, []

    def add(name, entry, calls):
        r = rows.setdefault(name, {
            "launches_per_step": launches[name],
            "forward_launches_under_grad": grad_launches[name],
            "forward_ms": 0.0, "forward_device_ms": 0.0, "backward_ms": 0.0,
            "plain_forward_ms": 0.0, "plain_backward_ms": 0.0,
            "forward_bound_ms": 0.0,
            "library_forward_device_ms": 0.0,
            "library_forward_backward_device_ms": 0.0,
            "forward_bound_by": {}, "max_abs_err": 0.0,
            "max_grad_rel_err": 0.0,
            "backward": "the plain version differentiated (autograd), "
                        "as stitchax's"})
        for k in ("forward_ms", "forward_device_ms", "backward_ms",
                  "plain_forward_ms", "plain_backward_ms", "forward_bound_ms",
                  "library_forward_device_ms",
                  "library_forward_backward_device_ms"):
            r[k] += calls * entry[k]
        if "forward_fp32_core_bound_ms" in entry:
            r["forward_fp32_core_bound_ms"] = (
                r.get("forward_fp32_core_bound_ms", 0.0)
                + calls * entry["forward_fp32_core_bound_ms"])
        by = r["forward_bound_by"]
        by[entry["forward_bound_by"]] = by.get(
            entry["forward_bound_by"], 0.0) + calls * entry["forward_bound_ms"]
        r["max_abs_err"] = max(r["max_abs_err"], entry["max_abs_err"])
        r["max_grad_rel_err"] = max(r["max_grad_rel_err"],
                                    entry["max_grad_rel_err"])
        detail.append({**entry, "calls_under_grad": calls})

    def leaf(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=g) * scale
                ).requires_grad_(True)

    def library(call, leaves, g_out):
        """The library call's device ms: forward, and forward + backward
        (its autograd) to the same leaves."""
        return {"library_forward_device_ms": device_ms(call, iters=5),
                "library_forward_backward_device_ms": device_ms(
                    lambda: torch.autograd.grad(call(), leaves, g_out),
                    iters=5)}

    for B, N, C, heads, calls in TRAIN_GSA_CALLS:
        q, k, v = leaf(B, N, C), leaf(B, GSA_KEYS, C), leaf(B, GSA_KEYS, C)
        g_out = torch.randn(B, N, C, device=dev, generator=g)
        fn = lambda: gsa_attention.gsa_attention(q, k, v, heads=heads)
        plain = lambda: gsa_attention.gsa_attention_plain(q, k, v,
                                                          heads=heads)
        e, eg, _ = _grad_check(fn, plain, (q, k, v), g_out)
        f, b = _fwd_bwd_ms(fn, (q, k, v), g_out)
        pf, pb = _fwd_bwd_ms(plain, (q, k, v), g_out, iters=3)
        d = C // heads
        heads_of = lambda t: t.view(B, -1, heads, d).transpose(1, 2)
        sdpa = lambda: F.scaled_dot_product_attention(
            heads_of(q), heads_of(k), heads_of(v)).transpose(1, 2).reshape(
                B, N, C)
        bound = fp32_attention_bound(
            4 * (2 * B * N * C + 2 * B * GSA_KEYS * C),
            4.0 * B * N * GSA_KEYS * C, B * N * GSA_KEYS * heads)
        add("gsa_attention", {
            "kernel": "gsa_attention", "B": B, "N": N, "C": C,
            "heads": heads, "dtype": "float32", "max_abs_err": e,
            "tol": TOL["gsa_attention_fp32"], "max_grad_rel_err": eg,
            "grad_tol": TRAIN_GRAD_TOL, "forward_ms": f,
            "forward_device_ms": device_ms(fn, iters=5), "backward_ms": b,
            "plain_forward_ms": pf, "plain_backward_ms": pb,
            "forward_bound_ms": bound["bound_ms"],
            "forward_bound_by": bound["bound_by"],
            "forward_bound_unit": bound["bound_unit"],
            "forward_fp32_core_bound_ms": bound["fp32_core_bound_ms"],
            "library": "F.scaled_dot_product_attention, fp32",
            **library(sdpa, (q, k, v), g_out)}, calls)
        del q, k, v, g_out

    cm = leaf(TRAIN_COST_P, COST_HW, COST_HW)
    coords = (torch.rand(TRAIN_COST_P, 2, device=dev, generator=g)
              * (COST_HW + 12) - 6).requires_grad_(True)
    win = 2 * COST_R + 1
    g_out = torch.randn(TRAIN_COST_P, win * win, device=dev, generator=g)
    fn = lambda: cost_lookup.cost_lookup(cm, coords, COST_R)
    plain = lambda: cost_lookup.cost_lookup_plain(cm, coords, COST_R)
    e, eg, _ = _grad_check(fn, plain, (cm, coords), g_out)
    # the decoder detaches the coordinates: the step's backward is the
    # cost maps' gradient alone
    f, b = _fwd_bwd_ms(lambda: cost_lookup.cost_lookup(
        cm, coords.detach(), COST_R), (cm,), g_out)
    pf, pb = _fwd_bwd_ms(lambda: cost_lookup.cost_lookup_plain(
        cm, coords.detach(), COST_R), (cm,), g_out, iters=3)
    # the forward's bound and F.grid_sample's yardstick as for the
    # evaluation's rows, at this P
    c = coords.detach()
    off = torch.arange(-COST_R, COST_R + 1, device=dev, dtype=torch.float32)
    gx = (c[:, 0, None, None] + off[:, None]).expand(-1, -1, win)
    gy = (c[:, 1, None, None] + off[None, :]).expand(-1, win, -1)
    grid = torch.stack([gx, gy], -1) * (2.0 / (COST_HW - 1)) - 1.0
    sample = lambda: F.grid_sample(
        cm[:, None], grid, mode="bilinear", padding_mode="zeros",
        align_corners=True).reshape(TRAIN_COST_P, win * win)
    steps = torch.arange(2 * COST_R + 2, device=dev)
    f0 = torch.floor(c).long() - COST_R
    inb = [((f0[:, i:i + 1] + steps >= 0) & (f0[:, i:i + 1] + steps < COST_HW)
            ).sum(1) for i in (0, 1)]
    touched = float((inb[0] * inb[1]).sum().item())
    fb, fby = bound_ms(touched * 4 + TRAIN_COST_P * 2 * 4
                       + TRAIN_COST_P * win * win * 4,
                       TRAIN_COST_P * (3 * win * (win + 1) + 3 * win * win),
                       PEAK["fp32"])
    add("cost_lookup", {
        "kernel": "cost_lookup", "P": TRAIN_COST_P, "H2": COST_HW,
        "W2": COST_HW, "r": COST_R, "dtype": "float32", "max_abs_err": e,
        "tol": TOL["cost_lookup"], "max_grad_rel_err": eg,
        "grad_tol": TRAIN_GRAD_TOL, "forward_ms": f,
        "forward_device_ms": device_ms(lambda: cost_lookup.cost_lookup(
            cm, coords.detach(), COST_R), iters=5),
        "backward_ms": b, "plain_forward_ms": pf, "plain_backward_ms": pb,
        "forward_bound_ms": fb, "forward_bound_by": fby,
        "library": "F.grid_sample, fp32, gradient to the cost maps",
        **library(sample, (cm,), g_out)}, DECODER_ITERS)
    del cm, coords, g_out, grid

    ws = WINDOW_WS
    for B, H, W, C, heads, fused, calls in TRAIN_WINDOW_CALLS:
        T = ws * ws
        if fused:       # leaves: the fused qkv product and its bias
            qkv, bias = leaf(B, H, W, 3 * C), leaf(3 * C, scale=0.3)
            leaves = (qkv, bias)

            def args():
                qx, kx, vx = qkv.split(C, -1)
                qb, kb, vb = bias.split(C)
                return qx, kx, vx, qb.expand(T, C), kb.expand(T, C), vb[None]
        else:
            leaves = (leaf(B, H, W, C), leaf(B, H, W, C), leaf(B, H, W, C),
                      leaf(T, C, scale=0.3), leaf(T, C, scale=0.3),
                      leaf(1, C, scale=0.3))
            args = lambda: leaves
        g_out = torch.randn(B, H, W, C, device=dev, generator=g)
        fn = lambda: wa.window_attention(*args(), heads=heads, ws=ws)
        plain = lambda: wa.window_attention_plain(*args(), heads=heads,
                                                  ws=ws)
        e, eg, _ = _grad_check(fn, plain, leaves, g_out)
        f, b = _fwd_bwd_ms(fn, leaves, g_out)
        pf, pb = _fwd_bwd_ms(plain, leaves, g_out, iters=3)
        d = C // heads
        with torch.no_grad():
            n_win = wa.biased_windows(*args(), ws)[0].shape[:2].numel()

        def sdpa():
            # SDPA on the partitioned, biased windows; its output stays
            # windowed, so the upstream gradient is the windows' sum
            q, k, v = (t.reshape(-1, T, heads, d).transpose(1, 2)
                       for t in wa.biased_windows(*args(), ws))
            return F.scaled_dot_product_attention(q, k, v).sum()

        bound = fp32_attention_bound(
            4 * (4 * B * H * W * C + 2 * T * C + C),
            4.0 * n_win * T * T * C, n_win * T * T * heads)
        add("window_attention", {
            "kernel": "window_attention", "B": B, "H": H, "W": W, "C": C,
            "heads": heads, "fused_qkv": fused, "dtype": "float32",
            "max_abs_err": e, "tol": TOL["window_attention_fp32"],
            "max_grad_rel_err": eg, "grad_tol": TRAIN_GRAD_TOL,
            "forward_ms": f, "forward_device_ms": device_ms(fn, iters=5),
            "backward_ms": b, "plain_forward_ms": pf,
            "plain_backward_ms": pb, "forward_bound_ms": bound["bound_ms"],
            "forward_bound_by": bound["bound_by"],
            "forward_bound_unit": bound["bound_unit"],
            "forward_fp32_core_bound_ms": bound["fp32_core_bound_ms"],
            "library": "F.scaled_dot_product_attention on the biased "
                       "windows, fp32 (partition and bias included)",
            **library(sdpa, leaves, None)}, calls)
        del leaves, g_out
    for r in rows.values():
        by = r["forward_bound_by"]
        r["forward_bound_by"] = max(by, key=by.get)
    torch.cuda.empty_cache()
    return rows, detail


def kernels_backward_phase(smi, launches, grad_launches):
    rows, detail = train_kernel_rows(launches, grad_launches)
    bad = sorted({d["kernel"] for d in detail
                  if not (d["max_abs_err"] <= d["tol"]
                          and d["max_grad_rel_err"] <= d["grad_tol"])})
    emit({"phase": "kernels_backward", "card": smi, "calls": detail,
          "per_step": rows, "ok": not bad})
    if bad:
        raise RuntimeError(f"kernels under autograd disagree with their "
                           f"plain versions' autograd: {bad}")
    return rows


def _flat_stitchax(tree):
    """A {model: stitchax variables} tree -> {stitchax key string: numpy}."""
    from stitchax_torch.convert import _flatten, _keystr

    return {_keystr(p): np.asarray(a, np.float32) for p, a in _flatten(tree)}


def train_vs_stitchax_phase():
    """One fp32 train step (TF32 off) from results/ckpt_r05_bf16.npz on the
    first committed pair at 512^2, against stitchax's jitted step on the
    same input (TRAIN_REFERENCE): losses, grad_norm, every leaf's gradient
    norm (BatchNorm statistics included), the kept leaves' whole gradients
    and their values after the update. Returns the step's launches, all
    and under grad (library.launches, library.grad_launches)."""
    import torch

    from stitchax_torch.ops.kernels import library
    from stitchax_torch.train import stitchax_tree
    from stitchax_torch.utils.precision import fp32_exact

    fp32_exact()
    tree, state, step, nets = _train_models()
    name, i1, i2, a, b = _train_pair()
    with np.load(os.path.join(REPO, TRAIN_REFERENCE)) as f:
        ref = {k: f[k] for k in f.files}
    sums = [int(i1.astype(np.int64).sum()), int(i2.astype(np.int64).sum())]
    if name != str(ref["name"]) or sums != ref["image_sums"].tolist():
        raise RuntimeError(f"train_vs_stitchax: input {name} {sums} is not "
                           f"the reference's {ref['name']} "
                           f"{ref['image_sums'].tolist()}")
    library.reset_launches()
    metrics, grads = step.loss_and_grads(state, a, b)
    torch.cuda.synchronize()
    launches = dict(library.launches)
    grad_launches = dict(library.grad_launches)
    res_masks = _threshold_flips(*nets, a, b, ref)
    state, m2 = step(state, a, b)
    got = {k: float(v) for k, v in metrics.items()}
    got["grad_norm"] = float(m2["grad_norm"])
    grads = _flat_stitchax(stitchax_tree(grads))
    updated = _flat_stitchax(stitchax_tree(state.params))
    start = _flat_stitchax({k: tree[k] for k in ("flow", "homo")})
    res = {"phase": "train_vs_stitchax", "pair": name, "dtype": "float32",
           "tf32": torch.backends.cudnn.allow_tf32,
           "reference": TRAIN_REFERENCE, "metrics": got,
           "stitchax_metrics": {k: float(ref[f"metric/{k}"]) for k in got},
           "launches_per_step": launches,
           "forward_launches_under_grad": grad_launches, "leaves": len(grads),
           **res_masks}
    for k in ("total", "photometric", "rigid", "border"):
        r = float(ref[f"metric/{k}"])
        res[f"{k}_rel"] = abs(got[k] - r) / abs(r)
    res["loss_rel"] = max(res[f"{k}_rel"] for k in
                          ("total", "photometric", "rigid", "border"))
    r = float(ref["metric/grad_norm"])
    res["grad_norm_rel"] = abs(got["grad_norm"] - r) / r
    floor = 1e-6 * r
    keys = [k[len("gradnorm/"):] for k in ref if k.startswith("gradnorm/")]
    if sorted(keys) != sorted(grads):
        raise RuntimeError("train_vs_stitchax: other gradient leaves than "
                           "stitchax's")
    norm_err = {k: abs(float(np.linalg.norm(grads[k]))
                       - float(ref[f"gradnorm/{k}"]))
                / (float(ref[f"gradnorm/{k}"]) + floor) for k in keys}
    worst = max(norm_err, key=norm_err.get)
    res.update(leaf_norm_rel=norm_err[worst], leaf_norm_worst=worst,
               batch_stats_leaves=sum("['batch_stats']" in k for k in keys),
               batch_stats_norm_rel=max(e for k, e in norm_err.items()
                                        if "['batch_stats']" in k))
    kept = [k[len("grad/"):] for k in ref if k.startswith("grad/")]
    for model in ("homo", "flow"):
        res[f"leaf_l2_rel_{model}"] = max(
            float(np.linalg.norm(grads[k] - ref[f"grad/{k}"]))
            / (float(np.linalg.norm(ref[f"grad/{k}"])) + floor)
            for k in kept if k.startswith(f"['{model}']"))
    lr0 = 3.125e-6 / 25
    worst_u, off, n, unmoved = 0.0, 0, 0, []
    for k in kept:
        d = np.abs(updated[k] - ref[f"updated/{k}"])
        worst_u = max(worst_u, float(
            (d - 1e-6 * np.abs(ref[f"updated/{k}"]).max()).max()) / lr0)
        off += int((d > 0.01 * lr0).sum())
        n += d.size
        if not np.any(updated[k] != start[k]):
            unmoved.append(k)
    res.update(updated_lr0=worst_u, updated_off_share=off / n,
               unmoved_leaves=unmoved)
    want = dict(EXPECT_TRAIN_LAUNCHES)
    if launches != want or grad_launches != EXPECT_TRAIN_GRAD_LAUNCHES:
        emit(res)
        raise RuntimeError(f"train_vs_stitchax: launches per step "
                           f"{launches} ({grad_launches} under grad), "
                           f"expected {want} ({EXPECT_TRAIN_GRAD_LAUNCHES})")
    if unmoved:
        emit(res)
        raise RuntimeError(f"train_vs_stitchax: leaves did not move: "
                           f"{unmoved}")
    _check(res, dict(TRAIN_STITCHAX_TOL), "train_vs_stitchax")
    del state, step, grads
    torch.cuda.empty_cache()
    return launches, grad_launches


def _threshold_flips(homo, flow, a, b, ref):
    """Pixels where the step's hard thresholds fell otherwise than in
    stitchax's step (the reference's packed masks): the occlusion mask
    (occ >= 0.5), each prediction's |flow| < max_flow, and the coverage
    support of the homography warp (the interior sampler's edge)."""
    import torch

    from stitchax_torch.align.adapter import AlignConfig
    from stitchax_torch.train import LossConfig, align_train_forward
    from stitchax_torch.train import occlusion_mask

    cfg = AlignConfig()
    with torch.no_grad():
        fwd = align_train_forward(homo, flow, a, b, cfg)
        occ = occlusion_mask(flow, fwd, a, cfg)[0, ..., 0] > 0.5
        valid = torch.stack([(f * f).sum(-1).sqrt() < LossConfig().max_flow
                             for f in fwd["flow_predictions"]])[:, 0]
        cover = fwd["output_H"][0, ..., 3] > 0
    out = {}
    for k, m in (("occ", occ), ("valid_flow", valid), ("cover", cover)):
        m = m.cpu().numpy()
        want = np.unpackbits(ref[f"mask/{k}"])[:m.size].reshape(m.shape)
        out[f"{k}_flipped_px"] = int((m != want.astype(bool)).sum())
        out[f"{k}_px"] = int(m.sum())
    return out


def _metrics_log(ckpt_dir, name="train"):
    with open(os.path.join(ckpt_dir, f"{name}_metrics.jsonl")) as f:
        return {r["step"]: r for r in map(json.loads, f)}


def _run_train_cli(argv):
    """python -m stitchax_torch.train in this process (so the kernels'
    launch counts are read), restoring the signal handlers it sets."""
    import signal

    from stitchax_torch.train.__main__ import main as train_main

    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                  signal.SIGINT)}
    try:
        rc = train_main(argv)
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
    if rc != 0:
        raise RuntimeError(f"train CLI {argv} returned {rc}")


def train_phase():
    """The trainer's CLI on the card: 4 steps from the trained npz on a
    temporary data dir whose training/ is the committed 12-pair split,
    checkpoints every 2 steps into a temporary directory outside the repo;
    then --resume from step 2 to 4 (equal to the run that did not stop),
    --remat for one step (its loss equal to the plain run's first, and its
    peak), final_ckpt.npz stitching a demo pair through
    StitchModels.from_npz, and a warm step's split: forward under autograd,
    the no-grad backward flow call, the backward pass, the update. Returns
    the split."""
    import shutil
    import tempfile

    import torch

    from stitchax_torch.ops.kernels import library
    from stitchax_torch.run.stitcher import StitchModels, Stitcher, load_image

    tmp = tempfile.mkdtemp(prefix="stitchax_torch_train_")
    try:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        os.symlink(os.path.join(REPO, SYNTH, "testing"),
                   os.path.join(data, "training"))
        base = ["--data_dir", data, "--panel_every", "0", "--log_every", "1",
                "--device", "cuda:0", "--init_npz", CKPT, "--num_steps"]
        run_a, run_b, run_c = (os.path.join(tmp, d) for d in "abc")
        library.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _run_train_cli(base + ["4", "--save_every", "2", "--ckpt_dir",
                               run_a])
        run_s = time.perf_counter() - t0
        launches = dict(library.launches)
        grad_launches = dict(library.grad_launches)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log_a = _metrics_log(run_a)
        if sorted(log_a) != [1, 2, 3, 4]:
            raise RuntimeError(f"train: logged steps {sorted(log_a)}")
        keys = ("total", "photometric", "rigid", "border", "grad_norm")
        if not all(math.isfinite(log_a[s][k]) for s in log_a for k in keys):
            raise RuntimeError(f"train: metrics not finite: {log_a}")
        step_s = [log_a[s]["t"] - log_a[s - 1]["t"] for s in (2, 3, 4)]
        want = {k: 4 * v for k, v in EXPECT_TRAIN_LAUNCHES.items()}
        want_grad = {k: 4 * v for k, v in EXPECT_TRAIN_GRAD_LAUNCHES.items()}
        if launches != want or grad_launches != want_grad:
            raise RuntimeError(f"train: launches over 4 steps {launches} "
                               f"({grad_launches} under grad), expected "
                               f"{want} ({want_grad})")
        a4 = torch.load(os.path.join(run_a, "step_00000004.pt"),
                        weights_only=True)
        from stitchax_torch import convert
        tree = convert.load_npz(CKPT)
        init = {f"{k}.{n}": torch.from_numpy(np.ascontiguousarray(v))
                for k in ("flow", "homo")
                for n, v in convert.params_from_jax(tree[k]).items()}
        moved = sum(bool((a4["params"][k] != v).any())
                    for k, v in init.items())

        torch.cuda.reset_peak_memory_stats()
        _run_train_cli(base + ["4", "--save_every", "2", "--ckpt_dir", run_b,
                               "--resume", os.path.join(
                                   run_a, "step_00000002.pt")])
        b4 = torch.load(os.path.join(run_b, "step_00000004.pt"),
                        weights_only=True)
        log_b = _metrics_log(run_b)
        resume_param = max(
            ((b4["params"][k] - p).abs().max()
             / p.abs().max().clamp(min=1e-3)).item()
            for k, p in a4["params"].items())
        resume_loss = max(abs(log_b[s]["total"] - log_a[s]["total"])
                          / abs(log_a[s]["total"]) for s in (3, 4))

        torch.cuda.reset_peak_memory_stats()
        _run_train_cli(base + ["1", "--save_every", "1", "--ckpt_dir", run_c,
                               "--remat"])
        remat_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log_c = _metrics_log(run_c)
        remat_loss = abs(log_c[1]["total"] - log_a[1]["total"]) / abs(
            log_a[1]["total"])

        models = StitchModels.from_npz(os.path.join(run_a, "final_ckpt.npz"),
                                       device="cuda", config=FAST)
        out = Stitcher(models, device="cuda", config=FAST).stitch(
            load_image(os.path.join(REPO, "demo_data", "demo1",
                                    "input1.jpg")),
            load_image(os.path.join(REPO, "demo_data", "demo1",
                                    "input2.jpg")))
        check_finite(out)
        final_bytes = os.path.getsize(os.path.join(run_a, "final_ckpt.npz"))
        ckpt_bytes = os.path.getsize(os.path.join(run_a, "step_00000004.pt"))
        del models, out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    split = train_step_split()
    res = {"phase": "train", "steps": 4, "image_size": TRAIN_SIZE,
           "batch": 1, "dtype": "float32", "weights": WEIGHTS,
           "run_s": run_s, "s_per_step_warm": step_s,
           "metrics": {s: {k: log_a[s][k] for k in keys} for s in log_a},
           "peak_mem_gib": peak, "remat_peak_mem_gib": remat_peak,
           "launches": launches, "grad_launches": grad_launches,
           "tensors_moved": moved,
           "tensors": len(init), "resume_param_max_rel": resume_param,
           "resume_loss_rel": resume_loss, "remat_loss_rel": remat_loss,
           "final_ckpt_mib": final_bytes / 2 ** 20,
           "step_ckpt_mib": ckpt_bytes / 2 ** 20,
           "final_ckpt_stitch": "finite", **split}
    if moved < 0.9 * len(init):
        emit(res)
        raise RuntimeError(f"train: only {moved} of {len(init)} trained "
                           "tensors moved in 4 steps")
    _check(res, {"resume_param_max_rel": TRAIN_RESUME_TOL["param_max_rel"],
                 "resume_loss_rel": TRAIN_RESUME_TOL["loss_rel"],
                 "remat_loss_rel": TRAIN_RESUME_TOL["loss_rel"]}, "train")
    return split


def train_step_split(warm=1, timed=3):
    """ms of a train step's parts, warm, mean of `timed` steps."""
    import torch

    from stitchax_torch.utils.precision import fp32_exact

    fp32_exact()
    _, state, step, nets = _train_models()
    _, _, _, a, b = _train_pair()
    for _ in range(warm):
        state, _ = step(state, a, b)
    timings = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        state, _ = step(state, a, b, timings=timings)
    step_ms = (time.perf_counter() - t0) * 1e3 / timed
    out = {f"split_{k}": v / timed for k, v in timings.items()}
    out["split_step_ms"] = step_ms
    # the no-grad backward flow call as the step makes it (only its last
    # prediction upsampled) and with all 12 upsampled, by CUDA events
    from stitchax_torch.align.adapter import AlignConfig
    from stitchax_torch.train import align_train_forward
    _, flow = nets
    with torch.no_grad():
        fwd = align_train_forward(*nets, a, b, AlignConfig())
        warp = fwd["output_H"][..., 0:3]
        for k, every in (("backward_flow_call_ms", False),
                         ("backward_flow_call_upsample_all_ms", True)):
            out[k] = cuda_time(lambda: flow(warp, a, upsample_all=every),
                               iters=timed, warmup=1, flush=False)
    del state, step, fwd, warp
    torch.cuda.empty_cache()
    return out


def profile_train_step():
    """A function running one warm fp32 train step, for the profiler."""
    from stitchax_torch.utils.precision import fp32_exact

    fp32_exact()
    _, state, step, _ = _train_models()
    _, _, _, a, b = _train_pair()
    state, _ = step(state, a, b)                         # warm-up
    return lambda timings: step(state, a, b, timings=timings)


# ----------------------------- TransRef trainer -----------------------------

TRANSREF_TRAIN_REFERENCE = ("tests/torch_reference/"
                            "transref_train_stitchax_fp32.npz")
TRANSREF_LR = 1e-4
TRANSREF_VGG_SEED = 0
# the TransRef CLI's defaults (train_transref.py): 512^2, batch 4
TRANSREF_TRAIN_BATCH, TRANSREF_TRAIN_STEPS = 4, 3
# the kept leaves of TRANSREF_TRAIN_REFERENCE (its gradients and values
# after Adam)
TRANSREF_KEPT = (
    "['params']['tenc']['block1_0']['attn']['kv']['kernel']",
    "['params']['tenc']['block1_0']['attn']['kv']['bias']",
    "['params']['tenc']['refpa1']['pa']['offset_estimator']['scale']"
    "['kernel']",
    "['params']['tenc']['refpa1']['pa']['offset_estimator']['scale']"
    "['bias']",
    "['params']['clean']['kernel']",
    "['params']['clean']['bias']")
# one fp32 TransRef step (TF32 off) on the card against stitchax's jitted
# step on the CPU (TRANSREF_TRAIN_REFERENCE: the trained TransRef, the
# seeded VGG, the first committed pair at 512^2, stitchax's boxes); see
# PERF.md section 2 for the readings these hold with ~10x headroom. After
# Adam, in units of lr: where stitchax's |g| > 1e-6 (100 eps) the first
# step is ~lr sign(g) on both sides; below it a gradient's rounding moves
# the step by up to 2 lr, so those elements are held by their share
TRANSREF_TRAIN_STITCHAX_TOL = {
    "loss_rel": 5e-6,            # total, l1, perceptual, style: 4.9e-7
    "grad_norm_rel": 2e-5,       # the raw gradients' global norm: 2.1e-6
    "leaf_norm_rel": 7e-3,       # each of the 506 leaves' norm: 7.4e-4
    "leaf_l2_rel": 4e-3,         # the kept leaves' whole gradients: 4.3e-4
    "updated_g_large_lr": 7e-3,  # after Adam where |g| > 1e-6: 6.6e-4 lr
    "updated_off_share": 2e-2,   # the share off by more than 0.01 lr: 2.0e-3
}


def vgg_he_params(seed=TRANSREF_VGG_SEED):
    """flax VGG16Features params, kernels ~ N(0, 2 / fan_in), biases
    ~ 0.01 N, from numpy (tests/test_torch_vgg.py's `vgg_params`, which
    the references were written with)."""
    from stitchax_torch.models.vgg import VGG16_LAYOUT

    rng = np.random.default_rng(seed)
    params, cin = {}, 3
    for name, ch, _ in VGG16_LAYOUT:
        params[name] = {
            "kernel": (rng.standard_normal((3, 3, cin, ch))
                       * np.sqrt(2.0 / (9 * cin))).astype(np.float32),
            "bias": (0.01 * rng.standard_normal(ch)).astype(np.float32)}
        cin = ch
    return {"params": params}


def _transref_step(device="cuda"):
    """The trained TransRef and the seeded VGG on the card, Adam at
    TRANSREF_LR: (the checkpoint's tree, the state, Adam, the step, the
    model)."""
    from stitchax_torch import convert
    from stitchax_torch.models.transref import TransRefBase
    from stitchax_torch.models.vgg import VGG16Features
    from stitchax_torch.train.transref_trainer import (
        create_train_state, make_transref_train_step)

    tree = convert.load_flax_msgpack(TRANSREF_CKPT)
    model = convert.load_jax_params(TransRefBase(), tree).to(device)
    vgg = convert.load_jax_params(VGG16Features(), vgg_he_params()).to(device)
    vgg.requires_grad_(False)
    state, tx = create_train_state(model, TRANSREF_LR)
    return tree, state, tx, make_transref_train_step(model, vgg, tx), model


def _transref_batch(n, device="cuda", seed=SEED):
    """The first n committed pairs at 512^2 in [-1, 1] and seeded holes
    (the port's box draws): (names, pixel sums, gt, ref, mask)."""
    import torch

    from stitchax_torch.data.udis import UDISDataset
    from stitchax_torch.train.transref_trainer import (draw_rect_boxes,
                                                       rect_masks)

    ds = UDISDataset(os.path.join(REPO, SYNTH), phase="testing",
                     size=(TRAIN_SIZE, TRAIN_SIZE))
    items = [ds[i] for i in range(n)]
    px = {k: np.stack([it[k] for it in items]) for k in ("image1", "image2")}
    unit = lambda x: torch.from_numpy(x).to(device) / 127.5 - 1.0
    boxes = draw_rect_boxes(torch.Generator().manual_seed(seed), n,
                            TRAIN_SIZE)
    mask = rect_masks(*(b.to(device) for b in boxes), TRAIN_SIZE)
    sums = [int(px[k].astype(np.int64).sum()) for k in ("image1", "image2")]
    return ([it["name"] for it in items], sums, unit(px["image1"]),
            unit(px["image2"]), mask)


def transref_train_vs_stitchax_phase():
    """One fp32 TransRef step (TF32 off) on the card from the committed
    checkpoint, with the seeded VGG, on the first committed pair at 512^2
    and stitchax's holes (the reference's boxes), against stitchax's jitted
    step (TRANSREF_TRAIN_REFERENCE): the losses, the global and every
    leaf's gradient norm, the kept leaves' whole gradients and their
    values after Adam."""
    import torch

    from stitchax_torch.ops.kernels import library
    from stitchax_torch.train.optim import apply_updates
    from stitchax_torch.train.transref_trainer import (conv_transpose_names,
                                                       rect_masks,
                                                       to_stitchax)
    from stitchax_torch.utils.precision import fp32_exact

    fp32_exact()
    with np.load(os.path.join(REPO, TRANSREF_TRAIN_REFERENCE)) as f:
        ref = {k: f[k] for k in f.files}
    names, sums, gt, img2, _ = _transref_batch(1)
    if names != ref["names"].tolist() or sums != ref["image_sums"].tolist():
        raise RuntimeError(f"transref_train_vs_stitchax: input {names} "
                           f"{sums} is not the reference's")
    tree, state, tx, step, model = _transref_step()
    dev = gt.device
    mask = rect_masks(*(torch.as_tensor(ref[f"box/{k}"], device=dev)
                        for k in ("x0", "y0", "w", "h")), TRAIN_SIZE)
    want_mask = np.unpackbits(ref["mask"])[:mask.numel()].reshape(
        tuple(mask.shape)).astype(bool)
    library.reset_launches()
    metrics, grads = step.loss_and_grads(state, gt, img2, mask)
    torch.cuda.synchronize()
    launches = dict(library.launches)
    updates, _ = tx.update(grads, state.opt_state, state.params)
    apply_updates(state.params, updates)
    ct = conv_transpose_names(model)
    flat = lambda d: {k: v.numpy() for k, v in to_stitchax(d, ct).items()}
    g_norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                  for g in grads.values())))
    grads, updated = flat(grads), flat(state.params)
    start = _flat_stitchax(tree)
    res = {"phase": "transref_train_vs_stitchax", "pair": names[0],
           "image_size": TRAIN_SIZE, "batch": 1, "dtype": "float32",
           "tf32": torch.backends.cudnn.allow_tf32,
           "reference": TRANSREF_TRAIN_REFERENCE,
           "mask_moved_px": int(((mask.cpu().numpy() > 0.5)
                                  != want_mask).sum()),
           "metrics": {k: float(v) for k, v in metrics.items()},
           "grad_norm": g_norm, "launches_per_step": launches,
           "leaves": len(grads)}
    res["stitchax_metrics"] = {k: float(ref[f"metric/{k}"])
                               for k in (*res["metrics"], "grad_norm")}
    res["loss_rel"] = max(abs(v - res["stitchax_metrics"][k])
                          / abs(res["stitchax_metrics"][k])
                          for k, v in res["metrics"].items())
    r = float(ref["metric/grad_norm"])
    res["grad_norm_rel"] = abs(g_norm - r) / r
    floor = 1e-6 * r
    keys = [k[len("gradnorm/"):] for k in ref if k.startswith("gradnorm/")]
    if sorted(keys) != sorted(grads):
        raise RuntimeError("transref_train_vs_stitchax: other gradient "
                           "leaves than stitchax's")
    norm_err = {k: abs(float(np.linalg.norm(grads[k]))
                       - float(ref[f"gradnorm/{k}"]))
                / (float(ref[f"gradnorm/{k}"]) + floor) for k in keys}
    worst = max(norm_err, key=norm_err.get)
    res.update(leaf_norm_rel=norm_err[worst], leaf_norm_worst=worst)
    res["leaf_l2_rel"] = max(
        float(np.linalg.norm(grads[k] - ref[f"grad/{k}"]))
        / (float(np.linalg.norm(ref[f"grad/{k}"])) + floor)
        for k in TRANSREF_KEPT)
    large = worst_u = 0.0
    off = n = 0
    unmoved = []
    for k in TRANSREF_KEPT:
        d = np.abs(updated[k] - ref[f"updated/{k}"]) / TRANSREF_LR
        big = np.abs(ref[f"grad/{k}"]) > 1e-6
        if big.any():
            large = max(large, float(d[big].max()))
        worst_u = max(worst_u, float(d.max()))
        off += int((d > 0.01).sum())
        n += d.size
        if not np.any(updated[k] != start[k]):
            unmoved.append(k)
    res.update(updated_g_large_lr=large, updated_worst_lr=worst_u,
               updated_off_share=off / n, unmoved_leaves=unmoved)
    if res["mask_moved_px"] or unmoved or worst_u > 2.0 + 1e-3:
        emit(res)
        raise RuntimeError("transref_train_vs_stitchax: the holes differ "
                           "from stitchax's, a kept leaf did not move, or "
                           "an element moved by more than 2 lr")
    _check(res, dict(TRANSREF_TRAIN_STITCHAX_TOL),
           "transref_train_vs_stitchax")
    del state, step, model, grads
    torch.cuda.empty_cache()


def transref_train_phase():
    """python -m stitchax_torch.train_transref at its defaults (512^2,
    batch 4, --ref_from pair) for TRANSREF_TRAIN_STEPS steps on a temporary
    data dir whose training/ is the committed 12-pair split, into a
    temporary directory outside the repo: s per step (the warm steps),
    peak memory, kernel launches per step; the export loaded into the
    port's Stitcher (the default configuration) stitching demo1 with its
    hole inpainted, finite; then a warm step's split."""
    import shutil
    import signal
    import tempfile

    import torch

    from stitchax_torch.ops.kernels import library
    from stitchax_torch.run.stitcher import StitchModels, Stitcher, load_image
    from stitchax_torch.train_transref.__main__ import main as tr_main

    tmp = tempfile.mkdtemp(prefix="stitchax_torch_transref_")
    try:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        os.symlink(os.path.join(REPO, SYNTH, "testing"),
                   os.path.join(data, "training"))
        run = os.path.join(tmp, "run")
        argv = ["--data_dir", data, "--num_steps", str(TRANSREF_TRAIN_STEPS),
                "--ckpt_dir", run, "--log_every", "1", "--ref_from", "pair",
                "--device", "cuda:0"]
        handlers = {sig: signal.getsignal(sig)
                    for sig in (signal.SIGTERM, signal.SIGINT)}
        library.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            rc = tr_main(argv)
        finally:
            for sig, h in handlers.items():
                signal.signal(sig, h)
        run_s = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"transref_train: the CLI returned {rc}")
        launches = dict(library.launches)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log = _metrics_log(run, "transref")
        keys = ("total", "l1", "perceptual", "style")
        if sorted(log) != list(range(1, TRANSREF_TRAIN_STEPS + 1)) or not all(
                math.isfinite(log[s][k]) for s in log for k in keys):
            raise RuntimeError(f"transref_train: metrics {log}")
        step_s = [log[s]["t"] - log[s - 1]["t"]
                  for s in range(2, TRANSREF_TRAIN_STEPS + 1)]
        export = os.path.join(run, "final_transref.msgpack")
        ckpt = os.path.join(run, f"step_{TRANSREF_TRAIN_STEPS:08d}.pt")
        sizes = {k: os.path.getsize(p) / 2 ** 20
                 for k, p in (("export_mib", export), ("step_ckpt_mib", ckpt))}
        models = StitchModels.from_npz(CKPT, "cuda", torch.bfloat16, DEFAULT,
                                       transref=export)
        demo = os.path.join(REPO, "demo_data", "demo1")
        out = Stitcher(models, device="cuda", config=DEFAULT).stitch(
            *(load_image(os.path.join(demo, f))
              for f in ("input1.jpg", "input2.jpg")))
        check_finite(out)
        hole = out["inpaint_area_mask"] > 0.5
        if not hole.any():
            raise RuntimeError("transref_train: the export's stitch of demo1 "
                               "inpainted no hole")
        hole_share = float(hole.mean())
        del models, out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    split = transref_step_split()
    res = {"phase": "transref_train", "steps": TRANSREF_TRAIN_STEPS,
           "image_size": TRAIN_SIZE, "batch": TRANSREF_TRAIN_BATCH,
           "dtype": "float32", "ref_from": "pair", "run_s": run_s,
           "s_per_step_warm": step_s,
           "metrics": {s: {k: log[s][k] for k in keys} for s in log},
           "peak_mem_gib": peak,
           "launches_per_step": {k: v / TRANSREF_TRAIN_STEPS
                                 for k, v in launches.items()},
           **sizes, "export_stitch": "finite",
           "export_hole_share": hole_share,
           **split, "ok": True}
    emit(res)


def transref_step_split(warm=1, timed=3):
    """ms of a TransRef train step's parts at 512^2, batch 4 (forward, the
    loss with the VGG's two forwards, backward, Adam; synchronized between
    them), warm, mean of `timed` steps; and its peak memory."""
    import torch

    from stitchax_torch.utils.precision import fp32_exact

    fp32_exact()
    _, state, _, step, _ = _transref_step()
    _, _, gt, img2, mask = _transref_batch(TRANSREF_TRAIN_BATCH)
    for _ in range(warm):
        state, _ = step(state, gt, img2, mask)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    t0 = time.perf_counter()
    for _ in range(timed):
        state, _ = step(state, gt, img2, mask, timings=timings)
    out = {f"split_{k}": v / timed for k, v in timings.items()}
    out["split_step_ms"] = (time.perf_counter() - t0) * 1e3 / timed
    out["split_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, step
    torch.cuda.empty_cache()
    return out


def profile_transref_train_step():
    """A function running one warm fp32 TransRef step (512^2, batch 4)."""
    from stitchax_torch.utils.precision import fp32_exact

    fp32_exact()
    _, state, _, step, _ = _transref_step()
    _, _, gt, img2, mask = _transref_batch(TRANSREF_TRAIN_BATCH)
    state, _ = step(state, gt, img2, mask)               # warm-up
    return lambda timings: step(state, gt, img2, mask, timings=timings)


# --------------------------- SD inpainting trainer ---------------------------

SD_TRAIN_REFERENCE = "tests/torch_reference/sd_train_stitchax_fp32.npz"
# the tool's learning rates and sizes (tools/train_sd_inpaint_learns.py
# defaults: 128^2, w = 48, batch 8), the committed checkpoint's widths
SD_TRAIN_LR_VAE, SD_TRAIN_LR = 3e-4, 2e-4
SD_TRAIN_SIZE, SD_TRAIN_BATCH = 128, 8
# the CLI's short run: a few steps of each phase, two evaluation points
SD_TRAIN_CLI = ["--steps_vae", "3", "--steps", "4", "--eval_every", "2",
                "--n_eval", "2", "--save_ckpt"]
# the kept leaves of SD_TRAIN_REFERENCE (their gradients and values after
# Adam)
SD_TRAIN_KEPT = (
    "['vae']['params']['encoder']['conv_in']['kernel']",
    "['vae']['params']['encoder']['mid']['attn']['to_q']['kernel']",
    "['vae']['params']['decoder']['conv_out']['kernel']",
    "['vae']['params']['decoder']['conv_out']['bias']",
    "['unet']['params']['conv_in']['kernel']",
    "['unet']['params']['mid_attn']['attn2_k']['kernel']",
    "['unet']['params']['conv_out']['kernel']",
    "['unet']['params']['conv_out']['bias']",
    "['controlnet']['params']['hint_in']['kernel']",
    "['controlnet']['params']['zero0']['kernel']")
SD_TRAIN_STEPS = {"vae": ("vae_total", "vae_l1", "vae_l2"),
                  "diffusion": ("mse",)}
# one fp32 VAE step and one diffusion step (TF32 off) on the card from the
# committed checkpoint against stitchax's jitted steps on the CPU
# (SD_TRAIN_REFERENCE: demo crops, the port's boxes, stitchax's t and
# eps); see PERF.md section 2 for the readings these hold with ~10x
# headroom. After Adam, in units of lr, as TRANSREF_TRAIN_STITCHAX_TOL
SD_TRAIN_STITCHAX_TOL = {
    "loss_rel": 1.5e-5,          # vae total / l1 / l2, the mse: 1.3e-6
    "grad_norm_rel": 5e-4,       # each step's global norm: 5.4e-5 (VAE)
    "leaf_norm_rel": 1e-3,       # each of the 244 + 440 leaves: 8.8e-5
    "leaf_l2_rel": 2e-3,         # the kept leaves' gradients: 1.8e-4
    "updated_g_large_lr": 1e-3,  # after Adam where |g| > 1e-6: 1.1e-4 lr
    "updated_off_share": 3e-3,   # off by more than 0.01 lr: 3.4e-4
}


def _sd_train_nets(device="cuda"):
    """The committed SD checkpoint's nets on `device`: ({"unet",
    "controlnet", "vae": module}, the context, the configs, the flat start
    values by stitchax's key strings)."""
    import torch

    from stitchax_torch import convert
    from stitchax_torch.models.diffusion import (ControlNet, UNet2DCondition,
                                                 UNetConfig)
    from stitchax_torch.models.vae import AutoencoderKL

    blob = convert.load_sd_container(SD_CKPT)
    cfgs = blob["configs"]
    cfg = UNetConfig(**cfgs["unet"])
    nets = {k: convert.load_jax_params(m, blob[f"{k}_vars"]).to(device)
            for k, m in (("unet", UNet2DCondition(cfg)),
                         ("controlnet", ControlNet(cfg)),
                         ("vae", AutoencoderKL(**cfgs["vae"])))}
    start = _flat_stitchax({k: blob[f"{k}_vars"] for k in nets})
    context = torch.as_tensor(blob["context"], dtype=torch.float32,
                              device=device)
    return nets, context, cfgs, start


def _sd_train_states(nets, context):
    """(diffusion state, its Adam, its step; VAE state, its Adam, its
    step) over `nets`."""
    from stitchax_torch.train.sd_inpaint_trainer import (
        create_train_state, make_diffusion_train_step, make_vae_train_step)

    state, tx = create_train_state({k: nets[k] for k in ("unet",
                                                         "controlnet")},
                                   SD_TRAIN_LR)
    step = make_diffusion_train_step(nets["unet"], nets["controlnet"],
                                     nets["vae"], tx, context)
    vstate, vtx = create_train_state({"vae": nets["vae"]}, SD_TRAIN_LR_VAE)
    return state, tx, step, vstate, vtx, make_vae_train_step(nets["vae"],
                                                             vtx)


def sd_train_vs_stitchax_phase():
    """One fp32 diffusion step and then one VAE step (TF32 off) on the card
    from the committed SD checkpoint, on the reference's crops, holes, t
    and eps, against stitchax's jitted steps (SD_TRAIN_REFERENCE): the
    losses, each step's global and every leaf's gradient norm, the kept
    leaves' whole gradients and their values after Adam."""
    import torch

    from stitchax_torch.ops.kernels import library
    from stitchax_torch.train.optim import apply_updates
    from stitchax_torch.train.trainer import stitchax_tree
    from stitchax_torch.utils.precision import fp32_exact

    fp32_exact()
    with np.load(os.path.join(REPO, SD_TRAIN_REFERENCE)) as f:
        ref = {k: f[k] for k in f.files}
    nets, context, _, start = _sd_train_nets()
    x, image01, hole, t, eps = _sd_train_batch()
    state, tx, step, vstate, vtx, vstep = _sd_train_states(nets, context)
    flat = lambda d: _flat_stitchax(stitchax_tree(d))
    library.reset_launches()
    m, g = step.loss_and_grads(state, image01, hole, t, eps)
    vm, vg = vstep.loss_and_grads(vstate, x)
    torch.cuda.synchronize()
    launches = dict(library.launches)
    metrics = {"mse": float(m["mse"]),
               **{f"vae_{k}": float(v) for k, v in vm.items()}}
    grads = {**flat(g), **flat(vg)}
    for st, o, gr in ((state, tx, g), (vstate, vtx, vg)):
        apply_updates(st.params, o.update(gr, st.opt_state)[0])
    updated = {**flat(state.params), **flat(vstate.params)}
    step_of = lambda k: "vae" if k.startswith("['vae']") else "diffusion"
    norm = {s: math.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2))
                             for k, v in grads.items() if step_of(k) == s))
            for s in SD_TRAIN_STEPS}
    res = {"phase": "sd_train_vs_stitchax", "image_size": SD_TRAIN_SIZE,
           "batch": len(ref["pixels"]), "dtype": "float32",
           "tf32": torch.backends.cudnn.allow_tf32,
           "reference": SD_TRAIN_REFERENCE, "t": ref["t"].tolist(),
           "metrics": metrics,
           "grad_norms": {f"{s}_grad_norm": v for s, v in norm.items()},
           "launches_per_step": launches, "leaves": len(grads)}
    want = {k: float(ref[f"metric/{k}"]) for k in metrics}
    want.update({f"{s}_grad_norm": float(ref[f"metric/{s}_grad_norm"])
                 for s in SD_TRAIN_STEPS})
    res["stitchax_metrics"] = want
    res["loss_rel"] = max(abs(v - want[k]) / abs(want[k])
                          for k, v in metrics.items())
    res["grad_norm_rel"] = max(abs(v - want[k]) / want[k]
                               for k, v in res["grad_norms"].items())
    floor = {s: 1e-6 * want[f"{s}_grad_norm"] for s in SD_TRAIN_STEPS}
    keys = [k[len("gradnorm/"):] for k in ref if k.startswith("gradnorm/")]
    if sorted(keys) != sorted(grads):
        raise RuntimeError("sd_train_vs_stitchax: other gradient leaves "
                           "than stitchax's")
    norm_err = {k: abs(float(np.linalg.norm(grads[k]))
                       - float(ref[f"gradnorm/{k}"]))
                / (float(ref[f"gradnorm/{k}"]) + floor[step_of(k)])
                for k in keys}
    worst = max(norm_err, key=norm_err.get)
    res.update(leaf_norm_rel=norm_err[worst], leaf_norm_worst=worst)
    res["leaf_l2_rel"] = max(
        float(np.linalg.norm(grads[k] - ref[f"grad/{k}"]))
        / (float(np.linalg.norm(ref[f"grad/{k}"])) + floor[step_of(k)])
        for k in SD_TRAIN_KEPT)
    large = worst_u = 0.0
    off = n = 0
    unmoved = []
    for k in SD_TRAIN_KEPT:
        lr = SD_TRAIN_LR_VAE if step_of(k) == "vae" else SD_TRAIN_LR
        d = np.abs(updated[k] - ref[f"updated/{k}"]) / lr
        big = np.abs(ref[f"grad/{k}"]) > 1e-6
        if big.any():
            large = max(large, float(d[big].max()))
        worst_u = max(worst_u, float(d.max()))
        off += int((d > 0.01).sum())
        n += d.size
        if not np.any(updated[k] != start[k]):
            unmoved.append(k)
    res.update(updated_g_large_lr=large, updated_worst_lr=worst_u,
               updated_off_share=off / n, unmoved_leaves=unmoved)
    if unmoved or worst_u > 2.0 + 1e-3:
        emit(res)
        raise RuntimeError("sd_train_vs_stitchax: a kept leaf did not move "
                           "or an element moved by more than 2 lr")
    _check(res, dict(SD_TRAIN_STITCHAX_TOL), "sd_train_vs_stitchax")
    del nets, state, vstate, grads
    torch.cuda.empty_cache()


def sd_train_phase():
    """python -m stitchax_torch.train_sd_inpaint at its defaults' widths
    (128^2, w = 48, batch 8) for a few steps (SD_TRAIN_CLI) into a
    temporary directory outside the repository: its files, s per run and
    peak memory; its sd_ckpt.pt loaded through StitchModels.from_npz(...,
    sd=...) stitching demo1 with the diffusion configuration (finite, its
    hole inpainted); then warm steps timed and split."""
    import shutil
    import tempfile

    import torch

    from stitchax_torch.ops.kernels import library
    from stitchax_torch.run.stitcher import StitchModels, Stitcher, load_image
    from stitchax_torch.train_sd_inpaint.__main__ import main as sd_main

    tmp = tempfile.mkdtemp(prefix="stitchax_torch_sd_train_")
    try:
        out_dir = os.path.join(tmp, "run")
        library.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = sd_main([*SD_TRAIN_CLI, "--out", out_dir, "--device", "cuda:0"])
        run_s = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"sd_train: the CLI returned {rc}")
        launches = dict(library.launches)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(os.path.join(out_dir, "result.json")) as f:
            result = json.load(f)
        files = sorted(os.listdir(out_dir))
        if files != ["panel_final.jpg", "result.json", "sd_ckpt.pt",
                     "sd_ckpt_best.pt"]:
            raise RuntimeError(f"sd_train: the CLI wrote {files}")
        if [h["step"] for h in result["history"]] != [2, 4] or not all(
                math.isfinite(h[k]) for h in result["history"]
                for k in ("mse", "hole_psnr", "hole_psnr_refine")):
            raise RuntimeError(f"sd_train: history {result['history']}")
        ckpt = os.path.join(out_dir, "sd_ckpt.pt")
        ckpt_mib = os.path.getsize(ckpt) / 2 ** 20
        models = StitchModels.from_npz(CKPT, "cuda", torch.bfloat16,
                                       DIFFUSION, sd=ckpt)
        demo = os.path.join(REPO, "demo_data", "demo1")
        out = Stitcher(models, device="cuda", config=DIFFUSION).stitch(
            *(load_image(os.path.join(demo, f))
              for f in ("input1.jpg", "input2.jpg")))
        check_finite(out)
        hole = out["inpaint_area_mask"] > 0.5
        if not hole.any():
            raise RuntimeError("sd_train: the checkpoint's stitch of demo1 "
                               "inpainted no hole")
        hole_share = float(hole.mean())
        del models, out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res = {"phase": "sd_train", "cli": SD_TRAIN_CLI,
           "image_size": result["size"], "width": result["width"],
           "batch": result["batch"], "dtype": "float32",
           "params_m": result["params_m"], "run_s": run_s,
           "history": result["history"],
           "vae_recon_psnr": result["vae_recon_psnr"],
           "psnr_push_pull": result["psnr_push_pull"],
           "peak_mem_gib": peak, "kernel_launches": launches,
           "ckpt_mib": ckpt_mib, "ckpt_stitch": "finite",
           "ckpt_hole_share": hole_share, **sd_step_split(), "ok": True}
    emit(res)


def _sd_train_batch(device="cuda"):
    """SD_TRAIN_REFERENCE's inputs on `device`: (x in [-1, 1], image01, the
    holes, NHWC, from its uint8 crops and hole boxes; stitchax's t and eps,
    NCHW). The timed steps take the same draws every time."""
    import torch

    from stitchax_torch.train.transref_trainer import rect_masks

    with np.load(os.path.join(REPO, SD_TRAIN_REFERENCE)) as f:
        ref = {k: f[k] for k in ("pixels", "size", "t", "eps",
                                 "box/x0", "box/y0", "box/w", "box/h")}
    px = torch.from_numpy(ref["pixels"]).to(device).float()
    hole = rect_masks(*(torch.as_tensor(ref[f"box/{k}"], device=device)
                        for k in ("x0", "y0", "w", "h")), int(ref["size"]))
    t = torch.as_tensor(ref["t"].astype(np.int64), device=device)
    eps = torch.as_tensor(ref["eps"], device=device).permute(0, 3, 1, 2)
    return px / 127.5 - 1.0, px / 255.0, hole, t, eps


def sd_step_split(warm=2, timed=5):
    """Warm steps at 128^2, batch 8 from the committed checkpoint: s per
    VAE step and per diffusion step (mean of `timed`), a diffusion step's
    parts (the VAE's encodes, the ControlNet + UNet forward, backward,
    Adam; synchronized between them) and a VAE step's, each step's peak
    memory, and the device kernels each step launches (from the
    profiler)."""
    import torch

    from stitchax_torch.utils.precision import fp32_exact

    fp32_exact()
    nets, context, _, _ = _sd_train_nets()
    x, image01, hole, t, eps = _sd_train_batch()
    state, _, step, vstate, _, vstep = _sd_train_states(nets, context)
    runs = {"diffusion": lambda s, tm=None: step(s, image01, hole, t=t,
                                                 eps=eps, timings=tm),
            "vae": lambda s, tm=None: vstep(s, x, timings=tm)}
    states = {"diffusion": state, "vae": vstate}
    out = {}
    for name, run in runs.items():
        st = states[name]
        for _ in range(warm):
            st, _ = run(st)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(timed):
            st, _ = run(st)
        torch.cuda.synchronize()
        out[f"{name}_step_s"] = (time.perf_counter() - t0) / timed
        out[f"{name}_peak_mem_gib"] = (torch.cuda.max_memory_allocated()
                                       / 2 ** 30)
        timings = {}
        for _ in range(timed):
            st, _ = run(st, timings)
        out[f"{name}_split_ms"] = {k: v / timed for k, v in timings.items()}
        ran = []
        dev = device_events(lambda: ran.append(run(st)))
        st, _ = ran[0]
        out[f"{name}_device_kernels"] = None if dev is None else len(dev)
        states[name] = st
    del nets, states, state, vstate
    torch.cuda.empty_cache()
    return out


def profile_sd_train_step():
    """A function running one warm fp32 diffusion step (128^2, batch 8,
    from the committed checkpoint)."""
    from stitchax_torch.utils.precision import fp32_exact

    fp32_exact()
    nets, context, _, _ = _sd_train_nets()
    _, image01, hole, t, eps = _sd_train_batch()
    state, _, step, _, _, _ = _sd_train_states(nets, context)
    state, _ = step(state, image01, hole, t=t, eps=eps)  # warm-up
    return lambda timings: step(state, image01, hole, t=t, eps=eps,
                                timings=timings)


# ------------------------- NA vertical attention (A5) ------------------------

# FlowFormer++ at configs/last_config.py's widths with the NA vertical layer
# (seeded; the trained npz for every shared leaf): on the card at 512^2,
# and card against CPU at NA_CPU_SIZE in fp32 (TF32 off); see PERF.md
# section 2 for the reading
NA_SIZE, NA_CPU_SIZE = 512, 128
NA_TOL = {"flow_max_abs_px": 6e-3}      # read 5.9e-4 px
EXPECT_NA_KERNELS = ("gsa_attention", "cost_lookup", "window_attention")


def na_flowformer(device):
    """The port's FlowFormer++ (the shipped config, upsample_all False) with
    `vertical_encoder_attn="NA"`: every leaf the trained npz shares with it
    from the npz, the three NA layers seeded by `_seeded_init` (a CPU
    generator seeded with SEED), on `device`."""
    import torch

    from stitchax_torch import convert
    from stitchax_torch.models.flowformer import FlowFormer, FlowFormerConfig

    model = FlowFormer(FlowFormerConfig(vertical_encoder_attn="NA"))
    tree = convert.load_npz(CKPT)["flow"]
    perceiver = tree["params"]["memory_encoder"]["cost_perceiver"]
    for k in [k for k in perceiver if k.startswith("vertical_layer")]:
        del perceiver[k]
    missing, unexpected = model.load_state_dict(convert.params_from_jax(tree),
                                                strict=False)
    na = [n for n, _ in model.state_dict().items()
          if ".vertical_layer" in n]
    if unexpected or sorted(missing) != sorted(na):
        raise RuntimeError(f"na_flowformer: unexpected {unexpected[:4]}, "
                           f"missing {sorted(set(missing) - set(na))[:4]}")
    g = torch.Generator().manual_seed(SEED)
    for i in range(model.cfg.encoder_depth):
        _seeded_init(getattr(model.memory_encoder.cost_perceiver,
                             f"vertical_layer{i}"), g)
    return model.to(device).eval()


def na_flowformer_phase():
    """The NA variant on the card at 512^2 (fp32, TF32 off): finite flow,
    ms per forward, K1 / K3 / K4 launched; then card against the port's CPU
    run at NA_CPU_SIZE on the same seeded images (NA_TOL)."""
    import torch

    from stitchax_torch.ops.kernels import library
    from stitchax_torch.utils.precision import fp32_exact

    fp32_exact()
    g = torch.Generator().manual_seed(SEED)
    imgs = [torch.rand(1, NA_SIZE, NA_SIZE, 3, generator=g) * 255.0
            for _ in range(2)]
    model = na_flowformer("cuda")
    a, b = (i.cuda() for i in imgs)
    with torch.no_grad():
        library.reset_launches()
        preds, _ = model(a, b)
        torch.cuda.synchronize()
        launches = dict(library.launches)
        flow = preds[-1]
        ms = cuda_time(lambda: model(a, b), iters=3, warmup=1, flush=False)
        small = [torch.nn.functional.interpolate(
            i.permute(0, 3, 1, 2), size=(NA_CPU_SIZE, NA_CPU_SIZE),
            mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
            for i in imgs]
        card = model(*(i.cuda() for i in small))[0][-1].cpu()
        cpu = na_flowformer("cpu")(*small)[0][-1]
    res = {"phase": "na_flowformer", "vertical_encoder_attn": "NA",
           "image_size": NA_SIZE, "dtype": "float32",
           "weights": f"{WEIGHTS} (shared leaves) + seeded NA layers",
           "flow_shape": list(flow.shape),
           "finite": bool(torch.isfinite(flow).all().item()),
           "flow_abs_max_px": flow.abs().max().item(), "forward_ms": ms,
           "launches": launches, "cpu_size": NA_CPU_SIZE,
           "flow_max_abs_px": (card - cpu).abs().max().item()}
    not_run = [k for k in EXPECT_NA_KERNELS if not launches.get(k)]
    if not res["finite"] or not_run:
        emit(res)
        raise RuntimeError(f"na_flowformer: flow finite {res['finite']}, "
                           f"kernels not launched {not_run}")
    _check(res, dict(NA_TOL), "na_flowformer")
    del model
    torch.cuda.empty_cache()


# ----------------------------- MAE pretraining -------------------------------

PRETRAIN_REFERENCE = "tests/torch_reference/pretrain_stitchax_fp32.npz"
PRETRAIN_HW = (368, 496)       # pic_size / the augmentor's crop_size
PRETRAIN_BATCH = 2
PRETRAIN_HEAD_SEED = 0         # convert.pretrain_variables' seed
# the pretrain loss and every leaf's gradient norm in fp32 on the card (TF32
# off) against stitchax's jitted loss and gradient on the CPU
# (PRETRAIN_REFERENCE, the same inputs and weights); a leaf whose norm is
# below 1e-6 of the largest is held by the largest
PRETRAIN_TOL = {"loss_rel": 1e-4, "leaf_norm_rel": 1e-3}
# the kernels of one pretrain forward (30 queries, encoder depth 3): K1 and
# K4 once per twins block of four twins passes (2 x 4) and of the three
# vertical layers, K3 at r = 7 (targets) and r = 4 (queries) per query
EXPECT_PRETRAIN_LAUNCHES = {"gsa_attention": 11, "window_attention": 11,
                            "cost_lookup": 60}
EXPECT_PRETRAIN_RADII = {7: 30, 4: 30}


def pretrain_model(device="cuda"):
    """FlowFormerPretrain at the shipped widths: the trained npz's
    FlowFormer++ leaves and a pretrain head seeded with PRETRAIN_HEAD_SEED
    (convert.pretrain_variables), on `device`."""
    from stitchax_torch import convert
    from stitchax_torch.models.flowformer import (FlowFormerConfig,
                                                  FlowFormerPretrain)

    cfg = FlowFormerConfig()
    tree = convert.pretrain_variables(convert.load_npz(CKPT, "flow"), cfg,
                                      seed=PRETRAIN_HEAD_SEED)
    return convert.load_jax_params(FlowFormerPretrain(cfg), tree).to(device)


def _flat_grads(model):
    """The model's gradients as {stitchax key string: float32 array}."""
    import torch

    from stitchax_torch import convert

    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters()}
    return {convert._keystr(p): a for p, a in
            convert._flatten(convert.params_to_jax(grads))}


def pretrain_vs_stitchax_phase():
    """One fp32 pretrain forward + backward (TF32 off) at 368x496, batch 2,
    on stitchax's inputs (PRETRAIN_REFERENCE: two seeded pairs, the masking
    and query noise) against its loss and gradient leaf norms."""
    import torch

    from stitchax_torch.ops.kernels import library
    from stitchax_torch.utils.precision import fp32_exact

    fp32_exact()
    with np.load(os.path.join(REPO, PRETRAIN_REFERENCE)) as f:
        ref = {k: f[k] for k in f.files}
    model = pretrain_model()
    args = [torch.as_tensor(np.asarray(ref[k], np.float32), device="cuda")
            for k in ("img1", "img2", "noise", "query_noise")]
    library.reset_launches()
    loss = model(*args)
    loss.backward()
    torch.cuda.synchronize()
    launches = dict(library.launches)
    grads = _flat_grads(model)
    names = [str(k) for k in ref["leaf_names"]]
    want = ref["leaf_norms"]
    got = np.array([np.linalg.norm(grads[k].astype(np.float64))
                    for k in names])
    rel = np.abs(got - want) / np.maximum(want, 1e-6 * want.max())
    res = {"phase": "pretrain_vs_stitchax", "image_size": list(PRETRAIN_HW),
           "batch": PRETRAIN_BATCH, "dtype": "float32",
           "reference": PRETRAIN_REFERENCE, "loss": float(loss.detach()),
           "loss_stitchax": float(ref["loss"]),
           "loss_rel": abs(float(loss) - float(ref["loss"]))
           / abs(float(ref["loss"])),
           "leaves": len(names), "leaf_norm_rel": float(rel.max()),
           "worst_leaf": names[int(rel.argmax())],
           "leaf_norm_rel_median": float(np.median(rel)),
           "launches": launches,
           "cost_lookup_by_radius": dict(library.cost_lookup_by_radius)}
    if sorted(grads) != sorted(names):
        emit(res)
        raise RuntimeError("pretrain_vs_stitchax: the gradient's leaves are "
                           "not stitchax's")
    _check(res, PRETRAIN_TOL, "pretrain_vs_stitchax")
    del model, args, loss
    torch.cuda.empty_cache()


def pretrain_pair():
    """A batch of PRETRAIN_BATCH pairs as the pretraining loader makes them:
    CADataset over a {phase}.txt (written under a temporary directory)
    listing demo_data's pairs, with the FlowAugmentor's crop to 368x496.
    Returns (img1, img2) float32 (B, H, W, 3) and ms per sample read."""
    import shutil
    import tempfile

    from stitchax_torch.data.flow_datasets import CADataset

    root = tempfile.mkdtemp(prefix="stitchax_pretrain_")
    try:
        os.makedirs(os.path.join(root, "img"))
        lines = []
        for pair in DEMO_PAIRS:
            names = []
            for i in (1, 2):
                name = f"{pair}_{i}.jpg"
                os.symlink(os.path.join(REPO, "demo_data", pair,
                                        f"input{i}.jpg"),
                           os.path.join(root, "img", name))
                names.append(name)
            lines.append(" ".join(names))
        with open(os.path.join(root, "train.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        # the demo images (448x384) are smaller than the crop: the
        # augmentor's resize, which scales an image above the crop, always
        # runs (stitchax's draws it with probability 0.8 and cannot crop
        # without it)
        ds = CADataset(root, aug_params={"crop_size": PRETRAIN_HW,
                                         "spatial_aug_prob": 1.0},
                       phase="train")
        t0 = time.perf_counter()
        items = [ds[i % len(ds)] for i in range(PRETRAIN_BATCH)]
        read_ms = (time.perf_counter() - t0) * 1e3 / PRETRAIN_BATCH
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return (np.stack([it["image1"] for it in items]),
            np.stack([it["image2"] for it in items]), read_ms)


def _capture_kernel_inputs(run):
    """{(kernel, input shapes...): [calls, the first call's arguments]} of
    every K1 / K3 / K4 launch in run() (the arguments kept as they were
    passed, strides included)."""
    import torch

    from stitchax_torch.ops.kernels import (cost_lookup, gsa_attention,
                                            window_attention)

    seen, patched = {}, []
    for mod, name in ((gsa_attention, "gsa_attention"),
                      (cost_lookup, "cost_lookup"),
                      (window_attention, "window_attention")):
        orig = mod._launch

        def wrap(*args, _orig=orig, _name=name):
            key = (_name,) + tuple(tuple(a.shape) if isinstance(
                a, torch.Tensor) else a for a in args)
            entry = seen.setdefault(key, [0, args])
            entry[0] += 1
            return _orig(*args)

        mod._launch = wrap
        patched.append((mod, orig))
    try:
        run()
    finally:
        for mod, orig in patched:
            mod._launch = orig
    return seen


def _kernel_entry(key, args):
    """One captured call held against its plain version and timed: max
    |diff|, ms / device ms of the kernel, its plain version and its PyTorch
    yardstick, and its bound (K1 / K4 at fp32 accuracy on the tensor
    cores, as their fp32 paths reach it; K3 at the CUDA cores' fp32
    rate)."""
    import torch
    import torch.nn.functional as F

    from stitchax_torch.ops.kernels import (cost_lookup, gsa_attention,
                                            window_attention as wa)

    kernel = key[0]
    if kernel == "gsa_attention":
        q, k, v, heads = args
        B, N, C = q.shape
        Nk = k.shape[1]
        fn = lambda: gsa_attention.gsa_attention(q, k, v, heads=heads)
        plain = lambda: gsa_attention.gsa_attention_plain(q, k, v,
                                                          heads=heads)
        d = C // heads
        qh, kh, vh = (t.reshape(B, -1, heads, d).transpose(1, 2).contiguous()
                      for t in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(qh, kh, vh)
        bound = fp32_attention_bound(4 * (2 * B * N * C + 2 * B * Nk * C),
                                     4.0 * B * N * Nk * C, B * N * Nk * heads)
        entry = {"B": B, "N": N, "keys": Nk, "C": C, "heads": heads,
                 "tol": TOL["gsa_attention_fp32"], **bound}
    elif kernel == "cost_lookup":
        cm, coords, r = args
        P, H2, W2 = cm.shape
        fn = lambda: cost_lookup.cost_lookup(cm, coords, r)
        plain = lambda: cost_lookup.cost_lookup_plain(cm, coords, r)
        off = torch.arange(-r, r + 1, device=cm.device, dtype=torch.float32)
        win = off.numel()
        c = coords.float()
        gx = (c[:, 0, None, None] + off[:, None]).expand(-1, -1, win)
        gy = (c[:, 1, None, None] + off[None, :]).expand(-1, win, -1)
        grid = torch.stack([gx * (2.0 / (W2 - 1)) - 1.0,
                            gy * (2.0 / (H2 - 1)) - 1.0], -1)
        lib = lambda: F.grid_sample(cm[:, None], grid, mode="bilinear",
                                    padding_mode="zeros", align_corners=True)
        # this run's taps: the (2r+2)^2 neighbourhood of each center that
        # lies inside its map, read once; coordinates read, window written
        steps = torch.arange(2 * r + 2, device=cm.device)
        f0 = torch.floor(c).long() - r
        inx = ((f0[:, :1] + steps >= 0) & (f0[:, :1] + steps < W2)).sum(1)
        iny = ((f0[:, 1:] + steps >= 0) & (f0[:, 1:] + steps < H2)).sum(1)
        touched = float((inx * iny).sum().item())
        b, by = bound_ms(touched * cm.element_size() + P * 2 * 4
                         + P * win * win * 4,
                         P * (3 * win * (win + 1) + 3 * win * win),
                         PEAK["fp32"])
        entry = {"P": P, "H2": H2, "W2": W2, "r": r,
                 "tol": TOL["cost_lookup"], "bound_ms": b, "bound_by": by}
    else:
        qx, kx, vx, qb, kb, vb, heads, ws = args
        B, H, W, C = qx.shape
        T = ws * ws
        fn = lambda: wa.window_attention(qx, kx, vx, qb, kb, vb, heads=heads,
                                         ws=ws)
        plain = lambda: wa.window_attention_plain(qx, kx, vx, qb, kb, vb,
                                                  heads=heads, ws=ws)
        q, k, v = wa.biased_windows(qx, kx, vx, qb, kb, vb, ws)
        d = C // heads
        qh, kh, vh = (t.reshape(-1, T, heads, d).transpose(1, 2).contiguous()
                      for t in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(qh, kh, vh)
        n_win = q.shape[0] * q.shape[1]
        bound = fp32_attention_bound(4 * (4 * B * H * W * C + 2 * T * C + C),
                                     4.0 * n_win * T * T * C,
                                     n_win * T * T * heads)
        entry = {"B": B, "H": H, "W": W, "C": C, "heads": heads, "ws": ws,
                 "tol": TOL["window_attention_fp32"], **bound}
    with torch.no_grad():
        err = (fn().float() - plain().float()).abs().max().item()
    entry.update(kernel=kernel, dtype=str(args[0].dtype).split(".")[-1],
                 max_abs_err=err, ms=cuda_time(fn, iters=5),
                 device_ms=device_ms(fn, iters=5),
                 plain_ms=cuda_time(plain, iters=3, warmup=1),
                 library_ms=cuda_time(lib, iters=5),
                 library_device_ms=device_ms(lib, iters=5))
    return entry


PRETRAIN_ROWS = (
    ("gsa_attention", None, "stitchax_torch/csrc/gsa_attention.cu",
     "stitchax/ops/pallas/gsa_attention.py:51"),
    ("cost_lookup", 7, "stitchax_torch/csrc/cost_lookup.cu",
     "stitchax/ops/pallas/cost_lookup.py:121"),
    ("cost_lookup", 4, "stitchax_torch/csrc/cost_lookup.cu",
     "stitchax/ops/pallas/cost_lookup.py:121"),
    ("window_attention", None, "stitchax_torch/csrc/window_attention.cu",
     "tools/exp_window_attn.py:96"))


def pretrain_kernel_rows(captured, launches, by_radius):
    """The kernel table's rows at the pretrain step's shapes: per kernel
    (K3 per radius), each captured call shape held against its plain
    version and timed, summed over its calls in one forward."""
    rows, detail = [], []
    for kernel, r, source, replaces in PRETRAIN_ROWS:
        calls = [(key, n, args) for key, (n, args) in captured.items()
                 if key[0] == kernel and (r is None or key[-1] == r)]
        row = {"name": f"{kernel}@pretrain" + (f"_r{r}" if r else ""),
               "route": "cuda", "source": source, "replaces": replaces,
               "launches": by_radius.get(r, 0) if r else launches[kernel],
               "max_abs_err": 0.0, "ms": 0.0, "device_ms": 0.0,
               "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
               "library_device_ms": 0.0}
        share = {"bytes": 0.0, "operations": 0.0}
        for key, n, args in calls:
            e = _kernel_entry(key, args)
            e["calls"] = n
            detail.append({"phase_shapes": "pretrain", **e})
            row["max_abs_err"] = max(row["max_abs_err"], e["max_abs_err"])
            for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                      "library_ms", "library_device_ms"):
                row[k] += n * e[k]
            share[e["bound_by"]] += n * e["bound_ms"]
        row["bound_by"] = max(share, key=share.get)
        row["calls_captured"] = sum(n for _, n, _ in calls)
        rows.append(row)
    return rows, detail


def pretrain_phase(smi):
    """The MAE pretrain step on the card at 368x496, batch 2, fp32 (TF32
    off), the shipped widths and the carried weights, on a batch from
    CADataset + FlowAugmentor: forward + backward + one AdamW update
    (clip, one-cycle), launches of K1 / K3 (r = 7 and r = 4 apart) / K4 in
    one step, warm ms of the step and its parts, peak memory; then the
    three kernels' rows at the step's shapes. Returns the rows."""
    import torch

    from stitchax_torch.ops.kernels import library
    from stitchax_torch.train.optim import (OptimConfig, apply_updates,
                                            fetch_optimizer)
    from stitchax_torch.utils.precision import fp32_exact

    fp32_exact()
    i1, i2, read_ms = pretrain_pair()
    model = pretrain_model()
    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(SEED)
    B, (H, W) = PRETRAIN_BATCH, PRETRAIN_HW
    H1, W1 = H // 8, W // 8
    L = (-(-H1 // cfg.patch_size)) * (-(-W1 // cfg.patch_size))
    a, b = (torch.from_numpy(x).cuda() for x in (i1, i2))
    noise = torch.rand(B * H1 * W1, L, device="cuda", generator=g)
    qnoise = torch.rand(cfg.query_num, B, H1, W1, 2, device="cuda",
                        generator=g)
    params = dict(model.named_parameters())
    tx = fetch_optimizer(OptimConfig(num_steps=100))
    opt = [tx.init(params)]
    split = {}

    def step(timings=None):
        t0 = time.perf_counter()
        loss = model(a, b, noise, qnoise)
        if timings is not None:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[n] for n in names])))
        if timings is not None:
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        updates, opt[0] = tx.update(grads, opt[0], params)
        apply_updates(params, updates)
        if timings is not None:
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            for k, v in (("forward_ms", t1 - t0), ("backward_ms", t2 - t1),
                         ("update_ms", t3 - t2)):
                timings.setdefault(k, []).append(v * 1e3)
        return loss

    step()                                     # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    library.reset_launches()
    loss = step()
    torch.cuda.synchronize()
    launches = dict(library.launches)
    by_radius = dict(library.cost_lookup_by_radius)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t) * 1e3)
    for _ in range(2):
        step(split)
    res = {"phase": "pretrain", "image_size": [H, W], "batch": B,
           "dtype": "float32", "encoder_depth": cfg.encoder_depth,
           "latent_tokens": cfg.cost_latent_token_num,
           "query_num": cfg.query_num, "gt_r": cfg.gt_r,
           "mask_ratio": cfg.mask_ratio,
           "weights": f"{WEIGHTS} (FlowFormer++ leaves) + pretrain head "
                      f"seeded {PRETRAIN_HEAD_SEED}",
           "data": "CADataset + FlowAugmentor over demo_data",
           "read_ms_per_sample": read_ms, "loss": float(loss.detach()),
           "finite": bool(torch.isfinite(loss).item()),
           "warm_step_ms": warm, "split_ms": split, "peak_mem_gib": peak,
           "launches": launches, "cost_lookup_by_radius": by_radius,
           "card": smi}
    bad = {k: launches.get(k) for k, n in EXPECT_PRETRAIN_LAUNCHES.items()
           if launches.get(k) != n}
    bad.update({f"r={r}": by_radius.get(r)
                for r, n in EXPECT_PRETRAIN_RADII.items()
                if by_radius.get(r) != n})
    if not res["finite"] or bad:
        emit(res)
        raise RuntimeError(f"pretrain: loss finite {res['finite']}, "
                           f"launches off {bad}")
    with torch.no_grad():
        captured = _capture_kernel_inputs(
            lambda: model(a, b, noise, qnoise))
    rows, detail = pretrain_kernel_rows(captured, launches, by_radius)
    bad = sorted({d["kernel"] for d in detail
                  if not d["max_abs_err"] <= d["tol"]})
    off = [r["name"] for r in rows if r["calls_captured"] != r["launches"]]
    res.update(kernels=detail, ok=not bad and not off)
    emit(res)
    if bad or off:
        raise RuntimeError(f"pretrain: kernels disagree with their plain "
                           f"versions {bad}; calls off {off}")
    del model, params, opt, captured, a, b, noise, qnoise
    torch.cuda.empty_cache()
    return rows


# --------------------------- data parallelism --------------------------------

DP_RANKS = 2
# each data-parallel run against one process on the card, on the same global
# batch of two pairs: the all-reduced gradient (every leaf's max |diff| by
# the largest |g| of all, 1e-5), grad_norm and the losses
# relative, and after the AdamW update the share of elements off by more
# than 0.01 lr0 (an element whose gradient is near eps may flip its sign:
# 2 lr0 apart). The card aligns a pair at batch 1 a little differently than
# at batch 2 (other convolution and GEMM algorithms; `batch_numerics` reads
# it: the flow, the offsets, the occlusion mask's flips), which the hard
# thresholds carry into the gradient (ROADMAP C1). So each run is held
# at DP_EXACT_TOL to the one-process step at its own per-rank
# shapes: nccl_1 (one rank of two pairs) to the batch-2 step, gloo_2 (two
# ranks of one pair) to `per_pair`, one process aligning each pair at batch
# 1 with the loss over both pairs' outputs (no collective, no surrogate).
# gloo_2 against the batch-2 step is held at about 10x its reading (PERF.md)
DP_EXACT_TOL = {"grad_rel": 1e-5, "grad_norm_rel": 1e-5, "loss_rel": 1e-5,
                "updated_off_share": 1e-3}
DP_TRAIN_TOL = {
    "nccl_1 vs batch2": DP_EXACT_TOL,
    "gloo_2 vs per_pair": DP_EXACT_TOL,
    "gloo_2 vs batch2": {"grad_rel": 3e-2, "grad_norm_rel": 4e-4,
                         "loss_rel": 6e-5, "updated_off_share": 5e-2},
}
DP_LR0 = 3.125e-6 / 25          # OptimConfig()'s first one-cycle rate
DP_REFERENCES = ("batch2", "per_pair")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _torchrun(nproc, argv, cwd, timeout=600):
    """python -m torch.distributed.run with `nproc` ranks on this host
    (localhost rendezvous on a free port); the output goes to
    chiprun_out/ if it exists. Raises on a non-zero exit."""
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc_per_node", str(nproc), "--nnodes", "1",
           "--master_addr", "localhost", "--master_port",
           str(_free_port()), *argv]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    log_dir = os.path.join(REPO, "chiprun_out")
    if os.path.isdir(log_dir):
        with open(os.path.join(log_dir, "torchrun.log"), "a") as f:
            f.write(f"$ {' '.join(cmd)}\n{out.stdout}\n{out.stderr}\n")
    if out.returncode != 0:
        raise RuntimeError(f"torchrun {argv[:2]} exited {out.returncode}: "
                           f"{out.stderr[-2000:]}")
    return secs


def _dp_pairs(device="cuda"):
    """The first DP_RANKS committed synthetic pairs at 512^2 (the global
    batch)."""
    import torch

    from stitchax_torch.data.udis import UDISDataset

    ds = UDISDataset(os.path.join(REPO, SYNTH), phase="testing",
                     size=(TRAIN_SIZE, TRAIN_SIZE))
    items = [ds[i] for i in range(DP_RANKS)]
    return [torch.from_numpy(np.stack([it[k] for it in items])).to(device)
            for k in ("image1", "image2")]


def _dp_compare(grads, params, metrics, ref):
    """One run's gradient, updated tensors and metrics against a reference
    (`_dp_reference`)."""
    top = max(g.abs().max().item() for g in ref["grads"].values())
    worst, own, worst_leaf = 0.0, 0.0, None
    for k, g in ref["grads"].items():
        d = (grads[k].cpu() - g).abs().max().item()
        worst = max(worst, d / top)
        r = d / max(g.abs().max().item(), 1e-6 * top)
        if r >= own:
            own, worst_leaf = r, k
    upd, off, n = 0.0, 0, 0
    for k, p in ref["params"].items():
        d = (params[k].detach().cpu() - p).abs()
        upd = max(upd, d.max().item() / DP_LR0)
        off += int((d > 0.01 * DP_LR0).sum())
        n += d.numel()
    return {"grad_rel": worst, "grad_leaf_rel_own_scale": own,
            "worst_leaf": worst_leaf,
            "grad_norm_rel": abs(metrics["grad_norm"] - ref["metrics"][
                "grad_norm"]) / ref["metrics"]["grad_norm"],
            "loss_rel": max(abs(metrics[k] - v) / abs(v) for k, v in
                            ref["metrics"].items() if k != "grad_norm"),
            "updated_lr0": upd, "updated_off_share": off / n}


def _dp_train_rank(out_dir, backend):
    """A rank of `dp_train` (started by torch.distributed.run): the
    alignment step over its block of the global batch through
    make_parallel_train_step; rank 0 holds its all-reduced gradient, its
    updated tensors and its metrics against each reference in out_dir and
    writes out_dir/<backend>_<world>.json."""
    import torch

    from stitchax_torch.parallel import (all_reduce_mean_, make_mesh,
                                         make_parallel_train_step,
                                         shard_batch)
    from stitchax_torch.utils.precision import fp32_exact

    world = make_mesh(backend=backend, device="cuda:0")
    fp32_exact()
    _, state, step, _ = _train_models()
    block = shard_batch(tuple(_dp_pairs()), world)
    _, grads = step.loss_and_grads(state, *block, world=world)
    all_reduce_mean_(list(grads.values()), world)
    pstep = make_parallel_train_step(step, world)
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, metrics = pstep(state, *block)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3
    if world.is_main:
        m = {k: float(v) for k, v in metrics.items()}
        res = {"backend": world.backend, "world": world.size,
               "batch_per_rank": block[0].shape[0], "metrics": m,
               "step_ms": step_ms,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        for name in DP_REFERENCES:
            ref = torch.load(os.path.join(out_dir, f"ref_{name}.pt"),
                             weights_only=True)
            res[f"vs_{name}"] = _dp_compare(grads, state.params, m, ref)
            del ref
        with open(os.path.join(out_dir, f"{world.backend}_{world.size}.json"),
                  "w") as f:
            json.dump(res, f)
    world.barrier()
    torch.distributed.destroy_process_group()
    return 0


def _batch_numerics(homo, flow, a, b):
    """The first pair aligned alone (batch 1) against within the batch on
    the card, without gradient: the last flow's max |diff|, the
    homography offsets' and the occlusion mask's flipped pixels."""
    import torch

    from stitchax_torch.align.adapter import AlignConfig
    from stitchax_torch.train.trainer import (align_train_forward,
                                              occlusion_mask)

    cfg = AlignConfig()
    with torch.no_grad():
        one = align_train_forward(homo, flow, a[:1], b[:1], cfg)
        both = align_train_forward(homo, flow, a, b, cfg)
        occ1 = occlusion_mask(flow, one, a[:1], cfg)
        occ2 = occlusion_mask(flow, both, a, cfg)
    return {"flow_max_abs_px": (one["flow_predictions"][-1]
                                - both["flow_predictions"][-1][:1]
                                ).abs().max().item(),
            "offsets_max_abs": (one["offsets"] - both["offsets"][:1]
                                ).abs().max().item(),
            "occlusion_flips": int((occ1 != occ2[:1]).sum().item())}


def _per_pair_loss_and_grads(state, homo, flow, a, b):
    """One process, the ranks' shapes: each pair aligned (and its occlusion
    mask found) at batch 1, the loss over both pairs' outputs concatenated,
    one backward. (losses, {name: gradient})."""
    import torch

    from stitchax_torch.align.adapter import AlignConfig
    from stitchax_torch.train.losses import (LossConfig,
                                             sequence_alignment_loss)
    from stitchax_torch.train.trainer import (align_train_forward,
                                              occlusion_mask)

    cfg = AlignConfig()
    fwds = [align_train_forward(homo, flow, a[j:j + 1], b[j:j + 1], cfg)
            for j in range(a.shape[0])]
    occ = torch.cat([occlusion_mask(flow, f, a[j:j + 1], cfg)
                     for j, f in enumerate(fwds)])
    preds = [torch.cat(p) for p in zip(*(f["flow_predictions"]
                                         for f in fwds))]
    losses = sequence_alignment_loss(
        a, torch.cat([f["output_H"] for f in fwds]), preds, occ,
        LossConfig())
    names = list(state.params)
    grads = torch.autograd.grad(losses["total"],
                                [state.params[k] for k in names],
                                allow_unused=True)
    return ({k: v.detach() for k, v in losses.items()},
            {k: torch.zeros_like(state.params[k]) if g is None else g
             for k, g in zip(names, grads)})


def _dp_reference(state, metrics, grads):
    """{grads, the tensors after one clip + AdamW update from the fresh
    state, metrics with grad_norm}, on the host; the state is not
    changed."""
    import torch

    from stitchax_torch.train.optim import (OptimConfig, fetch_optimizer,
                                            global_norm)

    tx = fetch_optimizer(OptimConfig())
    updates, _ = tx.update(grads, tx.init(state.params), state.params)
    with torch.no_grad():
        norm = float(global_norm(list(grads.values())))
        params = {k: (p.detach() + updates[k]).cpu()
                  for k, p in state.params.items()}
    return {"grads": {k: g.cpu() for k, g in grads.items()},
            "params": params,
            "metrics": {**{k: float(v) for k, v in metrics.items()},
                        "grad_norm": norm}}


def dp_train_phase():
    """Two ranks on the card (gloo, one pair each) through
    make_parallel_train_step, then one rank over nccl through the same
    wrapper, held to one process on the same global batch (DP_TRAIN_TOL):
    its batch-2 step, and the same pairs aligned at batch 1 each
    (`_per_pair_loss_and_grads`); with the card's batch-1 against batch-2
    numerics of the first pair."""
    import shutil
    import tempfile

    import torch

    _, state, step, (homo, flow) = _train_models()
    a, b = _dp_pairs()
    numerics = _batch_numerics(homo, flow, a, b)
    out_dir = tempfile.mkdtemp(prefix="stitchax_dp_")
    try:
        ref = _dp_reference(state, *step.loss_and_grads(state, a, b))
        one_process = ref["metrics"]
        torch.save(ref, os.path.join(out_dir, "ref_batch2.pt"))
        ref = _dp_reference(state, *_per_pair_loss_and_grads(
            state, homo, flow, a, b))
        torch.save(ref, os.path.join(out_dir, "ref_per_pair.pt"))
        del state, step, ref, a, b, homo, flow
        torch.cuda.empty_cache()
        runs = {}
        for backend, nproc in (("gloo", DP_RANKS), ("nccl", 1)):
            secs = _torchrun(nproc, [os.path.join(REPO, "chip_smoke.py"),
                                     "--dp-train-rank", out_dir, backend],
                             cwd=out_dir)
            with open(os.path.join(out_dir, f"{backend}_{nproc}.json")) as f:
                runs[f"{backend}_{nproc}"] = {**json.load(f),
                                              "command_s": secs}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    res = {"phase": "dp_train", "image_size": TRAIN_SIZE,
           "global_batch": DP_RANKS, "dtype": "float32",
           "one_process": one_process, "batch_numerics": numerics,
           "runs": runs, "tol": DP_TRAIN_TOL}
    misses = []
    for check, tol in DP_TRAIN_TOL.items():
        run, ref = check.split(" vs ")
        got = runs[run][f"vs_{ref}"]
        misses += [f"{check}: {k}" for k, t in tol.items() if not got[k] <= t]
    res["ok"] = not misses
    emit(res)
    if misses:
        raise RuntimeError(f"dp_train: outside tolerance: {misses}")


def _dp_evaluate_rank(out_json, argv):
    """A rank of `dp_evaluate`'s second run: stitchax_torch.evaluate's main
    with its per-pair results recorded; rank 0 writes them to out_json."""
    import stitchax_torch.evaluate as ev

    per_pair = []
    validate = ev.validate_with_model
    ev.validate_with_model = lambda *a, **kw: validate(
        *a, per_pair=per_pair, **kw)
    rc = ev.main(argv)
    if os.environ.get("RANK", "0") == "0":
        with open(out_json, "w") as f:
            json.dump({"per_pair": per_pair}, f)
    return rc


def dp_evaluate_phase(one_card):
    """`python -m stitchax_torch.evaluate` under torch.distributed.run with
    two ranks on the card (gloo) over the committed 12-pair split, batch
    12, then the same CLI's main with the per-pair results recorded. The
    card aligns a pair at batch 6 a little differently than at batch 12
    (other convolution algorithms, and the coverage is a hard threshold,
    ROADMAP C5), so the two-rank run is held bit-equal to a one-card run at
    the ranks' own batch (6): its report and every pair's PSNR / SSIM, in
    the one-card order. Against the one-card batch-12 run (`evaluate`) it
    must differ exactly as the one-card batch-6 run does."""
    import shutil
    import tempfile

    import torch

    from stitchax_torch.align.adapter import AlignConfig
    from stitchax_torch.data.udis import PrefetchLoader, UDISDataset
    from stitchax_torch.evaluate import load_models, validate_with_model

    report_b12, pairs_b12 = one_card
    ds = UDISDataset(os.path.join(REPO, SYNTH), phase="testing",
                     size=(512, 512))
    pairs_b6 = []
    report_b6 = validate_with_model(
        {}, PrefetchLoader(ds, batch_size=EVAL_BATCH // DP_RANKS,
                           num_workers=12),
        load_models(CKPT, "cuda"), AlignConfig(), per_pair=pairs_b6)
    torch.cuda.empty_cache()
    argv = ["--data_dir", os.path.join(REPO, SYNTH), "--ckpt_path", CKPT,
            "--device", "cuda:0", "--backend", "gloo"]
    work = tempfile.mkdtemp(prefix="stitchax_dp_eval_")
    try:
        cli_s = _torchrun(DP_RANKS, ["-m", "stitchax_torch.evaluate", *argv],
                          cwd=work)
        with open(os.path.join(work, "eval_result.json")) as f:
            report = json.load(f)
        out_json = os.path.join(work, "per_pair.json")
        _torchrun(DP_RANKS, [os.path.join(REPO, "chip_smoke.py"),
                             "--dp-evaluate-rank", out_json, "--", *argv],
                  cwd=work)
        with open(out_json) as f:
            pairs = [tuple(p) for p in json.load(f)["per_pair"]]
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def diff(a, b):
        return {"names_equal": [p[0] for p in a] == [p[0] for p in b],
                "psnr_max_abs": max(abs(x[1] - y[1]) for x, y in zip(a, b)),
                "ssim_max_abs": max(abs(x[2] - y[2]) for x, y in zip(a, b)),
                "bit_equal": a == b}

    one, b6 = [tuple(p) for p in pairs_b12], [tuple(p) for p in pairs_b6]
    res = {"phase": "dp_evaluate", "ranks": DP_RANKS, "backend": "gloo",
           "batch": EVAL_BATCH, "pairs": len(pairs), "cli_s": cli_s,
           "report": report,
           "report_equals_one_card_batch6": report == report_b6,
           "report_equals_one_card_batch12": report == report_b12,
           "vs_one_card_batch6": diff(pairs, b6),
           "vs_one_card_batch12": diff(pairs, one),
           "one_card_batch6_vs_batch12": diff(b6, one)}
    res["ok"] = (res["report_equals_one_card_batch6"]
                 and res["vs_one_card_batch6"]["bit_equal"]
                 and res["vs_one_card_batch12"]["names_equal"]
                 and res["vs_one_card_batch12"]
                 == res["one_card_batch6_vs_batch12"])
    emit(res)
    if not res["ok"]:
        raise RuntimeError("dp_evaluate: the two-rank evaluation is not the "
                           "one-card evaluation")


def main() -> int:
    import torch

    args = sys.argv[1:]
    if args[:1] == ["--dp-train-rank"]:          # a rank of dp_train
        return _dp_train_rank(args[1], args[2])
    if args[:1] == ["--dp-evaluate-rank"]:       # a rank of dp_evaluate
        return _dp_evaluate_rank(args[1], args[3:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    from stitchax_torch.ops.kernels import library
    b = library.ensure_built()
    emit({"phase": "build", "built": b is not None,
          **(b or {"path": str(library.library_path())})})

    img1, img2 = seeded_pair()
    if args[:1] == ["--profile"]:
        config = FAST
        if "--config" in args:
            i = args.index("--config")
            config = args[i + 1]
            del args[i:i + 2]
        profile_phase(img1, img2, args[1] if len(args) > 1 else None, config)
        return 0
    launches, tps_inputs = {}, {}
    for config in (FAST, DEFAULT, DIFFUSION):
        launches[config], tps_inputs[config] = stitch_phase(img1, img2,
                                                            config)
        torch.cuda.empty_cache()

    rows, detail = kernel_rows(tps_inputs, launches)
    bad = sorted({d["kernel"] for d in detail
                  if not d["max_abs_err"] <= d["tol"]})
    emit({"phase": "kernels", "card": smi, "calls": detail,
          "ok": not bad})
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{bad}")

    eval_rows, eval_detail = eval_kernel_rows()
    bad = sorted({d["kernel"] for d in eval_detail
                  if not d["max_abs_err"] <= d["tol"]})
    emit({"phase": "kernels_evaluation", "card": smi, "calls": eval_detail,
          "per_batch": eval_rows, "ok": not bad})
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions at "
                           f"the evaluation's shapes: {bad}")
    for row in rows:
        if row["name"] in eval_rows:
            row["evaluation"] = eval_rows[row["name"]]

    stitch_vs_cpu_phase(img1, img2)
    stitch_vs_cpu_default_phase(img1, img2)
    stitch_vs_stitchax_phase()
    stitch_vs_stitchax_bf16_phase()
    sd_vs_stitchax_phase()
    jpeg_phase()
    cli_phase()
    one_card_evaluation = evaluate_phase()
    sd15_widths_phase()

    step_launches = train_vs_stitchax_phase()
    train_rows = kernels_backward_phase(smi, *step_launches)
    split = train_phase()
    transref_train_vs_stitchax_phase()
    transref_train_phase()
    sd_train_vs_stitchax_phase()
    sd_train_phase()
    na_flowformer_phase()
    pretrain_vs_stitchax_phase()
    pretrain_rows = pretrain_phase(smi)
    dp_train_phase()
    dp_evaluate_phase(one_card_evaluation)
    for row in rows:
        if row["name"] in train_rows:
            row["train"] = {**train_rows[row["name"]],
                            "step_split_ms": split}
    rows += pretrain_rows

    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
