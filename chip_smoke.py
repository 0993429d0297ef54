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
  kernels                each kernel against its plain PyTorch version at
                         the shapes the stitches gave it: max |diff|, kernel
                         / plain / library ms by CUDA events, the kernel's
                         and the library call's device time per call from
                         the profiler, and the least time the card could
                         take (bound_ms)
  stitch_vs_cpu          the fast_cv_g8 stitch in fp32 on the card and on
                         the CPU, compared
  stitch_vs_cpu_default  the same for the default configuration, down to
                         the composition and the learned masks
  stitch_vs_stitchax     the fast_cv_g8 stitch of demo_data/demo1 and demo2
                         in fp32 on the card against stitchax's own outputs
                         (its jitted Stitcher on the CPU), committed in
                         tests/torch_reference/demo_stitchax_fp32.npz with
                         the decoded input images

Then the kernel table (one JSON object), the nvidia-smi line, and the final
`{"ok": true, "device": ...}` line. Any failed phase exits non-zero without
the final line. Imports nothing of JAX or of the JAX package.

    python3 chip_smoke.py --profile [TRACE.json] [--config NAME]

instead traces one warm bf16 stitch of the same pair (with fast_cv_g8, or
the named configuration) with torch.profiler and prints where the device
time goes (top kernels by device time, the device's busy share of the
stitch), optionally writing a Chrome trace.
"""

from __future__ import annotations

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
FAST, DEFAULT = "fast_cv_g8", "all_img1_with_inpaint_g12_transRef"
REFERENCE = "tests/torch_reference/demo_stitchax_fp32.npz"
DEMO_PAIRS = ("demo1", "demo2")
SEED = 0
PAIR_HW = (384, 448)            # the demo pair's size

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and flop/s by type
HBM_BPS = 3.35e12
PEAK = {"bf16": 989e12, "fp32": 67e12}

# kernel vs plain version on the same inputs, at main-path shapes. K1
# (gsa_attention) and K4 (window_attention, in bf16) are held to one bf16
# ulp of their largest |output| (`bf16_ulp`): both versions take the
# softmax and the sums in fp32 and differ only in summation order before
# the one rounding to bf16.
TOL = {
    # K1 in fp32 (exact fp32 on the CUDA cores): summation order only
    "gsa_attention_fp32": 2e-5,
    # K4 in fp32: summation order only
    "window_attention_fp32": 2e-5,
    # every product and sum rounded on its own in both: bit-equal
    "cost_lookup": 0.0,
    # fp32 log and accumulation over N centers, order and fma differences
    # (a few fp32 ulps of the [0, 1] map; an H100 read 3.6e-7, PERF.md)
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms of fn() over `iters` launches, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20):
    """Mean device time of one fn() call in ms, from the profiler: the sum
    of the device activities (kernels, copies, sets) it recorded over
    `iters` calls. Unlike `cuda_time`, host gaps between launches do not
    count. None where the profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None
    return sum(e.time_range.end - e.time_range.start
               for e in dev) / 1e3 / iters


def _add(total, x, n=1):
    """Sum per-call device times over calls; None (not measured) spreads."""
    return None if total is None or x is None else total + n * x


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def bound_ms(nbytes: float, nflops: float, peak: float):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = nflops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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
# launches per stitch of either configuration (same 512^2 align); the TPS
# grid (K2) launches at least once
EXPECT_LAUNCHES = {"gsa_attention": 9, "cost_lookup": 12,
                   "window_attention": 9}


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
                dev_ms = _add(dev_ms, d_k, calls)
                lib_dev_ms = _add(lib_dev_ms, d_l, calls)
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
    K2 row is the default configuration's. `launches` are the default
    configuration's per stitch. Returns the kernel table rows and one entry
    per call shape, each with its tolerance."""
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
        dev_ms = _add(dev_ms, d_k, calls)
        lib_dev_ms = _add(lib_dev_ms, d_l, calls)
        ms += calls * t_k
        plain += calls * t_p
        lib += calls * t_l
        bnd += calls * b
        bound_share[by] += calls * b
    rows.append({"name": "gsa_attention", "route": "cuda",
                 "source": "stitchax_torch/csrc/gsa_attention.cu",
                 "replaces": "stitchax/ops/pallas/gsa_attention.py:51",
                 "launches": launches["gsa_attention"],
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
                 "launches": launches["cost_lookup"], "max_abs_err": e,
                 "ms": DECODER_ITERS * t_k,
                 "device_ms": _add(0.0, d_k, DECODER_ITERS),
                 "plain_ms": DECODER_ITERS * t_p,
                 "bound_ms": DECODER_ITERS * b, "bound_by": by,
                 "library_ms": DECODER_ITERS * t_l,
                 "library_device_ms": _add(0.0, d_l, DECODER_ITERS)})

    # K2, at each configuration's canvas and control points
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
        # per (pixel, center): 2 sub + 3 for d2 + log + 2 mul + 2 fma ~ 12
        b, by = bound_ms(N * 16 + 24 + out_h * out_w * 8,
                         12.0 * out_h * out_w * N, PEAK["fp32"])
        detail.append({"kernel": "tps_grid", "config": config, "N": N,
                       "out_h": out_h, "out_w": out_w, "calls": 1,
                       "max_abs_err": e, "tol": TOL["tps_grid"], "ms": t_k,
                       "device_ms": d_k, "plain_ms": t_p, "bound_ms": b,
                       "bound_by": by})
    rows.append({"name": "tps_grid", "route": "cuda",
                 "source": "stitchax_torch/csrc/tps_grid.cu",
                 "replaces": "stitchax/ops/pallas/tps_kernel.py:53",
                 "launches": launches["tps_grid"], "max_abs_err": e,
                 "ms": t_k, "device_ms": d_k, "plain_ms": t_p,
                 "bound_ms": b, "bound_by": by, "library_ms": None,
                 "library_device_ms": None})

    # K4
    row, more = window_rows(g, launches)
    rows.append(row)
    detail += more
    return rows, detail


# ------------------------------- stitch --------------------------------------

def build_models(dtype, device, config=FAST):
    """The configuration's models with trained weights (tracked in the
    repo): ckpt_r05's flow and homo nets, and for the default configuration
    its comp net and the TransRef checkpoint. Raises if the checkout lacks
    them."""
    from stitchax_torch.run.stitcher import StitchModels
    default = config == DEFAULT
    for path in [CKPT] + ([TRANSREF_CKPT] if default else []):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{path} is missing: the smoke stitches "
                                    "with the trained weights")
    return StitchModels.from_npz(CKPT, device, dtype, config,
                                 transref=TRANSREF_CKPT if default else None)


def check_finite(out) -> None:
    for k, v in out.items():
        if v.dtype.kind == "f" and not np.isfinite(v).all():
            raise RuntimeError(f"stitch output {k} is not finite")


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
    check_finite(out)
    if (any(n == 0 for n in launches.values())
            or any(launches[k] != n for k, n in EXPECT_LAUNCHES.items())):
        raise RuntimeError(f"{config}: kernel launches per stitch "
                           f"{launches}, expected {EXPECT_LAUNCHES} and "
                           "tps_grid >= 1")
    res = {"phase": "stitch" if config == FAST else "stitch_default",
           "config": config, "dtype": "bfloat16", "weights": WEIGHTS,
           "weights_load_s": load_s, "pair_hw": list(PAIR_HW),
           "stitch_ms": total_ms, **timings, "first_call": warm,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "canvas_hw": out["canvas_hw"].tolist(),
           "true_hw": out["true_hw"].tolist(),
           "control_points": int(out["control_valid"].size),
           "control_valid": int(out["control_valid"].sum()),
           "mask2_mean": float(out["mask2"].mean()),
           "launches_per_stitch": launches}
    if config == DEFAULT:
        res["transref_weights"] = TRANSREF_WEIGHTS
        res["composition_hw"] = list(out["composition"].shape[:2])
        res["learned_mask1_mean"] = float(out["learned_mask1"].mean())
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


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile_phase(img1, img2, trace_path=None, config=FAST) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stitchax_torch.run.stitcher import Stitcher

    models = build_models(torch.bfloat16, "cuda", config)
    stitcher = Stitcher(models, device="cuda", config=config)
    stitcher.stitch(img1, img2)                          # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        timings = {}
        stitcher.stitch(img1, img2, timings=timings)
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in dev])

    def self_device_us(a):
        return getattr(a, "self_device_time_total",
                       getattr(a, "self_cuda_time_total", 0.0))

    top = sorted(prof.key_averages(), key=lambda a: -self_device_us(a))[:25]
    emit({"phase": "profile", "config": config, "weights": WEIGHTS,
          "stitch_ms": wall_us / 1e3,
          **timings, "device_events": len(dev),
          "device_busy_ms": busy / 1e3 if dev else None,
          "device_busy_share": busy / wall_us if dev else None,
          "top_self_device_ms": [
              {"name": a.key[:120], "count": a.count,
               "ms": self_device_us(a) / 1e3} for a in top]})
    if trace_path:
        prof.export_chrome_trace(trace_path)


def main() -> int:
    import torch

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
    args = sys.argv[1:]
    if args[:1] == ["--profile"]:
        config = FAST
        if "--config" in args:
            i = args.index("--config")
            config = args[i + 1]
            del args[i:i + 2]
        profile_phase(img1, img2, args[1] if len(args) > 1 else None, config)
        return 0
    _, tps_fast = stitch_phase(img1, img2, FAST)
    launches, tps_default = stitch_phase(img1, img2, DEFAULT)

    rows, detail = kernel_rows({FAST: tps_fast, DEFAULT: tps_default},
                               launches)
    bad = sorted({d["kernel"] for d in detail
                  if not d["max_abs_err"] <= d["tol"]})
    emit({"phase": "kernels", "card": smi, "calls": detail,
          "ok": not bad})
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{bad}")

    stitch_vs_cpu_phase(img1, img2)
    stitch_vs_cpu_default_phase(img1, img2)
    stitch_vs_stitchax_phase()

    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
