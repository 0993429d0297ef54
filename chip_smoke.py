"""On-card smoke of the PyTorch/H100 port (stitchax_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line before the next begins:

  device         card name, count, nvidia-smi name and power limit
  build          the single nvcc call that builds every csrc/*.cu kernel
  stitch         Stitcher.stitch on a seeded 384x448 pair, bf16, on the card:
                 per-stage ms, peak memory, canvas, kernel launches per stitch
  kernels        each kernel against its plain PyTorch version at the shapes
                 the stitch gave it: max |diff|, kernel / plain / library ms,
                 and the least time the card could take (bound_ms)
  stitch_vs_cpu  the same stitch in fp32 on the card and on the CPU, compared

Then the kernel table (one JSON object), the nvidia-smi line, and the final
`{"ok": true, "device": ...}` line. Any failed phase exits non-zero without
the final line. Imports nothing of JAX or of the JAX package.

    python3 chip_smoke.py --profile [TRACE.json]

instead traces one warm bf16 stitch of the same pair with torch.profiler
and prints where the device time goes (top kernels by device time, the
device's busy share of the stitch), optionally writing a Chrome trace.
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
SEED = 0
PAIR_HW = (384, 448)            # the demo pair's size

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and flop/s by type
HBM_BPS = 3.35e12
PEAK = {"bf16": 989e12, "fp32": 67e12}

# kernel vs plain version on the same inputs, at main-path shapes. K1
# (gsa_attention) is held to one bf16 ulp of its largest |output|
# (`bf16_ulp`): both versions take the softmax and the sums in fp32 and
# differ only in summation order before the one rounding to bf16.
TOL = {
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


def kernel_rows(tps_inputs, launches):
    """Hold each kernel against its plain version on the card at the
    main-path shapes and time it. `tps_inputs` are the (ctrl, kernel_w,
    affine_w, out_h, out_w) the stitch gave K2. Returns the kernel table
    rows and one entry per call shape, each with its tolerance."""
    import torch
    import torch.nn.functional as F

    from stitchax_torch.ops.kernels import (cost_lookup, gsa_attention,
                                            tps_grid)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows, detail = [], []

    # K1
    err = ms = plain = lib = bnd = 0.0
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
        nbytes = 2 * (2 * B * N * C + 2 * B * GSA_KEYS * C)
        b, by = bound_ms(nbytes, 4.0 * B * N * GSA_KEYS * C, PEAK["bf16"])
        detail.append({"kernel": "gsa_attention", "B": B, "N": N, "C": C,
                       "heads": heads, "calls": calls, "max_abs_err": e,
                       "tol": tol, "ms": t_k, "plain_ms": t_p,
                       "library_ms": t_l, "bound_ms": b, "bound_by": by})
        err = max(err, e)
        ms += calls * t_k
        plain += calls * t_p
        lib += calls * t_l
        bnd += calls * b
        bound_share[by] += calls * b
    rows.append({"name": "gsa_attention", "route": "cuda",
                 "source": "stitchax_torch/csrc/gsa_attention.cu",
                 "replaces": "stitchax/ops/pallas/gsa_attention.py:51",
                 "launches": launches["gsa_attention"],
                 "max_abs_err": err, "ms": ms, "plain_ms": plain,
                 "bound_ms": bnd,
                 "bound_by": max(bound_share, key=bound_share.get),
                 "library_ms": lib})

    # K3
    cm = torch.randn(COST_P, COST_HW, COST_HW, device=dev,
                     generator=g).bfloat16()
    coords = (torch.rand(COST_P, 2, device=dev, generator=g)
              * (COST_HW + 12) - 6)
    got = cost_lookup.cost_lookup(cm, coords, COST_R)
    want = cost_lookup.cost_lookup_plain(cm, coords, COST_R)
    torch.cuda.synchronize()
    e = (got - want).abs().max().item()
    t_k = cuda_time(lambda: cost_lookup.cost_lookup(cm, coords, COST_R))
    t_p = cuda_time(lambda: cost_lookup.cost_lookup_plain(cm, coords, COST_R))
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
    # bytes this data needs: the in-bounds (2r+2)^2 patch of each map
    steps = torch.arange(2 * COST_R + 2, device=dev)
    f0 = torch.floor(coords).long() - COST_R
    inb = [((f0[:, i:i + 1] + steps >= 0) & (f0[:, i:i + 1] + steps < COST_HW)
            ).sum(1) for i in (0, 1)]
    touched = float((inb[0] * inb[1]).sum().item())
    win2 = (2 * COST_R + 1) ** 2
    nbytes = touched * 2 + COST_P * 2 * 4 + COST_P * win2 * 4
    nflops = COST_P * (3 * (2 * COST_R + 1) * (2 * COST_R + 2) + 3 * win2)
    b, by = bound_ms(nbytes, nflops, PEAK["fp32"])
    detail.append({"kernel": "cost_lookup", "P": COST_P, "H2": COST_HW,
                   "W2": COST_HW, "r": COST_R, "calls": DECODER_ITERS,
                   "max_abs_err": e, "tol": TOL["cost_lookup"], "ms": t_k,
                   "plain_ms": t_p, "library_ms": t_l,
                   "library_max_abs_diff": lib_diff, "bound_ms": b,
                   "bound_by": by})
    rows.append({"name": "cost_lookup", "route": "cuda",
                 "source": "stitchax_torch/csrc/cost_lookup.cu",
                 "replaces": "stitchax/ops/pallas/cost_lookup.py:121",
                 "launches": launches["cost_lookup"], "max_abs_err": e,
                 "ms": DECODER_ITERS * t_k, "plain_ms": DECODER_ITERS * t_p,
                 "bound_ms": DECODER_ITERS * b, "bound_by": by,
                 "library_ms": DECODER_ITERS * t_l})

    # K2
    ctrl, kw, aw, out_h, out_w = tps_inputs
    N = ctrl.shape[0]
    got = tps_grid.tps_grid(ctrl, kw, aw, out_h, out_w)
    want = tps_grid.tps_grid_plain(ctrl, kw, aw, out_h, out_w)
    torch.cuda.synchronize()
    e = (got - want).abs().max().item()
    t_k = cuda_time(lambda: tps_grid.tps_grid(ctrl, kw, aw, out_h, out_w))
    t_p = cuda_time(lambda: tps_grid.tps_grid_plain(ctrl, kw, aw, out_h,
                                                    out_w), iters=5)
    # per (pixel, center): 2 sub + 3 for d2 + log + 2 mul + 2 fma ~ 12 ops
    b, by = bound_ms(N * 16 + 24 + out_h * out_w * 8,
                     12.0 * out_h * out_w * N, PEAK["fp32"])
    detail.append({"kernel": "tps_grid", "N": N, "out_h": out_h,
                   "out_w": out_w, "calls": 1, "max_abs_err": e,
                   "tol": TOL["tps_grid"], "ms": t_k, "plain_ms": t_p,
                   "bound_ms": b, "bound_by": by})
    rows.append({"name": "tps_grid", "route": "cuda",
                 "source": "stitchax_torch/csrc/tps_grid.cu",
                 "replaces": "stitchax/ops/pallas/tps_kernel.py:53",
                 "launches": launches["tps_grid"], "max_abs_err": e,
                 "ms": t_k, "plain_ms": t_p, "bound_ms": b, "bound_by": by,
                 "library_ms": None})
    return rows, detail


# ------------------------------- stitch --------------------------------------

def build_models(dtype, device):
    """The stitch's models with ckpt_r05's trained weights (tracked in the
    repo); raises if the checkout lacks them."""
    from stitchax_torch.run.stitcher import StitchModels
    if not os.path.isfile(CKPT):
        raise FileNotFoundError(f"{CKPT} is missing: the smoke stitches "
                                "with the trained weights")
    return StitchModels.from_npz(CKPT, device, dtype)


def check_finite(out) -> None:
    for k, v in out.items():
        if v.dtype.kind == "f" and not np.isfinite(v).all():
            raise RuntimeError(f"stitch output {k} is not finite")


def stitch_phase(img1, img2):
    import torch

    from stitchax_torch.ops.kernels import library
    from stitchax_torch.run.stitcher import Stitcher
    from stitchax_torch.tps.solve import tps_fit

    t0 = time.perf_counter()
    models = build_models(torch.bfloat16, "cuda")
    load_s = time.perf_counter() - t0
    stitcher = Stitcher(models, device="cuda")
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
    expect = {"gsa_attention": 9, "cost_lookup": 12}
    if (any(n == 0 for n in launches.values())
            or any(launches[k] != n for k, n in expect.items())):
        raise RuntimeError(f"kernel launches per stitch {launches}, "
                           f"expected {expect} and tps_grid >= 1")
    emit({"phase": "stitch", "dtype": "bfloat16", "weights": WEIGHTS,
          "weights_load_s": load_s, "pair_hw": list(PAIR_HW),
          "stitch_ms": total_ms, **timings,
          "first_call": warm,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "canvas_hw": out["canvas_hw"].tolist(),
          "true_hw": out["true_hw"].tolist(),
          "control_points": int(out["control_valid"].size),
          "control_valid": int(out["control_valid"].sum()),
          "mask2_mean": float(out["mask2"].mean()),
          "launches_per_stitch": launches})
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


def stitch_vs_cpu_phase(img1, img2):
    """The same stitch in fp32 on the card (TF32 off) and on the CPU."""
    import copy

    import torch

    from stitchax_torch.run.stitcher import Stitcher, StitchModels
    from stitchax_torch.utils.precision import fp32_exact

    fp32_exact()
    cpu_models = build_models(torch.float32, "cpu")
    gpu_models = StitchModels(copy.deepcopy(cpu_models.flow_model),
                              copy.deepcopy(cpu_models.homo_model), "cuda",
                              torch.float32)
    t0 = time.perf_counter()
    g = Stitcher(gpu_models, device="cuda").stitch(img1, img2)
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    c = Stitcher(cpu_models, device="cpu").stitch(img1, img2)
    cpu_s = time.perf_counter() - t0
    check_finite(g)
    check_finite(c)
    fd = np.abs(g["flow"] - c["flow"])
    res = {"phase": "stitch_vs_cpu", "dtype": "float32", "weights": WEIGHTS,
           "gpu_s": gpu_s, "cpu_s": cpu_s,
           "H_max_abs": float(np.abs(g["H"] - c["H"]).max()),
           "flow_max_px": float(fd.max()), "flow_mean_px": float(fd.mean()),
           "canvas_box_px": float(np.abs(g["canvas_box"]
                                         - c["canvas_box"]).max()),
           "true_hw": [g["true_hw"].tolist(), c["true_hw"].tolist()]}
    if g["true_hw"].tolist() == c["true_hw"].tolist():
        a = g["new_blend_image"].astype(np.float64)
        b = c["new_blend_image"].astype(np.float64)
        mse = float(np.mean((a - b) ** 2))
        res["blend_psnr_db"] = (float("inf") if mse == 0
                                else 10 * np.log10(255.0 ** 2 / mse))
    else:
        res["blend_psnr_db"] = float("-inf")
    res["tol"] = STITCH_TOL
    misses = [k for k, tol in STITCH_TOL.items()
              if (res[k] < tol if k == "blend_psnr_db" else res[k] > tol)]
    res["ok"] = not misses
    emit(res)
    if misses:
        raise RuntimeError(f"card vs CPU stitch outside tolerance: {misses}")


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile_phase(img1, img2, trace_path=None) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stitchax_torch.run.stitcher import Stitcher

    models = build_models(torch.bfloat16, "cuda")
    stitcher = Stitcher(models, device="cuda")
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
    emit({"phase": "profile", "weights": WEIGHTS, "stitch_ms": wall_us / 1e3,
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
    if sys.argv[1:2] == ["--profile"]:
        profile_phase(img1, img2, sys.argv[2] if len(sys.argv) > 2 else None)
        return 0
    launches, tps_inputs = stitch_phase(img1, img2)

    rows, detail = kernel_rows(tps_inputs, launches)
    bad = sorted({d["kernel"] for d in detail
                  if not d["max_abs_err"] <= d["tol"]})
    emit({"phase": "kernels", "card": smi, "calls": detail,
          "ok": not bad})
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{bad}")

    stitch_vs_cpu_phase(img1, img2)

    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
