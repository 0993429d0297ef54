"""Build, load and count the port's hand-written CUDA kernels.

All sources in `stitchax_torch/csrc/*.cu` have a plain `extern "C"`
interface and no PyTorch headers, so `nvcc` compiles each in seconds (not
the minutes a PyTorch-extension build takes), one process per source, all
at once, and links them into one shared library, which is loaded with
`ctypes`. The build runs at first use, into
`stitchax_torch/_build/` (gitignored), keyed by a hash of the sources.
Nothing is built or loaded at import time: the module imports on machines
without `nvcc` or a GPU, where only the plain PyTorch versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# dtype codes of the C interface (csrc/common.cuh)
FLOAT32, BFLOAT16 = 0, 1

# launches of each kernel, bumped by its wrapper right after a launch
launches: Dict[str, int] = {"gsa_attention": 0, "cost_lookup": 0,
                            "tps_grid": 0, "window_attention": 0}
# of those, the launches made by an autograd Function's forward (under grad)
grad_launches: Dict[str, int] = dict(launches)
# K3's launches by lookup radius (r = 4 in the decoder, r = 7 for the MAE
# pretrain targets)
cost_lookup_by_radius: Dict[int, int] = {}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = grad_launches[k] = 0
    cost_lookup_by_radius.clear()


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha1()
    for p in sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libstitchax_kernels_{_digest()}.so"


def find_nvcc() -> str:
    cand = [os.path.join(os.environ[v], "bin", "nvcc")
            for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    which = shutil.which("nvcc")
    if which:
        cand.append(which)
    cand.append("/usr/local/cuda/bin/nvcc")
    for c in cand:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the stitchax_torch "
                       "CUDA kernels cannot be built")


def build() -> dict:
    """Compile every csrc/*.cu, one nvcc process per source, all started
    together, then link the objects into one .so. Returns {cmds, link,
    seconds, path, ptxas}; raises on failure."""
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = find_nvcc()
    flags = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    cmds = [[nvcc, *flags, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources(), objs)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    failed = [(c, p.returncode, log) for c, p, log in zip(cmds, procs, logs)
              if p.returncode != 0]
    tmp = out.with_suffix(f".{tag}")
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
            *[str(o) for o in objs]]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append((link, proc.returncode, proc.stdout + proc.stderr))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{' '.join(c)} ({rc}):\n{log}" for c, rc, log in failed))
    secs = time.perf_counter() - t0
    os.replace(tmp, out)
    ptxas = [ln.strip() for ln in "".join(logs).splitlines()
             if re.search(r"Compiling entry|Used \d+ registers|spill", ln)]
    return {"cmds": [" ".join(c) for c in cmds], "link": " ".join(link),
            "seconds": secs, "path": str(out), "ptxas": ptxas}


def ensure_built() -> Optional[dict]:
    """Build the library unless these sources are built already. Returns
    the build's record (see `build`), or None when nothing was built."""
    return None if library_path().exists() else build()


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    ensure_built()
    lib = ctypes.CDLL(str(library_path()))
    vp, ci, cf, cl = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_longlong)
    lib.stx_gsa_attention.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                      ci, vp]
    lib.stx_cost_lookup.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci,
                                    vp]
    lib.stx_tps_grid.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, cf, cf, vp]
    lib.stx_window_attention.argtypes = [vp] * 7 + [ci] * 6 + [cl] * 5 + [
        ci, vp]
    for fn in (lib.stx_gsa_attention, lib.stx_cost_lookup, lib.stx_tps_grid,
               lib.stx_window_attention):
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def dtype_code(dtype) -> int:
    if dtype == torch.float32:
        return FLOAT32
    if dtype == torch.bfloat16:
        return BFLOAT16
    raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def plain_backward(plain, saved, needs, grad_out, **kwargs):
    """The gradients of a kernel's plain version, as its autograd backward
    returns them: `plain(*saved, **kwargs)` is recomputed under autograd
    and differentiated against `grad_out` for the inputs whose `needs` is
    true (None for the others). stitchax differentiates its kernels the
    same way: the custom_vjp of each Pallas kernel takes the VJP of its
    XLA oracle."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        out = plain(*xs, **kwargs)
        grads = iter(torch.autograd.grad(
            out, [x for x, n in zip(xs, needs) if n], grad_out))
    return tuple(next(grads) if n else None for n in needs)


def needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def require_cuda(name: str, *tensors) -> None:
    """A kernel wrapper takes CUDA tensors only from here on: contiguous,
    on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
