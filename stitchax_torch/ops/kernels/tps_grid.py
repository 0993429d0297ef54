"""K2: dense TPS grid evaluation (csrc/tps_grid.cu).

Port of `tps_eval_grid_pallas` (stitchax/ops/pallas/tps_kernel.py:53). No
padding of the centers is needed on the GPU; zero-weight centers still drop
out exactly.
"""

from __future__ import annotations

import torch

from . import library

VARIANTS = ("opencv", "kornia")


def u_kernel(d2: torch.Tensor, variant: str = "opencv") -> torch.Tensor:
    """Radial basis U on squared distances (stitchax/tps/solve.py:50)."""
    if variant == "kornia":
        return 0.5 * d2 * torch.log(d2 + 1e-8)
    return d2 * torch.log(torch.clamp(d2, min=1e-9)) * (d2 > 0)


def tps_grid_plain(ctrl: torch.Tensor, kernel_w: torch.Tensor,
                   affine_w: torch.Tensor, out_h: int, out_w: int,
                   variant: str = "opencv", kernel_scale: float = 1.0,
                   affine_scale: float = 1.0) -> torch.Tensor:
    """ctrl (N, 2) in [0, 1], kernel_w (N, 2), affine_w (3, 2) ->
    (out_h, out_w, 2) fp32 at p = (x/out_w, y/out_h); materializes the
    (H*W, N) basis (the oracle `tps_eval_grid_ref`, :91)."""
    dev = ctrl.device
    ys, xs = torch.meshgrid(torch.arange(out_h, device=dev, dtype=torch.float32),
                            torch.arange(out_w, device=dev, dtype=torch.float32),
                            indexing="ij")
    p = torch.stack([xs / out_w, ys / out_h], -1).reshape(-1, 2)
    d = p[:, None, :] - ctrl.float()[None, :, :]
    U = u_kernel((d * d).sum(-1), variant)
    A = torch.cat([torch.ones_like(p[:, :1]), p], 1)
    m = kernel_scale * (U @ kernel_w.float()) + affine_scale * (A @ affine_w.float())
    return m.reshape(out_h, out_w, 2)


def tps_grid(ctrl: torch.Tensor, kernel_w: torch.Tensor,
             affine_w: torch.Tensor, out_h: int, out_w: int,
             variant: str = "opencv", kernel_scale: float = 1.0,
             affine_scale: float = 1.0) -> torch.Tensor:
    if ctrl.device.type == "cpu":
        return tps_grid_plain(ctrl, kernel_w, affine_w, out_h, out_w, variant,
                              kernel_scale, affine_scale)
    if variant not in VARIANTS:
        raise ValueError(f"tps_grid: unknown variant {variant!r}")
    library.require_cuda("tps_grid", ctrl, kernel_w, affine_w)
    N = ctrl.shape[0]
    if (ctrl.shape != (N, 2) or kernel_w.shape != (N, 2)
            or affine_w.shape != (3, 2)):
        raise ValueError("tps_grid: expected ctrl/kernel_w (N, 2), "
                         "affine_w (3, 2)")
    for t in (ctrl, kernel_w, affine_w):
        if t.dtype != torch.float32:
            raise TypeError("tps_grid: float32 inputs only")
    out = torch.empty((out_h, out_w, 2), device=ctrl.device,
                      dtype=torch.float32)
    lib = library.load_library()
    err = lib.stx_tps_grid(
        ctrl.data_ptr(), kernel_w.data_ptr(), affine_w.data_ptr(),
        out.data_ptr(), N, out_h, out_w, int(variant == "kornia"),
        float(kernel_scale), float(affine_scale), library.stream_of(ctrl))
    library.check(err, "tps_grid")
    library.launches["tps_grid"] += 1
    return out
