"""K3: decoder cost lookup (csrc/cost_lookup.cu).

Port of `cost_lookup_transposed` (stitchax/ops/pallas/cost_lookup.py:121),
held to the semantics of stitchax's production selector form
`encode_flow_token` (stitchax/models/flowformer.py:635). The GPU reads the
natural (P, H2, W2) layout; the TPU's (H2, P, W2) transpose is not needed.
Under autograd the kernel runs inside `CostLookup`, whose backward
differentiates the plain version with respect to the cost maps and the
coordinates, as stitchax's `_eft_t_bwd` does (flowformer.py:704).
"""

from __future__ import annotations

import torch

from . import library

MAX_RADIUS = 7


def cost_lookup_plain(cost_maps: torch.Tensor, coords: torch.Tensor,
                      r: int = 4) -> torch.Tensor:
    """cost_maps (P, H2, W2), coords (P, 2) xy pixel coords ->
    (P, (2r+1)^2) fp32, channel k = a*(2r+1) + t (a: x offset, t: y offset).

    Zeros out of bounds; bilinear weights rounded to the cost dtype; the
    vertical pass accumulated in fp32 and rounded to the cost dtype, the
    horizontal pass accumulated in fp32."""
    P, H2, W2 = cost_maps.shape
    dt = cost_maps.dtype
    win = 2 * r + 1
    c = coords.float()
    f0 = torch.floor(c)
    frac = c - f0
    w0 = (1.0 - frac).to(dt).float()                      # (P, 2)
    w1 = frac.to(dt).float()
    steps = torch.arange(win + 1, device=c.device, dtype=torch.float32)
    xs = f0[:, 0:1] - r + steps                          # (P, win+1)
    ys = f0[:, 1:2] - r + steps
    vx = (xs >= 0) & (xs < W2)
    vy = (ys >= 0) & (ys < H2)
    xi = xs.clamp(0, W2 - 1).long()
    yi = ys.clamp(0, H2 - 1).long()
    base = torch.arange(P, device=c.device).view(P, 1, 1) * (H2 * W2)
    idx = base + yi[:, :, None] * W2 + xi[:, None, :]     # (P, y, x)
    g = cost_maps.reshape(-1)[idx].float()
    g = g * (vy[:, :, None] & vx[:, None, :])
    rows = (w0[:, 1, None, None] * g[:, :win]
            + w1[:, 1, None, None] * g[:, 1:]).to(dt).float()   # (P, t, x)
    s = (w0[:, 0, None, None] * rows[:, :, :win]
         + w1[:, 0, None, None] * rows[:, :, 1:])               # (P, t, a)
    return s.transpose(1, 2).reshape(P, win * win)


class CostLookup(torch.autograd.Function):
    """K3 forward, the plain version's gradient backward."""

    @staticmethod
    def forward(ctx, cost_maps, coords, r):
        ctx.save_for_backward(cost_maps, coords)
        ctx.r = r
        out = _launch(cost_maps, coords, r)
        library.grad_launches["cost_lookup"] += 1
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        return (*library.plain_backward(
            cost_lookup_plain, ctx.saved_tensors, ctx.needs_input_grad[:2],
            grad_out, r=ctx.r), None)


def cost_lookup(cost_maps: torch.Tensor, coords: torch.Tensor,
                r: int = 4) -> torch.Tensor:
    if cost_maps.device.type == "cpu":
        return cost_lookup_plain(cost_maps, coords, r)
    if library.needs_grad(cost_maps, coords):
        return CostLookup.apply(cost_maps, coords, r)
    return _launch(cost_maps, coords, r)


def _launch(cost_maps, coords, r: int) -> torch.Tensor:
    # the kernel reads fp32 or bf16 coordinates as they are (widened
    # exactly, as .float() does); other dtypes are converted here
    if coords.dtype not in (torch.float32, torch.bfloat16):
        coords = coords.float()
    library.require_cuda("cost_lookup", cost_maps, coords)
    P, H2, W2 = cost_maps.shape
    if coords.shape != (P, 2):
        raise ValueError(f"cost_lookup: coords {tuple(coords.shape)} for "
                         f"{P} cost maps")
    if not 1 <= r <= MAX_RADIUS:
        raise ValueError(f"cost_lookup: radius {r} outside 1..{MAX_RADIUS}")
    win = 2 * r + 1
    out = torch.empty((P, win * win), device=cost_maps.device,
                      dtype=torch.float32)
    lib = library.load_library()
    err = lib.stx_cost_lookup(
        cost_maps.data_ptr(), coords.data_ptr(), out.data_ptr(), P, H2, W2, r,
        library.dtype_code(cost_maps.dtype), library.dtype_code(coords.dtype),
        library.stream_of(cost_maps))
    library.check(err, "cost_lookup")
    library.launches["cost_lookup"] += 1
    library.cost_lookup_by_radius[r] = (
        library.cost_lookup_by_radius.get(r, 0) + 1)
    return out
