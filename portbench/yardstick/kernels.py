"""The port's kernels K1, K3 and K4: their calls per FlowFormer++ call and
each call's least time on the card, from operation and byte counts
(copied from the port's smoke test, `chip_smoke.py`: `bound_ms`,
`fp32_attention_bound` and the kernel rows' counts).

Bytes: each input read once, the output written once. K3 reads only the
in-bounds (2r+2)^2 patch of each cost map around its lookup point; the
points are counted where a zero flow puts them (each query at its own
pixel), the geometry the decoder starts from. fp32 attention (K1, K4) at
fp32's accuracy: the larger of the bytes at the memory rate, three times
the flops at the TF32 rate (3xTF32), and one exponential per logit on the
special-function units at the SM clock. bf16 attention and K3: the larger
of the bytes and the flops at the type's peak (K3 at the CUDA cores'
fp32 rate: it does no matrix products).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .peaks import FLOPS, HBM_BYTES_PER_S, SFU_PER_CLOCK_SM

# the symbol of each kernel in the device trace, by the launch counter's
# name (`stitchax_torch.ops.kernels.library.launches`)
SYMBOLS = {"gsa_attention": "gsa_attention", "cost_lookup": "cost_lookup",
           "window_attention": "window_attention", "tps_grid": "tps_grid"}
WINDOW = 7                    # K4's window side (ws)
LOOKUP_RADIUS = 4             # K3's radius in the decoder


def _size(dtype: str) -> int:
    return 4 if dtype == "float32" else 2


def bound_s(nbytes: float, nflops: float, n_exp: float, dtype: str,
            n_sm: int, sm_hz: float, matrix: bool = True) -> float:
    """A call's least time in seconds."""
    t = [nbytes / HBM_BYTES_PER_S]
    if not matrix:
        t.append(nflops / FLOPS["fp32_cuda_cores"])
    elif dtype == "float32":
        t.append(3.0 * nflops / FLOPS["tf32"])
        t.append(n_exp / (SFU_PER_CLOCK_SM * n_sm * sm_hz))
    else:
        t.append(nflops / FLOPS["bfloat16"])
    return max(t)


def gsa_counts(B, N, M, C, heads, dtype) -> Tuple[float, float, float]:
    """K1 (global subsampled attention): bytes, flops, exponentials."""
    return (_size(dtype) * (2 * B * N * C + 2 * B * M * C),
            4.0 * B * N * M * C, float(B * N * M * heads))


def window_counts(B, H, W, C, heads, dtype) -> Tuple[float, float, float]:
    """K4 (7x7 window attention): the three streams read, the output
    written, the q/k biases (ws^2 x C) and the v bias (C)."""
    T = WINDOW * WINDOW
    n_win = B * (-(-H // WINDOW)) * (-(-W // WINDOW))
    return (_size(dtype) * (4 * B * H * W * C + 2 * T * C + C),
            4.0 * n_win * T * T * C, float(n_win * T * T * heads))


def _in_bounds(n: int, r: int) -> int:
    """Sum over the points 0..n-1 of the patch cells (2r+2 of them,
    from p - r) that lie in [0, n)."""
    return sum(min(p + r + 1, n - 1) - max(p - r, 0) + 1 for p in range(n))


def cost_counts(B, side, r, dtype) -> Tuple[float, float, float]:
    """K3 (decoder cost lookup) at P = B side^2 points on side^2 maps,
    zero flow: the in-bounds patches, the coordinates and the (2r+1)^2
    outputs (fp32); two bilinear passes."""
    P = B * side * side
    win = 2 * r + 1
    touched = B * _in_bounds(side, r) ** 2
    return (touched * _size(dtype) + P * 2 * 4 + P * win * win * 4,
            float(P * (3 * win * (win + 1) + 3 * win * win)), 0.0)


def flow_call(B: int, size: int, dtype: str, iters: int
              ) -> List[Tuple[str, Tuple[float, float, float], int]]:
    """(kernel, (bytes, flops, exps), calls) of one FlowFormer++ call on a
    batch of B pairs at size^2: K1 and K4 in the context encoder (B) and
    the feature encoder (B, per image) at 1/4 and 1/8 resolution, and in
    the cost perceiver's three vertical blocks (8 latents a pair); K3 once
    per decoder iteration."""
    q, e = size // 4, size // 8
    keys = (size // 32) ** 2
    return [
        ("gsa_attention", gsa_counts(B, q * q, keys, 128, 4, dtype), 3),
        ("gsa_attention", gsa_counts(B, e * e, keys, 256, 8, dtype), 3),
        ("gsa_attention", gsa_counts(8 * B, e * e, keys, 128, 8, dtype), 3),
        ("window_attention", window_counts(B, q, q, 128, 4, dtype), 3),
        ("window_attention", window_counts(B, e, e, 256, 8, dtype), 3),
        ("window_attention", window_counts(8 * B, e, e, 128, 8, dtype), 3),
        ("cost_lookup", cost_counts(B, e, LOOKUP_RADIUS, dtype), iters)]


def slice_bounds(calls, n_sm: int, sm_hz: float, dtype: str
                 ) -> Tuple[Dict[str, float], Dict[str, int]]:
    """The summed least seconds and the launches of each kernel over a list
    of `flow_call` entries."""
    secs: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for name, (nb, nf, ne), n in calls:
        b = bound_s(nb, nf, ne, dtype, n_sm, sm_hz,
                    matrix=name != "cost_lookup")
        secs[name] = secs.get(name, 0.0) + n * b
        count[name] = count.get(name, 0) + n
    return secs, count
