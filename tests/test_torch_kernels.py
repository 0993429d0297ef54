"""The port's kernels: each plain PyTorch version against the JAX function
it replaces, on the same numpy inputs (CPU), and the fp32 tensor-core
kernels' arithmetic emulated in their order (K5, which replaces no JAX
function, against an fp64 convolution). The CUDA kernels against their
plain versions are in test_torch_kernels_gpu.py."""

import importlib.util
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stitchax.models.flowformer import encode_flow_token
from stitchax.ops.pallas.gsa_attention import (gsa_attention_pallas,
                                               gsa_attention_ref)
from stitchax.ops.pallas.tps_kernel import (tps_eval_grid_pallas,
                                            tps_eval_grid_ref)
from stitchax.ops.window_attention import window_attention_split
from stitchax_torch.ops.kernels import conv3x3 as tconv
from stitchax_torch.ops.kernels import cost_lookup as tcl
from stitchax_torch.ops.kernels import gsa_attention as tgsa
from stitchax_torch.ops.kernels import library
from stitchax_torch.ops.kernels import tps_grid as ttps
from stitchax_torch.ops.kernels import window_attention as twa

T = torch.from_numpy


# ------------------------------- K1 ------------------------------------------

GSA_CASES = [(2, 100, 16, 64, 4),    # d = 16, ragged N
             (1, 64, 9, 64, 2),      # d = 32
             (3, 37, 256, 128, 8)]   # d = 16, M at the kernel's limit


@pytest.mark.parametrize("B,N,M,C,heads", GSA_CASES)
def test_gsa_plain_matches_jax(rng, B, N, M, C, heads):
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, N, C), (B, M, C), (B, M, C)))
    ref = np.asarray(gsa_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), heads=heads))
    got = tgsa.gsa_attention_plain(T(q), T(k), T(v), heads=heads).numpy()
    # fp32 on both sides; summation order only
    np.testing.assert_allclose(got, ref, atol=2e-5)
    if N <= 100:
        pal = np.asarray(gsa_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=heads,
            tile=64, interpret=True))
        np.testing.assert_allclose(got, pal, atol=2e-5)


def test_gsa_plain_bf16_output_dtype(rng):
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, 50, 64), (1, 16, 64), (1, 16, 64)))
    qb, kb, vb = (T(a).bfloat16() for a in (q, k, v))
    got = tgsa.gsa_attention_plain(qb, kb, vb, heads=2)
    assert got.dtype == torch.bfloat16
    # fp32 softmax on bf16-rounded inputs, one bf16 rounding of the output
    ref = np.asarray(gsa_attention_ref(*(jnp.asarray(t.float().numpy())
                                         for t in (qb, kb, vb)), heads=2))
    np.testing.assert_allclose(got.float().numpy(), ref, atol=2e-2)


def test_gsa_wrapper_uses_plain_on_cpu(rng):
    q = T(rng.standard_normal((1, 8, 32)).astype(np.float32))
    before = dict(library.launches)
    out = tgsa.gsa_attention(q, q[:, :4].contiguous(), q[:, :4].contiguous(),
                             heads=2)
    assert out.shape == q.shape and library.launches == before


def gsa_mma_emulation(q, k, v, heads, chunk=64):
    """The rounding of K1's bf16 tensor-core kernel (csrc/gsa_attention.cu)
    in plain PyTorch: q K^T of bf16 values summed in fp32, an online softmax
    in the exp2 domain over chunks of 64 keys (running max, rescaled sums),
    P rounded to bf16 for the P V product and for the row sum, one rounding
    of the output to bf16."""
    B, N, C = q.shape
    M = k.shape[1]
    d = C // heads
    qh, kh, vh = (t.float().reshape(B, -1, heads, d).transpose(1, 2)
                  for t in (q, k, v))
    scale_log2 = np.float32(1.4426950408889634) / np.sqrt(np.float32(d))
    m = torch.full((B, heads, N, 1), -torch.inf)
    l = torch.zeros(B, heads, N, 1)
    o = torch.zeros(B, heads, N, d)
    for kc in range(0, M, chunk):
        s = qh @ kh[:, :, kc:kc + chunk].transpose(-1, -2) * float(scale_log2)
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        a = torch.exp2(m - mx)
        m = mx
        p = torch.exp2(s - m).bfloat16().float()
        l = l * a + p.sum(-1, keepdim=True)
        o = o * a + p @ vh[:, :, kc:kc + chunk]
    return (o / l).transpose(1, 2).reshape(B, N, C).bfloat16()


# the main path's K1 shapes (B, N, C, heads) with N cut to 512, at its 256
# keys, and key counts below a chunk and ragged
GSA_EMULATION_CASES = [(2, 512, 128, 4, 256), (2, 512, 256, 8, 256),
                       (1, 512, 128, 4, 256), (1, 512, 256, 8, 256),
                       (16, 512, 128, 8, 256), (2, 300, 64, 2, 49),
                       (3, 77, 128, 8, 100)]


@pytest.mark.parametrize("B,N,C,heads,M", GSA_EMULATION_CASES)
def test_gsa_mma_rounding_holds_one_bf16_ulp(B, N, C, heads, M):
    """K1's bf16 kernel rounds P to bf16 before the tensor-core P V product.
    Its rounding, emulated on the CPU, stays within the tolerance the card
    holds the kernel to: one bf16 ulp of max |out| of the plain version,
    on inputs drawn as chip_smoke.py draws them."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g).bfloat16()
               for s in ((B, N, C), (B, M, C), (B, M, C)))
    want = tgsa.gsa_attention_plain(q, k, v, heads=heads).float()
    got = gsa_mma_emulation(q, k, v, heads).float()
    top = want.abs().max().item()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert (got - want).abs().max().item() <= ulp


# ------------------------- 3xTF32 (K1 and K4 in fp32) ------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """`cvt.rna.tf32.f32` on fp32 values: 10 explicit mantissa bits, rounded
    to nearest with ties away from zero (half of the dropped 13 bits added
    to the magnitude, then cut); the result is an fp32 value."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def mm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int = 3):
    """a @ b (fp32) as the kernels' tensor cores take it, 8 of the inner
    dimension a step into fp32 sums: with passes=3 (3xTF32) each operand
    split as hi = tf32(x), lo = tf32(x - hi) and each step adding a_lo b_hi,
    then a_hi b_lo, then a_hi b_hi (every product exact in fp32); with
    passes=1 a single TF32 product a_hi b_hi."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        if passes == 3:
            acc = acc + al[..., ks] @ bh[..., ks, :]
            acc = acc + ah[..., ks] @ bl[..., ks, :]
        acc = acc + ah[..., ks] @ bh[..., ks, :]
    return acc


def gsa_tf32_emulation(q, k, v, heads, passes=3, chunk=64):
    """K1's fp32 kernel (csrc/gsa_attention.cu) in plain PyTorch: S = q K^T
    in 3xTF32 per chunk of 64 keys, an online softmax in the exp2 domain
    (running max, rescaled sums), P split for the 3xTF32 P V product and
    summed unsplit for the row sum, the output times the sum's reciprocal.
    passes=1 takes one TF32 product instead (P rounded to tf32)."""
    B, N, C = q.shape
    M = k.shape[1]
    d = C // heads
    qh, kh, vh = (t.reshape(B, -1, heads, d).transpose(1, 2)
                  for t in (q, k, v))
    scale_log2 = float(np.float32(1.4426950408889634) / np.sqrt(np.float32(d)))
    m = torch.full((B, heads, N, 1), -torch.inf)
    l = torch.zeros(B, heads, N, 1)
    o = torch.zeros(B, heads, N, d)
    for kc in range(0, M, chunk):
        s = mm_tf32(qh, kh[:, :, kc:kc + chunk].transpose(-1, -2),
                    passes) * scale_log2
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        a = torch.exp2(m - mx)
        m = mx
        p = torch.exp2(s - m)
        l = l * a + p.sum(-1, keepdim=True)
        o = o * a + mm_tf32(p, vh[:, :, kc:kc + chunk], passes)
    return (o * (1 / l)).transpose(1, 2).reshape(B, N, C)


def window_tf32_emulation(qx, kx, vx, q_bias, k_bias, v_bias, *, heads, ws,
                          passes=3):
    """K4's fp32 kernel (csrc/window_attention.cu) in plain PyTorch: the
    biased streams in fp32, S = q K^T in 3xTF32 over the window's keys
    padded to the next 8 with only that padding masked, the exact row max
    in one pass, P = 2^(s * scale_log2 - max * scale_log2) with the fused
    multiply-add's one rounding (emulated in float64), P split for the
    3xTF32 P V product and summed unsplit, the output times the sum's
    reciprocal. passes=1 takes one TF32 product instead."""
    B, H, W, C = qx.shape
    T, d = ws * ws, C // heads
    TP = -(-T // 8) * 8
    q, k, v = twa.biased_windows(qx, kx, vx, q_bias, k_bias, v_bias, ws)

    def split(t, rows):
        t = t.reshape(B, -1, T, heads, d).transpose(2, 3)
        return torch.nn.functional.pad(t, (0, 0, 0, rows - T))

    qh, kh, vh = split(q, T), split(k, TP), split(v, TP)
    scale_log2 = float(np.float32(1.4426950408889634) / np.sqrt(np.float32(d)))
    s = mm_tf32(qh, kh.transpose(-1, -2), passes)
    s[..., T:] = -torch.inf
    m = s.amax(-1, keepdim=True) * scale_log2
    p = torch.exp2((s.double() * scale_log2 - m.double()).float())
    o = mm_tf32(p, vh, passes) * (1 / p.sum(-1, keepdim=True))
    Hp, Wp = -(-H // ws) * ws, -(-W // ws) * ws
    o = o.transpose(2, 3).reshape(B, Hp // ws, Wp // ws, ws, ws, C)
    o = o.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    return o[:, :H, :W]


def test_tf32_rounds_to_nearest_ties_away():
    """tf32 keeps 10 mantissa bits: values one ulp (2^-23) above 1 round
    down, 2^-11 above 1 (a tie) rounds away from zero in both signs, and
    the split's lo part holds what hi drops."""
    x = torch.tensor([1 + 2.0 ** -23, 1 + 2.0 ** -11, -(1 + 2.0 ** -11),
                      1 + 3 * 2.0 ** -11, 3.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + 2.0 ** -10, -(1 + 2.0 ** -10),
                         1 + 4 * 2.0 ** -11, 3.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    hi = tf32(r)
    assert torch.equal(hi.view(torch.int32) & 0x1fff,
                       torch.zeros(1000, dtype=torch.int32))
    assert ((r - hi).abs() <= hi.abs() * 2.0 ** -11).all()
    # hi + lo carries ~22 significant bits
    assert ((hi + tf32(r - hi) - r).abs() <= r.abs() * 2.0 ** -21).all()


# (B, N, C, heads, M): d = 16 and 32, M = 256 and ragged (100, 49)
GSA_TF32_CASES = [(2, 160, 64, 4, 256), (1, 200, 64, 2, 256),
                  (2, 100, 128, 8, 100), (1, 77, 64, 2, 100),
                  (1, 50, 64, 2, 49)]


@pytest.mark.parametrize("B,N,C,heads,M", GSA_TF32_CASES)
def test_gsa_3xtf32_holds_fp32_tolerance(B, N, C, heads, M):
    """K1's fp32 kernel in 3xTF32, emulated on the CPU in its order, stays
    within the card's 2e-5 of the plain version and of stitchax's
    `gsa_attention_ref` (stitchax/ops/pallas/gsa_attention.py:92)."""
    rng = np.random.default_rng(B * 1000 + N + M)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, N, C), (B, M, C), (B, M, C)))
    got = gsa_tf32_emulation(T(q), T(k), T(v), heads).numpy()
    plain = tgsa.gsa_attention_plain(T(q), T(k), T(v), heads=heads).numpy()
    ref = np.asarray(gsa_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), heads=heads))
    np.testing.assert_allclose(got, plain, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


def _window_inputs_f32(rng, B, H, W, C, fused):
    """K4's fp32 inputs as the main path gives them: with `fused` the
    strided thirds of one qkv tensor and one bias row broadcast over the
    window (stride 0), else three streams and per-position biases."""
    T_ = WS * WS
    if fused:
        qkv = T(rng.standard_normal((B, H, W, 3 * C)).astype(np.float32))
        bias = T((rng.standard_normal(3 * C) * .3).astype(np.float32))
        qb, kb, vb = bias.split(C)
        return (*qkv.split(C, -1), qb.expand(T_, C), kb.expand(T_, C),
                vb[None])
    return _window_inputs(rng, B, H, W, C)


# (B, H, W, C, heads, fused): H, W not multiples of 7, d = 16 and 32
WINDOW_TF32_CASES = [(2, 9, 12, 64, 4, True), (1, 15, 10, 64, 2, True),
                     (2, 8, 13, 128, 4, False), (1, 16, 9, 128, 8, False)]


@pytest.mark.parametrize("B,H,W,C,heads,fused", WINDOW_TF32_CASES)
def test_window_3xtf32_holds_fp32_tolerance(B, H, W, C, heads, fused):
    """K4's fp32 kernel in 3xTF32, emulated on the CPU in its order, stays
    within the card's 2e-5 of the plain version and of stitchax's
    `window_attention_split` (stitchax/ops/window_attention.py:52)."""
    rng = np.random.default_rng(B * 1000 + H * 10 + W)
    args = _window_inputs_f32(rng, B, H, W, C, fused)
    if fused:
        assert args[0].stride(2) == 3 * C and args[3].stride(0) == 0
    got = window_tf32_emulation(*args, heads=heads, ws=WS).numpy()
    plain = twa.window_attention_plain(*args, heads=heads, ws=WS).numpy()
    ref = np.asarray(window_attention_split(
        *(jnp.asarray(a.numpy()) for a in args), heads=heads, ws=WS))
    np.testing.assert_allclose(got, plain, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


def test_one_tf32_pass_misses_fp32_tolerance():
    """Why the kernels split: a single TF32 product (hi * hi, P rounded to
    tf32) is off by far more than 2e-5 in both kernels, where the 3xTF32
    emulations above hold it."""
    rng = np.random.default_rng(0)
    q, k, v = (T(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 200, 64), (1, 256, 64), (1, 256, 64)))
    plain = tgsa.gsa_attention_plain(q, k, v, heads=2)
    one = gsa_tf32_emulation(q, k, v, 2, passes=1)
    assert (one - plain).abs().max().item() > 1e-4
    args = _window_inputs_f32(rng, 2, 9, 12, 64, True)
    plain = twa.window_attention_plain(*args, heads=2, ws=WS)
    one = window_tf32_emulation(*args, heads=2, ws=WS, passes=1)
    assert (one - plain).abs().max().item() > 1e-4


# ------------------------------- K2 ------------------------------------------

@pytest.mark.parametrize("variant", ["opencv", "kornia"])
def test_tps_plain_matches_jax(rng, variant):
    N, H, W = 37, 40, 56
    ctrl = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    kw = (rng.standard_normal((N, 2)) * .05).astype(np.float32)
    aw = np.array([[0.01, -0.02], [1.0, 0.05], [0.02, 0.97]], np.float32)
    args = (H, W, variant, 1.5, 0.75)
    ref = np.asarray(tps_eval_grid_ref(jnp.asarray(ctrl), jnp.asarray(kw),
                                       jnp.asarray(aw), *args))
    pal = np.asarray(tps_eval_grid_pallas(
        jnp.asarray(ctrl), jnp.asarray(kw), jnp.asarray(aw), *args,
        interpret=True))
    got = ttps.tps_grid_plain(T(ctrl), T(kw), T(aw), *args).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)
    np.testing.assert_allclose(got, pal, atol=2e-5)


def test_tps_zero_weight_centers_neutral(rng):
    N = 130
    ctrl = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    kw = (rng.standard_normal((N, 2)) * .05).astype(np.float32)
    aw = np.zeros((3, 2), np.float32)
    base = ttps.tps_grid_plain(T(ctrl), T(kw), T(aw), 16, 24)
    extra = np.concatenate([ctrl, rng.uniform(0, 1, (9, 2))]).astype(np.float32)
    kw0 = np.concatenate([kw, np.zeros((9, 2), np.float32)])
    padded = ttps.tps_grid_plain(T(extra), T(kw0), T(aw), 16, 24)
    np.testing.assert_array_equal(base.numpy(), padded.numpy())
    ref = tps_eval_grid_ref(jnp.asarray(ctrl), jnp.asarray(kw),
                            jnp.asarray(aw), 16, 24)
    np.testing.assert_allclose(padded.numpy(), np.asarray(ref), atol=2e-5)


def test_tps_wrapper_uses_plain_on_cpu(rng):
    ctrl = T(rng.uniform(0, 1, (9, 2)).astype(np.float32))
    kw = T((rng.standard_normal((9, 2)) * .05).astype(np.float32))
    aw = T(np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]], np.float32))
    before = dict(library.launches)
    out = ttps.tps_grid(ctrl, kw, aw, 5, 7, "kornia")
    assert library.launches == before
    np.testing.assert_array_equal(
        out.numpy(), ttps.tps_grid_plain(ctrl, kw, aw, 5, 7, "kornia").numpy())


# ------------------------------- K3 ------------------------------------------

def _cost_inputs(rng, B, H1, W1, H2, W2, lo, hi):
    cm = rng.standard_normal((B, H1, W1, H2, W2, 1)).astype(np.float32)
    coords = rng.uniform(lo, hi, (B, H1, W1, 2)).astype(np.float32)
    return cm, coords


def _lookup_both(cm, coords, jdt, tdt):
    B, H1, W1, H2, W2, _ = cm.shape
    ref = np.asarray(encode_flow_token(jnp.asarray(cm, jdt),
                                       jnp.asarray(coords)), np.float32)
    got = tcl.cost_lookup_plain(T(cm).to(tdt).reshape(-1, H2, W2),
                                T(coords).reshape(-1, 2))
    return ref, got.numpy().reshape(ref.shape)


@pytest.mark.parametrize("lo,hi", [(5.0, 58.0), (-80.0, 140.0)])
def test_cost_lookup_plain_matches_selector_bf16(rng, lo, hi):
    cm, coords = _cost_inputs(rng, 2, 8, 8, 64, 64, lo, hi)
    ref, got = _lookup_both(cm, coords, jnp.bfloat16, torch.bfloat16)
    # bf16 weights and products are exact in fp32, one bf16 rounding of
    # each row value on both sides: bit-equal
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("lo,hi", [(5.0, 58.0), (-80.0, 140.0)])
def test_cost_lookup_plain_matches_selector_fp32(rng, lo, hi):
    cm, coords = _cost_inputs(rng, 2, 8, 8, 64, 64, lo, hi)
    ref, got = _lookup_both(cm, coords, jnp.float32, torch.float32)
    # fp32: two-term lerps vs the selector's dot products, a few ULP
    np.testing.assert_allclose(got, ref, rtol=3e-6, atol=3e-6)


def test_cost_lookup_ragged_p_non_square(rng):
    cm, coords = _cost_inputs(rng, 1, 6, 7, 40, 56, -10.0, 70.0)
    ref, got = _lookup_both(cm, coords, jnp.bfloat16, torch.bfloat16)
    np.testing.assert_array_equal(got, ref)


def test_cost_lookup_integer_coords_and_edges(rng):
    cm = rng.standard_normal((1, 4, 8, 64, 64, 1)).astype(np.float32)
    vals = np.array([-13.0, -12.0, -9.0, -4.0, 0.0, 4.0, 31.0, 59.0,
                     63.0, 66.0, 67.0, 76.0, 77.0, 100.0])
    coords = np.stack(np.meshgrid(vals[:8], vals[6:10]), -1).reshape(
        1, 4, 8, 2).astype(np.float32)
    ref, got = _lookup_both(cm, coords, jnp.bfloat16, torch.bfloat16)
    np.testing.assert_array_equal(got, ref)


# ------------------------------- K4 ------------------------------------------

REPO = os.path.join(os.path.dirname(__file__), "..")
WS = 7


def _window_inputs(rng, B, H, W, C, fused=False):
    """Streams (B, H, W, C) and biases; with `fused`, the streams are the
    three strided thirds of one (B, H, W, 3C) tensor, as the port's
    LocallyGroupedAttn splits its qkv product."""
    T_ = WS * WS
    if fused:
        qkv = T(rng.standard_normal((B, H, W, 3 * C)).astype(np.float32))
        qx, kx, vx = qkv.split(C, -1)
    else:
        qx, kx, vx = (T(rng.standard_normal((B, H, W, C)).astype(np.float32))
                      for _ in range(3))
    qb, kb = (T((rng.standard_normal((T_, C)) * 0.3).astype(np.float32))
              for _ in range(2))
    vb = T((rng.standard_normal((1, C)) * 0.3).astype(np.float32))
    return qx, kx, vx, qb, kb, vb


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("H,W,heads", [(14, 21, 4), (16, 20, 8), (9, 7, 2)])
def test_window_plain_matches_jax(rng, H, W, heads, d, fused):
    """Ragged sizes (padded edge windows whose bias-valued tokens take part
    as keys and values), head dims 16 and 32, contiguous and strided
    streams. fp32 on both sides: summation order only."""
    args = _window_inputs(rng, 2, H, W, heads * d, fused)
    if fused:
        assert args[0].stride(2) == 3 * heads * d
    ref = np.asarray(window_attention_split(
        *(jnp.asarray(a.numpy()) for a in args), heads=heads, ws=WS))
    got = twa.window_attention_plain(*args, heads=heads, ws=WS).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_window_padding_is_not_masking(rng):
    """A padded position is a key and a value (its q/k/v are the biases):
    masking it out computes another function, which the reference tells
    apart at a ragged size."""
    args = _window_inputs(rng, 1, 9, 10, 32)
    got = twa.window_attention_plain(*args, heads=2, ws=WS)
    # the same windows with the pad tokens masked out of the softmax
    q, k, v = twa.biased_windows(*args, WS)
    keep = twa.partition(torch.ones(1, 9, 10, 1), WS)[..., 0] > 0  # (1,nW,T)
    qh, kh, vh = (t.reshape(1, -1, 49, 2, 16).transpose(2, 3)
                  for t in (q, k, v))
    logits = qh @ kh.transpose(-1, -2) * 16 ** -0.5
    logits = logits.masked_fill(~keep[:, :, None, None, :], float("-inf"))
    o = (torch.softmax(logits, -1) @ vh).transpose(2, 3).reshape(
        1, 2, 2, WS, WS, 32).permute(0, 1, 3, 2, 4, 5).reshape(1, 14, 14, 32)
    masked = o[:, :9, :10]
    ref = np.asarray(window_attention_split(
        *(jnp.asarray(a.numpy()) for a in args), heads=2, ws=WS))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
    assert np.abs(masked.numpy() - ref).max() > 1e-2


@pytest.fixture
def exp_window_attn(monkeypatch):
    """tools/exp_window_attn.py, the retired TPU kernel, imported on the
    CPU: STITCHAX_PLATFORM=cpu keeps its `setup_cli_jax` from turning on the
    persistent compile cache, and the sys.path entry it adds is undone."""
    monkeypatch.setenv("STITCHAX_PLATFORM", "cpu")
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        "exp_window_attn", os.path.join(REPO, "tools", "exp_window_attn.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


def test_window_plain_matches_pallas_interpret(rng, exp_window_attn):
    args = _window_inputs(rng, 1, 9, 10, 32)
    ref = np.asarray(exp_window_attn.window_attention_pallas(
        *(jnp.asarray(a.numpy()) for a in args), heads=2, ws=WS,
        interpret=True))
    got = twa.window_attention_plain(*args, heads=2, ws=WS).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_window_plain_bf16_rounds_biased_streams_once(rng):
    """bf16: the biases are added in bf16 as stitchax adds them, then the
    softmax and sums run in fp32 with one rounding of the output."""
    args = [a.bfloat16() for a in _window_inputs(rng, 1, 8, 9, 32)]
    got = twa.window_attention_plain(*args, heads=2, ws=WS)
    assert got.dtype == torch.bfloat16
    q, k, v = twa.biased_windows(*args, WS)
    assert q.dtype == torch.bfloat16
    ref = twa.window_attention_plain(*(a.float() for a in args), heads=2,
                                     ws=WS)
    # fp32 inputs skip the bias rounding: outputs <~ 4, a few bf16 ulps
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), atol=5e-2)


def window_mma_emulation(qx, kx, vx, q_bias, k_bias, v_bias, *, heads, ws,
                         keys=64):
    """The rounding of K4's bf16 tensor-core kernel
    (csrc/window_attention.cu) in plain PyTorch: the biased streams rounded
    to bf16, q K^T of bf16 values summed in fp32 over the window's keys
    padded to 64 with only the tile padding masked, the exact row max, P =
    2^(s * scale_log2 - max * scale_log2) with the fused multiply-add's one
    rounding (emulated in float64) and rounded to bf16 for the P V product
    and for the row sum, the output times the reciprocal of that sum, one
    rounding to bf16."""
    B, H, W, C = qx.shape
    T, d = ws * ws, C // heads
    q, k, v = twa.biased_windows(qx, kx, vx, q_bias, k_bias, v_bias, ws)

    def split(t, rows):
        t = t.float().reshape(B, -1, T, heads, d).transpose(2, 3)
        return torch.nn.functional.pad(t, (0, 0, 0, rows - T))

    qh, kh, vh = split(q, T), split(k, keys), split(v, keys)
    scale_log2 = np.float32(1.4426950408889634) / np.sqrt(np.float32(d))
    s = qh @ kh.transpose(-1, -2)
    s[..., T:] = -torch.inf
    m = s.amax(-1, keepdim=True) * float(scale_log2)
    arg = (s.double() * float(scale_log2) - m.double()).float()
    p = torch.exp2(arg).bfloat16().float()
    o = (p @ vh) * (1 / p.sum(-1, keepdim=True))
    Hp, Wp = -(-H // ws) * ws, -(-W // ws) * ws
    o = o.transpose(2, 3).reshape(B, Hp // ws, Wp // ws, ws, ws, C)
    o = o.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    return o[:, :H, :W].bfloat16()


def _window_inputs_bf16(B, H, W, C, fused, g):
    """K4's bf16 inputs drawn as chip_smoke.py's `window_inputs` draws them
    (on the CPU): with `fused`, the strided thirds of one qkv tensor and one
    bias row broadcast over the window."""
    T_ = WS * WS
    if fused:
        qkv = torch.randn(B, H, W, 3 * C, generator=g).bfloat16()
        qx, kx, vx = qkv.split(C, -1)
        bias = (torch.randn(3 * C, generator=g) * .3).bfloat16()
        qb, kb, vb = bias.split(C)
        return qx, kx, vx, qb.expand(T_, C), kb.expand(T_, C), vb[None]
    qx, kx, vx = (torch.randn(B, H, W, C, generator=g).bfloat16()
                  for _ in range(3))
    qb, kb = ((torch.randn(T_, C, generator=g) * .3).bfloat16()
              for _ in range(2))
    vb = (torch.randn(1, C, generator=g) * .3).bfloat16()
    return qx, kx, vx, qb, kb, vb


# the main path's K4 shapes (B, C, heads, fused) with B and H x W cut and
# ragged (H, W not multiples of 7), head dims 32 and 16
WINDOW_EMULATION_CASES = [(2, 30, 23, 128, 4, True), (2, 20, 16, 256, 8, True),
                          (1, 30, 23, 128, 4, True), (1, 20, 16, 256, 8, True),
                          (4, 16, 19, 128, 8, False), (3, 9, 12, 64, 2, False)]


@pytest.mark.parametrize("B,H,W,C,heads,fused", WINDOW_EMULATION_CASES)
def test_window_mma_rounding_holds_one_bf16_ulp(B, H, W, C, heads, fused):
    """K4's bf16 kernel rounds P to bf16 before the tensor-core P V product.
    Its rounding, emulated on the CPU, stays within the tolerance the card
    holds the kernel to: one bf16 ulp of max |out| of the plain version."""
    g = torch.Generator().manual_seed(0)
    args = _window_inputs_bf16(B, H, W, C, fused, g)
    want = twa.window_attention_plain(*args, heads=heads, ws=WS).float()
    got = window_mma_emulation(*args, heads=heads, ws=WS).float()
    top = want.abs().max().item()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert (got - want).abs().max().item() <= ulp


def test_window_wrapper_uses_plain_on_cpu(rng):
    args = _window_inputs(rng, 1, 8, 8, 32, fused=True)
    before = dict(library.launches)
    out = twa.window_attention(*args, heads=2, ws=WS)
    assert out.shape == (1, 8, 8, 32) and library.launches == before


# ------------------------------- K5 ------------------------------------------

def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """An fp32 value as the tensor cores read it for a tf32 operand: its low
    13 mantissa bits dropped (toward zero)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def conv3x3_tf32_emulation(x, weight, bias=None, *, relu=True, passes=3):
    """K5 (csrc/conv3x3.cu) in plain PyTorch: the implicit GEMM of the NHWC
    input in K5's K order (tap by tap, channels inside a tap, each tap's
    channels zero-padded to K5's stages of 32), each stage summed into
    fresh fp32 partial sums 8 of K a step, adding a_lo b_hi, then a_hi b_lo,
    then a_hi b_hi (hi = tf32(x), lo = x - hi read truncated to tf32), and
    each stage's partial sums added to the running sums; then the bias and
    the ReLU. passes=1 takes one TF32 product, a_hi b_hi."""
    B, H, W, Cin = x.shape
    Cout = weight.shape[0]
    cp = -(-Cin // 32) * 32
    xp = torch.nn.functional.pad(x, (0, cp - Cin, 1, 1, 1, 1))
    a = torch.stack([xp[:, r:r + H, s:s + W] for r in range(3)
                     for s in range(3)], -2).reshape(B * H * W, 9 * cp)
    b = torch.nn.functional.pad(weight.permute(0, 2, 3, 1),
                                (0, cp - Cin)).reshape(Cout, 9 * cp).T
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32_truncated(a - ah), tf32_truncated(b - bh)
    acc = torch.zeros(B * H * W, Cout)
    for k0 in range(0, 9 * cp, 32):
        part = torch.zeros_like(acc)
        for k1 in range(k0, k0 + 32, 8):
            ks = slice(k1, k1 + 8)
            if passes == 3:
                part = part + al[:, ks] @ bh[ks]
                part = part + ah[:, ks] @ bl[ks]
            part = part + ah[:, ks] @ bh[ks]
        acc = acc + part
    if bias is not None:
        acc = acc + bias
    out = acc.reshape(B, H, W, Cout)
    return torch.relu(out) if relu else out


def _conv_inputs(rng, B, H, W, Cin, Cout):
    """Inputs as the motion encoder gives them: a ReLU's output, and a
    weight and bias at the scale of the layer's initialisation."""
    bound = (9 * Cin) ** -0.5
    x = np.maximum(rng.standard_normal((B, H, W, Cin)), 0)
    w = rng.uniform(-bound, bound, (Cout, Cin, 3, 3))
    b = rng.uniform(-bound, bound, Cout)
    return x, w, b


def _conv64(x, w, b=None):
    """The fp64 convolution (x a numpy array or an fp64 tensor)."""
    x = torch.as_tensor(x, dtype=torch.float64)
    return torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), T(w).double(),
        None if b is None else T(b).double(), padding=1).permute(0, 2, 3, 1)


# (B, H, W, Cin, Cout): conv's and convf2's widths (convc2's Cin and K)
# at a cut batch and map; Cout = 126 leaves a ragged tile
CONV_TF32_CASES = [(2, 8, 8, 256, 126), (1, 6, 10, 128, 64)]
# K5 reads ~1e-6 from an fp64 convolution on the card at K = 2304, as
# cuDNN's fp32 does (its outputs ~2): fp32 tolerance with 10x room
CONV_FP32_TOL = 1e-5


@pytest.mark.parametrize("B,H,W,Cin,Cout", CONV_TF32_CASES)
def test_conv3x3_3xtf32_holds_fp32_tolerance(B, H, W, Cin, Cout):
    """K5's fp32 arithmetic in 3xTF32, emulated on the CPU in its order,
    stays within fp32 tolerance of an fp64 convolution, as the plain fp32
    version does."""
    x, w, b = _conv_inputs(np.random.default_rng(Cin + Cout), B, H, W, Cin,
                           Cout)
    ref = torch.relu(_conv64(x, w, b))
    xf, wf, bf = (T(a).float() for a in (x, w, b))
    got = conv3x3_tf32_emulation(xf, wf, bf)
    plain = tconv.conv3x3_relu_plain(xf, wf, bf)
    torch.testing.assert_close(got.double(), ref, atol=CONV_FP32_TOL, rtol=0)
    torch.testing.assert_close(plain.double(), ref, atol=CONV_FP32_TOL,
                               rtol=0)


@pytest.mark.parametrize("B,H,W,Cin,Cout", CONV_TF32_CASES)
def test_conv3x3_input_grad_holds_fp32_tolerance(B, H, W, Cin, Cout):
    """The backward's input gradient on K5 (the same convolution of the
    output's gradient with the weight transposed and flipped, its Cout
    channels padded to a multiple of 4), emulated, against autograd's
    input gradient of the fp64 convolution."""
    rng = np.random.default_rng(Cin * Cout)
    x, w, _ = _conv_inputs(rng, B, H, W, Cin, Cout)
    g = rng.standard_normal((B, H, W, Cout))
    x64 = T(x).requires_grad_(True)
    ref, = torch.autograd.grad(_conv64(x64, w), x64, T(g))
    gp, wt = tconv.input_grad_operands(T(g).float(), T(w).float())
    assert gp.shape[-1] % 4 == 0 and wt.shape == (Cin, gp.shape[-1], 3, 3)
    got = conv3x3_tf32_emulation(gp, wt, relu=False)
    torch.testing.assert_close(got.double(), ref, atol=CONV_FP32_TOL, rtol=0)


def test_conv3x3_one_tf32_pass_misses_fp32_tolerance():
    """Why K5 splits: one TF32 product (hi * hi) is off by far more than
    the fp32 tolerance its 3xTF32 emulation holds."""
    x, w, b = _conv_inputs(np.random.default_rng(0), *CONV_TF32_CASES[0])
    ref = torch.relu(_conv64(x, w, b))
    one = conv3x3_tf32_emulation(*(T(a).float() for a in (x, w, b)),
                                 passes=1)
    assert (one.double() - ref).abs().max().item() > 10 * CONV_FP32_TOL


def test_conv3x3_wrapper_uses_plain_on_cpu(rng):
    """On the CPU the wrapper is the plain version, `F.relu(Conv(x))` of
    models/layers.py, bit for bit, and launches nothing."""
    from stitchax_torch.models.layers import Conv
    conv = Conv(16, 12, 3, padding=1)
    x = T(rng.standard_normal((2, 5, 7, 16)).astype(np.float32))
    before = dict(library.launches)
    out = tconv.conv3x3_relu(x, conv.weight, conv.bias)
    assert library.launches == before
    assert torch.equal(out, torch.relu(conv(x)))
