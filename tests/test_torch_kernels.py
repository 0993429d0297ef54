"""The port's four kernels: each plain PyTorch version against the JAX
function it replaces, on the same numpy inputs (CPU). The CUDA kernels
against their plain versions are in test_torch_kernels_gpu.py."""

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


def test_window_wrapper_uses_plain_on_cpu(rng):
    args = _window_inputs(rng, 1, 8, 8, 32, fused=True)
    before = dict(library.launches)
    out = twa.window_attention(*args, heads=2, ws=WS)
    assert out.shape == (1, 8, 8, 32) and library.launches == before
