"""The port's three kernels: each plain PyTorch version against the JAX
function it replaces, on the same numpy inputs (CPU). The CUDA kernels
against their plain versions are in test_torch_kernels_gpu.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stitchax.models.flowformer import encode_flow_token
from stitchax.ops.pallas.gsa_attention import (gsa_attention_pallas,
                                               gsa_attention_ref)
from stitchax.ops.pallas.tps_kernel import (tps_eval_grid_pallas,
                                            tps_eval_grid_ref)
from stitchax_torch.ops.kernels import cost_lookup as tcl
from stitchax_torch.ops.kernels import gsa_attention as tgsa
from stitchax_torch.ops.kernels import library
from stitchax_torch.ops.kernels import tps_grid as ttps

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
