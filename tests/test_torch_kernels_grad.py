"""The gradients the port's kernels carry under autograd, against stitchax's,
on the CPU.

On the card K1, K3 and K4 run inside `torch.autograd.Function`s whose
backward differentiates each kernel's plain version (`library.
plain_backward`); on the CPU the wrappers are the plain versions, so
autograd through them is that backward. stitchax's gradients: K1's
custom_vjp differentiates its XLA oracle `gsa_attention_ref`, K3's
`encode_flow_token` (the selector form the trainer runs), and K4 is XLA's
`window_attention_split`. fp32 on both sides; each input gradient within
1e-5 of its largest |value| (readings: up to 4.9e-7)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stitchax.models.flowformer import encode_flow_token
from stitchax.ops.pallas.gsa_attention import gsa_attention_ref
from stitchax.ops.window_attention import window_attention_split
from stitchax_torch.ops.kernels import cost_lookup as tcl
from stitchax_torch.ops.kernels import gsa_attention as tgsa
from stitchax_torch.ops.kernels import library
from stitchax_torch.ops.kernels import window_attention as twa

WS = 7


def _vjp_both(jfn, tfn, inputs, g_out):
    """(stitchax's input gradients, the port's) for upstream g_out."""
    out, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in inputs))
    ref = vjp(jnp.asarray(g_out))
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    got = torch.autograd.grad(tfn(*ts), ts, torch.from_numpy(g_out))
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def _close(got, ref, rel):
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        scale = np.abs(r).max()
        assert np.abs(g - r).max() <= rel * scale, (np.abs(g - r).max(),
                                                    scale)


@pytest.mark.parametrize("B,N,M,C,heads", [(2, 100, 16, 64, 4),
                                           (1, 64, 9, 64, 2),
                                           (2, 300, 256, 128, 8)])
def test_gsa_gradients_match_stitchax(rng, B, N, M, C, heads):
    """d q, d k, d v of K1."""
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, N, C), (B, M, C), (B, M, C)))
    g = rng.standard_normal((B, N, C)).astype(np.float32)
    ref, got = _vjp_both(lambda *a: gsa_attention_ref(*a, heads=heads),
                         lambda *a: tgsa.gsa_attention(*a, heads=heads),
                         (q, k, v), g)
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("lo,hi", [(5.0, 58.0), (-80.0, 140.0)])
def test_cost_lookup_gradients_match_stitchax(rng, lo, hi):
    """d cost maps (what the trainer's decoder needs: it detaches the
    coordinates) of K3 against the selector form's, windows inside and
    across the map's edges."""
    B, H1, W1, H2, W2 = 2, 6, 6, 32, 32
    cm = rng.standard_normal((B, H1, W1, H2, W2, 1)).astype(np.float32)
    coords = rng.uniform(lo, hi, (B, H1, W1, 2)).astype(np.float32)
    g = rng.standard_normal((B, H1, W1, 81)).astype(np.float32)
    jfn = lambda c: encode_flow_token(c, jnp.asarray(coords))
    tfn = lambda c: tcl.cost_lookup(c.reshape(-1, H2, W2),
                                    torch.from_numpy(coords).reshape(-1, 2)
                                    ).reshape(B, H1, W1, 81)
    ref, got = _vjp_both(jfn, tfn, (cm,), g)
    _close(got, ref, 1e-5)


def test_cost_lookup_coordinate_gradient_is_the_bilinear_slope(rng):
    """d coords of K3's plain version: the bilinear interpolation's slope,
    checked against central differences that stay inside each pixel cell
    (fractions 0.3-0.7, steps of 0.05: the lookup is linear there; the
    coordinates are taken in fp32)."""
    cm = torch.from_numpy(rng.standard_normal((5, 16, 16))).double()
    coords = torch.from_numpy(rng.uniform(2.2, 12.8, (5, 2)))
    coords = (coords.floor() + 0.3 + 0.4 * torch.from_numpy(
        rng.uniform(0, 1, (5, 2)))).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((5, 81)))
    (got,) = torch.autograd.grad(tcl.cost_lookup(cm, coords), coords, g)
    h = 0.05
    for j in range(2):
        e = torch.zeros_like(coords)
        e[:, j] = h
        fd = ((tcl.cost_lookup(cm, coords + e) - tcl.cost_lookup(
            cm, coords - e)) * g).sum(1) / (2 * h)
        np.testing.assert_allclose(got[:, j].numpy(), fd.detach().numpy(),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("H,W,heads,d", [(14, 21, 4, 16), (9, 7, 2, 32)])
def test_window_gradients_match_stitchax(rng, H, W, heads, d, fused):
    """d of the three streams and the three biases of K4, ragged sizes
    (padded windows whose bias-valued tokens take part), and the fused
    qkv's strided thirds as the LSA block passes them."""
    B, C, T = 2, heads * d, WS * WS
    qkv = rng.standard_normal((B, H, W, 3 * C)).astype(np.float32)
    qb, kb = ((rng.standard_normal((T, C)) * 0.3).astype(np.float32)
              for _ in range(2))
    vb = (rng.standard_normal((1, C)) * 0.3).astype(np.float32)
    g = rng.standard_normal((B, H, W, C)).astype(np.float32)

    def jfn(qkv_, qb_, kb_, vb_):
        return window_attention_split(qkv_[..., :C], qkv_[..., C:2 * C],
                                      qkv_[..., 2 * C:], qb_, kb_, vb_,
                                      heads=heads, ws=WS)

    def tfn(qkv_, qb_, kb_, vb_):
        if fused:
            qx, kx, vx = qkv_.split(C, -1)
        else:
            qx, kx, vx = (t.contiguous() for t in qkv_.split(C, -1))
        return twa.window_attention(qx, kx, vx, qb_, kb_, vb_, heads=heads,
                                    ws=WS)

    ref, got = _vjp_both(jfn, tfn, (qkv, qb, kb, vb), g)
    _close(got, ref, 1e-5)


def test_plain_backward_is_autograd_of_the_plain_version(rng):
    """The Functions' backward (`library.plain_backward`) gives autograd's
    gradients of the plain version for the inputs it is asked for, None
    for the others."""
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 20, 32), (1, 8, 32), (1, 8, 32)))
    g = torch.from_numpy(rng.standard_normal((1, 20, 32)).astype(np.float32))
    got = library.plain_backward(tgsa.gsa_attention_plain, (q, k, v),
                                 (True, False, True), g, heads=2)
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(tgsa.gsa_attention_plain(*ts, heads=2),
                               ts, g)
    assert got[1] is None
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert not q.requires_grad
