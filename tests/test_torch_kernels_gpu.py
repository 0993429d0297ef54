"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`; each test skips without a CUDA device. The file imports no JAX
(the card's machine has none) and is run there without the suite's
conftest.py, which imports JAX:

    python3 -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels_gpu.py
"""

import math

import pytest
import torch

from stitchax_torch.ops.kernels import cost_lookup as tcl
from stitchax_torch.ops.kernels import gsa_attention as tgsa
from stitchax_torch.ops.kernels import library
from stitchax_torch.ops.kernels import tps_grid as ttps
from stitchax_torch.ops.kernels import window_attention as twa
from stitchax_torch.utils.precision import fp32_exact

GSA_CASES = [(2, 100, 16, 64, 4),    # d = 16, ragged N
             (1, 64, 9, 64, 2),      # d = 32
             (3, 37, 256, 128, 8),   # d = 16, M at the kernel's limit
             # the tensor-core path's chunks of 64 keys and 256-row tiles:
             # M under one chunk and ragged, N ragged, both head widths
             (2, 301, 49, 64, 2),    # d = 32
             (1, 517, 100, 128, 8),  # d = 16
             (2, 1000, 256, 256, 8),  # d = 32
             (3, 259, 49, 64, 4),    # d = 16
             (1, 700, 100, 64, 2)]   # d = 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fp32_exact()        # the plain versions' fp32 matmuls without TF32
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,M,C,heads", GSA_CASES)
def test_gsa_kernel_matches_plain(cuda, dtype, B, N, M, C, heads):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g).to(cuda, dtype)
               for s in ((B, N, C), (B, M, C), (B, M, C)))
    got = tgsa.gsa_attention(q, k, v, heads=heads)
    want = tgsa.gsa_attention_plain(q, k, v, heads=heads)
    # fp32: summation order only. bf16: both take the softmax and sums in
    # fp32, then round once; one bf16 ulp (8 significant bits) of max |out|
    top = want.float().abs().max().item()
    tol = (2e-5 if dtype == torch.float32
           else 2.0 ** (math.floor(math.log2(top)) - 7))
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


# K2 shapes (N, H, W): widths that are not a multiple of the 4 pixels a
# thread takes, H * W not a multiple of a block's pixels, one center, the
# default configuration's canvas, and more centers than 48 KiB of shared
# memory holds (N > 3072), up to the kernel's limit
TPS_CASES = [(77, 100, 130), (1, 37, 53), (106, 512, 768), (54, 61, 203),
             (3073, 29, 31), (8192, 16, 23)]


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["opencv", "kornia"])
@pytest.mark.parametrize("N,H,W", TPS_CASES)
def test_tps_kernel_matches_plain(cuda, variant, N, H, W):
    g = torch.Generator().manual_seed(0)
    ctrl = torch.rand(N, 2, generator=g).to(cuda)
    kw = (torch.randn(N, 2, generator=g) * .05).to(cuda)
    aw = torch.tensor([[0.01, -0.02], [1.0, 0.05], [0.02, 0.97]], device=cuda)
    got = ttps.tps_grid(ctrl, kw, aw, H, W, variant)
    want = ttps.tps_grid_plain(ctrl, kw, aw, H, W, variant)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cost_lookup_kernel_matches_plain(cuda, dtype):
    g = torch.Generator().manual_seed(0)
    cm = torch.randn(300, 40, 56, generator=g).to(cuda, dtype)
    coords = (torch.rand(300, 2, generator=g) * 90 - 15).to(cuda)
    got = tcl.cost_lookup(cm, coords)
    want = tcl.cost_lookup_plain(cm, coords)
    # every product and sum rounded on its own in both: bit-equal
    torch.testing.assert_close(got, want, atol=0, rtol=0)


# K3 cases (P, H2, W2, r, map dtype, coordinate dtype): the main path's
# (bf16 maps and coordinates, 64x64, r = 4), an odd row length (no pair
# loads), and other radii; coordinates run past every edge
COST_CASES = [(8192, 64, 64, 4, torch.bfloat16, torch.bfloat16),
              (8192, 64, 64, 4, torch.float32, torch.float32),
              (500, 33, 47, 4, torch.bfloat16, torch.float32),
              (500, 33, 47, 4, torch.float32, torch.bfloat16),
              (300, 40, 56, 1, torch.bfloat16, torch.bfloat16),
              (300, 40, 56, 7, torch.float32, torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("P,H2,W2,r,dtype,cdtype", COST_CASES)
def test_cost_lookup_kernel_edges_and_coordinate_dtypes(cuda, P, H2, W2, r,
                                                        dtype, cdtype):
    g = torch.Generator().manual_seed(0)
    cm = torch.randn(P, H2, W2, generator=g).to(cuda, dtype)
    span = torch.tensor([W2, H2], dtype=torch.float32)
    coords = ((torch.rand(P, 2, generator=g) * 1.5 - 0.25) * span
              + torch.randint(-1, 2, (P, 2), generator=g) * (r + 2))
    coords[:8] = torch.tensor([[-r - 1.5, 3.25], [W2 + r + .5, 3.],
                               [4.75, -r - 1.], [5., H2 + r + .25],
                               [-.5, -.5], [W2 - .5, H2 - .5], [0., 0.],
                               [W2 - 1., H2 - 1.]])
    coords = coords.to(cuda, cdtype)
    before = library.launches["cost_lookup"]
    got = tcl.cost_lookup(cm, coords, r)
    assert library.launches["cost_lookup"] == before + 1
    want = tcl.cost_lookup_plain(cm, coords, r)
    # every product and sum rounded on its own in both: bit-equal
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.gpu
def test_wrappers_count_launches(cuda):
    library.reset_launches()
    x = torch.randn(1, 16, 32, device=cuda)
    tgsa.gsa_attention(x, x, x, heads=2)
    tcl.cost_lookup(torch.randn(4, 8, 8, device=cuda),
                    torch.zeros(4, 2, device=cuda))
    b = torch.zeros(49, 32, device=cuda)
    twa.window_attention(x.view(1, 4, 4, 32), x.view(1, 4, 4, 32),
                         x.view(1, 4, 4, 32), b, b, b[:1], heads=2, ws=7)
    assert library.launches == {"gsa_attention": 1, "cost_lookup": 1,
                                "tps_grid": 0, "window_attention": 1}
    # no input needs a gradient: none of them went through autograd
    assert library.grad_launches == dict.fromkeys(library.launches, 0)


# K4 shapes (B, H, W, C, heads, fused, ws): the main path's (stage 1 and 2
# of the twins encoders, whose LSA blocks split one fused qkv product into
# strided views with broadcast biases; the cost perceiver's vertical blocks
# on 2 directions x 8 latents), and ragged ones
WINDOW_CASES = [(2, 128, 128, 128, 4, True, 7), (2, 64, 64, 256, 8, True, 7),
                (16, 64, 64, 128, 8, False, 7), (1, 9, 10, 32, 2, False, 7),
                (3, 14, 21, 64, 4, True, 7), (2, 16, 20, 256, 8, False, 7),
                # the bf16 kernel's blocks serve one window and a group of
                # heads, split further while the grid is small: the main
                # path's 100- and 361-window calls, a single window, and a
                # few windows whose heads split down to one a block
                (1, 64, 64, 256, 8, True, 7), (1, 128, 128, 128, 4, True, 7),
                (1, 7, 7, 64, 2, False, 7), (1, 5, 12, 256, 8, True, 7),
                (3, 13, 15, 128, 8, False, 7), (2, 22, 9, 128, 4, True, 7),
                # other window sizes: one 8-key tile (ws 2), a partly masked
                # one (ws 5), four whole row tiles (ws 8)
                (2, 7, 7, 64, 4, False, 2), (2, 16, 13, 64, 4, True, 5),
                (2, 25, 19, 64, 4, False, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,heads,fused,ws", WINDOW_CASES)
def test_window_kernel_matches_plain(cuda, dtype, B, H, W, C, heads, fused,
                                     ws):
    g = torch.Generator().manual_seed(0)
    T = ws * ws
    if fused:
        qkv = torch.randn(B, H, W, 3 * C, generator=g).to(cuda, dtype)
        qx, kx, vx = qkv.split(C, -1)
        bias = (torch.randn(3 * C, generator=g) * .3).to(cuda, dtype)
        qb, kb, vb = bias.split(C)
        qb, kb, vb = qb.expand(T, C), kb.expand(T, C), vb[None]
    else:
        qx, kx, vx = (torch.randn(B, H, W, C, generator=g).to(cuda, dtype)
                      for _ in range(3))
        qb, kb = ((torch.randn(T, C, generator=g) * .3).to(cuda, dtype)
                  for _ in range(2))
        vb = (torch.randn(1, C, generator=g) * .3).to(cuda, dtype)
    args = (qx, kx, vx, qb, kb, vb)
    got = twa.window_attention(*args, heads=heads, ws=ws)
    want = twa.window_attention_plain(*args, heads=heads, ws=ws)
    # fp32: summation order only. bf16: both round the biased streams to
    # bf16, take the logits, softmax and sums in fp32 and round once (the
    # kernel also rounds P to bf16 for the tensor cores); one bf16 ulp
    # (8 significant bits) of max |out|
    top = want.float().abs().max().item()
    tol = (2e-5 if dtype == torch.float32
           else 2.0 ** (math.floor(math.log2(top)) - 7))
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


@pytest.mark.gpu
def test_window_kernel_refuses_misaligned_bf16(cuda):
    """The bf16 kernel reads 16-byte chunks: a stream that starts off a
    16-byte boundary is refused, not read misaligned."""
    qkv = torch.randn(1, 7, 7, 3 * 64 + 1, device=cuda).bfloat16()
    qx, kx, vx = qkv[..., 1:].split(64, -1)
    b = torch.zeros(49, 64, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="aligned"):
        twa.window_attention(qx, kx, vx, b, b, b[:1], heads=2, ws=7)


# the evaluation's shapes (stitchax_torch.evaluate, batch 12 at 512^2, fp32
# nets): K1 at the context / feature encoders (B) and the cost perceiver
# (8B), K3 at P = B x 64 x 64 maps of 64 x 64. The kernels form their
# offsets in 64 bits and the grids stay inside their limits (K1 grid.z = B
# <= 65535; K3 P x 64 x 64 = 201M elements, blocks = P / 24); B = 24 as
# well, were both flow directions batched into one call
EVAL_GSA_CASES = [(12, 128 * 128, 256, 128, 4), (12, 64 * 64, 256, 256, 8),
                  (96, 64 * 64, 256, 128, 8), (192, 64 * 64, 256, 128, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M,C,heads", EVAL_GSA_CASES)
def test_gsa_kernel_at_evaluation_shapes(cuda, B, N, M, C, heads):
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(s, generator=g).to(cuda)
               for s in ((B, N, C), (B, M, C), (B, M, C)))
    got = tgsa.gsa_attention(q, k, v, heads=heads)
    want = tgsa.gsa_attention_plain(q, k, v, heads=heads)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [12, 24])
def test_cost_lookup_kernel_at_evaluation_shapes(cuda, B):
    g = torch.Generator().manual_seed(2)
    P = B * 64 * 64
    cm = torch.randn(P, 64, 64, generator=g).to(cuda)
    coords = (torch.rand(P, 2, generator=g) * 76 - 6).to(cuda)
    got = tcl.cost_lookup(cm, coords, 4)
    want = tcl.cost_lookup_plain(cm, coords, 4)
    assert torch.equal(got, want)


# ------------------------ under autograd (training) ---------------------------

def _grads_both(fn, plain, leaves, g_out):
    """The wrapper's output and input gradients, and the plain version's
    autograd on the same leaves, for one upstream gradient."""
    out = fn()
    grads = torch.autograd.grad(out, leaves, g_out)
    ref = plain()
    return out, grads, ref, torch.autograd.grad(ref, leaves, g_out)


def _check_under_grad(name, fn, plain, leaves, g_out, out_tol):
    before = library.launches[name]
    before_grad = library.grad_launches[name]
    out, grads, ref, ref_grads = _grads_both(fn, plain, leaves, g_out)
    assert library.launches[name] == before + 1     # the kernel ran forward
    assert library.grad_launches[name] == before_grad + 1   # under autograd
    assert out.grad_fn is not None
    torch.testing.assert_close(out, ref, atol=out_tol, rtol=0)
    # both differentiate the plain version at the same inputs: equal up to
    # the order of atomic adds
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a, b, atol=1e-5 * b.abs().max().item(),
                                   rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M,C,heads", [(1, 1000, 256, 128, 4),
                                           (8, 700, 100, 128, 8)])
def test_gsa_autograd_function(cuda, B, N, M, C, heads):
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(s, generator=g).to(cuda).requires_grad_(True)
               for s in ((B, N, C), (B, M, C), (B, M, C)))
    g_out = torch.randn(B, N, C, generator=g).to(cuda)
    _check_under_grad(
        "gsa_attention", lambda: tgsa.gsa_attention(q, k, v, heads=heads),
        lambda: tgsa.gsa_attention_plain(q, k, v, heads=heads), (q, k, v),
        g_out, 2e-5)


@pytest.mark.gpu
def test_cost_lookup_autograd_function(cuda):
    g = torch.Generator().manual_seed(4)
    cm = torch.randn(500, 64, 64, generator=g).to(cuda).requires_grad_(True)
    coords = (torch.rand(500, 2, generator=g) * 76 - 6).to(cuda)
    coords.requires_grad_(True)
    g_out = torch.randn(500, 81, generator=g).to(cuda)
    _check_under_grad(
        "cost_lookup", lambda: tcl.cost_lookup(cm, coords, 4),
        lambda: tcl.cost_lookup_plain(cm, coords, 4), (cm, coords), g_out,
        0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
def test_window_autograd_function(cuda, fused):
    g = torch.Generator().manual_seed(5)
    B, H, W, C, heads, ws = 2, 30, 33, 128, 4, 7
    T = ws * ws
    qkv = torch.randn(B, H, W, 3 * C, generator=g).to(cuda)
    qkv.requires_grad_(True)
    qb, kb = ((torch.randn(T, C, generator=g) * .3).to(cuda)
              .requires_grad_(True) for _ in range(2))
    vb = (torch.randn(1, C, generator=g) * .3).to(cuda).requires_grad_(True)
    g_out = torch.randn(B, H, W, C, generator=g).to(cuda)

    def streams():
        qx, kx, vx = qkv.split(C, -1)
        if not fused:
            qx, kx, vx = qx.contiguous(), kx.contiguous(), vx.contiguous()
        return qx, kx, vx, qb, kb, vb

    _check_under_grad(
        "window_attention",
        lambda: twa.window_attention(*streams(), heads=heads, ws=ws),
        lambda: twa.window_attention_plain(*streams(), heads=heads, ws=ws),
        (qkv, qb, kb, vb), g_out, 2e-5)
