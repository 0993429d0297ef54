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
import torch.nn.functional as F

from stitchax_torch.ops.kernels import conv3x3 as tconv
from stitchax_torch.ops.kernels import conv3x3_wide as tk7
from stitchax_torch.ops.kernels import cost_lookup as tcl
from stitchax_torch.ops.kernels import gsa_attention as tgsa
from stitchax_torch.ops.kernels import library
from stitchax_torch.ops.kernels import pair_scores as tscore
from stitchax_torch.ops.kernels import tps_grid as ttps
from stitchax_torch.ops.kernels import window_attention as twa
from stitchax_torch.utils.precision import fp32_exact
import test_torch_pair_scores as tps

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


# K1's fp32 path (3xTF32; blocks of 8 or 12 warps of 16 query rows times
# 1, 2 or 4 tiles, picked by the grid's size): N under, across and past a
# block's rows, M in {49, 100, 256} (under one 64-key chunk, ragged, full),
# one head, and B * heads far above the SM count
GSA_F32_CASES = [(1, 1, 49, 64, 2),        # d = 32, one query row
                 (3, 129, 49, 64, 4),      # d = 16
                 (2, 513, 100, 256, 8),    # d = 32
                 (12, 4103, 256, 256, 8),  # d = 32, 4 tiles a warp, ragged
                 (40, 300, 256, 128, 8),   # d = 16, B * heads = 320
                 (700, 65, 100, 64, 4),    # d = 16, B * heads = 2800
                 (2, 50, 256, 16, 1),      # d = 16, one head
                 (1, 16461, 256, 128, 4)]  # d = 32, the stitch's N, ragged


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M,C,heads", GSA_F32_CASES)
def test_gsa_fp32_kernel_edges(cuda, B, N, M, C, heads):
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(s, generator=g).to(cuda)
               for s in ((B, N, C), (B, M, C), (B, M, C)))
    before = library.launches["gsa_attention"]
    got = tgsa.gsa_attention(q, k, v, heads=heads)
    assert library.launches["gsa_attention"] == before + 1
    want = tgsa.gsa_attention_plain(q, k, v, heads=heads)
    # 3xTF32 keeps fp32's accuracy: summation order and ~22-bit products
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


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
    tconv.conv3x3_relu(x.view(1, 4, 4, 32), torch.zeros(8, 32, 3, 3,
                                                         device=cuda),
                       torch.zeros(8, device=cuda))
    assert library.launches == {"gsa_attention": 1, "cost_lookup": 1,
                                "tps_grid": 0, "window_attention": 1,
                                "conv3x3": 1, "conv3x3_input_grad": 0,
                                "pair_scores": 0, "conv3x3_wide": 0,
                                "conv3x3_wide_input_grad": 0}
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


def _window_args(B, H, W, C, heads, fused, broadcast, dtype, ws, g, cuda):
    """K4's inputs: the streams as the strided thirds of one qkv tensor
    (`fused`) or three tensors, the q / k biases one row broadcast over the
    window (stride 0, `broadcast`) or one row per window position."""
    T = ws * ws
    if fused:
        qkv = torch.randn(B, H, W, 3 * C, generator=g).to(cuda, dtype)
        qx, kx, vx = qkv.split(C, -1)
    else:
        qx, kx, vx = (torch.randn(B, H, W, C, generator=g).to(cuda, dtype)
                      for _ in range(3))
    if broadcast:
        bias = (torch.randn(3 * C, generator=g) * .3).to(cuda, dtype)
        qb, kb, vb = bias.split(C)
        qb, kb = qb.expand(T, C), kb.expand(T, C)
        vb = vb[None]
    else:
        qb, kb = ((torch.randn(T, C, generator=g) * .3).to(cuda, dtype)
                  for _ in range(2))
        vb = (torch.randn(1, C, generator=g) * .3).to(cuda, dtype)
    return qx, kx, vx, qb, kb, vb


# K4 at H, W in {7, 13, 64, 128} (one window, ragged windows, the main
# path's maps), both stream layouts and both bias layouts, both head dims
WINDOW_EDGE_CASES = [(1, 7, 7, 64, 2, True, True),
                     (2, 7, 13, 128, 8, False, False),
                     (1, 13, 7, 256, 8, True, False),
                     (3, 13, 13, 64, 4, False, True),
                     (1, 64, 128, 128, 4, True, True),
                     (1, 128, 64, 256, 8, False, False),
                     (2, 64, 64, 128, 8, True, False),
                     (1, 128, 128, 128, 4, False, True),
                     (4, 13, 64, 64, 2, True, True),
                     (1, 128, 7, 32, 2, False, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,heads,fused,broadcast", WINDOW_EDGE_CASES)
def test_window_kernel_edges(cuda, dtype, B, H, W, C, heads, fused,
                             broadcast):
    g = torch.Generator().manual_seed(7)
    args = _window_args(B, H, W, C, heads, fused, broadcast, dtype, 7, g,
                        cuda)
    before = library.launches["window_attention"]
    got = twa.window_attention(*args, heads=heads, ws=7)
    assert library.launches["window_attention"] == before + 1
    want = twa.window_attention_plain(*args, heads=heads, ws=7)
    # fp32 (3xTF32): summation order and ~22-bit products; bf16: one bf16
    # ulp of max |out|, as test_window_kernel_matches_plain
    top = want.float().abs().max().item()
    tol = (2e-5 if dtype == torch.float32
           else 2.0 ** (math.floor(math.log2(top)) - 7))
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


@pytest.mark.gpu
def test_window_kernel_refuses_misaligned_fp32(cuda):
    """The fp32 kernel reads 16-byte chunks too: a stream whose token
    stride is not a multiple of 4 values is refused."""
    qkv = torch.randn(1, 7, 7, 3 * 64 + 2, device=cuda)
    qx, kx, vx = qkv[..., :192].split(64, -1)
    b = torch.zeros(49, 64, device=cuda)
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
@pytest.mark.parametrize("heads", [4, 8])
@pytest.mark.parametrize("fused", [False, True])
def test_window_autograd_function(cuda, fused, heads):
    g = torch.Generator().manual_seed(5)
    B, H, W, C, ws = 2, 30, 33, 128, 7
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


# ------------------------------- K5 ------------------------------------------

# the motion encoder's three 3x3 convolutions (Cin, Cout): convc2, convf2,
# conv
CONV_LAYERS = [(256, 192), (128, 64), (256, 126)]
# (B, H, W, Cin, Cout): ragged maps and pixel tiles, Cin under and across
# the kernel's 32-channel stages, Cout ragged and odd
CONV_EDGES = [(1, 5, 7, 4, 5), (2, 9, 13, 36, 126), (1, 1, 1, 8, 3),
              (3, 17, 33, 100, 70), (1, 3, 130, 64, 65)]
# K5 (3xTF32, each stage of 32 channels summed apart and added in fp32) and
# the plain version (cuDNN in fp32, by FFT at some of these shapes) each
# read 1e-6 to 3e-6 from an fp64 convolution on the card, at K = 2304 and
# outputs up to ~2: K1's and K4's fp32 tolerance leaves 6x
CONV_TOL = 2e-5


def _conv_inputs(dev, B, H, W, Cin, Cout, seed=0):
    """A ReLU's output, and a weight and bias at the scale of the layer's
    initialisation, as the motion encoder gives them."""
    g = torch.Generator().manual_seed(seed)
    bound = (9 * Cin) ** -0.5
    x = torch.randn(B, H, W, Cin, generator=g).relu()
    w = (torch.rand(Cout, Cin, 3, 3, generator=g) * 2 - 1) * bound
    b = (torch.rand(Cout, generator=g) * 2 - 1) * bound
    return x.to(dev), w.to(dev), b.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("Cin,Cout", CONV_LAYERS)
def test_conv3x3_kernel_matches_plain(cuda, Cin, Cout):
    x, w, b = _conv_inputs(cuda, 2, 64, 64, Cin, Cout)
    got = tconv.conv3x3_relu(x, w, b)
    want = tconv.conv3x3_relu_plain(x, w, b)
    torch.testing.assert_close(got, want, atol=CONV_TOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,Cin,Cout", CONV_EDGES)
def test_conv3x3_kernel_edges(cuda, B, H, W, Cin, Cout):
    x, w, b = _conv_inputs(cuda, B, H, W, Cin, Cout, seed=1)
    got = tconv.conv3x3_relu(x, w, b)
    want = tconv.conv3x3_relu_plain(x.double(), w.double(), b.double())
    torch.testing.assert_close(got.double(), want, atol=CONV_TOL, rtol=0)
    # the input gradient's launch: no bias, no ReLU, Cout padded to 4s
    gy = torch.randn(B, H, W, Cout, device=cuda)
    x64 = x.double().requires_grad_(True)
    y64 = F.conv2d(x64.permute(0, 3, 1, 2), w.double(), padding=1)
    ref, = torch.autograd.grad(y64.permute(0, 2, 3, 1), x64, gy.double())
    torch.testing.assert_close(tconv.input_grad(gy, w).double(), ref,
                               atol=CONV_TOL, rtol=0)


@pytest.mark.gpu
def test_conv3x3_counts_one_launch_a_call(cuda):
    x, w, b = _conv_inputs(cuda, 1, 8, 8, 16, 8)
    library.reset_launches()
    for n in (1, 2, 3):
        tconv.conv3x3_relu(x, w, b)
        assert library.launches["conv3x3"] == n
    tconv.input_grad(torch.randn(1, 8, 8, 8, device=cuda), w)
    assert library.launches["conv3x3_input_grad"] == 1
    assert library.launches["conv3x3"] == 3
    assert library.grad_launches == dict.fromkeys(library.launches, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("Cin,Cout", CONV_LAYERS)
def test_conv3x3_autograd_function(cuda, Cin, Cout):
    x, w, b = (t.requires_grad_(True)
               for t in _conv_inputs(cuda, 2, 64, 64, Cin, Cout, seed=2))
    g = torch.Generator().manual_seed(3)
    g_out = torch.randn(2, 64, 64, Cout, generator=g).to(cuda)
    # K5's and cuDNN's outputs differ by ~1e-6, so their ReLU masks may
    # differ where the convolution is that close to 0: no gradient there
    with torch.no_grad():
        pre = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=1)
    g_out = g_out * (pre.permute(0, 2, 3, 1).abs() > 1e-4)
    before, before_grad = dict(library.launches), dict(library.grad_launches)
    out, grads, ref, ref_grads = _grads_both(
        lambda: tconv.conv3x3_relu(x, w, b),
        lambda: tconv.conv3x3_relu_plain(x, w, b), (x, w, b), g_out)
    # one forward, under autograd, and one input gradient: no forward
    # recomputed in the backward
    assert library.launches["conv3x3"] == before["conv3x3"] + 1
    assert library.grad_launches["conv3x3"] == before_grad["conv3x3"] + 1
    assert (library.launches["conv3x3_input_grad"]
            == before["conv3x3_input_grad"] + 1)
    assert out.grad_fn is not None
    torch.testing.assert_close(out, ref, atol=CONV_TOL, rtol=0)
    # the weight's and the bias's gradients are convolution_backward on
    # the same inputs; the input's is K5 against cuDNN, both fp32-accurate
    for a, r in zip(grads, ref_grads):
        torch.testing.assert_close(a, r, atol=1e-5 * r.abs().max().item(),
                                   rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("Cin,Cout", [(256, 192), (256, 126)])
def test_conv3x3_backward_takes_no_fft(cuda, Cin, Cout):
    """cuDNN takes the input gradient of these two layers by FFT at the
    train step's batch: the Function's backward runs it on K5."""
    from torch.profiler import ProfilerActivity, profile
    x, w, b = (t.requires_grad_(True)
               for t in _conv_inputs(cuda, 8, 64, 64, Cin, Cout, seed=4))
    out = tconv.conv3x3_relu(x, w, b)
    g_out = torch.randn_like(out)
    torch.autograd.grad(out, (x, w, b), g_out, retain_graph=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(out, (x, w, b), g_out)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("conv3x3_tf32_kernel" in n for n in names) == 1, names
    assert not [n for n in names if "fft" in n.lower() or "cf32" in n]


@pytest.mark.gpu
def test_conv3x3_kernel_refuses(cuda):
    x, w, b = _conv_inputs(cuda, 1, 8, 8, 16, 8)
    with pytest.raises(TypeError):
        tconv.conv3x3_relu(x.bfloat16(), w.bfloat16(), b.bfloat16())
    with pytest.raises(ValueError):             # not contiguous
        tconv.conv3x3_relu(x.transpose(1, 2), w, b)
    with pytest.raises(ValueError):             # not 16-byte aligned
        buf = torch.empty(x.numel() + 1, device=cuda)
        tconv.conv3x3_relu(buf[1:].view(x.shape), w, b)
    x6, w6, b6 = _conv_inputs(cuda, 1, 8, 8, 6, 8)
    with pytest.raises(ValueError):             # Cin not a multiple of 4
        tconv.conv3x3_relu(x6, w6, b6)


@pytest.mark.gpu
def test_motion_encoder_takes_k5_in_fp32_only(cuda):
    """BasicMotionEncoder's three 3x3 convolutions run on K5 in fp32 (the
    1x1 and 7x7 ones on cuDNN), and all five on cuDNN in bf16."""
    from stitchax_torch.models.flowformer import BasicMotionEncoder
    g = torch.Generator().manual_seed(5)
    enc = BasicMotionEncoder(452).to(cuda)
    flow = torch.randn(2, 16, 16, 2, generator=g).to(cuda)
    corr = torch.randn(2, 16, 16, 452, generator=g).to(cuda)
    library.reset_launches()
    with torch.no_grad():
        got = enc(flow, corr)
        assert library.launches["conv3x3"] == 3
        cor = F.relu(enc.convc2(F.relu(enc.convc1(corr))))
        flo = F.relu(enc.convf2(F.relu(enc.convf1(flow))))
        want = torch.cat([F.relu(enc.conv(torch.cat([cor, flo], -1))),
                          flow], -1)
        torch.testing.assert_close(got, want, atol=CONV_TOL, rtol=0)
        enc.bfloat16()(flow.bfloat16(), corr.bfloat16())
    assert library.launches["conv3x3"] == 3


# ------------------------------- K7 ------------------------------------------

# the VGG16's 11 convolutions (Cin, Cout), conv1_1's image padded to 4
# channels for the kernel
VGG_LAYERS = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256),
              (256, 256), (256, 256), (256, 512), (512, 512), (512, 512),
              (512, 512)]
# (B, H, W): odd sides, sides under and across a tile's 16 x 8 and 16 x 16
# pixel boxes, the map's edges in every tile
VGG_MAPS = [(2, 13, 21), (1, 17, 33), (3, 8, 8), (1, 1, 5)]


def _vgg_inputs(dev, B, H, W, Cin, Cout, seed=0):
    """A ReLU's output (the image in [-1, 1] for Cin = 3), a He-scaled
    weight and a small bias, as the VGG's layers see them."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, H, W, Cin, generator=g)
    x = x.clamp(-1, 1) if Cin == 3 else x.relu()
    w = torch.randn(Cout, Cin, 3, 3, generator=g) * (2.0 / (9 * Cin)) ** 0.5
    b = 0.01 * torch.randn(Cout, generator=g)
    return x.to(dev), w.to(dev), b.to(dev)


def _rel64(got, ref):
    """max |got - ref| over max |ref|, ref in fp64."""
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


# K7's stage-wise sums against cuDNN's fp32 (SIMT, or FFT), both from an
# fp64 convolution: at most twice cuDNN's error, or 2^-21 of the largest
# output, the error of one 3xTF32 product (the lo parts cut to tf32, lo lo
# dropped): on a 1 x 5 map most taps read the padding, cuDNN's few fp32
# products read 1.2e-7 and K7's 2.6e-7 (an H100)
def _k7_error_bound(cudnn_err):
    return max(2.0 * cudnn_err, 2.0 ** -21)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W", VGG_MAPS)
@pytest.mark.parametrize("Cin,Cout", VGG_LAYERS)
def test_conv3x3_wide_matches_fp64_and_cudnn(cuda, Cin, Cout, B, H, W):
    """K7 forward and input gradient at each VGG layer's channels (K = 9 Cin
    up to 4608), against an fp64 convolution and cuDNN's fp32."""
    x, w, b = _vgg_inputs(cuda, B, H, W, Cin, Cout, seed=Cin + Cout + H)
    before = dict(library.launches)
    got = tk7.conv3x3_wide_relu(x, w, b)
    assert library.launches["conv3x3_wide"] == before["conv3x3_wide"] + 1
    assert got.shape == (B, H, W, Cout) and got.is_contiguous()
    ref = tk7.conv3x3_wide_relu_plain(x.double(), w.double(), b.double())
    cudnn = tk7.conv3x3_wide_relu_plain(x, w, b)
    assert _rel64(got, ref) <= _k7_error_bound(_rel64(cudnn, ref))
    torch.testing.assert_close(got, cudnn, rtol=0,
                               atol=2e-5 * cudnn.abs().max().item())
    gy = torch.randn(B, H, W, Cout, device=cuda)
    gx = tk7.input_grad(gy, w)
    assert (library.launches["conv3x3_wide_input_grad"]
            == before["conv3x3_wide_input_grad"] + 1)
    assert gx.shape == (B, H, W, Cin)
    gref = tk7.input_grad_plain(gy.double(), w.double())
    gcudnn = tk7.input_grad_plain(gy, w)
    assert _rel64(gx, gref) <= _k7_error_bound(_rel64(gcudnn, gref))


@pytest.mark.gpu
def test_conv3x3_wide_at_the_cells_largest_tensor(cuda):
    """conv1_2 at the cell's batch 32 and 512^2: its input and output are
    2^31 bytes, so offsets pass int32's range; every image's output and
    input gradient against cuDNN's fp32."""
    x, w, b = _vgg_inputs(cuda, 1, 512, 512, 64, 64, seed=7)
    x = x.expand(32, -1, -1, -1) * torch.linspace(
        0.5, 1.5, 32, device=cuda).view(32, 1, 1, 1)
    got = tk7.conv3x3_wide_relu(x, w, b)
    want = tk7.conv3x3_wide_relu_plain(x, w, b)
    top = want.abs().max().item()
    for i in (0, 15, 16, 31):             # the last images lie past 2^31 B
        torch.testing.assert_close(got[i], want[i], rtol=0, atol=2e-5 * top)
    del got, want
    gx = tk7.input_grad(x, w)
    want = tk7.input_grad_plain(x, w)
    top = want.abs().max().item()
    for i in (0, 15, 16, 31):
        torch.testing.assert_close(gx[i], want[i], rtol=0, atol=2e-5 * top)


@pytest.mark.gpu
@pytest.mark.parametrize("trainable", [False, True])
@pytest.mark.parametrize("Cin,Cout", [(3, 64), (128, 256), (512, 512)])
def test_conv3x3_wide_autograd_function(cuda, Cin, Cout, trainable):
    """The Function against autograd over the plain version: with a frozen
    weight (the VGG's) only the input's gradient, on K7; with a trainable
    one the weight's and the bias's too (convolution_backward)."""
    x, w, b = _vgg_inputs(cuda, 2, 24, 19, Cin, Cout, seed=9)
    x.requires_grad_(True)
    leaves = (x, w, b) if trainable else (x,)
    for t in leaves[1:]:
        t.requires_grad_(True)
    g = torch.Generator().manual_seed(10)
    g_out = torch.randn(2, 24, 19, Cout, generator=g).to(cuda)
    # K7's and cuDNN's outputs differ by ~1e-6, so their ReLU masks may
    # differ where the convolution is that close to 0: no gradient there
    with torch.no_grad():
        pre = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=1)
    g_out = g_out * (pre.permute(0, 2, 3, 1).abs() > 1e-4)
    before, before_grad = dict(library.launches), dict(library.grad_launches)
    out, grads, ref, ref_grads = _grads_both(
        lambda: tk7.conv3x3_wide_relu(x, w, b),
        lambda: tk7.conv3x3_wide_relu_plain(x, w, b), leaves, g_out)
    # one forward, under autograd, and one input gradient: no forward
    # recomputed in the backward
    assert library.launches["conv3x3_wide"] == before["conv3x3_wide"] + 1
    assert (library.grad_launches["conv3x3_wide"]
            == before_grad["conv3x3_wide"] + 1)
    assert (library.launches["conv3x3_wide_input_grad"]
            == before["conv3x3_wide_input_grad"] + 1)
    assert out.grad_fn is not None and grads[0].shape == x.shape
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=2e-5 * ref.abs().max().item())
    for a, r in zip(grads, ref_grads):
        torch.testing.assert_close(a, r, rtol=0,
                                   atol=1e-5 * r.abs().max().item())


@pytest.mark.gpu
def test_conv3x3_wide_counts_one_launch_a_call(cuda):
    x, w, b = _vgg_inputs(cuda, 1, 8, 8, 64, 128)
    library.reset_launches()
    for n in (1, 2, 3):
        tk7.conv3x3_wide_relu(x, w, b)
        assert library.launches["conv3x3_wide"] == n
    tk7.input_grad(torch.randn(1, 8, 8, 128, device=cuda), w)
    assert library.launches["conv3x3_wide_input_grad"] == 1
    assert library.launches["conv3x3_wide"] == 3
    assert library.grad_launches == dict.fromkeys(library.launches, 0)
    assert library.launches["conv3x3"] == 0


@pytest.mark.gpu
def test_conv3x3_wide_refuses(cuda):
    x, w, b = _vgg_inputs(cuda, 1, 8, 8, 16, 8)
    with pytest.raises(TypeError):
        tk7.conv3x3_wide_relu(x.bfloat16(), w.bfloat16(), b.bfloat16())
    with pytest.raises(ValueError):             # not contiguous
        tk7.conv3x3_wide_relu(x.transpose(1, 2), w, b)
    with pytest.raises(ValueError):             # not 16-byte aligned
        buf = torch.empty(x.numel() + 1, device=cuda)
        tk7.conv3x3_wide_relu(buf[1:].view(x.shape), w, b)
    x6, w6, b6 = _vgg_inputs(cuda, 1, 8, 8, 16, 6)
    with pytest.raises(ValueError):             # Cout not a multiple of 4
        tk7.conv3x3_wide_relu(x6, w6, b6)


@pytest.mark.gpu
def test_vgg_takes_k7_for_every_convolution(cuda):
    """VGG16Features on the card: 13 K7 launches a call (the two re-applied
    conv5_1 included), 13 of them under autograd when the input needs a
    gradient, and 13 input gradients in the backward; no K5. Every
    activation and the input's gradient against the CPU's plain path."""
    from stitchax_torch.models.vgg import VGG16Features

    vgg = VGG16Features()
    vgg.reset_parameters(torch.Generator().manual_seed(0))
    vgg.requires_grad_(False)
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    x = x * 2 - 1
    xc = x.clone().requires_grad_(True)
    want = vgg(xc)
    want_g, = torch.autograd.grad(want["relu5_3"].sum()
                                  + want["relu2_2"].sum(), xc)
    vgg.to(cuda)
    library.reset_launches()
    with torch.no_grad():
        vgg(x.to(cuda))
    assert library.launches["conv3x3_wide"] == 13
    xg = x.to(cuda).requires_grad_(True)
    got = vgg(xg)
    assert library.grad_launches["conv3x3_wide"] == 13
    got_g, = torch.autograd.grad(got["relu5_3"].sum() + got["relu2_2"].sum(),
                                 xg)
    assert library.launches == {**dict.fromkeys(library.launches, 0),
                                "conv3x3_wide": 26,
                                "conv3x3_wide_input_grad": 13}
    for k, v in want.items():
        assert got[k].is_contiguous(), k
        torch.testing.assert_close(got[k].cpu(), v.detach(), rtol=0,
                                   atol=1e-5 * v.abs().max().item())
    torch.testing.assert_close(got_g.cpu(), want_g, rtol=0,
                               atol=1e-4 * want_g.abs().max().item())


# K6 (the evaluation's per-pair scores): the CPU tests' cases
# (tests/test_torch_pair_scores.py), on the card
@pytest.mark.gpu
@pytest.mark.parametrize("name,B,H,W", tps.CASES)
def test_pair_scores_kernel_matches_plain_and_numpy(cuda, name, B, H, W):
    args = tps.make_case(name, B, H, W)
    library.reset_launches()
    got = tscore.pair_scores(*(t.to(cuda) for t in args))
    assert library.launches["pair_scores"] == 1
    plain = tscore.pair_scores_plain(*args)
    # the squared error is an exact integer; the SSIM sums differ only by
    # their order of summation
    assert torch.equal(got[:, 0].cpu(), plain[:, 0])
    torch.testing.assert_close(got[:, 1:].cpu(), plain[:, 1:], rtol=1e-14,
                               atol=0)
    scores = tscore.psnr_ssim(got.cpu().numpy(), H, W)
    tps.assert_scores_match(scores, tscore.psnr_ssim(plain.numpy(), H, W))
    tps.assert_scores_match(scores, tps.numpy_scores(*args))


@pytest.mark.gpu
def test_pair_scores_kernel_repeats_bit_equal(cuda):
    """The evaluation's batch (12 pairs at 512^2, the warp output's channel
    slice): two launches give the same bits, and one launch a call."""
    args = [t.to(cuda) for t in tps.make_case("channel_slice", 12, 512,
                                              512, seed=3)]
    library.reset_launches()
    first = tscore.pair_scores(*args)
    second = tscore.pair_scores(*args)
    assert library.launches["pair_scores"] == 2
    assert torch.equal(first, second)
    tps.assert_scores_match(
        tscore.psnr_ssim(first.cpu().numpy(), 512, 512),
        tps.numpy_scores(*(t.cpu() for t in args)))


@pytest.mark.gpu
def test_pair_scores_kernel_refuses(cuda):
    img1, warped, valid = (t.to(cuda) for t in tps.make_case("random", 1,
                                                             16, 16))
    with pytest.raises(TypeError):
        tscore.pair_scores(img1.double(), warped.double(), valid.double())
    with pytest.raises(ValueError):             # one tensor on the CPU
        tscore.pair_scores(img1, warped.cpu(), valid)
