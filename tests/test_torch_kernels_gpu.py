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
             (3, 37, 256, 128, 8)]   # d = 16, M at the kernel's limit


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


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["opencv", "kornia"])
def test_tps_kernel_matches_plain(cuda, variant):
    g = torch.Generator().manual_seed(0)
    ctrl = torch.rand(77, 2, generator=g).to(cuda)
    kw = (torch.randn(77, 2, generator=g) * .05).to(cuda)
    aw = torch.tensor([[0.01, -0.02], [1.0, 0.05], [0.02, 0.97]], device=cuda)
    got = ttps.tps_grid(ctrl, kw, aw, 100, 130, variant)
    want = ttps.tps_grid_plain(ctrl, kw, aw, 100, 130, variant)
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


# K4 shapes (B, H, W, C, heads, fused): the main path's (stage 1 and 2 of
# the twins encoders, whose LSA blocks split one fused qkv product into
# strided views with broadcast biases; the cost perceiver's vertical blocks
# on 2 directions x 8 latents), and ragged ones
WINDOW_CASES = [(2, 128, 128, 128, 4, True), (2, 64, 64, 256, 8, True),
                (16, 64, 64, 128, 8, False), (1, 9, 10, 32, 2, False),
                (3, 14, 21, 64, 4, True), (2, 16, 20, 256, 8, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,heads,fused", WINDOW_CASES)
def test_window_kernel_matches_plain(cuda, dtype, B, H, W, C, heads, fused):
    g = torch.Generator().manual_seed(0)
    if fused:
        qkv = torch.randn(B, H, W, 3 * C, generator=g).to(cuda, dtype)
        qx, kx, vx = qkv.split(C, -1)
        bias = (torch.randn(3 * C, generator=g) * .3).to(cuda, dtype)
        qb, kb, vb = bias.split(C)
        qb, kb, vb = qb.expand(49, C), kb.expand(49, C), vb[None]
    else:
        qx, kx, vx = (torch.randn(B, H, W, C, generator=g).to(cuda, dtype)
                      for _ in range(3))
        qb, kb = ((torch.randn(49, C, generator=g) * .3).to(cuda, dtype)
                  for _ in range(2))
        vb = (torch.randn(1, C, generator=g) * .3).to(cuda, dtype)
    args = (qx, kx, vx, qb, kb, vb)
    got = twa.window_attention(*args, heads=heads, ws=7)
    want = twa.window_attention_plain(*args, heads=heads, ws=7)
    # fp32: summation order only. bf16: both round the biased streams to
    # bf16, take the softmax and sums in fp32 and round once; one bf16 ulp
    # (8 significant bits) of max |out|
    top = want.float().abs().max().item()
    tol = (2e-5 if dtype == torch.float32
           else 2.0 ** (math.floor(math.log2(top)) - 7))
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
