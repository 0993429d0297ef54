"""K1: fused global-subsample attention (csrc/gsa_attention.cu).

Port of `gsa_attention_pallas` (stitchax/ops/pallas/gsa_attention.py:51).
`gsa_attention` launches the CUDA kernel for CUDA tensors and takes the plain
PyTorch version only for CPU tensors. bf16 runs on the tensor cores with P
rounded to bf16 for the P V product (within one bf16 ulp of max |out| of
the plain version); fp32 runs on the tensor cores too, in 3xTF32: each
operand split into tf32 hi and lo parts and each product taken as lo*hi +
hi*lo + hi*hi, which keeps fp32's accuracy (within 2e-5 of the plain
version) without TF32's loss. The kernel reads q, k and v 16 bytes at a
time, so it takes 16-byte aligned tensors (as the main path's are). Under
autograd the kernel runs inside `GsaAttention`, a `torch.autograd.Function`
whose backward differentiates the plain version, as stitchax's custom_vjp
does (stitchax/ops/pallas/gsa_attention.py:116).
"""

from __future__ import annotations

import torch

from . import library

MAX_KEYS = 256
HEAD_DIMS = (16, 32)


def gsa_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, heads: int) -> torch.Tensor:
    """q (B, N, C), k/v (B, M, C) -> (B, N, C): multi-head softmax
    attention, logits scaled by (C/heads)^-0.5, computed in fp32, output in
    q's dtype (the oracle `gsa_attention_ref`, :92)."""
    B, N, C = q.shape
    M = k.shape[1]
    d = C // heads
    qh = q.float().reshape(B, N, heads, d).transpose(1, 2)
    kh = k.float().reshape(B, M, heads, d).transpose(1, 2)
    vh = v.float().reshape(B, M, heads, d).transpose(1, 2)
    attn = torch.softmax(qh @ kh.transpose(-1, -2) * d ** -0.5, dim=-1)
    out = (attn @ vh).transpose(1, 2).reshape(B, N, C)
    return out.to(q.dtype)


class GsaAttention(torch.autograd.Function):
    """K1 forward, the plain version's gradient backward."""

    @staticmethod
    def forward(ctx, q, k, v, heads):
        ctx.save_for_backward(q, k, v)
        ctx.heads = heads
        out = _launch(q, k, v, heads)
        library.grad_launches["gsa_attention"] += 1
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        return (*library.plain_backward(
            gsa_attention_plain, ctx.saved_tensors, ctx.needs_input_grad[:3],
            grad_out, heads=ctx.heads), None)


def gsa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  heads: int) -> torch.Tensor:
    if q.device.type == "cpu":
        return gsa_attention_plain(q, k, v, heads=heads)
    if library.needs_grad(q, k, v):
        return GsaAttention.apply(q, k, v, heads)
    return _launch(q, k, v, heads)


def _launch(q, k, v, heads: int) -> torch.Tensor:
    library.require_cuda("gsa_attention", q, k, v)
    B, N, C = q.shape
    M = k.shape[1]
    if (k.shape != (B, M, C) or v.shape != (B, M, C) or C % heads
            or C // heads not in HEAD_DIMS or not 0 < M <= MAX_KEYS):
        raise ValueError(f"gsa_attention: unsupported shapes q{tuple(q.shape)}"
                         f" k{tuple(k.shape)} v{tuple(v.shape)} heads={heads}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError("gsa_attention: q, k, v must share a dtype")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("gsa_attention: q, k, v must be 16-byte aligned")
    out = torch.empty_like(q)
    lib = library.load_library()
    err = lib.stx_gsa_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, M, C,
        heads, library.dtype_code(q.dtype), library.stream_of(q))
    library.check(err, "gsa_attention")
    library.launches["gsa_attention"] += 1
    return out
