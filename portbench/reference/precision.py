"""The precision the reference computes in: float32 with TF32 off, or the
control's TF32 (the nearest precision below the configuration's float32).
On the card TF32 is PyTorch's own switch for matrix products and
convolutions. The CPU has no TF32, so there the control rounds the two
operands of every matrix product and convolution to TF32 (10 mantissa
bits, to nearest, ties away from zero, as `cvt.rna.tf32.f32`) and
multiplies them in float32."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (nearest, ties away);
    the gradient passes through the rounding unchanged, as it passes
    through a TF32 product's operands."""
    if x.dtype != torch.float32:
        return x
    d = x.detach()
    bits = d.contiguous().view(torch.int32)
    mag = (bits & 0x7FFFFFFF) + 0x1000
    rounded = (mag & ~0x1FFF) | (bits & ~0x7FFFFFFF)
    r = torch.where(torch.isfinite(d), rounded.view(torch.float32), d)
    return x + (r - d)


_PRODUCTS = {torch.matmul, torch.Tensor.__matmul__, torch.Tensor.matmul,
             torch.bmm, torch.mm, F.linear, F.conv2d, F.conv_transpose2d,
             torch.einsum}


class _TF32Products(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            if func is torch.einsum:
                args = (args[0], *[to_tf32(a) if isinstance(a, torch.Tensor)
                                   else a for a in args[1:]])
            else:
                args = tuple(to_tf32(a) if i < 2 and isinstance(a, torch.Tensor)
                             else a for i, a in enumerate(args))
        return func(*args, **kwargs)


@contextlib.contextmanager
def precision(tf32: bool, device):
    """float32 exact (TF32 off), or with `tf32` the control's TF32."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        if tf32 and torch.device(device).type == "cpu":
            with _TF32Products():
                yield
        else:
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
