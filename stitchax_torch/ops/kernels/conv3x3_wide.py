"""K7: 3x3 convolution (stride 1, zero padding 1) + bias + ReLU on NHWC fp32,
on Hopper's `wgmma` fed by TMA (csrc/conv3x3_wide.cu).

It replaces no TPU kernel: stitchax leaves these convolutions to XLA. It
runs the 13 convolutions of the VGG16 in TransRef's training loss
(`VGG16Features`, models/vgg.py), whose channels are all multiples of 64
but the first layer's 3, where cuDNN, with TF32 off, takes them as fp32
SIMT GEMMs on the CUDA cores. The kernel is an implicit GEMM on the tensor
cores in 3xTF32 (each operand split into tf32 hi and lo parts, each
product taken as lo*hi + hi*lo + hi*hi), which keeps fp32's accuracy.
`conv3x3_wide_relu` launches it for CUDA tensors and takes the plain
PyTorch version only for CPU tensors. It takes fp32, a contiguous,
16-byte aligned input and Cout a multiple of 4, and raises otherwise; an
input whose channels are not a multiple of 4 (the image's 3) is padded
with zero channels.

Under autograd the kernel runs inside `Conv3x3WideRelu`, whose backward
masks the upstream gradient by the saved output's ReLU, as autograd does
for `F.relu(conv(x))`, and recomputes no forward: the input's gradient is
K7 again (the same convolution of that gradient with the weight
transposed and flipped, which the kernel's weight split forms), the
weight's and the bias's are `convolution_backward` on the saved input,
only when they are asked for.

K5 (`conv3x3.py`) stays on FlowFormer++'s motion encoder: its 126-channel
layer's rows are only 8-byte aligned, which TMA's 16-byte strides and K7's
16-byte stores do not take.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import library
from .conv3x3 import conv3x3_relu_plain

# relu(conv3x3(x) + bias) for x (B, H, W, Cin), weight (Cout, Cin, 3, 3),
# bias (Cout,), NHWC in and out: K5's plain version
conv3x3_wide_relu_plain = conv3x3_relu_plain


def input_grad_plain(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The gradient to the input (B, H, W, Cin) of the convolution by
    `weight`, from the gradient `g` (B, H, W, Cout) to its output."""
    B, H, W, _ = g.shape
    return torch.nn.grad.conv2d_input(
        (B, weight.shape[1], H, W), weight, g.permute(0, 3, 1, 2),
        padding=1).permute(0, 2, 3, 1)


class Conv3x3WideRelu(torch.autograd.Function):
    """K7 forward; the backward of ReLU and of the convolution, from the
    saved output, input and weight."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        out = _forward(x, weight, bias)
        ctx.save_for_backward(x, weight, out)
        library.grad_launches["conv3x3_wide"] += 1
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        x, weight, out = ctx.saved_tensors
        nx, nw, nb = ctx.needs_input_grad
        g = torch.ops.aten.threshold_backward(grad_out, out, 0)
        gx = input_grad(g, weight) if nx else None
        gw = gb = None
        if nw or nb:
            _, gw, gb = torch.ops.aten.convolution_backward(
                g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), weight,
                [weight.shape[0]], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                [False, nw, nb])
        return gx, gw, gb


def conv3x3_wide_relu(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """relu(conv3x3(x) + bias), NHWC: K7 for CUDA tensors."""
    if x.device.type == "cpu":
        return conv3x3_wide_relu_plain(x, weight, bias)
    if library.needs_grad(x, weight, bias):
        return Conv3x3WideRelu.apply(x, weight, bias)
    return _forward(x, weight, bias)


def _forward(x, weight, bias):
    """K7 on x, its channels padded with zeros to a multiple of 4 (the
    image's 3: TMA's 16-byte rows); the padded copy is not kept."""
    pad = -x.shape[-1] % 4
    return _launch(F.pad(x, (0, pad)) if pad else x, weight, bias)


def input_grad(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The gradient (B, H, W, Cin) to the input of the convolution by
    `weight` (Cout, Cin, 3, 3), from the gradient `g` (B, H, W, Cout) to
    its output, on K7 (Cin computed padded to 4s and cut back)."""
    if g.device.type == "cpu":
        return input_grad_plain(g, weight)
    cin = weight.shape[1]
    out = _launch(g.contiguous(), weight, None, relu=False,
                  input_grad=True, n_out=cin + -cin % 4)
    return out if out.shape[-1] == cin else out[..., :cin]


def _launch(x, weight, bias, relu: bool = True, input_grad: bool = False,
            n_out: int = 0) -> torch.Tensor:
    B, H, W, C = x.shape
    O, I = weight.shape[:2]
    N = n_out if input_grad else O
    if weight.shape[2:] != (3, 3) or (C < O if input_grad else C < I) or (
            bias is not None and bias.shape != (N,)):
        raise ValueError(f"conv3x3_wide: unsupported shapes x{tuple(x.shape)}"
                         f" weight{tuple(weight.shape)} bias"
                         f"{None if bias is None else tuple(bias.shape)}")
    tensors = (x, weight) if bias is None else (x, weight, bias)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"conv3x3_wide: takes float32, got "
                        f"{[t.dtype for t in tensors]}")
    if C % 4 or N % 4:
        raise ValueError(f"conv3x3_wide: the input's channels ({C}) and the "
                         f"output's ({N}) must be multiples of 4")
    library.require_cuda("conv3x3_wide", x, *tensors[2:])
    if weight.device != x.device:
        raise ValueError("conv3x3_wide: tensors must share one CUDA device")
    if x.data_ptr() % 16 or (bias is not None and bias.data_ptr() % 16):
        raise ValueError("conv3x3_wide: x and bias must be 16-byte aligned")
    lib = library.load_library()
    w = weight.detach().contiguous()
    # the weight split into tf32 hi and lo planes, padded to whole tiles
    wp = torch.empty(lib.stx_conv3x3_wide_scratch(N, C), device=x.device,
                     dtype=x.dtype)
    out = torch.empty(B, H, W, N, device=x.device, dtype=x.dtype)
    err = lib.stx_conv3x3_wide(
        x.data_ptr(), w.data_ptr(), None if bias is None else
        bias.data_ptr(), wp.data_ptr(), out.data_ptr(), B, H, W, C, N, O, I,
        int(input_grad), int(relu), library.stream_of(x))
    library.check(err, "conv3x3_wide")
    library.launches["conv3x3_wide_input_grad" if input_grad
                     else "conv3x3_wide"] += 1
    return out
