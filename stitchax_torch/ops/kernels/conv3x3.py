"""K5: 3x3 convolution (stride 1, zero padding 1) + bias + ReLU on NHWC fp32
(csrc/conv3x3.cu).

It replaces no TPU kernel: stitchax runs these convolutions in XLA. It runs
the three 3x3 convolutions of FlowFormer++'s motion encoder
(`BasicMotionEncoder`, models/flowformer.py) in fp32, where cuDNN, with
TF32 off, takes them by FFT on the CUDA cores. The kernel is an implicit
GEMM on the tensor cores in 3xTF32 (each operand split into tf32 hi and lo
parts, each product taken as lo*hi + hi*lo + hi*hi), which keeps fp32's
accuracy. `conv3x3_relu` launches it for CUDA tensors and takes the plain
PyTorch version only for CPU tensors. It takes fp32, Cin a multiple of 4
and a contiguous, 16-byte aligned input, and raises otherwise.

Under autograd the kernel runs inside `Conv3x3Relu`, whose backward masks
the upstream gradient by the saved output's ReLU, as autograd does for
`F.relu(Conv(x))`, and recomputes no forward: the input's gradient is K5
again (the same convolution of that gradient with the weight transposed
and flipped, where cuDNN takes FFT), the weight's and the bias's are
`convolution_backward` on the saved input, as autograd computes them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import library


def conv3x3_relu_plain(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """relu(conv3x3(x) + bias) for x (B, H, W, Cin), weight (Cout, Cin, 3,
    3), bias (Cout,): `F.relu(Conv(x))` of models/layers.py."""
    return F.relu(F.conv2d(x.permute(0, 3, 1, 2), weight, bias,
                           padding=1).permute(0, 2, 3, 1))


class Conv3x3Relu(torch.autograd.Function):
    """K5 forward; the backward of ReLU and of the convolution, from the
    saved output, input and weight."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        out = _launch(x, weight, bias)
        ctx.save_for_backward(x, weight, out)
        library.grad_launches["conv3x3"] += 1
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


def conv3x3_relu(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return conv3x3_relu_plain(x, weight, bias)
    if library.needs_grad(x, weight, bias):
        return Conv3x3Relu.apply(x, weight, bias)
    return _launch(x, weight, bias)


def input_grad_operands(g: torch.Tensor, weight: torch.Tensor):
    """The input gradient of a 3x3, stride 1, padding 1 convolution is the
    same convolution of the gradient `g` (B, H, W, Cout) to its output with
    the weight transposed and flipped: those two operands, the channels of
    `g` (and the weight's matching ones) zero-padded to a multiple of 4 for
    K5."""
    wt = weight.detach().transpose(0, 1).flip(2, 3)
    pad = -g.shape[-1] % 4
    if pad:
        g = F.pad(g, (0, pad))
        wt = F.pad(wt, (0, 0, 0, 0, 0, pad))
    return g.contiguous(), wt


def input_grad(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The gradient to the input of the convolution by `weight`, from the
    gradient `g` to its output, on K5."""
    return _launch(*input_grad_operands(g, weight), None, relu=False)


def _launch(x, weight, bias, relu: bool = True) -> torch.Tensor:
    B, H, W, Cin = x.shape
    Cout = weight.shape[0]
    if weight.shape != (Cout, Cin, 3, 3) or (
            bias is not None and bias.shape != (Cout,)):
        raise ValueError(f"conv3x3: unsupported shapes x{tuple(x.shape)} "
                         f"weight{tuple(weight.shape)} bias"
                         f"{None if bias is None else tuple(bias.shape)}")
    tensors = (x, weight) if bias is None else (x, weight, bias)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"conv3x3: takes float32, got "
                        f"{[t.dtype for t in tensors]}")
    if Cin % 4:
        raise ValueError(f"conv3x3: Cin must be a multiple of 4, got {Cin}")
    library.require_cuda("conv3x3", x, *tensors[2:])
    if weight.device != x.device:
        raise ValueError("conv3x3: tensors must share one CUDA device")
    if x.data_ptr() % 16:
        raise ValueError("conv3x3: x must be 16-byte aligned")
    # K-major (Cout, 3, 3, Cin): a new tensor, so aligned
    wk = weight.detach().permute(0, 2, 3, 1).contiguous()
    out = torch.empty(B, H, W, Cout, device=x.device, dtype=x.dtype)
    err = library.load_library().stx_conv3x3(
        x.data_ptr(), wk.data_ptr(), None if bias is None else
        bias.data_ptr(), out.data_ptr(), B, H, W, Cin, Cout, int(relu),
        library.stream_of(x))
    library.check(err, "conv3x3")
    library.launches["conv3x3" if relu else "conv3x3_input_grad"] += 1
    return out
