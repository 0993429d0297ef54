"""K4: windowed (LSA) multi-head attention (csrc/window_attention.cu).

Port of `window_attention_pallas` (tools/exp_window_attn.py:96), which
computes stitchax's `window_attention_split`
(stitchax/ops/window_attention.py:53). Inputs are the bias-free projected
streams qx/kx/vx (B, H, W, C) plus per-window-position biases q_bias/k_bias
(ws*ws, C) and v_bias (1, C): zero-padded border tokens then reduce exactly
to the biases, as the reference pads before projecting, and take part as
keys and values. `window_attention` launches the CUDA kernel for CUDA
tensors and takes the plain PyTorch version only for CPU tensors. In bf16
the kernel runs on the tensor cores and reads each token's channels with
16-byte loads, so it takes 16-byte aligned tensors whose strides are
multiples of 8 elements (as the main path's are) and raises otherwise.
Under autograd the kernel runs inside `WindowAttention`, whose backward
differentiates the plain version for the three streams and the three
biases: stitchax's LSA blocks are XLA (stitchax/ops/window_attention.py:52),
so that is the gradient stitchax trains with.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import library

HEAD_DIMS = (16, 32)
MAX_TOKENS = 64          # ws * ws: four 16-row tiles (bf16), one thread
                         # per query row (fp32)


def partition(t: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> zero-padded windows (B, nW, ws*ws, C)."""
    B, H, W, C = t.shape
    ph, pw = (ws - H % ws) % ws, (ws - W % ws) % ws
    t = F.pad(t, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    t = t.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
    return t.permute(0, 1, 3, 2, 4, 5).reshape(B, -1, ws * ws, C)


def biased_windows(qx, kx, vx, q_bias, k_bias, v_bias, ws: int):
    """The partitioned streams with their biases added in the streams'
    dtype, as stitchax adds them: three (B, nW, ws*ws, C) tensors."""
    T = ws * ws
    C = qx.shape[-1]
    return (partition(qx, ws) + q_bias.reshape(1, 1, T, C),
            partition(kx, ws) + k_bias.reshape(1, 1, T, C),
            partition(vx, ws) + v_bias.reshape(1, 1, 1, C))


def window_attention_plain(qx, kx, vx, q_bias, k_bias, v_bias, *, heads: int,
                           ws: int) -> torch.Tensor:
    """Pad, partition, add the biases (rounded to the streams' dtype), then
    per window and head softmax(q k^T * d^-0.5) v in fp32, rounded once to
    the streams' dtype, merged and cropped to (B, H, W, C)."""
    B, H, W, C = qx.shape
    T = ws * ws
    d = C // heads
    q, k, v = biased_windows(qx, kx, vx, q_bias, k_bias, v_bias, ws)

    def split(t):
        return t.float().reshape(B, -1, T, heads, d).transpose(2, 3)

    qh, kh, vh = split(q), split(k), split(v)
    attn = torch.softmax(qh @ kh.transpose(-1, -2) * d ** -0.5, dim=-1)
    Hp, Wp = -(-H // ws) * ws, -(-W // ws) * ws
    o = (attn @ vh).transpose(2, 3).reshape(B, Hp // ws, Wp // ws, ws, ws, C)
    o = o.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    return o[:, :H, :W].to(qx.dtype)


def _token_stride(t: torch.Tensor, name: str) -> int:
    """Token stride of a (B, H, W, C) view whose tokens are evenly spaced
    (e.g. one third of a fused qkv product); raises otherwise."""
    s0, s1, s2, s3 = t.stride()
    _, H, W, _ = t.shape
    if s3 != 1 or s1 != W * s2 or s0 != H * W * s2:
        raise ValueError(f"window_attention: {name} must have channel stride"
                         f" 1 and evenly spaced tokens, got strides "
                         f"{t.stride()}")
    return s2


class WindowAttention(torch.autograd.Function):
    """K4 forward, the plain version's gradient backward."""

    @staticmethod
    def forward(ctx, qx, kx, vx, q_bias, k_bias, v_bias, heads, ws):
        ctx.save_for_backward(qx, kx, vx, q_bias, k_bias, v_bias)
        ctx.heads, ctx.ws = heads, ws
        out = _launch(qx, kx, vx, q_bias, k_bias, v_bias, heads, ws)
        library.grad_launches["window_attention"] += 1
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        return (*library.plain_backward(
            window_attention_plain, ctx.saved_tensors,
            ctx.needs_input_grad[:6], grad_out, heads=ctx.heads,
            ws=ctx.ws), None, None)


def window_attention(qx, kx, vx, q_bias, k_bias, v_bias, *, heads: int,
                     ws: int) -> torch.Tensor:
    if qx.device.type == "cpu":
        return window_attention_plain(qx, kx, vx, q_bias, k_bias, v_bias,
                                      heads=heads, ws=ws)
    if library.needs_grad(qx, kx, vx, q_bias, k_bias, v_bias):
        return WindowAttention.apply(qx, kx, vx, q_bias, k_bias, v_bias,
                                     heads, ws)
    return _launch(qx, kx, vx, q_bias, k_bias, v_bias, heads, ws)


def _launch(qx, kx, vx, q_bias, k_bias, v_bias, heads: int,
            ws: int) -> torch.Tensor:
    # the checks read each tensor's attributes once: this host path is
    # most of an event-clocked call at the main path's small shapes
    shape, dtype, dev = qx.shape, qx.dtype, qx.device
    B, H, W, C = shape
    T = ws * ws
    if (kx.shape != shape or vx.shape != shape or C % heads
            or C // heads not in HEAD_DIMS or not 0 < T <= MAX_TOKENS
            or q_bias.shape != (T, C) or k_bias.shape != (T, C)
            or v_bias.shape != (1, C)):
        raise ValueError(
            f"window_attention: unsupported shapes qx{tuple(qx.shape)} "
            f"kx{tuple(kx.shape)} vx{tuple(vx.shape)} q_bias"
            f"{tuple(q_bias.shape)} k_bias{tuple(k_bias.shape)} v_bias"
            f"{tuple(v_bias.shape)} heads={heads} ws={ws}")
    tensors = (qx, kx, vx, q_bias, k_bias, v_bias)
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError("window_attention: streams and biases must "
                            "share a dtype")
        if t.device != dev or dev.type != "cuda":
            raise ValueError("window_attention: tensors must share one "
                             "CUDA device")
    qbs, qbc = q_bias.stride()
    kbs, kbc = k_bias.stride()
    if qbc != 1 or kbc != 1 or v_bias.stride(1) != 1:
        raise ValueError("window_attention: biases need channel stride 1")
    qs, ks, vs = (_token_stride(qx, "qx"), _token_stride(kx, "kx"),
                  _token_stride(vx, "vx"))
    ptrs = [t.data_ptr() for t in tensors]
    code = library.dtype_code(dtype)
    if code == library.BFLOAT16 and (any(p % 16 for p in ptrs)
                                     or (qs | ks | vs | qbs | kbs) % 8):
        raise ValueError("window_attention: bf16 tensors must be 16-byte "
                         "aligned with strides that are multiples of 8")
    out = torch.empty(shape, device=dev, dtype=dtype)
    err = library.load_library().stx_window_attention(
        *ptrs, out.data_ptr(), B, H, W, C, heads, ws, qs, ks, vs, qbs, kbs,
        code, library.stream_of(qx))
    library.check(err, "window_attention")
    library.launches["window_attention"] += 1
    return out
