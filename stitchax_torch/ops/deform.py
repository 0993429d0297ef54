"""Deformable convolution as a bilinear gather plus one matmul (port of
stitchax/ops/deform.py, mmcv DeformConv2d semantics: one deform group, no
modulation mask, zero padding, no bias).

    out(p) = sum_k W_k * x(p + r_k + delta_k(p))

r_k are the regular KxK taps (row-major), delta_k the learned per-pixel
offsets stored as 2*K*K channels ordered (dy, dx) per tap. A tap whose
corner falls outside the map reads zero. stitchax computes this outside
any Pallas kernel, so here it is plain PyTorch: four gathers and a
`torch.matmul`. Arithmetic runs in the input's dtype, as stitchax's does.
With the tracer on, each call bumps `deform.calls` by one and
`deform.taps_gathered` by B*H*W*K*K*C, the elements of the gathered taps.
"""

from __future__ import annotations

import torch

from ..utils.tracing import count


def _bilinear_gather_zero(img: torch.Tensor, x: torch.Tensor,
                          y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample img (B, H, W, C) at pixel coords x/y (B, ...) with
    zero padding -> (B, ..., C)."""
    B, H, W, C = img.shape
    shape = x.shape
    x = x.reshape(B, -1)
    y = y.reshape(B, -1)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    flat = img.reshape(B, H * W, C)

    def tap(xi, yi, w):
        ix = xi.nan_to_num(0.0).clamp(0, W - 1).long()
        iy = yi.nan_to_num(0.0).clamp(0, H - 1).long()
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        v = torch.gather(flat, 1, (iy * W + ix)[..., None].expand(-1, -1, C))
        return v * (w * inb.to(img.dtype))[..., None]

    out = (tap(x0, y0, (1 - wx) * (1 - wy)) + tap(x0 + 1, y0, wx * (1 - wy))
           + tap(x0, y0 + 1, (1 - wx) * wy) + tap(x0 + 1, y0 + 1, wx * wy))
    return out.reshape(*shape, C)


def deform_conv2d_b(x: torch.Tensor, offsets: torch.Tensor,
                    weights: torch.Tensor, kernel_size: int = 3
                    ) -> torch.Tensor:
    """x (B, H, W, C); offsets (B, H, W, 2*K*K); weights (K*K*C, C_out)
    -> (B, H, W, C_out)."""
    B, H, W, C = x.shape
    K = kernel_size
    r = K // 2
    dev, dt = x.device, x.dtype
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=dt),
                            torch.arange(W, device=dev, dtype=dt),
                            indexing="ij")
    tap = torch.arange(K * K, device=dev)
    ti = (tap // K - r).to(dt)          # row offset of each tap
    tj = (tap % K - r).to(dt)           # column offset
    off = offsets.reshape(B, H, W, K * K, 2)
    sy = (ys[..., None] + ti) + off[..., 0]
    sx = (xs[..., None] + tj) + off[..., 1]
    taps = _bilinear_gather_zero(x, sx, sy)          # (B, H, W, K*K, C)
    count("deform.calls")
    count("deform.taps_gathered", B * H * W * K * K * C)
    out = taps.reshape(B, H * W, K * K * C) @ weights
    return out.reshape(B, H, W, -1)


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor,
                  weights: torch.Tensor, kernel_size: int = 3
                  ) -> torch.Tensor:
    """Unbatched deform_conv2d_b: x (H, W, C), offsets (H, W, 2*K*K)."""
    return deform_conv2d_b(x[None], offsets[None], weights, kernel_size)[0]
