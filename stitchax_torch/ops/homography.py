"""Batched 4-point DLT and normalized-space helpers (fp32).

Port of stitchax/ops/homography.py: the 8x8 DLT system on
Hartley-normalized points, solved with a batched linear solve.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tracing import count_sync


# sqrt(2) and its reciprocal as fp32 constants (jnp.sqrt(2.0) and XLA's
# folded 1 / sqrt(2))
SQRT2 = float(np.float32(np.sqrt(2.0)))
INV_SQRT2 = float(np.float32(1.0) / np.float32(SQRT2))


def dlt_solve(src_p: torch.Tensor, dst_p: torch.Tensor,
              normalize: bool = True) -> torch.Tensor:
    """src/dst (B, 4, 2) -> H (B, 3, 3) with H[2, 2] = 1."""
    if normalize:
        def norm_T(p):
            c = p.mean(1, keepdim=True)
            d = torch.clamp(torch.sqrt(((p - c) ** 2).sum(-1)).mean(1),
                            min=1e-8)
            # a true division (a python number over a tensor would be
            # the tensor's reciprocal times the number in torch)
            return c[:, 0], torch.full_like(d, SQRT2) / d, d

        c_s, s_s, _ = norm_T(src_p)
        c_d, s_d, d_d = norm_T(dst_p)
        src_n = (src_p - c_s[:, None]) * s_s[:, None, None]
        dst_n = (dst_p - c_d[:, None]) * s_d[:, None, None]
        Hn = dlt_solve(src_n, dst_n, normalize=False)
        zeros, ones = torch.zeros_like(s_s), torch.ones_like(s_s)
        T_src = torch.stack([
            torch.stack([s_s, zeros, -s_s * c_s[:, 0]], -1),
            torch.stack([zeros, s_s, -s_s * c_s[:, 1]], -1),
            torch.stack([zeros, zeros, ones], -1)], 1)
        # 1 / s_d as XLA folds it under jit: d times the rounded 1/sqrt(2)
        inv_s_d = d_d * INV_SQRT2
        T_dst_inv = torch.stack([
            torch.stack([inv_s_d, zeros, c_d[:, 0]], -1),
            torch.stack([zeros, inv_s_d, c_d[:, 1]], -1),
            torch.stack([zeros, zeros, ones], -1)], 1)
        H = T_dst_inv @ Hn @ T_src
        return H / H[:, 2:3, 2:3]

    B = src_p.shape[0]
    x, y = src_p[..., 0], src_p[..., 1]
    xp, yp = dst_p[..., 0], dst_p[..., 1]
    ones, zeros = torch.ones_like(x), torch.zeros_like(x)
    row_x = torch.stack([x, y, ones, zeros, zeros, zeros, -x * xp, -y * xp], -1)
    row_y = torch.stack([zeros, zeros, zeros, x, y, ones, -x * yp, -y * yp], -1)
    A = torch.stack([row_x, row_y], 2).reshape(B, 8, 8)
    b = torch.stack([xp, yp], 2).reshape(B, 8, 1)
    count_sync(A.device)            # linalg.solve checks it on the host
    h8 = torch.linalg.solve(A, b).reshape(B, 8)
    return torch.cat([h8, torch.ones_like(h8[:, :1])], 1).reshape(B, 3, 3)


def scale_matrix(h: float, w: float, device=None,
                 dtype=torch.float32) -> torch.Tensor:
    """M mapping normalized [-1, 1] coords to pixels of an (h, w) image."""
    count_sync(device)              # a blocking host-to-device copy
    return torch.tensor([[w / 2.0, 0.0, w / 2.0], [0.0, h / 2.0, h / 2.0],
                         [0.0, 0.0, 1.0]], device=device, dtype=dtype)
