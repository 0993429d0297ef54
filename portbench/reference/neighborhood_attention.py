"""Neighborhood attention, NATTEN's definition (port of
stitchax/ops/neighborhood_attention.py).

Each query attends to a k x k window that is shifted, not zero-padded, at
the borders, with a learned relative-position bias:

  start_i = clamp(i - k // 2, 0, H - k)
  attn    = softmax(q . k_nbr * scale + rpb[rel_i, rel_j])
  out     = attn @ v_nbr

Plain PyTorch (stitchax has no Pallas kernel here): a loop over the k^2
window offsets, each gathering one neighbour row and column per query,
so no (k^2, d) stack of neighbours is held at once.
"""

from __future__ import annotations

import torch


def _window_starts(n: int, k: int, device) -> torch.Tensor:
    return torch.clamp(torch.arange(n, device=device) - k // 2, 0, n - k)


def neighborhood_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           rpb: torch.Tensor, kernel_size: int = 7
                           ) -> torch.Tensor:
    """q / k / v (B, H, W, heads, d), rpb (heads, 2 k - 1, 2 k - 1) ->
    (B, H, W, heads, d). On a map smaller than the kernel the window
    shrinks per axis to the map's extent, made odd; the bias is still
    indexed by the true offsets (stitchax's rule)."""
    B, H, W, heads, d = q.shape
    ks, dev = kernel_size, q.device
    ks_h = min(ks, H if H % 2 == 1 else H - 1)
    ks_w = min(ks, W if W % 2 == 1 else W - 1)
    scale = d ** -0.5
    si, sj = _window_starts(H, ks_h, dev), _window_starts(W, ks_w, dev)
    rows, cols = torch.arange(H, device=dev), torch.arange(W, device=dev)

    logits = []
    for a in range(ks_h):
        ri = si + a                              # neighbour row per row
        rel_i = ri - rows + ks - 1
        k_rows = k[:, ri]
        for b in range(ks_w):
            cj = sj + b
            rel_j = cj - cols + ks - 1
            logit = (q * k_rows[:, :, cj]).sum(-1) * scale   # (B, H, W, n)
            bias = rpb[:, rel_i[:, None], rel_j[None, :]]    # (n, H, W)
            logits.append(logit + bias.permute(1, 2, 0)[None])
    attn = torch.softmax(torch.stack(logits, -1), -1)    # (B, H, W, n, k^2)
    out = torch.zeros_like(q)
    for a in range(ks_h):
        v_rows = v[:, si + a]
        for b in range(ks_w):
            out = out + attn[..., a * ks_w + b, None] * v_rows[:, :, sj + b]
    return out
