"""Input padding to a multiple of 8 (port of stitchax/ops/padding.py)."""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F


class InputPadder:
    """Pads NHWC images so H and W divide by `multiple`
    (reference core/utils/utils.py:7-30)."""

    def __init__(self, shape: Tuple[int, ...], mode: str = "sintel",
                 multiple: int = 8):
        self.ht, self.wd = shape[-3], shape[-2]
        m = multiple
        pad_ht = (((self.ht // m) + 1) * m - self.ht) % m
        pad_wd = (((self.wd // m) + 1) * m - self.wd) % m
        self.mode = mode
        if mode == "sintel":
            self._pad = (pad_wd // 2, pad_wd - pad_wd // 2,
                         pad_ht // 2, pad_ht - pad_ht // 2)
        elif mode == "downzero":
            self._pad = (0, pad_wd, 0, pad_ht)
        else:
            self._pad = (pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht)

    def pad(self, *inputs: torch.Tensor) -> List[torch.Tensor]:
        mode = "constant" if self.mode == "downzero" else "replicate"
        out = []
        for x in inputs:
            y = F.pad(x.permute(0, 3, 1, 2), self._pad, mode=mode)
            out.append(y.permute(0, 2, 3, 1))
        return out

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        l, r, t, b = self._pad
        ht, wd = x.shape[-3], x.shape[-2]
        return x[..., t:ht - b, l:wd - r, :]
