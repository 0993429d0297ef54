"""Mixed precision, as stitchax runs it (stitchax/utils/precision.py:27).

The neural backbones run in bfloat16 (parameters and activations cast to
bf16, matmuls accumulating in fp32 on the card) and hand fp32 outputs back;
geometry (DLT/TPS solves, canvas math) stays fp32. `fp32_exact()` turns off
the TF32 paths PyTorch would otherwise take for fp32 matmuls and
convolutions on the card, wherever fp32 results are compared.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def cast_floats(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every floating tensor in a nested list/tuple/dict."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(t, dtype) for t in tree)
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    return tree


def call_in(fn: Callable, dtype: torch.dtype, *args) -> Any:
    """Run `fn(*args)` (a module or its method, whose parameters are
    already held in `dtype`) on args cast to `dtype`, and return fp32
    outputs -- stitchax's `bf16_call` for dtype=bfloat16."""
    with torch.no_grad():
        out = fn(*cast_floats(args, dtype))
    return cast_floats(out, torch.float32)


def fp32_exact() -> None:
    """fp32 matmuls and convolutions in full fp32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
