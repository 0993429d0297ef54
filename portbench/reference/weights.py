"""Reading the tracked npz snapshot into the reference's nets: a frozen
copy of the port's `convert.load_npz` / `load_jax_params` (stitchax's
flax layout -> PyTorch state_dict names, kernels HWIO -> OIHW, bf16
leaves decoded exactly)."""

from __future__ import annotations

from typing import Any, Collection, Dict

import numpy as np
import torch


def decode_bf16(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit patterns -> float32 (exact)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)


def _key_path(key: str):
    """Split a key like ['flow']['params']['a'] into its parts."""
    return tuple(p.strip("'\"") for p in key.strip()[1:-1].split("]["))


def load_npz(path: str, subtree: str | None = None) -> Dict[str, Any]:
    """Nested dict of float32 numpy arrays from a stitchax npz snapshot,
    optionally only the top-level `subtree` ('flow', 'homo', 'comp')."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            arr = data[key]
            if key.startswith("bf16:"):
                key, arr = key[len("bf16:"):], decode_bf16(arr)
            parts = _key_path(key)
            if subtree is not None:
                if parts[0] != subtree:
                    continue
                parts = parts[1:]
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(arr)
    if not tree:
        raise KeyError(f"{path}: no leaves under {subtree!r}")
    return tree


def _flatten(tree: Dict[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


_LEAF = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def params_from_jax(variables: Dict[str, Any],
                    conv_transpose: Collection[str] = ()
                    ) -> Dict[str, torch.Tensor]:
    """stitchax variables {'params': ..., 'batch_stats': ...} -> the port's
    state_dict (float32 tensors). `conv_transpose` names the modules
    (dotted paths) that are flax ConvTransposes."""
    sd: Dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"unexpected variable collection {collection!r}")
        for path, arr in _flatten(tree):
            *mods, leaf = path
            if leaf == "kernel":
                leaf = "weight"
                if ".".join(mods) in conv_transpose:
                    # HWIO, flipped in space -> (I, O, kH, kW)
                    arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
                elif arr.ndim == 4:          # HWIO -> OIHW
                    arr = arr.transpose(3, 2, 0, 1)
                elif arr.ndim == 2:          # (in, out) -> (out, in)
                    arr = arr.T
            else:
                leaf = _LEAF.get(leaf, leaf)
            name = ".".join([*mods, leaf])
            if name in sd:
                raise KeyError(f"two stitchax leaves map onto {name}")
            sd[name] = torch.tensor(np.ascontiguousarray(arr),
                                    dtype=torch.float32)
    return sd


def load_jax_params(module: torch.nn.Module,
                    variables: Dict[str, Any]) -> torch.nn.Module:
    """Fill every parameter and buffer of `module` from a stitchax
    variables tree; raises on any leaf left unused, any parameter left
    unfilled, or any shape mismatch."""
    sd = params_from_jax(variables, {
        name for name, m in module.named_modules()
        if isinstance(m, torch.nn.ConvTranspose2d)})
    own = module.state_dict()
    unused = sorted(set(sd) - set(own))
    unfilled = sorted(set(own) - set(sd))
    if unused or unfilled:
        raise KeyError(f"stitchax leaves unused: {unused[:8]}"
                       f"{'...' if len(unused) > 8 else ''}; "
                       f"parameters unfilled: {unfilled[:8]}"
                       f"{'...' if len(unfilled) > 8 else ''}")
    for k, v in sd.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: stitchax {tuple(v.shape)} vs port "
                             f"{tuple(own[k].shape)}")
    module.load_state_dict(sd, strict=True)
    return module


# the recurrent decoder's leaves, which FlowFormerPretrain does not have
_FLOW_DECODER_ONLY = ("proj", "att", "mask_head")
