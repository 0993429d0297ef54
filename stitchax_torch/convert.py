"""Weights carried across from stitchax param trees.

`load_npz` reads a stitchax npz snapshot (e.g. results/ckpt_r05_bf16.npz,
written by stitchax/convert.py `save_params_npz`) with numpy alone: every
float leaf is stored as the uint16 bit pattern of a bf16 value under a key
like "bf16:['flow']['params']['context_encoder']...", and decodes exactly
as `(bits.astype(uint32) << 16).view(float32)`.

`params_from_jax` maps a stitchax variables tree (nested dicts of numpy
arrays: {'params': ..., 'batch_stats': ...}) onto the port's state_dict.
The port's modules carry stitchax's module names, so the map is a rename of
the leaf plus the inverse of stitchax/convert.py:45-60: flax conv kernels
HWIO -> OIHW, Dense kernels (in, out) -> (out, in), LayerNorm/BatchNorm
scale -> weight, batch_stats mean/var -> running_mean/running_var. A flax
`ConvTranspose` kernel (kH, kW, I, O) becomes torch's `ConvTranspose2d`
weight (I, O, kH, kW) flipped in space: flax correlates the dilated input
with the kernel as it is, torch with the kernel flipped (the inverse of
stitchax/convert.py `conv_transpose_kernel`); its padding (lo, hi) maps to
torch's padding k-1-lo and output_padding hi-lo.

`load_flax_msgpack` reads flax's msgpack serialisation (e.g.
results/transref_ckpt_r05_bf16.msgpack, written by
`flax.serialization.to_bytes`) with numpy alone.
"""

from __future__ import annotations

import struct
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


# ------------------------- flax msgpack checkpoints ---------------------------

_EXT_NDARRAY = 1       # flax.serialization's ext type code of an array


def _array_from(shape, dtype_name: str, buf: bytes) -> np.ndarray:
    if dtype_name == "bfloat16":
        a = decode_bf16(np.frombuffer(buf, np.uint16))
    else:
        a = np.frombuffer(buf, np.dtype(dtype_name)).copy()
    return a.reshape(shape)


class _Reader:
    """msgpack decoder for what a flax state dict holds: maps, arrays,
    str/bin, ints, floats, nil, bool and flax's ext type 1 (an ndarray as
    [shape, dtype name, buffer])."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated input")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7f:
            return t
        if t >= 0xe0:
            return t - 0x100
        if 0x80 <= t <= 0x8f:
            return self.map(t & 0x0f)
        if 0x90 <= t <= 0x9f:
            return self.array(t & 0x0f)
        if 0xa0 <= t <= 0xbf:
            return self.take(t & 0x1f).decode()
        if 0xd4 <= t <= 0xd8:
            return self.ext(1 << (t - 0xd4))
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if t in simple:
            return simple[t]
        sized = {0xc4: ("B", bytes), 0xc5: ("H", bytes), 0xc6: ("I", bytes),
                 0xd9: ("B", str), 0xda: ("H", str), 0xdb: ("I", str),
                 0xdc: ("H", list), 0xdd: ("I", list), 0xde: ("H", dict),
                 0xdf: ("I", dict), 0xc7: ("B", "ext"), 0xc8: ("H", "ext"),
                 0xc9: ("I", "ext")}
        if t in sized:
            fmt, kind = sized[t]
            n = self.unpack(fmt)
            if kind is bytes:
                return self.take(n)
            if kind is str:
                return self.take(n).decode()
            if kind is list:
                return self.array(n)
            if kind is dict:
                return self.map(n)
            return self.ext(n)
        scalar = {0xca: "f", 0xcb: "d", 0xcc: "B", 0xcd: "H", 0xce: "I",
                  0xcf: "Q", 0xd0: "b", 0xd1: "h", 0xd2: "i", 0xd3: "q"}
        if t in scalar:
            return self.unpack(scalar[t])
        raise ValueError(f"msgpack: unsupported type byte 0x{t:02x}")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack("b")
        body = _Reader(self.take(n)).read()
        if code != _EXT_NDARRAY:
            raise ValueError(f"msgpack: unsupported ext type {code}")
        shape, dtype_name, buf = body
        return _array_from(tuple(shape), dtype_name, buf)


def load_flax_msgpack(path: str) -> Dict[str, Any]:
    """Nested dict of numpy arrays from a `flax.serialization.to_bytes`
    file; bf16 leaves decode exactly to float32 (as `load_npz`)."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    tree = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: not a flax state dict")
    return tree
