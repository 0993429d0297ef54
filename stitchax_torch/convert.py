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

`params_to_jax` is the inverse of `params_from_jax`, and `save_params_npz`
writes a tree as stitchax/convert.py:551 does (the same key strings, float32
leaves as bf16 bit patterns rounded to nearest even, as ml_dtypes rounds;
or, with `bf16=False`, as float32 leaves under the plain key strings,
uncompressed, which both packages' readers take too).

`pretrain_variables` builds FlowFormerPretrain's tree from a FlowFormer
tree (the shared leaves) and a seeded pretrain head.

`load_flax_msgpack` reads flax's msgpack serialisation (e.g.
results/transref_ckpt_r05_bf16.msgpack, written by
`flax.serialization.to_bytes`) with numpy alone, and `save_flax_msgpack`
writes a tree of arrays as `flax.serialization.to_bytes` does (the same
bytes: keys in the dicts' order, arrays as flax's ext type 1), which flax's
`from_bytes` and `load_flax_msgpack` both restore. A flax VGG16Features
tree (stitchax/models/vgg.py) maps onto the port's `VGG16Features` through
`params_from_jax` / `params_to_jax` like any other conv stack.

`load_sd_container` reads a packed SD checkpoint (e.g.
results/sd_ckpt_r05.pt, a `torch.save`d dict); `conv_params`,
`linear_params` and `norm_params` map diffusers / transformers state-dict
entries onto stitchax's flax layout (stitchax/convert.py:45-77), so its
converters' trees load with `load_jax_params` like any other.
"""

from __future__ import annotations

import struct
from typing import Any, Collection, Dict

import numpy as np
import torch


def decode_bf16(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit patterns -> float32 (exact)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)


def encode_bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> uint16 bf16 bit patterns, rounded to nearest even; NaN
    stays a (quiet) NaN, as ml_dtypes converts."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rounded = ((bits + (0x7FFF + ((bits >> 16) & 1))) >> 16).astype(np.uint16)
    nan = np.isnan(np.asarray(x, np.float32))
    return np.where(nan, (bits >> 16).astype(np.uint16) | np.uint16(0x40),
                    rounded)


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


def params_to_jax(state_dict: Dict[str, torch.Tensor],
                  conv_transpose: Collection[str] = ()) -> Dict[str, Any]:
    """The port's state_dict -> stitchax variables {'params': ...[,
    'batch_stats': ...]} of float32 numpy arrays, the inverse of
    `params_from_jax`: running_mean/var -> batch_stats mean/var, a 1-D
    weight (a norm's) -> scale, a Linear weight (out, in) -> kernel (in,
    out), a conv weight OIHW -> HWIO, and the weight of a module named in
    `conv_transpose` -> flax's ConvTranspose kernel (flipped back)."""
    tree: Dict[str, Any] = {}
    for name, t in state_dict.items():
        *mods, leaf = name.split(".")
        arr = t.detach().to("cpu", torch.float32).numpy()
        collection = "params"
        if leaf in ("running_mean", "running_var"):
            collection, leaf = "batch_stats", leaf[len("running_"):]
        elif leaf == "weight":
            if ".".join(mods) in conv_transpose:
                arr, leaf = arr.transpose(2, 3, 0, 1)[::-1, ::-1], "kernel"
            elif arr.ndim == 4:
                arr, leaf = arr.transpose(2, 3, 1, 0), "kernel"
            elif arr.ndim == 2:
                arr, leaf = arr.T, "kernel"
            elif arr.ndim == 1:
                leaf = "scale"
            else:
                raise ValueError(f"{name}: no stitchax leaf for a "
                                 f"{arr.ndim}-D weight")
        node = tree.setdefault(collection, {})
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


def _keystr(path) -> str:
    """jax.tree_util.keystr of a path of dict keys: ['a']['b']."""
    return "".join(f"[{k!r}]" for k in path)


def save_params_npz(path: str, tree: Dict[str, Any],
                    bf16: bool = True) -> None:
    """A nested dict of arrays as an npz under stitchax's key strings:
    float32 leaves as bf16 bits under "bf16:<key>", compressed (stitchax's
    format), or with bf16=False as they are, uncompressed (zlib saves a
    fifth of float32 weights and takes seconds per 100 MB)."""
    flat = {}
    for path_, arr in sorted(_flatten(tree)):
        key = _keystr(path_)
        if bf16 and arr.dtype == np.float32:
            arr, key = encode_bf16(arr), "bf16:" + key
        flat[key] = arr
    (np.savez_compressed if bf16 else np.savez)(path, **flat)


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


def pretrain_variables(flow_variables: Dict[str, Any], cfg,
                       seed: int = 0) -> Dict[str, Any]:
    """FlowFormerPretrain's variables (stitchax flowformer.py:903) for a
    FlowFormerConfig `cfg` from a FlowFormer tree ({'params': ...}, e.g.
    load_npz(npz, 'flow')): the shared leaves as they are, the perceiver's
    layers cut to cfg.encoder_depth, the recurrent decoder's own leaves
    dropped, and the pretrain head (pretrain_head0/1/2, 1x1 convs Dq -> 2Dq
    -> 2Dq -> gt_r^2) drawn from numpy's default_rng(seed): kernels ~ N(0,
    1 / fan_in) as flax's lecun_normal draws them, biases 0. No pretrain
    checkpoint is in the repo; both packages load the result."""
    src = flow_variables["params"]
    perceiver = dict(src["memory_encoder"]["cost_perceiver"])
    for k in [k for k in perceiver if k.startswith(("encoder_layer",
                                                    "vertical_layer"))]:
        if int(k.rsplit("layer", 1)[1]) >= cfg.encoder_depth:
            del perceiver[k]
    decoder = {k: v for k, v in src["memory_decoder"].items()
               if k not in _FLOW_DECODER_ONLY}
    decoder["iteration"] = {k: v for k, v in decoder["iteration"].items()
                            if k != "update_block"}
    rng = np.random.default_rng(seed)
    Dq = cfg.query_latent_dim
    dims = (Dq, 2 * Dq, 2 * Dq, cfg.gt_r ** 2)
    for i in range(3):
        cin, cout = dims[i], dims[i + 1]
        decoder[f"pretrain_head{i}"] = {
            "kernel": (rng.standard_normal((1, 1, cin, cout))
                       / np.sqrt(cin)).astype(np.float32),
            "bias": np.zeros(cout, np.float32)}
    return {"params": {
        "context_encoder": src["context_encoder"],
        "memory_encoder": {**src["memory_encoder"],
                           "cost_perceiver": perceiver},
        "memory_decoder": decoder}}


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


def _packed_len(n: int, small: int, fix, codes) -> bytes:
    """The header of a msgpack map / array / str / bin of n entries (or a
    non-negative int n): the fix form below `small`, else the first of
    `codes` (code, struct format, limit) whose limit exceeds n."""
    if fix is not None and n < small:
        return bytes([fix | n])
    for code, fmt, limit in codes:
        if n < limit:
            return bytes([code]) + struct.pack(">" + fmt, n)
    raise ValueError(f"msgpack: {n} entries is too many")


_U16, _U32 = 1 << 16, 1 << 32


def _pack(obj, out: list) -> None:
    """Append obj's msgpack bytes (the shortest form of each, as
    msgpack-python writes them) to `out`."""
    if isinstance(obj, dict):
        out.append(_packed_len(len(obj), 16, 0x80, ((0xde, "H", _U16),
                                                    (0xdf, "I", _U32))))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_packed_len(len(obj), 16, 0x90, ((0xdc, "H", _U16),
                                                    (0xdd, "I", _U32))))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, str):
        b = obj.encode()
        out.append(_packed_len(len(b), 32, 0xa0, ((0xd9, "B", 256),
                                                  (0xda, "H", _U16),
                                                  (0xdb, "I", _U32))))
        out.append(b)
    elif isinstance(obj, bytes):
        out.append(_packed_len(len(obj), 0, None, ((0xc4, "B", 256),
                                                   (0xc5, "H", _U16),
                                                   (0xc6, "I", _U32))))
        out.append(obj)
    elif isinstance(obj, (int, np.integer)) and 0 <= obj < (1 << 64):
        # a shape entry: positive fixint, else the shortest unsigned form
        out.append(_packed_len(int(obj), 128, 0x00, (
            (0xcc, "B", 256), (0xcd, "H", _U16), (0xce, "I", _U32),
            (0xcf, "Q", 1 << 64))))
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        a = (obj.detach().cpu().numpy() if isinstance(obj, torch.Tensor)
             else obj)
        body: list = []
        _pack([list(a.shape), a.dtype.name, a.tobytes("C")], body)
        body = b"".join(body)
        n = len(body)
        fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
        out.append(bytes([fixext[n]]) if n in fixext else _packed_len(
            n, 0, None, ((0xc7, "B", 256), (0xc8, "H", _U16),
                         (0xc9, "I", _U32))))
        out.append(struct.pack(">b", _EXT_NDARRAY))
        out.append(body)
    else:
        raise TypeError(f"msgpack: cannot write a {type(obj).__name__}")


def save_flax_msgpack(path: str, tree: Dict[str, Any]) -> None:
    """A nested dict of arrays (or tensors) as `flax.serialization.to_bytes`
    writes it; leaves keep their dtype (float32 stays float32)."""
    out: list = []
    _pack(tree, out)
    with open(path, "wb") as f:
        f.write(b"".join(out))


# --------------------------- torch state dicts --------------------------------

def _np(t) -> np.ndarray:
    return t if isinstance(t, np.ndarray) else t.detach().cpu().numpy()


def conv_params(sd, prefix: str) -> Dict[str, np.ndarray]:
    """torch Conv2d weight (O, I, kH, kW) [+ bias] -> flax kernel (kH, kW,
    I, O) [+ bias]."""
    p = {"kernel": _np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0)}
    if f"{prefix}.bias" in sd:
        p["bias"] = _np(sd[f"{prefix}.bias"])
    return p


def linear_params(sd, prefix: str) -> Dict[str, np.ndarray]:
    """torch Linear weight (out, in) [+ bias] -> flax kernel (in, out)."""
    p = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        p["bias"] = _np(sd[f"{prefix}.bias"])
    return p


def norm_params(sd, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def load_sd_container(path: str) -> Dict[str, Any]:
    """The dict a packed SD checkpoint holds: format "stitchax_jax"
    (stitchax's own trees of numpy arrays under unet_vars /
    controlnet_vars / vae_vars, the empty-prompt `context`, `configs`,
    `preferred_strength`) or diffusers / transformers state dicts under
    unet / controlnet / vae / clip."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(blob, dict):
        raise ValueError(f"{path}: not a packed SD checkpoint")
    return blob
