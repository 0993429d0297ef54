"""Weights carried across: the numpy-only bf16 decode and flax msgpack reader
are exact, every leaf of the trained checkpoints fills exactly one parameter
of the port, flax ConvTranspose kernels map onto torch's ConvTranspose2d,
and a param tree loads identically into both packages."""

import ast
import os

import numpy as np
import jax
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

from stitchax.convert import save_params_npz
from stitchax_torch import convert
from stitchax_torch.models import (CompositionNet, FlowFormer, TransRefBase,
                                   UDIS2HomographyNet)
from stitchax_torch.models.twins import TwinsSVT

REPO = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(REPO, "results", "ckpt_r05_bf16.npz")
TRANSREF = os.path.join(REPO, "results", "transref_ckpt_r05_bf16.msgpack")


def test_bf16_decode_is_exact(rng):
    x = np.concatenate([rng.standard_normal(1000).astype(np.float32) * 1e3,
                        np.array([0.0, -0.0, np.inf, -np.inf, 1e-40,
                                  3.3895314e38], np.float32)])
    bits = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    want = bits.view(ml_dtypes.bfloat16).astype(np.float32)
    got = convert.decode_bf16(bits)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_npz_round_trip_matches_stitchax_writer(tmp_path, rng):
    from stitchax.models.twins import TwinsSVT as JTwins
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    variables = JTwins().init(jax.random.PRNGKey(1), x)
    path = str(tmp_path / "twins.npz")
    save_params_npz(path, {"feat": variables})
    tree = convert.load_npz(path, "feat")
    flat = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    n = 0
    for kp, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]:
        node = tree
        for k in kp:
            node = node[k.key]
        want = np.asarray(leaf).astype(ml_dtypes.bfloat16).astype(np.float32)
        np.testing.assert_array_equal(node, want)
        n += 1
    assert n == len(flat)
    convert.load_jax_params(TwinsSVT(), tree)


@pytest.mark.parametrize("subtree,model", [("flow", FlowFormer),
                                           ("homo", UDIS2HomographyNet),
                                           ("comp", CompositionNet)])
def test_every_checkpoint_leaf_is_used(subtree, model):
    if not os.path.isfile(CKPT):
        pytest.skip(f"{CKPT} is not in this checkout")
    tree = convert.load_npz(CKPT, subtree)
    n_leaves = sum(1 for _ in convert._flatten(tree))
    m = convert.load_jax_params(model(), tree)
    sd = m.state_dict()
    assert len(sd) == n_leaves
    # spot-check one transposed conv kernel and one dense kernel
    if subtree == "flow":
        k = tree["params"]["context_encoder"]["patch_embed0"]["proj"]["kernel"]
        np.testing.assert_array_equal(
            sd["context_encoder.patch_embed0.proj.weight"].numpy(),
            k.transpose(3, 2, 0, 1))
        d = tree["params"]["memory_decoder"]["memory_k"]["kernel"]
        np.testing.assert_array_equal(sd["memory_decoder.memory_k.weight"]
                                      .numpy(), d.T)
    elif subtree == "homo":
        v = tree["batch_stats"]["feature_extractor"]["bn1"]["var"]
        np.testing.assert_array_equal(
            sd["feature_extractor.bn1.running_var"].numpy(), v)


def test_unused_and_unfilled_leaves_raise(rng):
    from stitchax.models.twins import TwinsSVT as JTwins
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray,
                                  JTwins().init(jax.random.PRNGKey(0), x))
    tree["params"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="unused"):
        convert.load_jax_params(TwinsSVT(), tree)
    del tree["params"]["extra"]
    del tree["params"]["pos_block0"]
    with pytest.raises(KeyError, match="unfilled"):
        convert.load_jax_params(TwinsSVT(), tree)


def test_msgpack_reader_matches_flax_on_every_leaf():
    """All 506 bf16 leaves of the trained TransRef checkpoint, against
    flax.serialization's own reader: same paths, shapes and values."""
    from flax import serialization
    if not os.path.isfile(TRANSREF):
        pytest.skip(f"{TRANSREF} is not in this checkout")
    got = convert.load_flax_msgpack(TRANSREF)
    with open(TRANSREF, "rb") as f:
        ref = serialization.msgpack_restore(f.read())
    want = jax.tree_util.tree_flatten_with_path(ref)[0]
    have = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(want) == len(have) == 506
    for kp, leaf in want:
        assert leaf.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(have[kp], np.asarray(leaf, np.float32))


def test_msgpack_reader_other_types(tmp_path, rng):
    """ints, floats, str/bin, nil, bool and arrays of other dtypes as flax
    writes them, in maps and lists; other ext types raise."""
    from flax import serialization
    tree = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                  "i": np.arange(5, dtype=np.int32),
                  "b": jnp.asarray(rng.standard_normal(7), jnp.bfloat16)},
            "n": 3, "neg": -70000, "big": 2 ** 40, "f": 0.25, "s": "x" * 40,
            "none": None, "t": True, "raw": b"\x00\x01",
            "lst": [1, 2.5, "z"]}
    path = tmp_path / "t.msgpack"
    path.write_bytes(serialization.to_bytes(tree))
    got = convert.load_flax_msgpack(str(path))
    ref = serialization.msgpack_restore(path.read_bytes())
    assert got["n"] == 3 and got["neg"] == -70000 and got["big"] == 2 ** 40
    assert got["f"] == 0.25 and got["s"] == "x" * 40 and got["none"] is None
    assert got["t"] is True and got["raw"] == b"\x00\x01"
    assert got["lst"] == ref["lst"]
    for k in ("w", "i"):
        np.testing.assert_array_equal(got["a"][k], ref["a"][k])
        assert got["a"][k].dtype == ref["a"][k].dtype
    np.testing.assert_array_equal(got["a"]["b"],
                                  np.asarray(ref["a"]["b"], np.float32))
    path.write_bytes(serialization.to_bytes({"sc": np.float32(1.5)}))
    with pytest.raises(ValueError, match="ext type 3"):
        convert.load_flax_msgpack(str(path))


def test_transref_checkpoint_fills_every_parameter():
    if not os.path.isfile(TRANSREF):
        pytest.skip(f"{TRANSREF} is not in this checkout")
    tree = convert.load_flax_msgpack(TRANSREF)
    m = convert.load_jax_params(TransRefBase(), tree)
    assert len(m.state_dict()) == sum(1 for _ in convert._flatten(tree))


@pytest.mark.parametrize("k,pad,torch_pad,out_pad", [(3, (1, 2), 1, 1),
                                                     (4, (2, 2), 1, 0)])
def test_conv_transpose_maps_flax_to_torch(rng, k, pad, torch_pad, out_pad):
    """flax ConvTranspose (kernel used as is) vs torch ConvTranspose2d
    (kernel flipped, padding k-1-lo, output_padding hi-lo): the two ups of
    TransRef (DynamicOffsetEstimator k3, ConvProjection k4)."""
    import flax.linen as fnn
    from stitchax_torch.models.transref import ConvTranspose
    x = rng.standard_normal((1, 7, 9, 5)).astype(np.float32)
    jm = fnn.ConvTranspose(6, (k, k), strides=(2, 2), padding=(pad, pad))
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = torch.nn.Sequential()
    tm.add_module("up", ConvTranspose(5, 6, k, stride=2, padding=torch_pad,
                                      output_padding=out_pad))
    tree = jax.tree_util.tree_map(np.asarray, {"params": {
        "up": variables["params"]}})
    convert.load_jax_params(tm, tree)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 14, 18, 6)
    np.testing.assert_allclose(got, ref, atol=1e-5)


BANNED = ("jax", "flax", "optax", "ml_dtypes", "msgpack", "PIL", "stitchax")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def _port_files():
    files = [os.path.join(REPO, f)
             for f in ("chip_smoke.py", "held_to_stitchax.py")]
    for root, _, names in os.walk(os.path.join(REPO, "stitchax_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_nothing_of_jax_or_stitchax():
    files = _port_files()
    assert len(files) > 20
    bad = {f: sorted(set(_imports(f)) & set(BANNED)) for f in files}
    bad = {os.path.relpath(f, REPO): b for f, b in bad.items() if b}
    assert not bad, bad
