"""Weights carried across: the numpy-only bf16 decode is exact, every leaf of
the trained checkpoint fills exactly one parameter of the port, and a param
tree loads identically into both packages."""

import ast
import os

import numpy as np
import jax
import jax.numpy as jnp
import ml_dtypes
import pytest

from stitchax.convert import save_params_npz
from stitchax_torch import convert
from stitchax_torch.models import FlowFormer, UDIS2HomographyNet
from stitchax_torch.models.twins import TwinsSVT

REPO = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(REPO, "results", "ckpt_r05_bf16.npz")


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
                                           ("homo", UDIS2HomographyNet)])
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
    else:
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


BANNED = ("jax", "flax", "ml_dtypes", "PIL", "stitchax")


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
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "stitchax_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_nothing_of_jax_or_stitchax():
    files = _port_files()
    assert len(files) > 20
    bad = {f: sorted(set(_imports(f)) & set(BANNED)) for f in files}
    bad = {os.path.relpath(f, REPO): b for f, b in bad.items() if b}
    assert not bad, bad
