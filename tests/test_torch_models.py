"""The port's models against stitchax's, with ONE set of weights loaded into
both (flax init from a fixed key, carried across by `params_from_jax`), in
fp32 on the CPU at small inputs. Tolerances are stated per test: fp32
reassociation through deep stacks, relative to the output scale."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stitchax.models.flowformer import FlowFormer as JFlowFormer
from stitchax.models.flowformer import FlowFormerConfig as JCfg
from stitchax.models.twins import TwinsBlockRPEContext as JBlockRPE
from stitchax.models.twins import TwinsSVT as JTwins
from stitchax.models.udis2 import UDIS2HomographyNet as JUDIS2
from stitchax_torch.convert import load_jax_params
from stitchax_torch.models import FlowFormer, UDIS2HomographyNet
from stitchax_torch.models.twins import TwinsBlockRPEContext, TwinsSVT

KEY = jax.random.PRNGKey(0)


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def rel_close(got, ref, rel):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    err = np.abs(got - ref).max()
    scale = np.abs(ref).max()
    assert err <= rel * scale, f"max|diff| {err} > {rel} * {scale}"


def test_udis2_homography_net(rng):
    a = rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    b = np.roll(a, 5, axis=2) + rng.normal(0, .05, a.shape).astype(np.float32)
    jm = JUDIS2()
    variables = np_tree(jm.init(KEY, jnp.asarray(a), jnp.asarray(b)))
    # non-trivial running statistics for the BatchNorm layers
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda s: (s + rng.uniform(0.5, 1.5, s.shape)).astype(np.float32),
        variables["batch_stats"])
    ref = jm.apply(variables, jnp.asarray(a), jnp.asarray(b))
    tm = load_jax_params(UDIS2HomographyNet(128), variables)
    got = tm(torch.from_numpy(a), torch.from_numpy(b))
    rel_close(got, ref, 1e-4)


def test_twins_svt(rng):
    x = rng.uniform(-1, 1, (2, 64, 96, 3)).astype(np.float32)
    jm = JTwins()
    variables = np_tree(jm.init(KEY, jnp.asarray(x)))
    ref8, ref4 = jm.apply(variables, jnp.asarray(x))
    got8, got4 = load_jax_params(TwinsSVT(), variables)(torch.from_numpy(x))
    rel_close(got8, ref8, 2e-5)
    rel_close(got4, ref4, 2e-5)


@pytest.mark.parametrize("ws", [7, 1])
def test_vertical_rpe_context_blocks(rng, ws):
    # 2 samples x K=4 latents: per-sample context pairing must match
    x = rng.standard_normal((8, 12, 10, 128)).astype(np.float32)
    ctx = rng.standard_normal((2, 12, 10, 256)).astype(np.float32)
    jm = JBlockRPE(128, 8, ws=ws, sr_ratio=4, vert_c_dim=64)
    variables = np_tree(jm.init(KEY, jnp.asarray(x), jnp.asarray(ctx)))
    ref = jm.apply(variables, jnp.asarray(x), jnp.asarray(ctx))
    tm = load_jax_params(TwinsBlockRPEContext(128, 8, ws, 4, 64), variables)
    got = tm(torch.from_numpy(x), torch.from_numpy(ctx))
    rel_close(got, ref, 2e-5)


def test_flowformer_bidirectional(rng):
    base = rng.uniform(0, 255, (1, 136, 136, 3)).astype(np.float32)
    i1 = base[:, 4:132, 4:132]
    i2 = base[:, 6:134, 1:129]
    jm = JFlowFormer(JCfg(upsample_all=False))
    variables = np_tree(jm.init(KEY, jnp.asarray(i1), jnp.asarray(i2)))
    # open the GMA gate (0 at init) so the aggregation path is compared
    agg = variables["params"]["memory_decoder"]["iteration"]["update_block"][
        "aggregator"]
    agg["gamma"] = np.array([0.5], np.float32)
    (rf, rf_lr), (rb, rb_lr) = jm.apply(
        variables, jnp.asarray(i1), jnp.asarray(i2),
        method=JFlowFormer.bidirectional)
    tm = load_jax_params(FlowFormer(), variables)
    with torch.no_grad():
        (gf, gf_lr), (gb, gb_lr) = tm.bidirectional(torch.from_numpy(i1),
                                                    torch.from_numpy(i2))
    # 12 recurrent fp32 iterations: relative 1e-3 of the flow's range
    for g, r in ((gf[-1], rf[-1]), (gb[-1], rb[-1]), (gf_lr, rf_lr),
                 (gb_lr, rb_lr)):
        assert g.shape == r.shape
        rel_close(g, r, 1e-3)
