"""The port's off-default modules against stitchax, on the CPU, each on the
same seeded numpy inputs and weights: neighborhood attention and its
vertical layer (`vertical_encoder_attn == "NA"`), FlowFormer++ with that
layer, the quarter-resolution upsampler, bilinear splatting, the logger's
flow panel and quiver figures, and the config node's merge_from_list /
freeze / defrost / clone. Tolerances are stated where they are used.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stitchax_torch.convert import load_jax_params

J = jnp.asarray
T = torch.from_numpy


def randomize(tree, rng):
    """`tree`'s shapes with seeded values: kernels ~ N(0, 1 / fan_in), norm
    scales ~ 1 + 0.1 N, everything else ~ 0.1 N (flax's zero-initialised
    position biases would hide their indexing)."""
    def fill(path, x):
        name = path[-1].key
        if name == "kernel":
            v = rng.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]))
        elif name == "scale":
            v = 1 + 0.1 * rng.standard_normal(x.shape)
        else:
            v = 0.1 * rng.standard_normal(x.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, tree)


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------- neighborhood attention -------------------------

@pytest.mark.parametrize("hw,ks", [((9, 12), 7), ((4, 5), 7), ((5, 13), 11)])
def test_neighborhood_attention_matches_stitchax(rng, hw, ks):
    """Shifted windows at the borders and, on a 4x5 map, the window shrunk
    to the map's odd extent, with the bias at true offsets: relative 1e-5
    of max |out| (reading ~2e-7)."""
    from stitchax.ops.neighborhood_attention import (
        neighborhood_attention as j_na)
    from stitchax_torch.ops.neighborhood_attention import (
        neighborhood_attention)

    q, k, v = (rng.standard_normal((2, *hw, 2, 16)).astype(np.float32)
               for _ in range(3))
    rpb = rng.standard_normal((2, 2 * ks - 1, 2 * ks - 1)).astype(np.float32)
    want = jax.jit(j_na, static_argnums=4)(J(q), J(k), J(v), J(rpb), ks)
    got = neighborhood_attention(T(q), T(k), T(v), T(rpb), ks)
    assert got.shape == want.shape
    assert rel_err(got.numpy(), want) < 1e-5


def test_na_layer_matches_stitchax(rng):
    """NeighborhoodSelfAttentionLayer at configs/last_config.py's widths
    (latent 128, context 256 -> 64, 8 heads of 16, kernel 11) on 2 images
    x 2 latent tokens of 5x6 (a 5x5 window, the map's odd extent, the 21x21
    bias read at true offsets): relative 1e-5 (reading ~5e-7)."""
    from stitchax.models.na_layer import NeighborhoodSelfAttentionLayer as J
    from stitchax_torch.models.na_layer import NeighborhoodSelfAttentionLayer

    x = rng.standard_normal((4, 5, 6, 128)).astype(np.float32)
    ctx = rng.standard_normal((2, 5, 6, 256)).astype(np.float32)
    layer = J()
    params = randomize(jax.eval_shape(layer.init, jax.random.PRNGKey(0),
                                      jnp.asarray(x), jnp.asarray(ctx)), rng)
    want = jax.jit(layer.apply)(params, jnp.asarray(x), jnp.asarray(ctx))
    port = load_jax_params(NeighborhoodSelfAttentionLayer(), params)
    with torch.no_grad():
        got = port(T(x), T(ctx))
    assert rel_err(got.numpy(), want) < 1e-5


def na_flowformer_pair(rng, size=64):
    """stitchax's FlowFormer with NA vertical layers (decoder depth 1,
    encoder depth 1, as tests/test_aux_models.py builds it) and the port's
    with the same seeded variables; and a seeded image pair."""
    from stitchax.models import FlowFormer as JFlow
    from stitchax.models import FlowFormerConfig as JCfg
    from stitchax_torch.models import FlowFormer, FlowFormerConfig

    img1, img2 = (rng.uniform(0, 255, (1, size, size, 3)).astype(np.float32)
                  for _ in range(2))
    jmodel = JFlow(JCfg(decoder_depth=1, encoder_depth=1,
                        vertical_encoder_attn="NA"))
    params = randomize(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                      J(img1), J(img2)), rng)
    port = load_jax_params(FlowFormer(FlowFormerConfig(
        decoder_depth=1, encoder_depth=1, vertical_encoder_attn="NA",
        upsample_all=True)), params)
    return jmodel, params, port, img1, img2


def test_na_cost_encoder_matches_stitchax(rng):
    """The cost perceiver with NA vertical layers (encoder depth 1, the
    shipped widths) on 8x8 cost maps of a 5x6 source grid: it builds
    the NA layer where `vertical_encoder_attn == "NA"`, and its latent
    tokens agree within 1e-5 relative (reading ~4e-7)."""
    from stitchax.models.flowformer import CostPerceiverEncoder as JEnc
    from stitchax.models.flowformer import FlowFormerConfig as JCfg
    from stitchax_torch.models.flowformer import (CostPerceiverEncoder,
                                                  FlowFormerConfig)
    from stitchax_torch.models.na_layer import NeighborhoodSelfAttentionLayer

    cost = rng.standard_normal((1, 5, 6, 8, 8, 1)).astype(np.float32)
    ctx = rng.standard_normal((1, 5, 6, 256)).astype(np.float32)
    enc = JEnc(JCfg(encoder_depth=1, vertical_encoder_attn="NA"))
    params = randomize(jax.eval_shape(enc.init, jax.random.PRNGKey(0),
                                      J(cost), J(ctx)), rng)
    want = jax.jit(enc.apply)(params, J(cost), J(ctx))[0]
    port = load_jax_params(CostPerceiverEncoder(FlowFormerConfig(
        encoder_depth=1, vertical_encoder_attn="NA")), params)
    assert isinstance(port.vertical_layer0, NeighborhoodSelfAttentionLayer)
    with torch.no_grad():
        got = port(T(cost), T(ctx))
    assert got.shape == want.shape == (30, 8, 128)
    assert rel_err(got.numpy(), want) < 1e-5


@pytest.mark.slow
def test_na_flowformer_forward_matches_stitchax(rng):
    """FlowFormer++ with the NA vertical layer at 64^2 (every weight
    seeded, ~20 s): the cost encoder builds NA layers, and the upsampled
    flow agrees within 1e-3 of its largest magnitude (reading ~1e-5)."""
    from stitchax_torch.models.na_layer import NeighborhoodSelfAttentionLayer

    jmodel, params, port, img1, img2 = na_flowformer_pair(rng)
    layer = port.memory_encoder.cost_perceiver.vertical_layer0
    assert isinstance(layer, NeighborhoodSelfAttentionLayer)
    preds, _ = jax.jit(jmodel.apply)(params, J(img1), J(img2))
    with torch.no_grad():
        got, _ = port(T(img1), T(img2))
    want = np.asarray(preds[-1])
    assert got[-1].shape == want.shape == (1, 64, 64, 2)
    assert np.isfinite(got[-1].numpy()).all()
    assert rel_err(got[-1].numpy(), want) < 1e-3


# --------------------------- quarter-resolution refinement -------------------

def test_local_cost_and_quater_upsampler_match_stitchax(rng):
    """local_cost_3x3 within 1e-6 relative; QuaterUpsampler (1/8-res flow
    5x7, 1/4-res features 10x14x16) to the full-resolution flow 40x56,
    relative 1e-5 (reading ~3e-7)."""
    from stitchax.models.quater_upsampler import QuaterUpsampler as JQ
    from stitchax.models.quater_upsampler import local_cost_3x3 as j_cost
    from stitchax_torch.models.quater_upsampler import (QuaterUpsampler,
                                                        local_cost_3x3)

    f1, f2 = (rng.standard_normal((2, 6, 9, 16)).astype(np.float32)
              for _ in range(2))
    assert rel_err(local_cost_3x3(T(f1), T(f2)).numpy(),
                   j_cost(J(f1), J(f2))) < 1e-6
    flow = (3 * rng.standard_normal((1, 5, 7, 2))).astype(np.float32)
    feat1, feat2 = (rng.standard_normal((1, 10, 14, 16)).astype(np.float32)
                    for _ in range(2))
    params = randomize(jax.eval_shape(JQ().init, jax.random.PRNGKey(0),
                                      J(flow), J(feat1), J(feat2)), rng)
    want = jax.jit(JQ().apply)(params, J(flow), J(feat1), J(feat2))
    port = load_jax_params(QuaterUpsampler(feat_dim=16), params)
    with torch.no_grad():
        got = port(T(flow), T(feat1), T(feat2))
    assert got.shape == want.shape == (1, 40, 56, 2)
    assert rel_err(got.numpy(), want) < 1e-5


# ---------------------------------- splatting --------------------------------

def test_bilinear_splat_matches_stitchax(rng):
    """Targets inside, across and outside the canvas, with per-pixel
    weights: the warp and the weight map within 1e-5 (the scatter sums'
    order; reading ~1e-7); the batched form equals the per-image one."""
    from stitchax.ops.splat import bilinear_splat as j_splat
    from stitchax.ops.splat import bilinear_splat_b as j_splat_b
    from stitchax_torch.ops.splat import bilinear_splat, bilinear_splat_b

    vals = rng.uniform(0, 255, (2, 9, 11, 3)).astype(np.float32)
    coords = rng.uniform(-3, 14, (2, 9, 11, 2)).astype(np.float32)
    wts = rng.uniform(0.1, 1, (9, 11, 1)).astype(np.float32)
    out, w = j_splat(J(vals[0]), J(coords[0]), 10, 12, J(wts))
    got, got_w = bilinear_splat(T(vals[0]), T(coords[0]), 10, 12, T(wts))
    assert np.abs(got.numpy() - np.asarray(out)).max() <= 1e-5 * 255
    assert np.abs(got_w.numpy() - np.asarray(w)).max() <= 1e-5
    out_b, w_b = j_splat_b(J(vals), J(coords), 10, 12)
    got_b, got_wb = bilinear_splat_b(T(vals), T(coords), 10, 12)
    assert np.abs(got_b.numpy() - np.asarray(out_b)).max() <= 1e-5 * 255
    assert np.abs(got_wb.numpy() - np.asarray(w_b)).max() <= 1e-5
    for i in range(2):
        one, one_w = bilinear_splat(T(vals[i]), T(coords[i]), 10, 12)
        assert torch.equal(one, got_b[i]) and torch.equal(one_w, got_wb[i])


def test_forward_warp_properties_and_stitchax(rng):
    """tests/test_deform_and_splat.py's properties on the port: the zero
    flow returns the image with weight 1; an integer flow of 3 translates
    it onto a 16x16 canvas, nothing above row 3; a half-pixel splat
    conserves the mass; and a fractional flow with a canvas offset equals
    stitchax's forward_warp_with_flow within 1e-5 relative."""
    from stitchax.ops.splat import forward_warp_with_flow as j_fwd
    from stitchax_torch.ops.splat import bilinear_splat, forward_warp_with_flow

    img = rng.uniform(0, 255, (12, 14, 3)).astype(np.float32)
    out, w = forward_warp_with_flow(T(img), torch.zeros(12, 14, 2), 12, 14)
    np.testing.assert_allclose(out.numpy(), img, atol=1e-3)
    np.testing.assert_allclose(w.numpy(), np.ones((12, 14, 1)), atol=1e-5)

    img = rng.uniform(0, 255, (10, 10, 3)).astype(np.float32)
    out, w = forward_warp_with_flow(T(img), torch.full((10, 10, 2), 3.0),
                                    16, 16)
    np.testing.assert_allclose(out.numpy()[3:13, 3:13], img, atol=1e-3)
    assert float(w[:3].sum()) == 0.0

    vals = rng.uniform(1, 2, (8, 8, 1)).astype(np.float32)
    coords = (np.stack(np.meshgrid(np.arange(8), np.arange(8))[:2], -1)
              .astype(np.float32) + 0.5)
    out, w = bilinear_splat(T(vals), T(coords), 12, 12)
    assert abs(float((out * w).sum()) - float(vals.sum())) < 1e-3

    img = rng.uniform(0, 255, (9, 13, 3)).astype(np.float32)
    flow = rng.uniform(-2, 2, (9, 13, 2)).astype(np.float32)
    want, want_w = j_fwd(J(img), J(flow), 14, 18, offset_xy=(2.5, 1.0))
    got, got_w = forward_warp_with_flow(T(img), T(flow), 14, 18,
                                        offset_xy=(2.5, 1.0))
    assert rel_err(got.numpy(), want) < 1e-5
    assert np.abs(got_w.numpy() - np.asarray(want_w)).max() <= 1e-5


# -------------------------------- flow figures -------------------------------

def _png_pixels(path):
    import matplotlib.image as mpimg
    return np.rint(mpimg.imread(path)[..., :3] * 255).astype(np.uint8)


@pytest.mark.parametrize("figure", ["panel", "panel_no_warp", "quiver"])
def test_flow_figures_are_stitchax_pixels(rng, tmp_path, figure):
    """The port writes stitchax's figure (its PNG's pixels) through its own
    JPEG writer: the file's bytes are `io.jpeg.encode` of stitchax's
    decoded PNG."""
    from stitchax.utils import logger as j_logger
    from stitchax_torch.io import jpeg
    from stitchax_torch.utils import logger

    i1, i2 = (rng.uniform(0, 255, (40, 48, 3)) for _ in range(2))
    flow = 5 * rng.standard_normal((40, 48, 2))
    want, got = str(tmp_path / "s.png"), str(tmp_path / "p.jpg")
    if figure == "quiver":
        j_logger.save_flow_quiver(want, flow, step=8)
        assert logger.save_flow_quiver(got, flow, step=8) == got
    else:
        warped = i2 if figure == "panel" else None
        j_logger.save_flow_panel(want, i1, i2, flow, warped)
        logger.save_flow_panel(got, i1, i2, flow, warped)
    with open(got, "rb") as f:
        assert f.read() == jpeg.encode(_png_pixels(want))


# --------------------------------- CfgNode -----------------------------------

def _cfg_ops(CfgNode):
    """The same operations on either package's CfgNode: (the node after
    merge_from_list, its clone after an edit, whether assignments were
    refused while frozen, the node after defrost and an edit)."""
    base = {"a": {"b": 1, "c": None, "d": 0.5, "e": "x"}, "f": True,
            "g": None, "h": 3}
    cfg = CfgNode(base)
    cfg.merge_from_list(["a.b", "7", "a.c", "2.5", "a.d", "3", "a.e", "yes",
                         "f", "off", "g", "true", "h", "not-an-int"])
    clone = cfg.clone()
    clone.a.b = 8
    cfg.freeze()
    refused = []
    for set_ in (lambda: setattr(cfg, "h", 1),
                 lambda: cfg.a.__setitem__("b", 2),
                 lambda: setattr(cfg.a, "new", 1)):
        try:
            set_()
            refused.append(False)
        except AttributeError:
            refused.append(True)
    after_freeze = cfg.to_dict()
    cfg.defrost()
    cfg.a.b = 9
    return (after_freeze, clone.to_dict(), refused, cfg.to_dict(),
            cfg.dump())


def test_cfgnode_methods_match_stitchax():
    """merge_from_list's coercions (int, float, bool words, None -> the
    string's own type, a string kept where the cast fails), clone's
    independent copy, freeze refusing assignments in nested nodes, and
    defrost: the same results as stitchax's CfgNode; an odd override list
    is refused by both."""
    from stitchax.utils.config import CfgNode as JCfgNode
    from stitchax_torch.utils.config import CfgNode

    got, want = _cfg_ops(CfgNode), _cfg_ops(JCfgNode)
    assert got == want
    assert got[2] == [True, True, True]
    assert got[0]["a"] == {"b": 7, "c": 2.5, "d": 3.0, "e": "yes"}
    assert got[0]["f"] is False and got[0]["g"] is True
    with pytest.raises(ValueError):
        CfgNode({"a": 1}).merge_from_list(["a"])
    with pytest.raises(AssertionError):
        JCfgNode({"a": 1}).merge_from_list(["a"])
