"""The VGG16 loss network of TransRef's training objective
(stitchax_torch/models/vgg.py) against stitchax's (stitchax/models/vgg.py),
on the CPU.

The same He-scaled parameters, drawn with numpy from a seed, go into
stitchax's jitted `VGG16Features.apply` and the port's module (through
`convert.load_jax_params`): every reluX_Y activation, the Gram matrix, the
perceptual, style and total losses (with the trainer's weights 0.04 / 250)
and `feature_total_loss`. Inputs are 64^2, batch 2, the smallest size at
which relu5_3 (1/64 of the side) is not empty. Also stitchax's
`convert_vgg16_features` against the port's native load of a torchvision
state dict. Tolerances are stated where they are used: readings of this
file with ~10x headroom.
"""

import numpy as np
import pytest
import torch

SIZE, BATCH = 64, 2
TORCHVISION = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
STYLE = ("relu2_2", "relu3_3", "relu4_3", "relu5_2")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def vgg_params(seed=0):
    """flax VGG16Features params: kernels ~ N(0, 2 / fan_in) (He), biases
    ~ 0.01 N, from numpy."""
    from stitchax_torch.models.vgg import VGG16_LAYOUT

    rng = np.random.default_rng(seed)
    params, cin = {}, 3
    for name, ch, _ in VGG16_LAYOUT:
        params[name] = {
            "kernel": (rng.standard_normal((3, 3, cin, ch))
                       * np.sqrt(2.0 / (9 * cin))).astype(np.float32),
            "bias": (0.01 * rng.standard_normal(ch)).astype(np.float32)}
        cin = ch
    return {"params": params}


def images(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
            for _ in range(n)]


LOSS_KW = ({"perc_weight": 0.04, "style_weight": 250.0}, {})
LOSS_KEYS = ("total", "l1", "perceptual", "style")


@pytest.fixture(scope="module")
def stitchax_side():
    """stitchax's values on the same params and inputs, from one jitted
    program: the activations of pred, the style layers' Grams of pred, the
    perceptual and style losses of (pred, target), the total loss with
    the trainer's weights and with the defaults, and feature_total_loss
    over the style layers."""
    import jax
    import jax.numpy as jnp

    from stitchax.models import vgg as jv

    @jax.jit
    def run(params, pred, target):
        apply = lambda x: jv.VGG16Features().apply(params, x)
        fx, fy = apply(pred), apply(target)
        # the VGG is applied once per input; the losses read its outputs
        cached = lambda t: fx if t is pred else fy
        feats = lambda t: [cached(t)[k] for k in STYLE]
        return {"acts": fx,
                "gram": {k: jv.gram_matrix(fx[k]) for k in STYLE},
                "perceptual": jv.perceptual_loss(fx, fy),
                "style": jv.style_loss(fx, fy),
                "total": [jv.transref_total_loss(cached, pred, target, None,
                                                 **kw) for kw in LOSS_KW],
                "feature": jv.feature_total_loss(feats, pred, target, None)}

    pred, target = images(1, 2)
    out = run(vgg_params(), jnp.asarray(pred), jnp.asarray(target))
    return jax.tree_util.tree_map(np.asarray, out), (pred, target)


@pytest.fixture(scope="module")
def port_vgg():
    from stitchax_torch.convert import load_jax_params
    from stitchax_torch.models.vgg import VGG16Features

    return load_jax_params(VGG16Features(), vgg_params())


def _rel(got, ref):
    return abs(float(got) - float(ref)) / abs(float(ref))


def test_every_activation_matches_stitchax(stitchax_side, port_vgg):
    """Every reluX_Y (relu5_2 / relu5_3 re-applying the relu5_1 block),
    within 2e-5 of its scale (reading 2.3e-6)."""
    ref, (pred, _) = stitchax_side
    with torch.no_grad():
        got = port_vgg(torch.from_numpy(pred))
    assert sorted(got) == sorted(ref["acts"]) and len(got) == 13
    assert got["relu5_3"].shape == (BATCH, 1, 1, 512)
    for k, r in ref["acts"].items():
        g = got[k].numpy()
        assert g.shape == r.shape, k
        assert np.abs(g - r).max() <= 2e-5 * np.abs(r).max(), k


def test_losses_match_stitchax(stitchax_side, port_vgg):
    """The Gram of each style layer within 2e-5 of its scale (reading
    1.7e-6), the perceptual and style losses and the total with the
    trainer's weights (0.04 / 250) and with the function's defaults
    (0.1 / 250) within 3e-6 relative (readings up to 2.8e-7)."""
    from stitchax_torch.models import vgg as tv

    ref, (pred, target) = stitchax_side
    tp, tt = torch.from_numpy(pred), torch.from_numpy(target)
    with torch.no_grad():
        fx, fy = port_vgg(tp), port_vgg(tt)
        for k in STYLE:
            g, r = tv.gram_matrix(fx[k]).numpy(), ref["gram"][k]
            assert np.abs(g - r).max() <= 2e-5 * np.abs(r).max(), k
        assert _rel(tv.perceptual_loss(fx, fy), ref["perceptual"]) <= 3e-6
        assert _rel(tv.style_loss(fx, fy), ref["style"]) <= 3e-6
        for kw, want in zip(LOSS_KW, ref["total"]):
            got = tv.transref_total_loss(port_vgg, tp, tt, None, **kw)
            for k in LOSS_KEYS:
                assert _rel(got[k], want[k]) <= 3e-6, (kw, k)


def test_feature_total_loss_matches_stitchax(stitchax_side, port_vgg):
    """`feature_total_loss` over a list of maps (the VGG's style layers)
    within 5e-6 relative (reading 4.1e-7)."""
    from stitchax_torch.models import vgg as tv

    ref, (pred, target) = stitchax_side
    feats = lambda t: [port_vgg(t)[k] for k in STYLE]
    with torch.no_grad():
        got = tv.feature_total_loss(feats, torch.from_numpy(pred),
                                    torch.from_numpy(target), None)
    for k in LOSS_KEYS:
        assert _rel(got[k], ref["feature"][k]) <= 5e-6, k


def test_torchvision_state_dict_loads_as_stitchax_converts_it(rng):
    """A seeded torchvision-layout `features.*` state dict (conv5_2 / 5_3
    included): the port's native load equals stitchax's
    convert_vgg16_features carried through load_jax_params, and back
    through params_to_jax, bit for bit."""
    from stitchax.models.vgg import convert_vgg16_features
    from stitchax_torch.convert import (_flatten, load_jax_params,
                                        params_to_jax)
    from stitchax_torch.models.vgg import (VGG16Features,
                                           load_torchvision_features)

    sd, cin = {}, 3
    for i, ch in zip(TORCHVISION, (64, 64, 128, 128, 256, 256, 256, 512,
                                   512, 512, 512, 512, 512)):
        sd[f"features.{i}.weight"] = torch.from_numpy(
            rng.standard_normal((ch, cin, 3, 3)).astype(np.float32))
        sd[f"features.{i}.bias"] = torch.from_numpy(
            rng.standard_normal(ch).astype(np.float32))
        cin = ch
    sd["classifier.0.weight"] = torch.zeros(2, 2)
    tree = convert_vgg16_features(sd)
    native = load_torchvision_features(VGG16Features(), sd).state_dict()
    via = load_jax_params(VGG16Features(), tree).state_dict()
    assert sorted(native) == sorted(via) and len(native) == 22
    assert all(torch.equal(native[k], via[k]) for k in native)
    back = dict(_flatten(params_to_jax(native)))
    want = dict(_flatten(tree))
    assert sorted(back) == sorted(want)
    assert all(np.array_equal(back[k], want[k]) for k in want)


def test_seeded_init_is_flax_scaled():
    """The CLI's VGG without --vgg_ckpt: kernels ~ N(0, 1 / fan_in) as
    flax's lecun_normal draws them (each std within 5%), zero biases; the
    same seed gives the same weights."""
    from stitchax_torch.models.vgg import VGG16_LAYOUT, VGG16Features

    a, b = VGG16Features(), VGG16Features()
    a.reset_parameters(torch.Generator().manual_seed(5))
    b.reset_parameters(torch.Generator().manual_seed(5))
    for name, _, _ in VGG16_LAYOUT:
        w = getattr(a, name).weight
        fan_in = w[0].numel()
        assert abs(float(w.detach().std()) * fan_in ** 0.5 - 1) < 0.05, name
        assert not getattr(a, name).bias.any()
        assert torch.equal(w, getattr(b, name).weight)


def _forward_before_k7(vgg, x):
    """`VGG16Features.forward` as it stood before K7: F.relu(conv(x)) on
    NCHW views of the NHWC tensors, the pools between."""
    import torch.nn.functional as F
    from stitchax_torch.models.vgg import VGG16_LAYOUT

    x, feats = x.permute(0, 3, 1, 2), {}
    for name, _, pool in VGG16_LAYOUT:
        if pool:
            x = F.max_pool2d(x, 2)
        x = F.relu(getattr(vgg, name)(x))
        feats["relu" + name[4:]] = x
    for name in ("relu5_2", "relu5_3"):
        x = F.relu(vgg.conv5_1(F.max_pool2d(x, 2)))
        feats[name] = x
    return {k: v.permute(0, 2, 3, 1) for k, v in feats.items()}


def _seeded_vgg_and_image(seed=0):
    from stitchax_torch.models.vgg import VGG16Features

    vgg = VGG16Features()
    vgg.reset_parameters(torch.Generator().manual_seed(seed))
    x = torch.rand(1, SIZE, SIZE, 3,
                   generator=torch.Generator().manual_seed(seed + 1)) * 2 - 1
    return vgg, x


def test_cpu_forward_is_the_plain_path_bit_for_bit():
    """On the CPU the VGG takes no kernel: every activation equals the
    forward before K7 (NCHW views throughout) bit for bit, with and
    without a gradient to the input, and each is contiguous NHWC."""
    from stitchax_torch.ops.kernels import library

    vgg, x = _seeded_vgg_and_image()
    before = dict(library.launches)
    with torch.no_grad():
        got, want = vgg(x), _forward_before_k7(vgg, x)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(v.is_contiguous() for v in got.values())
    # under autograd too (the CPU's convolution backward is not
    # bit-reproducible itself with two threads: no gradient compared)
    xg = x.clone().requires_grad_(True)
    got, want = vgg(xg), _forward_before_k7(vgg, xg)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert got["relu5_3"].grad_fn is not None
    assert library.launches == before


def test_image_padded_to_four_channels_is_the_same_convolution():
    """On a card K7 takes conv1_1's image padded with a zero channel (TMA's
    16-byte rows); with the weight's channel padded alike it is the same
    convolution: the CPU's plain version within fp32 rounding."""
    from stitchax_torch.ops.kernels import conv3x3_wide as k7

    vgg, x = _seeded_vgg_and_image(2)
    pad = torch.nn.functional.pad
    with torch.no_grad():
        want = vgg(x)["relu1_1"]
        got = k7.conv3x3_wide_relu_plain(
            pad(x, (0, 1)), pad(vgg.conv1_1.weight, (0, 0, 0, 0, 0, 1)),
            vgg.conv1_1.bias)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("cin,cout", [(3, 64), (64, 128), (512, 512)])
def test_k7_input_grad_plain_is_the_convolutions_input_gradient(cin, cout):
    """The plain version of K7's input gradient (the card tests' reference)
    against autograd through F.conv2d, NHWC."""
    from stitchax_torch.ops.kernels import conv3x3_wide as k7

    g = torch.Generator().manual_seed(cin)
    x = torch.randn(2, 6, 5, cin, generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn(cout, cin, 3, 3, generator=g, dtype=torch.float64)
    gy = torch.randn(2, 6, 5, cout, generator=g, dtype=torch.float64)
    y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, padding=1)
    want, = torch.autograd.grad(y.permute(0, 2, 3, 1), x, gy)
    got = k7.input_grad(gy, w)
    assert got.shape == x.shape
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
