"""The default configuration (`all_img1_with_inpaint_g12_transRef`: TransRef
inpainter, grid 12, the composition net) in the port against stitchax, on
the same inputs and the same trained weights (results/ckpt_r05_bf16.npz
'comp', results/transref_ckpt_r05_bf16.msgpack), fp32 on the CPU: each
module, then the whole stitch through stub backbones (tests/stub_backbones.py
and a torch copy of them), as tests/test_demo_golden_transref.py builds it.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from held_to_stitchax import psnr
from stub_backbones import stub_flow_fn, stub_homo_fn
from test_torch_stitch import _load_demo_pair, t_stub_flow, t_stub_homo

from stitchax.compose.inpainters import TransRefInpainter as JTransRefInp  # noqa: E402
from stitchax.compose.mix_methods import all_img1_with_inpaint as j_mix  # noqa: E402
from stitchax.models.transref import TransRefBase as JTransRef  # noqa: E402
from stitchax.models.udis2 import CompositionNet as JComp  # noqa: E402
from stitchax.models.udis2 import compose_seam as j_compose_seam  # noqa: E402
from stitchax.ops.deform import deform_conv2d_b as j_deform  # noqa: E402
from stitchax_torch import convert  # noqa: E402
from stitchax_torch.align.adapter import AlignConfig  # noqa: E402
from stitchax_torch.compose.inpainters import (TransRefInpainter,  # noqa: E402
                                               get_inpainter)
from stitchax_torch.compose.mix_methods import all_img1_with_inpaint  # noqa: E402
from stitchax_torch.models import (CompositionNet, TransRefBase,  # noqa: E402
                                   compose_seam)
from stitchax_torch.ops.deform import deform_conv2d, deform_conv2d_b  # noqa: E402
from stitchax_torch.ops.kernels import library  # noqa: E402
from stitchax_torch.ops.sampling import image_resize  # noqa: E402
from stitchax_torch.run.stitcher import (Stitcher, StitchModels,  # noqa: E402
                                         load_inf_config)

REPO = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(REPO, "results", "ckpt_r05_bf16.npz")
TRANSREF = os.path.join(REPO, "results", "transref_ckpt_r05_bf16.msgpack")
DEFAULT = "all_img1_with_inpaint_g12_transRef"
T = torch.from_numpy
J = jnp.asarray


def _need(path):
    if not os.path.isfile(path):
        pytest.skip(f"{path} is not in this checkout")


@pytest.fixture(scope="module")
def transref_tree():
    _need(TRANSREF)
    return convert.load_flax_msgpack(TRANSREF)


@pytest.fixture(scope="module")
def comp_tree():
    _need(CKPT)
    return convert.load_npz(CKPT, "comp")


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _j_transref_inpainter(tree, size=256):
    """stitchax's TransRefInpainter on the same weights, fp32 (what
    make_default_transref_apply(bf16=False, ckpt=...) builds, without its
    random init)."""
    params = _jtree(tree)
    return JTransRefInp(apply_fn=lambda d, m, r: JTransRef().apply(
        params, d, m, r), size=size)


def test_default_config():
    c = load_inf_config(DEFAULT)
    assert (c["tps_cfg"].grid_h, c["tps_cfg"].grid_w) == (12, 12)
    assert c["inpainter"] == "transref_inpainter"
    assert c["mix_method"] == "all_img1_with_inpaint"
    assert c["use_composition"] is True
    assert load_inf_config("fast_cv_g8")["use_composition"] is False


def test_from_npz_loads_what_the_configuration_uses():
    _need(CKPT)
    _need(TRANSREF)
    fast = StitchModels.from_npz(CKPT, "cpu", torch.float32)
    assert fast.comp_model is None and fast.transref_model is None
    full = StitchModels.from_npz(CKPT, "cpu", torch.float32, config=DEFAULT,
                                 transref=TRANSREF)
    assert isinstance(full.comp_model, CompositionNet)
    assert isinstance(full.transref_model, TransRefBase)
    st = Stitcher(full, device="cpu", config=DEFAULT)
    assert st.inpainter.model is full.transref_model
    assert (st.tps_cfg.grid_h, st.use_composition) == (12, True)


# ------------------------------- ops ------------------------------------------

@pytest.mark.parametrize("scale", [0.7, 6.0])
def test_deform_conv2d_matches_stitchax(rng, scale):
    """Offsets up to ~3 sigma * 6 px send taps out of the map, where they
    read zero. fp32: the matmul's summation order only."""
    x = rng.standard_normal((2, 11, 13, 6)).astype(np.float32)
    off = (rng.standard_normal((2, 11, 13, 18)) * scale).astype(np.float32)
    w = rng.standard_normal((54, 7)).astype(np.float32)
    ref = np.asarray(j_deform(J(x), J(off), J(w)))
    got = deform_conv2d_b(T(x), T(off), T(w)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(deform_conv2d(T(x[0]), T(off[0]), T(w)),
                               ref[0], atol=1e-5)


@pytest.mark.parametrize("src,dst", [((385, 540), (512, 512)),
                                     ((512, 512), (385, 540))])
def test_image_resize_matches_jax_image_resize(rng, src, dst):
    """The inpainter's resizes at the real canvas size: to 512^2 (its width
    downsampled, antialiased) and back. bilinear on [0, 255]: 5e-3 covers
    jax's own fp32 accumulation (it reads 3.1e-3 from a float64 sum at
    512 -> 385, the port 2.7e-5); nearest picks the same pixels."""
    x = (rng.uniform(0, 255, (*src, 3))).astype(np.float32)
    for method, tol in (("bilinear", 5e-3), ("nearest", 0.0)):
        ref = np.asarray(jax.image.resize(J(x), (*dst, 3), method))
        got = image_resize(T(x), *dst, method).numpy()
        np.testing.assert_allclose(got, ref, atol=tol, err_msg=method)


# ------------------------------- models ---------------------------------------

def test_transref_matches_stitchax(rng, transref_tree):
    """Trained weights at 256^2, fp32: relative 2e-5 of max |output| (deep
    net, 4 stages of attention and deformable alignment; reads 1.6e-6)."""
    S = 256
    det = rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (1, S, S, 1)) > 0.8).astype(np.float32)
    ref_img = rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
    m = convert.load_jax_params(TransRefBase(), transref_tree).eval()
    with torch.no_grad():
        got = m(T(det), T(mask), T(ref_img)).numpy()
    want = np.asarray(jax.jit(JTransRef().apply)(_jtree(transref_tree), det,
                                                  mask, ref_img))
    top = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2e-5 * top)


def test_composition_net_matches_stitchax(rng, comp_tree):
    """Trained weights at 512^2 (the dilated convs need >= ~400 px), fp32:
    relative 5e-4 of max |output| (sigmoid in [0, 1]; 20 dilated convs
    with up to 4608-term fp32 sums on random inputs; reads 7.3e-5)."""
    S = 512
    w1, w2 = (rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
              for _ in range(2))
    m1 = np.ones((1, S, S, 1), np.float32)
    m2 = (rng.uniform(0, 1, (1, S, S, 1)) > 0.3).astype(np.float32)
    m = convert.load_jax_params(CompositionNet(), comp_tree).eval()
    with torch.no_grad():
        got = m(T(w1), T(w2), T(m1), T(m2)).numpy()
    want = np.asarray(jax.jit(JComp().apply)(_jtree(comp_tree), w1, w2, m1,
                                             m2))
    np.testing.assert_allclose(got, want, atol=5e-4 * np.abs(want).max())


def test_compose_seam_matches_stitchax(rng):
    out = rng.uniform(0, 1, (1, 9, 11, 1)).astype(np.float32)
    w1, w2 = (rng.uniform(-1, 1, (1, 9, 11, 3)).astype(np.float32)
              for _ in range(2))
    m1, m2 = ((rng.uniform(0, 1, (1, 9, 11, 1)) > 0.4).astype(np.float32)
              for _ in range(2))
    got = compose_seam(T(out), T(w1), T(w2), T(m1), T(m2))
    ref = j_compose_seam(J(out), J(w1), J(w2), J(m1), J(m2))
    for k in ("learned_mask1", "learned_mask2", "stitched_image"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-6, err_msg=k)


# ------------------------------ compose ---------------------------------------

def test_transref_inpainter_run_matches_stitchax(rng, transref_tree):
    """`_run` at a 300x200 canvas (height downsampled, width upsampled to
    the model's 256^2): resize, normalise, mean-fill, TransRef with the
    control image as reference, composite, resize back, clip. fp32 on
    [0, 255]: 5e-3 (reads 6.0e-4: the model's fp32 error after the
    rescale to [0, 255] and the resizes' sums)."""
    H, W = 300, 200
    image = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    control = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    mask = np.zeros((H, W, 1), np.float32)
    mask[100:160, 40:150] = 1.0
    model = convert.load_jax_params(TransRefBase(), transref_tree).eval()
    got = TransRefInpainter(model, size=256, dtype=torch.float32)._run(
        T(image), T(mask), T(control)).numpy()
    ref = np.asarray(_j_transref_inpainter(transref_tree).inpaint(
        J(image), J(mask), J(control)))
    assert np.abs(ref[100:160, 40:150] - image[100:160, 40:150]).mean() > 1
    np.testing.assert_allclose(got, ref, atol=5e-3)


def test_transref_inpainter_refuses_missing_weights():
    with pytest.raises(ValueError, match="trained weights"):
        get_inpainter("transref_inpainter")
    with pytest.raises(ValueError, match="trained weights"):
        Stitcher(None, device="cpu", homo_fn=t_stub_homo, flow_fn=t_stub_flow,
                 config=DEFAULT)


def test_mix_transref_branch_matches_stitchax(rng):
    """With inpainter_name "transref" the img1-filled composite, clipped to
    [0, 255], is both the inpainting input and the reference."""
    H, W = 48, 56
    out1 = (rng.uniform(-20, 275, (H, W, 3))).astype(np.float32)
    warp, fw = (rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
                for _ in range(2))
    m1 = np.zeros((H, W, 1), np.float32)
    m1[:, :36] = 1
    wm = np.zeros((H, W, 1), np.float32)
    wm[4:44, 20:] = 1
    occ = (rng.uniform(0, 1, (H, W, 1)) < 0.9).astype(np.float32)

    def fill(image, mask, control):     # uses all three arguments
        return image * 0.5 + control * 0.25 + mask * 30.0

    got = all_img1_with_inpaint(T(warp), T(wm), T(out1), T(m1), T(fw),
                                T(occ), inpaint=fill,
                                inpainter_name="transref")
    ref = j_mix(J(warp), J(wm), J(out1), J(m1), J(fw), J(occ), inpaint=fill,
                inpainter_name="transref")
    for name in ("tps_final_warp", "tps_final_warp_mask", "inpaint_img",
                 "inpaint_area_mask"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-3,
                                   err_msg=name)


# ----------------------------- end to end -------------------------------------

class _Cfg(dict):
    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)


def test_default_config_stitch_matches_stitchax(monkeypatch, transref_tree,
                                                comp_tree):
    """The default configuration end to end on demo_data/demo1 at 224x192
    through stub backbones, with the trained composition and TransRef
    weights (TransRef at 256^2, as stitchax's golden runs it): stitchax's
    Stitcher (its device results, before the uint8 pack) against the port's,
    fp32 on both sides (stitchax's bf16 composition call is swapped for an
    fp32 one). The canvas is under 512 px, so the composition runs upsized.
    Limits about 10x or more of the readings: PSNRs read 108-115 dB,
    learned masks 1.5e-7 mean and 3.8e-4 max |diff|, no mask flips."""
    import stitchax.utils.precision as jprec
    from stitchax.align.adapter import AlignConfig as JAlign
    from stitchax.run.stitcher import StitchModels as JModels
    from stitchax.run.stitcher import Stitcher as JStitcher
    from stitchax.tps.pipeline import TPSConfig as JTPS

    monkeypatch.setattr(jprec, "bf16_call",
                        lambda fn, params, *args: fn(params, *args))
    img1, img2 = _load_demo_pair()
    acfg = dict(model_size=128, canvas_bucket=64)
    jst = JStitcher(JModels(None, None, None, None, JComp(),
                            _jtree(comp_tree)),
                    _Cfg(swap_image=False), JAlign(**acfg),
                    JTPS(grid_h=12, grid_w=12),
                    inpainter_name="transref_inpainter",
                    mix_method="all_img1_with_inpaint",
                    homo_fn=stub_homo_fn, flow_fn=stub_flow_fn,
                    keep_inpaint_outputs=True)
    jst.inpainter = _j_transref_inpainter(transref_tree)
    ref = {k: np.asarray(v) for k, v in
           jst._stitch_device(img1, img2)["result"].items()
           if isinstance(v, jnp.ndarray)}

    models = StitchModels(
        None, None, "cpu", torch.float32,
        comp_model=convert.load_jax_params(CompositionNet(), comp_tree),
        transref_model=convert.load_jax_params(TransRefBase(), transref_tree))
    st = Stitcher(models, align_cfg=AlignConfig(**acfg), device="cpu",
                  homo_fn=t_stub_homo, flow_fn=t_stub_flow, config=DEFAULT)
    assert st.inpainter.size == 512
    st.inpainter = TransRefInpainter(models.transref_model, 256,
                                     torch.float32)
    library.reset_launches()
    res = st.stitch_tensors(T(img1)[None], T(img2)[None])
    got = {k: v.numpy() for k, v in res.items() if torch.is_tensor(v)}
    assert all(n == 0 for n in library.launches.values())   # CPU: plain

    assert got["new_blend_image"].shape == ref["ave_fusion"].shape
    assert got["composition"].shape == ref["composition"].shape
    assert min(ref["composition"].shape[:2]) == 512          # upsized
    ring = ref["inpaint_area_mask"][..., 3] > 0.5
    assert ring.mean() > 0.005 and ref["mask2"].mean() > 0.05
    # thresholded masks: at most 0.1% of pixels may flip on a float tie
    flips = np.mean(np.abs(got["mask2"] - ref["mask2"]) > 1e-3)
    assert flips <= 1e-3, flips
    # images on [0, 255]; the TransRef ring on its own
    assert psnr(got["output2"], ref["warp2"]) > 90.0
    assert psnr(got["output2"][ring], ref["warp2"][ring]) > 90.0
    assert psnr(got["new_blend_image"], ref["ave_fusion"]) > 90.0
    assert psnr(got["composition"], ref["composition"]) > 90.0
    for k in ("learned_mask1", "learned_mask2"):
        d = np.abs(got[k] - ref[k])
        assert d.mean() < 1e-5 and d.max() < 5e-3, (k, d.mean(), d.max())
