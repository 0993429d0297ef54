"""The SD diffusion plugin (`inpaint_all_area_g12_diffusion`) in the port
against stitchax, on the CPU: the noise, the schedule, each net at TINY
widths and with the committed checkpoint (results/sd_ckpt_r05.pt), the
inpaint function, the inpainter, the mix method and the whole stitch
through stub backbones. The same seeded numpy arrays go to both sides.

    python tests/test_torch_sd.py --write

writes tests/torch_reference/sd_stitchax_fp32.npz (stitchax's jitted
Stitcher with this configuration on demo_data/demo1, fp32 nets, CPU: the
uint8 canvases, mask1, the hole mask, the learned masks, the canvas origin
and size, and the SD inpainter's own input and output) and the carried schedule
stitchax_torch/models/sd15_alphas_cumprod_f32.npy; it is their only
producer. The slow test holds the port's full-size CPU stitch to the file.
"""

import os
import sys

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))
if __name__ == "__main__":
    sys.path.insert(0, REPO)
    import conftest  # noqa: F401 -- the tests' XLA settings, on the CPU
SD_CKPT = os.path.join(REPO, "results", "sd_ckpt_r05.pt")
CKPT = os.path.join(REPO, "results", "ckpt_r05_bf16.npz")
SD_REF = os.path.join(REPO, "tests", "torch_reference", "sd_stitchax_fp32.npz")
ACP = os.path.join(REPO, "stitchax_torch", "models",
                   "sd15_alphas_cumprod_f32.npy")
DIFFUSION = "inpaint_all_area_g12_diffusion"
PAIR = "demo1"


def _need(path):
    if not os.path.isfile(path):
        pytest.skip(f"{path} is not in this checkout")


def _psnr(a, b, peak=255.0):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(peak ** 2 / mse)


def _u8(x):
    return np.rint(np.clip(x, 0, 255)).astype(np.uint8)


# ----------------------------- the reference ----------------------------------

def stitchax_sd_reference(img1, img2):
    """demo1 through stitchax's jitted Stitcher with the diffusion
    configuration as out.py builds it (tests/test_torch_parity.py
    `stitchax_stitcher`), fp32 nets, its SD inpainter from the committed
    checkpoint; the inpainter's input and output captured inside the jitted
    stage. The input is stored with its hole zeroed and the output only in
    its hole: the plugin reads neither elsewhere (the rest of the output is
    the input)."""
    import jax

    import stitchax.utils.precision as jprec
    from test_torch_parity import stitchax_stitcher

    st = stitchax_stitcher(DIFFUSION)
    st.keep_inpaint_outputs = True
    sd = st.inpainter
    seen = {}

    def keep(image, mask, out):
        seen.update(image=np.asarray(image), mask=np.asarray(mask),
                    out=np.asarray(out))

    class Capturing:
        name = "inpainter"

        def inpaint(self, image, mask, control_image=None):
            out = sd.inpaint(image, mask)
            jax.debug.callback(keep, image, mask, out)
            return out

    st.inpainter = Capturing()
    saved = jprec.bf16_call
    jprec.bf16_call = lambda fn, params, *args: fn(params, *args)
    try:
        res = st._stitch_device(img1, img2)["result"]
        jax.effects_barrier()
    finally:
        jprec.bf16_call = saved
    th, tw = res["out_h"], res["out_w"]
    crop = lambda v: np.asarray(v)[:th, :tw]
    hole = seen["mask"][..., :1] > 0.5
    out = {k: _u8(crop(res[k])) for k in ("warp2", "ave_fusion",
                                          "composition")}
    out.update({k: crop(res[k]) for k in ("learned_mask1", "learned_mask2")})
    out.update(
        mask1=np.asarray(res["mask1"]),
        hole_mask=np.asarray(res["inpaint_area_mask"]),
        canvas_origin=np.array([res["width_min"], res["height_min"]],
                               np.float32),
        canvas_hw=np.array(res["mask1"].shape[:2]), true_hw=np.array([th, tw]),
        inpaint_in=np.where(hole, 0.0, seen["image"]).astype(np.float32),
        inpaint_mask=seen["mask"].astype(np.float32),
        inpaint_out_hole=np.where(hole, seen["out"], 0.0).astype(np.float32))
    return out


def write_reference(path=SD_REF):
    from stitchax.models.diffusion import ddim_schedule
    from test_torch_parity import load_pair

    _, acp = ddim_schedule(1000, 50)
    np.save(ACP, np.asarray(acp, np.float32))
    ref = stitchax_sd_reference(*load_pair(PAIR))
    np.savez_compressed(path, **{f"{PAIR}/{k}": v for k, v in ref.items()})
    return path


# ------------------------ JAX on the CPU, the port ----------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stitchax.compose import inpainters as j_inpainters  # noqa: E402
from stitchax.compose.mix_methods import inpaint_all_area as j_mix  # noqa: E402
from stitchax.models import clip_text as jclip  # noqa: E402
from stitchax.models import diffusion as jdiff  # noqa: E402
from stitchax.models import vae as jvae  # noqa: E402
from stitchax_torch import convert  # noqa: E402
from stitchax_torch.compose import inpainters  # noqa: E402
from stitchax_torch.compose.inpainters import (  # noqa: E402
    StableDiffusionInpainter, get_inpainter, resolve_sd_ckpt)
from stitchax_torch.compose.mix_methods import inpaint_all_area  # noqa: E402
from stitchax_torch.models import clip_text, diffusion, vae  # noqa: E402
from stitchax_torch.models.sd_pipeline import load_sd_models  # noqa: E402
from stitchax_torch.utils import prng  # noqa: E402

T = torch.from_numpy
J = jnp.asarray

TINY = dict(in_channels=9, out_channels=4, block_channels=(8, 16),
            layers_per_block=1, attention_resolutions=(0, 1), context_dim=8,
            num_heads=2, num_train_timesteps=100, norm_groups=4)
TINY_VAE = dict(block_channels=(8, 8, 16, 16), latent_channels=4, groups=4)


def nchw(x):
    return T(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def _randomize(tree, rng):
    """The same tree with seeded values: kernels ~ N(0, 1 / fan_in), biases
    and norm offsets ~ 0.1 N, norm scales ~ 1 + 0.1 N (flax's zero-init
    convs would otherwise hide the ControlNet's residual paths)."""
    def fill(path, x):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(x.shape[:-1]))
            return (rng.standard_normal(x.shape) / np.sqrt(fan_in)
                    ).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, tree)


def _japply(model, variables, x, method):
    return jax.jit(lambda v, a: model.apply(v, a, method=method))(
        variables, J(x))


def _rel_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


# ------------------------------- the noise ------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", [(1, 8, 12, 4), (1, 64, 96, 4)])
def test_noise_matches_jax_random(seed, shape):
    """Bits equal to jax.random.bits; normals within 4 float32 ulps of
    jax.random.normal's (read 3: XLA's CPU log1p inside ErfInv differs from
    numpy's by up to 2 ulps; the uniforms are equal)."""
    key = jax.random.PRNGKey(seed)
    bits = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    np.testing.assert_array_equal(prng.random_bits(seed, shape), bits)
    want = np.asarray(jax.random.normal(key, shape, jnp.float32))
    got = prng.normal(seed, shape)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 4, ulps.max()


def test_noise_is_drawn_in_stitchax_nhwc_layout():
    """Drawn in NHWC and permuted: an NCHW draw gives other noise."""
    nhwc_draw = prng.normal(0, (1, 8, 12, 4)).transpose(0, 3, 1, 2)
    nchw_draw = prng.normal(0, (1, 4, 8, 12))
    assert not np.array_equal(nhwc_draw, nchw_draw)


# ------------------------------ the schedule ----------------------------------

@pytest.mark.parametrize("T_train,S", [(1000, 50), (1000, 4), (100, 2)])
def test_ddim_schedule_matches_stitchax(T_train, S):
    """ts equal; at 1000 training steps alphas_cumprod is stitchax's carried
    array, equal; elsewhere (TINY's 100) a sequential fp32 product, within
    2e-6 (XLA's linspace and cumprod round differently)."""
    ts, acp = jdiff.ddim_schedule(T_train, S)
    got_ts, got_acp = diffusion.ddim_schedule(T_train, S)
    np.testing.assert_array_equal(got_ts, np.asarray(ts))
    if T_train == 1000:
        np.testing.assert_array_equal(got_acp, np.asarray(acp))
    else:
        np.testing.assert_allclose(got_acp, np.asarray(acp), atol=2e-6)


@pytest.mark.parametrize("strength,steps", [(1.0, 50), (0.35, 18),
                                            (0.99, 49), (0.5, 25)])
def test_first_step_uses_python_rounding(strength, steps):
    """round((1 - s) * 50) as Python rounds the float: 32.5 -> 32 (0.35),
    0.5000000000000004 -> 1 (0.99)."""
    assert 50 - diffusion.first_step(strength, 50) == steps


# ---------------------------- nets at TINY widths -----------------------------

def _tiny_unet_pair(rng):
    cfg = jdiff.UNetConfig(**TINY)
    lat = jnp.zeros((1, 8, 12, 9))
    ctx = jnp.zeros((1, 5, 8))
    args = (lat, jnp.zeros((1,)), ctx)
    jv = _randomize(jax.eval_shape(jdiff.UNet2DCondition(cfg).init,
                                   jax.random.PRNGKey(0), *args), rng)
    port = convert.load_jax_params(
        diffusion.UNet2DCondition(diffusion.UNetConfig(**TINY)), jv).eval()
    return cfg, jv, port


def test_unet_with_control_residuals_matches_stitchax(rng):
    """UNet at TINY widths, latent 8x12, ControlNet-shaped residuals and
    mid: relative 1e-5 of max |out| (reads 1.0e-6)."""
    cfg, jv, port = _tiny_unet_pair(rng)
    lat = rng.standard_normal((1, 8, 12, 9)).astype(np.float32)
    ctx = rng.standard_normal((1, 5, 8)).astype(np.float32)
    t = np.array([37.0], np.float32)
    res = [rng.standard_normal(s).astype(np.float32) for s in
           [(1, 8, 12, 8), (1, 8, 12, 8), (1, 4, 6, 8), (1, 4, 6, 16)]]
    mid = rng.standard_normal((1, 4, 6, 16)).astype(np.float32)
    want = jax.jit(jdiff.UNet2DCondition(cfg).apply)(
        jv, J(lat), J(t), J(ctx), [J(r) for r in res], J(mid))
    with torch.no_grad():
        got = port(nchw(lat), T(t), T(ctx), [nchw(r) for r in res],
                   nchw(mid))
    assert _rel_err(nhwc(got), want) < 1e-5


@pytest.mark.parametrize("hw", [(8, 12), (7, 9)])
def test_controlnet_matches_stitchax(rng, hw):
    """ControlNet at TINY widths with a control image 8x the latent: the
    residual list and mid, relative 1e-5 of max |out| each (read at most
    8.0e-7). The odd latent
    (7x9, control 56x72) takes flax's SAME (1, 1) stride-2 pad in the
    down block, the even one (0, 1)."""
    cfg = jdiff.UNetConfig(**TINY)
    h, w = hw
    lat = rng.standard_normal((1, h, w, 4)).astype(np.float32)
    ctrl = rng.uniform(-1, 1, (1, 8 * h, 8 * w, 3)).astype(np.float32)
    ctx = rng.standard_normal((1, 5, 8)).astype(np.float32)
    t = np.array([91.0], np.float32)
    jv = _randomize(jax.eval_shape(jdiff.ControlNet(cfg).init,
                                   jax.random.PRNGKey(0), J(lat), J(t),
                                   J(ctx), J(ctrl)), rng)
    port = convert.load_jax_params(
        diffusion.ControlNet(diffusion.UNetConfig(**TINY)), jv).eval()
    res, mid = jax.jit(jdiff.ControlNet(cfg).apply)(jv, J(lat), J(t),
                                                    J(ctx), J(ctrl))
    with torch.no_grad():
        got_res, got_mid = port(nchw(lat), T(t), T(ctx), nchw(ctrl))
    assert len(got_res) == len(res) == 4
    for g, r in zip(got_res + [got_mid], list(res) + [mid]):
        assert g.shape == nchw(np.asarray(r)).shape
        assert _rel_err(nhwc(g), r) < 1e-5


def test_transformer_block_odd_size_matches_stitchax(rng):
    """One TransformerBlock at 7x9 (heads 2, width 8, context 5x6): the
    tanh GELU of the GEGLU and the two attentions; relative 1e-5 (reads
    2.8e-7)."""
    x = rng.standard_normal((1, 7, 9, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, 5, 6)).astype(np.float32)
    blk = jdiff.TransformerBlock(2, 6, 4)
    jv = _randomize(jax.eval_shape(blk.init, jax.random.PRNGKey(0), J(x),
                                   J(ctx)), rng)
    port = convert.load_jax_params(diffusion.TransformerBlock(8, 2, 6, 4),
                                   jv).eval()
    want = blk.apply(jv, J(x), J(ctx))
    with torch.no_grad():
        got = port(nchw(x), T(ctx))
    assert _rel_err(nhwc(got), want) < 1e-5
    # the exact GELU would not pass: flax's nn.gelu is the tanh form
    assert not np.allclose(np.asarray(jax.nn.gelu(J(x))),
                           np.asarray(jax.nn.gelu(J(x), approximate=False)),
                           atol=1e-5)


@pytest.mark.parametrize("hw", [(32, 48), (24, 40)])
def test_vae_matches_stitchax(rng, hw):
    """VAE at TINY widths: encode_mode at the image size, decode at the
    latent; relative 1e-5 of max |out| (reads 9.3e-7)."""
    model = jvae.AutoencoderKL(**TINY_VAE)
    img = rng.uniform(-1, 1, (1, *hw, 3)).astype(np.float32)
    jv = _randomize(jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                   J(img)), rng)
    port = convert.load_jax_params(vae.AutoencoderKL(**TINY_VAE), jv).eval()
    z = _japply(model, jv, img, jvae.AutoencoderKL.encode_mode)
    lat = rng.standard_normal(z.shape).astype(np.float32)
    dec = _japply(model, jv, lat, jvae.AutoencoderKL.decode)
    with torch.no_grad():
        got_z = port.encode_mode(nchw(img))
        got_dec = port.decode(nchw(lat))
    assert _rel_err(nhwc(got_z), z) < 1e-5
    assert _rel_err(nhwc(got_dec), dec) < 1e-5


# --------------------------- the committed checkpoint -------------------------

@pytest.fixture(scope="module")
def sd_blob():
    _need(SD_CKPT)
    return convert.load_sd_container(SD_CKPT)


@pytest.fixture(scope="module")
def sd_models():
    _need(SD_CKPT)
    return load_sd_models(SD_CKPT, device="cpu")


def _count_leaves(tree):
    return len(jax.tree_util.tree_leaves(tree))


def test_committed_checkpoint_loads_every_leaf(sd_blob, sd_models):
    """Every stitchax leaf fills one parameter and every parameter is
    filled (load_jax_params raises otherwise): 286 / 154 / 244 leaves."""
    assert sd_blob["format"] == "stitchax_jax"
    for key, net, n in (("unet_vars", sd_models.unet, 286),
                        ("controlnet_vars", sd_models.controlnet, 154),
                        ("vae_vars", sd_models.vae, 244)):
        assert _count_leaves(sd_blob[key]) == n == len(net.state_dict())
    assert sd_models.preferred_strength == pytest.approx(0.35)
    assert tuple(sd_models.context.shape) == (1, 77, 96)
    np.testing.assert_array_equal(sd_models.context.numpy(),
                                  sd_blob["context"])


def _jcfgs(blob):
    c = blob["configs"]
    return jdiff.UNetConfig(**c["unet"]), jvae.AutoencoderKL(**c["vae"])


def test_committed_nets_match_stitchax(rng, sd_blob, sd_models):
    """The checkpoint's three nets at a 64x96 image (latent 8x12), fp32:
    ControlNet residuals and mid, the UNet's eps given them, the VAE's
    encode_mode and decode; relative 1e-5 of max |out| each (read at most
    1.6e-6)."""
    cfg, jv_vae = _jcfgs(sd_blob)
    jt = lambda k: jax.tree_util.tree_map(jnp.asarray, sd_blob[k])
    ctx = sd_blob["context"]
    img = rng.uniform(-1, 1, (1, 64, 96, 3)).astype(np.float32)
    lat = rng.standard_normal((1, 8, 12, 4)).astype(np.float32)
    lat9 = rng.standard_normal((1, 8, 12, 9)).astype(np.float32)
    t = np.array([601.0], np.float32)
    res, mid = jax.jit(jdiff.ControlNet(cfg).apply)(
        jt("controlnet_vars"), J(lat), J(t), J(ctx), J(img))
    eps = jax.jit(jdiff.UNet2DCondition(cfg).apply)(
        jt("unet_vars"), J(lat9), J(t), J(ctx), res, mid)
    z = _japply(jv_vae, jt("vae_vars"), img, jvae.AutoencoderKL.encode_mode)
    dec = _japply(jv_vae, jt("vae_vars"), lat, jvae.AutoencoderKL.decode)
    m = sd_models
    with torch.no_grad():
        g_res, g_mid = m.controlnet(nchw(lat), T(t), m.context, nchw(img))
        g_eps = m.unet(nchw(lat9), T(t), m.context,
                       [nchw(np.asarray(r)) for r in res], nchw(mid))
        g_z = m.vae.encode_mode(nchw(img))
        g_dec = m.vae.decode(nchw(lat))
    for g, r in zip(g_res + [g_mid], list(res) + [mid]):
        assert _rel_err(nhwc(g), r) < 1e-5
    assert _rel_err(nhwc(g_eps), eps) < 1e-5
    assert _rel_err(nhwc(g_z), z) < 1e-5
    assert _rel_err(nhwc(g_dec), dec) < 1e-5


def _hole_image(rng, H=64, W=96):
    img = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    mask = np.zeros((H, W, 1), np.float32)
    mask[20:44, 30:70] = 1.0
    return img, mask


# ------------------------------ the inpainter ---------------------------------

def _stub_denoise(image, mask, steps):
    """Deterministic and shape-faithful: each array library's own ops."""
    return image * 0.5 + mask * 100.0 + 3.0


@pytest.mark.parametrize("limit,hw", [(40 * 40, (50, 70)), (10 ** 6,
                                                            (48, 64))])
def test_inpainter_area_limit_matches_stitchax(rng, limit, hw):
    """The area-limit branch (a 50x70 canvas over a 1600 px limit: 32x48
    inside, antialiased-bilinear down, nearest mask, bilinear back, the
    original kept outside the hole) and the direct call, with one stub
    denoiser on both sides; 2e-3 on [0, 255] (the resizes' fp32 sums)."""
    H, W = hw
    img = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (H, W, 1)) > 0.6).astype(np.float32)
    ref = j_inpainters.StableDiffusionInpainter(
        denoise_fn=_stub_denoise, resize_to_area_limit=limit)
    got = StableDiffusionInpainter(denoise_fn=_stub_denoise,
                                   resize_to_area_limit=limit)
    want = np.asarray(ref.inpaint(J(img), J(mask)))
    np.testing.assert_allclose(got.inpaint(T(img), T(mask)).numpy(), want,
                               atol=2e-3)


def test_inpainter_resolves_stitchax_strength(monkeypatch, sd_models):
    """strength: the argument, else STITCHAX_SD_STRENGTH, else the
    checkpoint's 0.35."""
    monkeypatch.delenv("STITCHAX_SD_STRENGTH", raising=False)
    assert StableDiffusionInpainter(models=sd_models).strength == \
        pytest.approx(0.35)
    monkeypatch.setenv("STITCHAX_SD_STRENGTH", "0.6")
    ip = StableDiffusionInpainter(models=sd_models)
    assert ip.strength == pytest.approx(0.6) and ip.denoise_fn.steps == 30
    assert StableDiffusionInpainter(models=sd_models,
                                    strength=1.0).denoise_fn.steps == 50


def test_inpainter_refuses_a_missing_checkpoint(monkeypatch, tmp_path):
    """Where stitchax warns and fills by push-pull, the port raises."""
    monkeypatch.delenv("STITCHAX_SD_CKPT", raising=False)
    with pytest.raises(FileNotFoundError):
        StableDiffusionInpainter(ckpt=str(tmp_path / "missing.pt"),
                                 device="cpu")
    monkeypatch.setattr(inpainters, "DEFAULT_SD_CKPT",
                        str(tmp_path / "missing.pt"))
    with pytest.raises(ValueError, match="SD checkpoint"):
        get_inpainter("inpainter", device="cpu")
    monkeypatch.setenv("STITCHAX_SD_CKPT", "none")
    with pytest.raises(ValueError, match="SD checkpoint"):
        resolve_sd_ckpt()
    monkeypatch.setattr(inpainters, "DEFAULT_SD_CKPT", SD_CKPT)
    with pytest.raises(ValueError, match="SD checkpoint"):
        StableDiffusionInpainter(device="cpu")


def test_inpainter_default_checkpoint_is_stitchax_default(monkeypatch):
    _need(SD_CKPT)
    monkeypatch.delenv("STITCHAX_SD_CKPT", raising=False)
    assert os.path.samefile(resolve_sd_ckpt(), SD_CKPT)


# ------------------------------ the mix method --------------------------------

@pytest.mark.parametrize("with_inpainter", [False, True])
def test_inpaint_all_area_matches_stitchax(rng, with_inpainter):
    """inpaint_all_area without an inpainter and with a stub: the hole mask
    (thin parts thickened by 16 px) equal, the canvases within 1e-3."""
    H, W = 56, 64
    warp, fw, out1 = (rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
                      for _ in range(3))
    m1 = np.zeros((H, W, 1), np.float32)
    m1[:, :44] = 1
    wm = np.zeros((H, W, 1), np.float32)
    wm[4:52, 16:] = 1
    occ = np.ones((H, W, 1), np.float32)
    occ[20:36, 22:40] = 0                # a thick hole
    occ[10:12, 18:42] = 0                # a thin one
    occ = occ * m1
    fill = (lambda image, mask: image * 0.25 + mask * 40.0) \
        if with_inpainter else None
    got = inpaint_all_area(T(warp), T(wm), T(out1), T(m1), T(fw), T(occ),
                           inpaint=fill, inpainter_name="inpainter")
    ref = j_mix(J(warp), J(wm), J(out1), J(m1), J(fw), J(occ),
                inpaint=fill, inpainter_name="inpainter")
    hole = np.asarray(ref.inpaint_area_mask)
    assert 0.05 < (hole > 0.5).mean() < 0.5
    np.testing.assert_array_equal(got.inpaint_area_mask.numpy(), hole)
    for name in ("tps_final_warp", "tps_final_warp_mask", "inpaint_img",
                 "inpaint_img_mask"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-3,
                                   err_msg=name)


# ------------------- stitchax's full-size stitch (committed) ------------------

def _sd_ref():
    _need(SD_REF)
    with np.load(SD_REF) as d:
        return {k.split("/", 1)[1]: d[k] for k in d.files}


def _demo1_pair():
    from test_torch_parity import REF
    _need(REF)
    with np.load(REF) as d:
        return [d[f"{PAIR}/img{i}"].astype(np.float32) for i in (1, 2)]


def test_sd_reference_holds_the_inpainter_call():
    """The committed reference: the inpainter's mask is the stitch's hole
    mask, its input is zero in the hole and its output only there, at the
    bucketed canvas; the hole covers some of the canvas."""
    ref = _sd_ref()
    np.testing.assert_array_equal(ref["inpaint_mask"], ref["hole_mask"])
    hole = ref["inpaint_mask"][..., 0] > 0.5
    assert tuple(ref["canvas_hw"]) == hole.shape == ref["mask1"].shape[:2]
    assert (ref["inpaint_in"][hole] == 0).all()
    assert (ref["inpaint_out_hole"][~hole] == 0).all()
    assert 0.001 < hole.mean() < 0.5
    th, tw = (int(v) for v in ref["true_hw"])
    for k in ("warp2", "ave_fusion", "composition", "learned_mask1"):
        assert ref[k].shape[:2] == (th, tw)


def sd_stitch_checks(got, pair, ref):
    """{metric: value} of the port's diffusion stitch of demo1 (numpy
    outputs of `Stitcher.stitch`) against stitchax's committed one."""
    from stitchax_torch.run.stitcher import output_images

    th, tw = (int(v) for v in ref["true_hw"])
    files = output_images(got, *pair)
    res = {f"{k}_psnr_db": _psnr(files[k], ref[k])
           for k in ("warp2", "ave_fusion", "composition")}
    lm = np.concatenate([np.abs(got[k] - ref[k]).ravel()
                         for k in ("learned_mask1", "learned_mask2")])
    res.update(
        canvas_moved_px=float(np.abs(np.concatenate([
            got["canvas_box"][:2] - ref["canvas_origin"],
            got["true_hw"] - ref["true_hw"],
            got["canvas_hw"] - ref["canvas_hw"]])).max()),
        mask1_moved_px=int((got["mask1"] != ref["mask1"][:th, :tw]).sum()),
        hole_moved_px=int((got["inpaint_area_mask"]
                           != ref["hole_mask"][:th, :tw]).sum()),
        learned_mask_mean_abs=float(lm.mean()),
        learned_mask_max_abs=float(lm.max()))
    return res


# equalities kept equal; PSNR about 11 dB under the CPU's readings (81.4 /
# 82.4 / 81.3 dB), the learned masks' mean |diff| 10x of its 1.0e-6
SD_STITCH_TOL = {"canvas_moved_px": 0.0, "mask1_moved_px": 0,
                 "hole_moved_px": 0, "warp2_psnr_db": 70.0,
                 "ave_fusion_psnr_db": 70.0, "composition_psnr_db": 70.0,
                 "learned_mask_mean_abs": 1e-5}


@pytest.mark.slow
def test_sd_inpainter_matches_stitchax_on_its_inputs(sd_models):
    """The port's inpainter (fp32, CPU) on the input and hole mask
    stitchax's inpainter got inside its demo1 stitch (512x768, 18 steps):
    outside the hole the input, the hole at or above 105 dB PSNR from
    stitchax's output (reads 127.9 dB)."""
    ref = _sd_ref()
    hole = ref["inpaint_mask"][..., 0] > 0.5
    got = StableDiffusionInpainter(models=sd_models).inpaint(
        T(ref["inpaint_in"]), T(ref["inpaint_mask"])).numpy()
    np.testing.assert_array_equal(got[~hole], ref["inpaint_in"][~hole])
    db = _psnr(got[hole], ref["inpaint_out_hole"][hole])
    print({"inpaint_hole_psnr_db": db})
    assert db >= 105.0


@pytest.mark.slow
def test_diffusion_stitch_full_size_matches_stitchax():
    """The port's Stitcher with the diffusion configuration (trained homo,
    flow, comp and SD weights, fp32, CPU) on demo1 at its native 384x448
    against stitchax's jitted Stitcher's committed outputs, within
    SD_STITCH_TOL."""
    _need(CKPT)
    _need(SD_CKPT)
    from stitchax_torch.run.stitcher import Stitcher, StitchModels

    models = StitchModels.from_npz(CKPT, "cpu", torch.float32, DIFFUSION,
                                   sd=SD_CKPT)
    pair = _demo1_pair()
    got = Stitcher(models, device="cpu", config=DIFFUSION).stitch(*pair)
    res = sd_stitch_checks(got, pair, _sd_ref())
    print(res)
    for k, lim in SD_STITCH_TOL.items():
        assert (res[k] >= lim if k.endswith("_db") else res[k] <= lim), \
            (k, res[k], lim)


@pytest.mark.slow
def test_cli_writes_the_diffusion_files_on_the_cpu(tmp_path):
    """python -m stitchax_torch.out --inf_cfg inpaint_all_area_g12_diffusion
    --device cpu --fp32 over demo1: out.py's twelve files."""
    _need(CKPT)
    _need(SD_CKPT)
    from stitchax_torch import out

    root = tmp_path / "data"
    root.mkdir()
    os.symlink(os.path.join(REPO, "demo_data", PAIR), root / PAIR)
    (root / "one.txt").write_text(PAIR + "\n")
    rc = out.main(["--inf_cfg", DIFFUSION, "--device", "cpu", "--fp32",
                   "--data_root_path", str(root), "--txt_file", "one.txt",
                   "--ckpt_path", CKPT, "--sd_ckpt", SD_CKPT,
                   "--result_dir", str(tmp_path / "out")])
    assert rc == 0
    pair_dir = tmp_path / "out" / f"{DIFFUSION}_g12x12_stitchax" / PAIR
    assert sorted(f[:-4] for f in os.listdir(pair_dir)) == sorted(
        ["H_warp", "ave_fusion", "composition", "flow_warp", "input1",
         "input2", "learned_mask1", "learned_mask2", "mask1", "mask2",
         "warp1", "warp2"])


# ------------------- diffusers / transformers checkpoints ---------------------

def _trees_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_diffusers_converters_match_stitchax(rng):
    """Synthetic diffusers state dicts at TINY widths (as
    tests/test_diffusion_pipeline.py builds them): the port's converters
    give stitchax's trees exactly, and every leaf fills a parameter."""
    from test_diffusion_pipeline import (_controlnet_keys, _fake_sd,
                                         _unet_keys, _vae_keys)
    cfg, pcfg = jdiff.UNetConfig(**TINY), diffusion.UNetConfig(**TINY)
    unet_sd = _fake_sd(_unet_keys(cfg), rng)
    cnet_sd = _fake_sd(_controlnet_keys(cfg), rng)
    vae_sd = _fake_sd(_vae_keys((8, 8, 16, 16)), rng)
    for ours, theirs, sd, net in (
            (diffusion.convert_sd_unet, jdiff.convert_sd_unet, unet_sd,
             diffusion.UNet2DCondition(pcfg)),
            (diffusion.convert_controlnet, jdiff.convert_controlnet, cnet_sd,
             diffusion.ControlNet(pcfg))):
        tree = ours(sd, pcfg)
        _trees_equal(tree, theirs(sd, cfg))
        convert.load_jax_params(net, tree)
    tree = vae.convert_vae(vae_sd)
    _trees_equal(tree, jvae.convert_vae(vae_sd))
    convert.load_jax_params(vae.AutoencoderKL(**TINY_VAE), tree)


def _clip_state_dict(rng, vocab=99, width=32, layers=3, max_tokens=16):
    """transformers CLIPTextModel's layout with seeded values."""
    w = lambda *s: torch.from_numpy(
        (rng.standard_normal(s) * 0.2).astype(np.float32))
    p = "text_model"
    sd = {f"{p}.embeddings.token_embedding.weight": w(vocab, width),
          f"{p}.embeddings.position_embedding.weight": w(max_tokens, width),
          f"{p}.final_layer_norm.weight": 1 + w(width),
          f"{p}.final_layer_norm.bias": w(width)}
    for i in range(layers):
        lp = f"{p}.encoder.layers.{i}"
        for n in ("layer_norm1", "layer_norm2"):
            sd[f"{lp}.{n}.weight"] = 1 + w(width)
            sd[f"{lp}.{n}.bias"] = w(width)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{lp}.self_attn.{n}.weight"] = w(width, width)
            sd[f"{lp}.self_attn.{n}.bias"] = w(width)
        sd[f"{lp}.mlp.fc1.weight"] = w(4 * width, width)
        sd[f"{lp}.mlp.fc1.bias"] = w(4 * width)
        sd[f"{lp}.mlp.fc2.weight"] = w(width, 4 * width)
        sd[f"{lp}.mlp.fc2.bias"] = w(width)
    return sd


def test_clip_text_encoder_matches_stitchax(rng):
    """CLIP text tower at width 32, 3 layers, 4 heads, 16 tokens: the
    converted tree equals stitchax's, the forward is within 1e-5 relative
    of max |out|; the empty prompt's tokens are stitchax's."""
    sd = _clip_state_dict(rng)
    tree = clip_text.convert_clip_text(sd)
    _trees_equal(tree, jclip.convert_clip_text(sd))
    kw = dict(vocab_size=99, width=32, layers=3, heads=4, max_tokens=16)
    port = convert.load_jax_params(clip_text.ClipTextEncoder(**kw),
                                   tree).eval()
    ids = rng.integers(0, 99, (2, 16)).astype(np.int32)
    want = jax.jit(jclip.ClipTextEncoder(**kw).apply)(
        jax.tree_util.tree_map(jnp.asarray, tree), J(ids))
    with torch.no_grad():
        got = port(T(ids.astype(np.int64)))
    assert _rel_err(got.numpy(), want) < 1e-5
    np.testing.assert_array_equal(clip_text.empty_prompt_tokens(2).numpy(),
                                  np.asarray(jclip.empty_prompt_tokens(2)))


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_sd.py --write")
    print(write_reference())
