"""The SD plugin's inpaint function against stitchax's on the CPU: with
the committed checkpoint (results/sd_ckpt_r05.pt) at both strengths, and
through `load_sd_checkpoint` from a seeded diffusers-layout pack. Helpers
and fixtures are test_torch_sd.py's."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stitchax.models import diffusion as jdiff  # noqa: E402
from stitchax.models.sd_pipeline import load_sd_checkpoint as j_load_sd  # noqa: E402
from stitchax.models.sd_pipeline import make_sd_inpaint_fn as j_make_sd  # noqa: E402
from stitchax_torch.models.sd_pipeline import (  # noqa: E402
    load_sd_checkpoint, make_sd_inpaint_fn)
from test_torch_sd import (J, T, _clip_state_dict, _hole_image,  # noqa: E402
                           _jcfgs, _psnr, sd_blob, sd_models)


@pytest.mark.parametrize("strength,min_psnr", [(0.35, 110.0),
                                               (1.0, 110.0)])
def test_inpaint_fn_matches_stitchax(rng, sd_blob, sd_models, strength,
                                     min_psnr):
    """make_sd_inpaint_fn with the committed checkpoint on a 64x96 image
    with a 24x40 hole, against stitchax's jitted inpaint_fn: pixels outside
    the hole equal, the hole's PSNR on [0, 255] at or above 110 dB, 10x of
    the readings in RMS (18 steps from the push-pull fill at 0.35 read
    130 dB, 50 steps from the noise at 1.0 read 129 dB: fp32 sums in
    another order, through the loop)."""
    cfg, jv_vae = _jcfgs(sd_blob)
    jt = lambda k: jax.tree_util.tree_map(jnp.asarray, sd_blob[k])
    img, mask = _hole_image(rng)
    fn = j_make_sd(jt("unet_vars"), jt("controlnet_vars"), jt("vae_vars"),
                   J(sd_blob["context"]), cfg=cfg, vae=jv_vae, num_steps=50,
                   seed=0, strength=strength)
    want = np.asarray(jax.jit(fn)(J(img), J(mask)))
    port = make_sd_inpaint_fn(sd_models, 50, 0, strength)
    assert port.steps == (18 if strength < 1 else 50)
    got = port(T(img), T(mask)).numpy()
    keep = mask[..., 0] < 0.5
    np.testing.assert_array_equal(got[keep], img[keep])
    np.testing.assert_array_equal(want[keep], img[keep])
    hole = ~keep
    assert np.abs(want[hole] - img[hole]).mean() > 1.0
    assert _psnr(got[hole], want[hole]) >= min_psnr


def test_load_sd_checkpoint_diffusers_pack_matches_stitchax(rng, tmp_path):
    """A seeded diffusers-layout pack at width 8, as
    tools/make_random_sd_checkpoint.py packs one (UNet, ControlNet, VAE and
    a CLIP text tower with the full vocabulary, sized by its configs
    entry): load_sd_checkpoint's inpaint_fn, with the context from the
    port's CLIP, against stitchax's, 2 steps at 64x64: outside the hole
    equal, the hole at or above 110 dB (reads 138 dB)."""
    from test_diffusion_pipeline import (_controlnet_keys, _fake_sd,
                                         _unet_keys, _vae_keys)
    unet_kw = dict(in_channels=9, out_channels=4, block_channels=(8, 16),
                   layers_per_block=1, attention_resolutions=(0, 1),
                   context_dim=16, num_heads=4, num_train_timesteps=1000,
                   norm_groups=8)
    vae_kw = dict(block_channels=(8, 8, 8, 8), latent_channels=4, groups=8)
    clip_kw = dict(vocab_size=49408, width=16, layers=2, heads=4)
    cfg = jdiff.UNetConfig(**unet_kw)
    pack = tmp_path / "sd_rand_tiny.pt"
    torch.save({"unet": _fake_sd(_unet_keys(cfg), rng),
                "controlnet": _fake_sd(_controlnet_keys(cfg), rng),
                "vae": _fake_sd(_vae_keys((8, 8, 8, 8)), rng),
                "clip": _clip_state_dict(rng, 49408, 16, 2, 77),
                "configs": {"unet": unet_kw, "vae": vae_kw,
                            "clip": clip_kw}}, pack)
    img, mask = _hole_image(rng, 64, 64)
    want = np.asarray(jax.jit(j_load_sd(str(pack), num_steps=2))(
        J(img), J(mask)))
    got = load_sd_checkpoint(str(pack), num_steps=2, device="cpu")(
        T(img), T(mask)).numpy()
    keep = mask[..., 0] < 0.5
    np.testing.assert_array_equal(got[keep], img[keep])
    assert np.abs(want[~keep] - img[~keep]).mean() > 1.0
    assert _psnr(got[~keep], want[~keep]) >= 110.0
