"""The diffusion configuration (`inpaint_all_area_g12_diffusion`) end to
end through the port's `Stitcher` against stitchax's, on the CPU with stub
backbones, the trained composition net and the committed SD checkpoint.
Helpers and fixtures are test_torch_sd.py's."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stitchax.compose import inpainters as j_inpainters  # noqa: E402
from stitchax_torch import convert  # noqa: E402
from test_torch_sd import (CKPT, DIFFUSION, SD_CKPT, T, _need,  # noqa: E402
                           _psnr, sd_models)


class _Cfg(dict):
    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)


def test_diffusion_stitch_matches_stitchax(monkeypatch, sd_models):
    """The diffusion configuration end to end on demo1 at 224x192 through
    stub backbones (tests/stub_backbones.py and the port's copy of them),
    the trained composition net and the committed SD checkpoint, fp32 on
    both sides (stitchax's bf16 composition call swapped for fp32): the
    canvas box, mask1 and the hole mask equal; warp2, ave_fusion and the
    composition at or above 90 dB (read 104 / 104 / 105 dB)."""
    _need(CKPT)
    import stitchax.utils.precision as jprec
    from stitchax.align.adapter import AlignConfig as JAlign
    from stitchax.models.udis2 import CompositionNet as JComp
    from stitchax.run.stitcher import StitchModels as JModels
    from stitchax.run.stitcher import Stitcher as JStitcher
    from stitchax.tps.pipeline import TPSConfig as JTPS
    from stub_backbones import stub_flow_fn, stub_homo_fn
    from test_torch_stitch import _load_demo_pair, t_stub_flow, t_stub_homo

    from stitchax_torch.align.adapter import AlignConfig
    from stitchax_torch.models import CompositionNet
    from stitchax_torch.ops.kernels import library
    from stitchax_torch.run.stitcher import Stitcher, StitchModels

    monkeypatch.setattr(jprec, "bf16_call",
                        lambda fn, params, *args: fn(params, *args))
    comp_tree = convert.load_npz(CKPT, "comp")
    img1, img2 = _load_demo_pair()
    acfg = dict(model_size=128, canvas_bucket=64)
    jst = JStitcher(JModels(None, None, None, None, JComp(),
                            jax.tree_util.tree_map(jnp.asarray, comp_tree)),
                    _Cfg(swap_image=False), JAlign(**acfg),
                    JTPS(grid_h=12, grid_w=12), inpainter_name="inpainter",
                    mix_method="inpaint_all_area", homo_fn=stub_homo_fn,
                    flow_fn=stub_flow_fn, keep_inpaint_outputs=True)
    jst.inpainter = j_inpainters.StableDiffusionInpainter(ckpt=SD_CKPT)
    ref = jst._stitch_device(img1, img2)["result"]

    models = StitchModels(
        None, None, "cpu", torch.float32,
        comp_model=convert.load_jax_params(CompositionNet(), comp_tree),
        sd_models=sd_models)
    st = Stitcher(models, align_cfg=AlignConfig(**acfg), device="cpu",
                  homo_fn=t_stub_homo, flow_fn=t_stub_flow, config=DIFFUSION)
    assert st.inpainter.strength == pytest.approx(0.35)
    library.reset_launches()
    timings = {}
    res = st.stitch_tensors(T(img1)[None], T(img2)[None], timings)
    got = {k: v.numpy() for k, v in res.items() if torch.is_tensor(v)}
    assert all(n == 0 for n in library.launches.values())   # CPU: plain
    assert timings["inpaint_ms"] > 0

    assert list(got["canvas_box"][:2]) == [ref["width_min"],
                                           ref["height_min"]]
    assert list(res["true_hw"]) == [ref["out_h"], ref["out_w"]]
    assert got["new_blend_image"].shape == ref["ave_fusion"].shape
    np.testing.assert_array_equal(got["mask1"], np.asarray(ref["mask1"]))
    hole = np.asarray(ref["inpaint_area_mask"])
    assert (hole > 0.5).mean() > 0.002
    np.testing.assert_array_equal(got["inpaint_area_mask"], hole)
    assert _psnr(got["output2"], ref["warp2"]) >= 90.0
    assert _psnr(got["new_blend_image"], ref["ave_fusion"]) >= 90.0
    assert _psnr(got["composition"], ref["composition"]) >= 90.0
