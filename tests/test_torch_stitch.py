"""The slice end to end: the port's Stitcher against stitchax's stages
(stitch_model_step -> stitch_render -> the Stitcher._tps_step body:
tps_break_warp, all_img1_with_inpaint with the classical inpainter, blend)
on demo_data/demo1, driven through tests/stub_backbones.py and a torch copy
of the stubs; plus one run with the trained ckpt_r05 FlowFormer++ weights at
a reduced input size. fp32 on the CPU."""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from stub_backbones import OFFSETS, W_FLOW, stub_flow_fn, stub_homo_fn  # noqa: E402

from held_to_stitchax import psnr  # noqa: E402
from stitchax.align.adapter import AlignConfig as JAlign  # noqa: E402
from stitchax.align.adapter import bucket_canvas as j_bucket  # noqa: E402
from stitchax.align.adapter import stitch_model_step as j_model_step  # noqa: E402
from stitchax.align.adapter import stitch_render as j_render  # noqa: E402
from stitchax.compose.inpainters import push_pull_inpaint as j_inpaint  # noqa: E402
from stitchax.compose.mix_methods import all_img1_with_inpaint as j_mix  # noqa: E402
from stitchax.tps.pipeline import TPSConfig as JTPS  # noqa: E402
from stitchax.tps.pipeline import tps_break_warp as j_tps  # noqa: E402
from stitchax_torch.align.adapter import AlignConfig  # noqa: E402
from stitchax_torch.ops.kernels import library  # noqa: E402
from stitchax_torch.ops.morphology import avg_pool_same  # noqa: E402
from stitchax_torch.run.stitcher import (Stitcher, StitchModels,  # noqa: E402
                                         load_inf_config)

REPO = os.path.join(os.path.dirname(__file__), "..")
DEMO = os.path.join(REPO, "demo_data", "demo1")
CKPT = os.path.join(REPO, "results", "ckpt_r05_bf16.npz")


def _load_demo_pair(size=(224, 192)):
    from PIL import Image
    out = []
    for name in ("input1.jpg", "input2.jpg"):
        im = Image.open(os.path.join(DEMO, name)).convert("RGB")
        out.append(np.asarray(im.resize(size, Image.BILINEAR), np.float32))
    return out


def t_stub_homo(a, b):
    return torch.from_numpy(OFFSETS)[None].expand(a.shape[0], 8)


def t_stub_flow(a, b):
    d = avg_pool_same((a - b) / 255.0, 31)
    return [torch.tanh(d @ torch.from_numpy(W_FLOW)) * 5.0], None


def _jax_stitch(img1, img2, acfg, tcfg, homo_fn, flow_fn, flow_pair_fn=None):
    """stitchax's per-pair stages, as its Stitcher chains them."""
    i1, i2 = jnp.asarray(img1[None]), jnp.asarray(img2[None])
    out = j_model_step(homo_fn, flow_fn, i1, i2, acfg,
                       flow_pair_fn=flow_pair_fn)
    box = np.asarray(out["canvas_box"])[0]
    true_w, true_h = int(box[2] - box[0]), int(box[3] - box[1])
    out_w = j_bucket(true_w, acfg.canvas_bucket, acfg.max_canvas)
    out_h = j_bucket(true_h, acfg.canvas_bucket, acfg.max_canvas)
    r = j_render(i1, i2, out["H"], out["flow"], out["origin_occlusion_mask"],
                 out["width_min"], out["height_min"], out_h, out_w, acfg)
    occ0 = r["occlusion_mask"][0]
    t = j_tps(r["output1"][0], r["mask1"][0], r["H_warp"][0],
              r["H_warp_mask"][0], r["final_warp"][0], out["flow"][0],
              out["width_min"][0], out["height_min"][0], tcfg,
              occlusion_mask=occ0)
    m = j_mix(t["output2"], t["mask2"], r["output1"][0], r["mask1"][0],
              r["final_warp"][0], occ0, inpaint=j_inpaint,
              inpainter_name="cv_inpainter")
    mask2 = m.tps_final_warp_mask
    output2 = m.tps_final_warp * mask2
    mask1, output1 = r["mask1"][0], r["output1"][0]
    blend = jnp.clip((output1 * mask1 + output2 * mask2)
                     / jnp.maximum(mask1 + mask2, 1e-6), 0, 255)
    res = dict(H=out["H"][0], flow=out["flow"][0], canvas_box=box,
               H_warp=r["H_warp"][0], final_warp=r["final_warp"][0],
               output1=output1, mask1=mask1, output2=output2, mask2=mask2,
               new_blend_image=blend, occlusion_mask=occ0,
               control_src=t["control_src"], control_dst=t["control_dst"],
               control_valid=t["control_valid"])
    return {k: np.asarray(v) for k, v in res.items()}, (out_h, out_w)


def _torch_stitch(stitcher, img1, img2):
    to = lambda a: torch.from_numpy(a)[None]
    res = stitcher.stitch_tensors(to(img1), to(img2))
    canvas = res.pop("canvas")
    res.pop("true_hw")
    return {k: v.numpy() for k, v in res.items()}, canvas


TPS = dict(grid_h=8, grid_w=8)


def test_fast_cv_g8_config():
    c = load_inf_config("fast_cv_g8")
    assert (c["tps_cfg"].grid_h, c["tps_cfg"].grid_w) == (8, 8)
    assert c["inpainter"] == "cv_inpainter"
    assert c["mix_method"] == "all_img1_with_inpaint"


def test_stub_stitch_matches_stitchax():
    img1, img2 = _load_demo_pair()
    ref, ref_canvas = _jax_stitch(
        img1, img2, JAlign(model_size=128, canvas_bucket=64),
        JTPS(**TPS), stub_homo_fn, stub_flow_fn)
    st = Stitcher(None, None, AlignConfig(model_size=128, canvas_bucket=64),
                  device="cpu", homo_fn=t_stub_homo, flow_fn=t_stub_flow)
    got, canvas = _torch_stitch(st, img1, img2)
    assert canvas == ref_canvas
    np.testing.assert_array_equal(got["canvas_box"], ref["canvas_box"])
    np.testing.assert_allclose(got["H"], ref["H"], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got["flow"], ref["flow"], atol=1e-4)
    # warps on [0, 255]: fp32 reassociation in the sampler weights
    for k in ("H_warp", "output1", "final_warp"):
        np.testing.assert_allclose(got[k], ref[k], atol=5e-2, err_msg=k)
    # thresholded masks: at most 0.1% of canvas pixels may flip on a
    # float-rounding tie at a threshold
    for k in ("mask1", "occlusion_mask", "mask2"):
        flips = np.mean(np.abs(got[k] - ref[k]) > 1e-3)
        assert flips <= 1e-3, (k, flips)
    np.testing.assert_array_equal(got["control_valid"], ref["control_valid"])
    np.testing.assert_allclose(got["control_dst"], ref["control_dst"],
                               atol=1e-3)
    assert ref["mask2"].mean() > 0.05          # img2 really contributes
    assert psnr(got["new_blend_image"], ref["new_blend_image"]) > 50.0
    assert psnr(got["output2"], ref["output2"]) > 45.0


def test_stitcher_numpy_entry_point_crops_to_true_canvas():
    img1, img2 = _load_demo_pair()
    st = Stitcher(None, None, AlignConfig(model_size=128, canvas_bucket=64),
                  device="cpu", homo_fn=t_stub_homo, flow_fn=t_stub_flow)
    out = st.stitch(img1, img2)
    th, tw = out["true_hw"]
    assert out["new_blend_image"].shape == (th, tw, 3)
    assert out["new_blend_image"].dtype == np.float32
    assert np.isfinite(out["new_blend_image"]).all()
    assert (out["canvas_hw"] % 64 == 0).all()


def test_entry_points_refuse_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Stitcher(None, homo_fn=t_stub_homo, flow_fn=t_stub_flow)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StitchModels.from_npz(CKPT)


def test_trained_flowformer_stitch_matches_stitchax():
    """ckpt_r05's trained FlowFormer++ in both packages (fp32), both flow
    directions from one bidirectional call, at a 96x112 pair and a
    128^2 model input; the stub homography (the trained homography net's
    regression head is sized for 512^2 inputs)."""
    from stitchax.convert import load_params_npz
    from stitchax.models.flowformer import FlowFormer as JFF
    from stitchax.models.flowformer import FlowFormerConfig as JFFC
    from stitchax_torch import convert
    from stitchax_torch.models import FlowFormer, UDIS2HomographyNet

    if not os.path.isfile(CKPT):
        pytest.skip(f"{CKPT} is not in this checkout")
    img1, img2 = _load_demo_pair(size=(112, 96))
    jm = JFF(JFFC(upsample_all=False))
    x = jnp.zeros((1, 128, 128, 3), jnp.float32)
    tpl = {"flow": jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                  x, x))}
    tpl = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tpl)
    jparams = load_params_npz(CKPT, tpl)["flow"]
    flow_fn = lambda a, b: jm.apply(jparams, a, b)
    pair_fn = lambda a, b: jm.apply(jparams, a, b, method=JFF.bidirectional)
    acfg = dict(model_size=128, canvas_bucket=64)
    ref, ref_canvas = _jax_stitch(img1, img2, JAlign(**acfg), JTPS(**TPS),
                                  stub_homo_fn, flow_fn, pair_fn)

    tree = convert.load_npz(CKPT, "flow")
    models = StitchModels(convert.load_jax_params(FlowFormer(), tree),
                          UDIS2HomographyNet(128), device="cpu",
                          dtype=torch.float32)
    st = Stitcher(models, None, AlignConfig(**acfg), device="cpu",
                  homo_fn=t_stub_homo)
    library.reset_launches()
    got, canvas = _torch_stitch(st, img1, img2)
    assert library.launches == {"gsa_attention": 0, "cost_lookup": 0,
                                "tps_grid": 0, "window_attention": 0,
                                "conv3x3": 0, "conv3x3_input_grad": 0,
                                "pair_scores": 0, "conv3x3_wide": 0,
                                "conv3x3_wide_input_grad": 0}
    # (CPU: plain versions only)
    assert canvas == ref_canvas
    np.testing.assert_array_equal(got["canvas_box"], ref["canvas_box"])
    # flow through 12 recurrent iterations in fp32: sub-pixel agreement
    diff = np.abs(got["flow"] - ref["flow"])
    assert diff.max() < 0.05 and diff.mean() < 5e-3, (diff.max(), diff.mean())
    assert psnr(got["new_blend_image"], ref["new_blend_image"]) > 40.0
