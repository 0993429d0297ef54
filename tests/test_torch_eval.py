"""The port's evaluation (`stitchax_torch.evaluate`) against stitchax's.

Module by module on the CPU: PSNR/SSIM against stitchax's numpy reference,
the UDIS loader's pixels against stitchax's (Pillow) loader,
`train_eval_forward` with one set of random weights in both packages, the
trained homography net at 512^2, and `validate_with_model` with stub
backbones (tests/test_evaluate_cli.py's) on a tiny split.

The whole evaluation with the trained weights runs on a committed split:
12 pairs from tools/make_synth_udis.py (`write_split`, testing, seed 7,
recipe mixed) in tests/torch_reference/udis_synth/, and stitchax's
`validate_with_model` over them (batch 12, 512^2, fp32 nets, CPU,
results/ckpt_r05_bf16.npz) in tests/torch_reference/eval_stitchax_fp32.npz:
per-pair PSNR/SSIM, the report, and the uint8 warped img2 and coverage of
two pairs. This file is the only producer of both:

    python tests/test_torch_eval.py --write

`chip_smoke.py` holds the card's evaluation to the same file.
"""

import os
import shutil
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
REF = os.path.join(REPO, "tests", "torch_reference", "eval_stitchax_fp32.npz")
SYNTH = os.path.join(REPO, "tests", "torch_reference", "udis_synth")
CKPT = os.path.join(REPO, "results", "ckpt_r05_bf16.npz")
SYNTH_PAIRS, SYNTH_SEED, SYNTH_RECIPE = 12, 7, "mixed"
BATCH, SIZE = 12, (512, 512)
SAVED_PAIRS = (0, 1)          # pairs whose warped img2 and coverage are kept
REPORT_KEYS = ("avg_psnr", "avg_ssim", "easy_psnr", "mid_psnr", "hard_psnr",
               "easy_ssim", "mid_ssim", "hard_ssim", "num_pairs")


# ------------------------------ the producer ---------------------------------

def stitchax_eval_models():
    """stitchax's models as its evaluate.py builds them (512^2 init, the
    trained npz), and its config."""
    from stitchax.run import StitchModels
    from stitchax.run.config import build_eval_config

    args = SimpleNamespace(ckpt_path=CKPT, model_config_name="last_config",
                           data_dir=SYNTH, batch_size=BATCH, gpu="0",
                           max_pairs=-1, image_size=None)
    cfg = build_eval_config(args)
    return cfg, StitchModels.build(cfg, use_composition=False,
                                   init_size=SIZE[0])


def write_reference():
    """Regenerate the split and stitchax's evaluation of it."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_synth_udis import write_split

    from evaluate import make_eval_step, validate_with_model
    from stitchax.align.adapter import AlignConfig
    from stitchax.data import PrefetchLoader, UDISDataset
    from stitchax.metrics import psnr_batch, ssim_batch

    shutil.rmtree(SYNTH, ignore_errors=True)
    write_split(SYNTH, "testing", SYNTH_PAIRS, seed=SYNTH_SEED,
                recipe=SYNTH_RECIPE)
    cfg, models = stitchax_eval_models()
    align_cfg = AlignConfig(
        use_fb_consistency_mask=cfg.get("use_fb_consistency_mask", True))
    step = make_eval_step(models, align_cfg)
    seen = []

    def recording_step(*args):
        warped, valid = step(*args)
        seen.append((np.asarray(args[2]), np.asarray(warped),
                     np.asarray(valid)))
        return warped, valid

    ds = UDISDataset(SYNTH, phase="testing", size=SIZE)
    loader = PrefetchLoader(ds, batch_size=BATCH, shuffle=False,
                            num_workers=12)
    report = validate_with_model(cfg, loader, models, align_cfg,
                                 eval_step=recording_step)
    arrays = {f"report/{k}": np.asarray(report[k]) for k in REPORT_KEYS}
    psnr, ssim, warped_u8, valid_u8 = [], [], [], []
    for img1, warped, valid in seen:
        i1 = np.clip(img1, 0, 255).astype(np.uint8)
        w = np.clip(warped, 0, 255).astype(np.uint8)
        m = valid.astype(np.uint8)
        psnr += list(psnr_batch(i1 * m, w * m, 255.0))
        ssim += list(ssim_batch(i1 * m, w * m, 7, 255.0))
        warped_u8 += list(w)
        valid_u8 += list(m)
    arrays.update(names=np.array([p[2] for p in ds.pairs]),
                  psnr=np.array(psnr), ssim=np.array(ssim))
    for i in SAVED_PAIRS:
        arrays[f"warped/{i}"] = warped_u8[i]
        arrays[f"valid/{i}"] = valid_u8[i]
    np.savez_compressed(REF, **arrays)
    return REF


# ------------------------------ helpers --------------------------------------

def _random_u8(rng, shape):
    return (rng.random(shape) * 255).astype(np.uint8)


def _write_stub_split(root, noise):
    """test_evaluate_cli.py's split: input2 = input1 + uniform noise of
    each pair's amplitude, 96x96, Pillow quality 95."""
    from PIL import Image

    d1 = os.path.join(root, "testing", "input1")
    d2 = os.path.join(root, "testing", "input2")
    os.makedirs(d1)
    os.makedirs(d2)
    rng = np.random.default_rng(7)
    for i, amp in enumerate(noise):
        base = rng.uniform(40, 215, (96, 96, 3)).astype(np.float32)
        noisy = np.clip(base + rng.uniform(-amp, amp, base.shape), 0, 255)
        for d, arr in ((d1, base), (d2, noisy)):
            Image.fromarray(arr.astype(np.uint8)).save(
                os.path.join(d, f"{i:06d}.jpg"), quality=95)


class _StubModels:
    """The port's duck-typed models for validate_with_model: identity
    homography (zero corner offsets) and zero flow, as
    tests/test_evaluate_cli.py's stubs."""

    def __init__(self):
        import torch

        self.device = torch.device("cpu")
        self.dtype = torch.float32
        self.homo_model = lambda a, b: torch.zeros(a.shape[0], 8)
        self.flow_model = lambda a, b: (
            [torch.zeros(a.shape[:3] + (2,))], None)


# ------------------------------ the tests ------------------------------------

def test_metrics_match_stitchax_numpy_reference():
    """PSNR and SSIM of the port against stitchax's numpy reference on
    random and on masked uint8 batches, within 1e-12."""
    from stitchax import metrics as jm
    from stitchax_torch import metrics

    rng = np.random.default_rng(0)
    a = _random_u8(rng, (3, 40, 56, 3))
    b = np.clip(a.astype(int) + rng.integers(-20, 21, a.shape), 0,
                255).astype(np.uint8)
    m = (rng.random((3, 40, 56, 1)) > 0.3).astype(np.uint8)
    for x, y in ((a, b), (a * m, b * m), (a, a)):
        got_p = metrics.psnr_batch(x, y)
        got_s = metrics.ssim_batch(x, y, 7, 255.0)
        want_p = np.array([jm.psnr_np(u, v) for u, v in zip(x, y)])
        want_s = np.array([jm.ssim_np(u, v, 7) for u, v in zip(x, y)])
        np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-12)
        np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-12)


def test_udis_dataset_reads_stitchax_pixels():
    """The port's UDIS loader (its JPEG decoder and BILINEAR resize)
    reads the committed split's first pairs as stitchax's loader (Pillow)
    does, at 512^2 and at the native 480x640."""
    from stitchax.data import UDISDataset as JUDIS
    from stitchax_torch.data.udis import UDISDataset

    for size in (SIZE, None):
        ours = UDISDataset(SYNTH, phase="testing", size=size)
        theirs = JUDIS(SYNTH, phase="testing", size=size)
        assert [p[2] for p in ours.pairs] == [p[2] for p in theirs.pairs]
        for i in (0, 3):
            got, want = ours[i], theirs[i]
            for k in ("image1", "image2"):
                assert got[k].dtype == want[k].dtype == np.float32
                np.testing.assert_array_equal(got[k], want[k])


def test_prefetch_loader_batches_and_raises():
    """Batches in order with a short last one; a failed read raises in
    the consumer instead of leaving it waiting."""
    from stitchax_torch.data.udis import PrefetchLoader

    class Items:
        def __init__(self, n, bad=None):
            self.n, self.bad = n, bad

        def __len__(self):
            return self.n

        def __getitem__(self, i):
            if i == self.bad:
                raise OSError(f"cannot read item {i}")
            return {"x": np.full((2,), i, np.float32), "name": str(i)}

    batches = list(PrefetchLoader(Items(7), batch_size=3, num_workers=2))
    assert [b["name"] for b in batches] == [["0", "1", "2"], ["3", "4", "5"],
                                           ["6"]]
    assert batches[2]["x"].shape == (1, 2)

    result = {}

    def consume():
        try:
            list(PrefetchLoader(Items(9, bad=4), batch_size=2, num_workers=2))
        except OSError as e:
            result["error"] = e

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(30)
    assert not t.is_alive(), "the loader hung on a failed read"
    assert "item 4" in str(result.get("error"))


@pytest.fixture(scope="module")
def random_homography_net():
    """One set of random weights (flax init from a fixed key) in the
    homography net at 128^2 of both packages: (stitchax's fn, the
    port's fn)."""
    import jax
    import jax.numpy as jnp
    import torch

    from stitchax.models.udis2 import UDIS2HomographyNet as JUDIS2
    from stitchax_torch.convert import load_jax_params
    from stitchax_torch.models import UDIS2HomographyNet
    from stitchax_torch.utils.precision import call_in

    x = jnp.zeros((1, 128, 128, 3), jnp.float32)
    jh = JUDIS2()
    hv = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                jax.jit(jh.init)(jax.random.PRNGKey(0), x, x))
    th = load_jax_params(UDIS2HomographyNet(128), hv).eval()
    return (lambda a, b: jh.apply(hv, a, b),
            lambda a, b: call_in(th, torch.float32, a, b))


def _textured_pair(rng, B=2, n=128):
    base = rng.uniform(0, 255, (B, n + 16, n + 16, 3)).astype(np.float32)
    k = np.ones(5) / 5
    for ax in (1, 2):
        base = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), ax,
                                   base).astype(np.float32)
    return base[:, 8:8 + n, 8:8 + n].copy(), base[:, 10:10 + n, 5:5 + n].copy()


def _fixed_flows(B=2, n=128):
    """A smooth forward flow and a backward flow that undoes most of it,
    up to ~6 px: the flow net's place taken by the same fields in both
    packages, so that the alignment code is held on its own (FlowFormer++
    is held by tests/test_torch_models.py and, with the trained weights,
    by the evaluation below)."""
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    fwd = np.stack([3 + 3 * np.sin(yy / 17.0), -2 + 2 * np.cos(xx / 13.0)],
                   -1)
    bwd = -fwd * np.float32(0.9)
    bwd[40:70, 50:90] += 4.0                 # an inconsistent (occluded) patch
    tile = lambda f: np.broadcast_to(f, (B, n, n, 2)).astype(np.float32)
    return tile(fwd), tile(bwd)


def _run_both(jax_fns, torch_fns, i1, i2, fb):
    import jax
    import jax.numpy as jnp
    import torch

    from stitchax.align.adapter import AlignConfig as JAlignConfig
    from stitchax.align.adapter import train_eval_forward as j_forward
    from stitchax_torch.align.adapter import AlignConfig, train_eval_forward

    want = jax.jit(lambda a, b: j_forward(
        *jax_fns, a, b, JAlignConfig(use_fb_consistency_mask=fb)))(
        jnp.asarray(i1), jnp.asarray(i2))
    got = train_eval_forward(*torch_fns, torch.from_numpy(i1),
                             torch.from_numpy(i2),
                             AlignConfig(use_fb_consistency_mask=fb))
    return ({k: np.asarray(v) for k, v in want.items()
             if k != "flow_predictions"},
            {k: v.numpy() for k, v in got.items() if k != "flow_predictions"})


@pytest.mark.parametrize("fb", [True, False])
def test_train_eval_forward_matches_stitchax(random_homography_net, fb):
    """train_eval_forward at 128^2, B=2, the homography net with random
    weights, the flow net replaced by the same fixed fields in both
    packages, with the consistency mask on and off, against stitchax's
    jitted forward: H within 1e-8 (the two DLT solves differ by ~2e-10),
    the warps of img2 and img1 with their coverage within 2e-3 (read
    2.5e-4: those H ulps moving the samples), the occlusion mask and the
    overlap equal."""
    import jax.numpy as jnp
    import torch

    jh, th = random_homography_net
    fwd, bwd = _fixed_flows()
    calls = {"jax": 0, "torch": 0}

    def flow_fn(kind, to):
        def fn(a, b):
            f = fwd if calls[kind] % 2 == 0 else bwd
            calls[kind] += 1
            return [to(f)], None
        return fn

    i1, i2 = _textured_pair(np.random.default_rng(1))
    want, got = _run_both((jh, flow_fn("jax", jnp.asarray)),
                                (th, flow_fn("torch", torch.from_numpy)),
                                i1, i2, fb)
    assert calls == ({"jax": 2, "torch": 2} if fb else {"jax": 1, "torch": 1})
    keys = ["H", "output_H", "output_H_inv", "final_warp_output", "overlap"]
    if fb:
        keys.append("origin_occlusion_mask")
        assert 0.01 < want["origin_occlusion_mask"].mean() < 0.99
    assert sorted(got) == sorted(want)
    assert np.abs(got["H"] - want["H"]).max() <= 1e-8
    for k in ("output_H", "output_H_inv", "final_warp_output"):
        assert np.abs(got[k] - want[k]).max() <= 2e-3, k
    for k in keys[4:]:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_stub_evaluation_gives_stitchax_report(tmp_path):
    """validate_with_model with stub backbones (identity homography, zero
    flow) on tests/test_evaluate_cli.py's tiny split at 128^2, batch 2: the
    port's report is stitchax's (stitchax computes its metrics in its
    native library, so the floats are held to 1e-12)."""
    from evaluate import validate_with_model as j_validate
    from stitchax.align.adapter import AlignConfig as JAlignConfig
    from stitchax.data import PrefetchLoader as JLoader
    from stitchax.data import UDISDataset as JUDIS
    from stitchax_torch.align.adapter import AlignConfig
    from stitchax_torch.data.udis import PrefetchLoader, UDISDataset
    from stitchax_torch.evaluate import validate_with_model

    sys.path.insert(0, os.path.dirname(__file__))
    from test_evaluate_cli import _StubModels as JStubModels

    _write_stub_split(str(tmp_path), [2, 4, 8, 16, 32])
    want = j_validate({}, JLoader(JUDIS(str(tmp_path), phase="testing",
                                        size=(128, 128)), batch_size=2,
                                  shuffle=False, num_workers=1),
                      JStubModels(), JAlignConfig(use_fb_consistency_mask=False))
    got = validate_with_model({}, PrefetchLoader(
        UDISDataset(str(tmp_path), phase="testing", size=(128, 128)),
        batch_size=2, num_workers=1), _StubModels(),
        AlignConfig(use_fb_consistency_mask=False))
    assert got["num_pairs"] == want["num_pairs"] == 5
    for k in REPORT_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                   err_msg=k)


@pytest.fixture(scope="module")
def trained_homography():
    """The trained homography net (ckpt_r05) in both packages, fp32."""
    import jax
    import jax.numpy as jnp
    import torch

    from stitchax.convert import load_params_npz
    from stitchax.models.udis2 import UDIS2HomographyNet as JUDIS2
    from stitchax_torch import convert
    from stitchax_torch.models import UDIS2HomographyNet

    if not os.path.isfile(CKPT):
        pytest.skip(f"{CKPT} is not in this checkout")
    jm = JUDIS2()
    x = jnp.zeros((1, 512, 512, 3), jnp.float32)
    tpl = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, x))
    tpl = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tpl)
    params = load_params_npz(CKPT, {"homo": tpl})["homo"]
    tm = convert.load_jax_params(UDIS2HomographyNet(),
                                 convert.load_npz(CKPT, "homo")).eval()
    return (jax.jit(lambda a, b: jm.apply(params, a, b)),
            lambda a, b: tm(torch.from_numpy(a), torch.from_numpy(b))
            .detach().numpy())


def test_trained_homography_net_matches_stitchax(trained_homography):
    """The trained UDIS2 homography net at 512^2, fp32 on the CPU, on the
    inputs it gets: the demo pairs as the stitch resizes them and two
    synthetic pairs as the evaluation loads them. Corner offsets within
    1e-3 px (the two packages' fp32 convolutions differ by ~1e-5 px,
    ROADMAP C1)."""
    import jax.numpy as jnp

    from stitchax import ops
    from stitchax_torch.data.udis import UDISDataset
    from stitchax_torch.run.stitcher import load_image

    j_net, t_net = trained_homography
    a, b = [], []
    for name in ("demo1", "demo2"):
        pair = [load_image(os.path.join(REPO, "demo_data", name, f))
                for f in ("input1.jpg", "input2.jpg")]
        r = [np.asarray(ops.resize_image_b(jnp.asarray(p[None]), 512, 512))[0]
             for p in pair]
        a.append(r[0])
        b.append(r[1])
    ds = UDISDataset(SYNTH, phase="testing", size=SIZE)
    for i in (0, 1):
        a.append(ds[i]["image1"])
        b.append(ds[i]["image2"])
    a = np.stack(a) / 127.5 - 1.0
    b = np.stack(b) / 127.5 - 1.0
    a, b = a.astype(np.float32), b.astype(np.float32)
    want = np.asarray(j_net(jnp.asarray(a), jnp.asarray(b)))
    got = t_net(a, b)
    print("max |offset diff| px", np.abs(got - want).max(),
          "max |offset| px", np.abs(want).max())
    assert np.abs(got - want).max() <= 1e-3


# the port's evaluation of the committed split against stitchax's, fp32 on
# the CPU: the worst per-pair and report differences, the share of the
# saved pairs' coverage pixels that differ and the mean uint8 difference
# of their warps where both cover. The coverage counts only where it is
# exactly 1.0 (stitchax's `valid.astype(uint8)`, evaluate.py:99), so the
# ~1e-4 px by which the two FlowFormer++ differ moves the last ulp of the
# bilinear weights' sum, and with it 3.3% of the coverage pixels (read on
# the CPU: 0.0158 dB, 1.19e-3 SSIM, report 0.0058 dB / 8.1e-5, 3.26%,
# 2.8e-4 levels). Limits 3-10x of those readings
EVAL_TOL = {"psnr_abs_diff": 0.1, "ssim_abs_diff": 5e-3,
            "report_psnr_abs_diff": 0.05, "report_ssim_abs_diff": 5e-4,
            "valid_moved_share": 0.1,
            "warped_mean_level": 0.01}


def compare_with_reference(per_pair, report, warped, valid):
    """The port's evaluation against REF: {metric: worst value}, the
    limits in EVAL_TOL. `per_pair` is [(name, psnr, ssim)], `warped` /
    `valid` the uint8 arrays of the saved pairs by index."""
    with np.load(REF) as ref:
        names = [str(n) for n in ref["names"]]
        assert [p[0] for p in per_pair] == names
        got_p = np.array([p[1] for p in per_pair])
        got_s = np.array([p[2] for p in per_pair])
        res = {"psnr_abs_diff": float(np.abs(got_p - ref["psnr"]).max()),
               "ssim_abs_diff": float(np.abs(got_s - ref["ssim"]).max()),
               "report_psnr_abs_diff": max(
                   abs(report[k] - float(ref[f"report/{k}"]))
                   for k in REPORT_KEYS if "psnr" in k),
               "report_ssim_abs_diff": max(
                   abs(report[k] - float(ref[f"report/{k}"]))
                   for k in REPORT_KEYS if "ssim" in k)}
        assert report["num_pairs"] == int(ref["report/num_pairs"])
        moved, level = 0.0, 0.0
        for i in SAVED_PAIRS:
            v, w = ref[f"valid/{i}"], ref[f"warped/{i}"]
            both = (valid[i] == 1) & (v == 1)
            moved = max(moved, float(np.mean(valid[i] != v)))
            d = np.abs(warped[i].astype(int) - w.astype(int))
            level = max(level, float(d[both[..., 0]].mean()))
        res.update(valid_moved_share=moved, warped_mean_level=level)
    return res


@pytest.mark.slow
def test_trained_evaluation_matches_stitchax():
    """The port's evaluation of the committed split (trained weights,
    512^2, batch 12, fp32, CPU) against stitchax's committed one, within
    EVAL_TOL."""
    from stitchax_torch.align.adapter import AlignConfig
    from stitchax_torch.data.udis import PrefetchLoader, UDISDataset
    from stitchax_torch.evaluate import (load_models, make_eval_step,
                                         validate_with_model)

    if not os.path.isfile(CKPT):
        pytest.skip(f"{CKPT} is not in this checkout")
    models = load_models(CKPT, "cpu")
    align_cfg = AlignConfig()
    step = make_eval_step(models, align_cfg)
    outs = []

    def recording_step(a, b):
        w, v = step(a, b)
        outs.append((w.numpy(), v.numpy()))
        return w, v

    per_pair = []
    report = validate_with_model(
        {}, PrefetchLoader(UDISDataset(SYNTH, phase="testing", size=SIZE),
                           batch_size=BATCH, num_workers=4), models, align_cfg,
        eval_step=recording_step, per_pair=per_pair)
    warped = np.concatenate([np.clip(w, 0, 255).astype(np.uint8)
                             for w, _ in outs])
    valid = np.concatenate([v.astype(np.uint8) for _, v in outs])
    res = compare_with_reference(per_pair, report, warped, valid)
    print(res)
    for k, lim in EVAL_TOL.items():
        assert res[k] <= lim, (k, res[k], lim)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_eval.py --write")
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    print(write_reference())
