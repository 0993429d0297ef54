"""The port's stitch CLI (`python -m stitchax_torch.out`) against stitchax's
out.py: the resolved config and its dump, the per-pair files' uint8
images, and the CLI end to end on demo_data/demo1 against stitchax's
committed outputs (tests/torch_reference/demo_stitchax_fp32.npz,
tests/test_torch_parity.py)."""

import glob
import io
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CKPT = os.path.join(REPO, "results", "ckpt_r05_bf16.npz")
REF = os.path.join(REPO, "tests", "torch_reference", "demo_stitchax_fp32.npz")
INF_CONFIGS = sorted(os.path.basename(p)[:-3] for p in glob.glob(
    os.path.join(REPO, "inf_configs", "*.py"))
    if not p.endswith("__init__.py"))
FAST_FILES = ["H_warp", "ave_fusion", "flow_warp", "input1", "input2",
              "mask1", "mask2", "warp1", "warp2"]


def _stitchax_out_args(monkeypatch, argv):
    import out as jout
    monkeypatch.setattr(sys, "argv", ["out.py"] + argv)
    return jout.get_args()


@pytest.mark.parametrize("inf_cfg", INF_CONFIGS)
def test_config_dump_equals_stitchax(monkeypatch, inf_cfg):
    """The CLI's resolved config, dumped as config.txt, is stitchax's for
    the same flags (its two TPU flags recorded at their defaults), and
    the evaluation config too."""
    from stitchax.run.config import build_eval_config as j_eval_config
    from stitchax.run.config import build_out_config as j_out_config
    from stitchax_torch import out
    from stitchax_torch.run.config import build_eval_config, build_out_config

    argv = ["--inf_cfg", inf_cfg, "--ckpt_path", "w.npz", "--result_dir", "r",
            "--transref_ckpt", "t.msgpack", "--num_shards", "2"]
    want = j_out_config(_stitchax_out_args(monkeypatch, argv))
    got = build_out_config(out.config_args(out.get_args(
        argv + ["--device", "cpu", "--fp32"])))
    assert got.dump() == want.dump()
    assert got.dump().encode() == want.dump().encode()
    args = SimpleNamespace(ckpt_path="w.npz", model_config_name="last_config",
                           data_dir="d", batch_size=12, gpu="0",
                           max_pairs=-1, image_size=None)
    assert build_eval_config(args).dump() == j_eval_config(args).dump()


def test_diffusion_config_is_refused(tmp_path, monkeypatch):
    """Without an SD checkpoint (STITCHAX_SD_CKPT=none, or a path that does
    not exist) the diffusion configuration refuses to start, before it
    writes anything: stitchax warns and fills by push-pull instead."""
    from stitchax_torch import out

    if not os.path.isfile(CKPT):
        pytest.skip(f"{CKPT} is not in this checkout")
    argv = ["--inf_cfg", "inpaint_all_area_g12_diffusion", "--device", "cpu",
            "--ckpt_path", CKPT, "--result_dir", str(tmp_path)]
    monkeypatch.setenv("STITCHAX_SD_CKPT", "none")
    with pytest.raises(SystemExit, match="SD checkpoint"):
        out.main(argv)
    monkeypatch.delenv("STITCHAX_SD_CKPT")
    with pytest.raises(SystemExit, match="does not exist"):
        out.main(argv + ["--sd_ckpt", str(tmp_path / "missing.pt")])
    assert not any(tmp_path.iterdir())


def _canvas_dict(rng, h=40, w=56, composition=True):
    """A stitch's outputs as the port returns them, with values past
    [0, 255] / [0, 1], and learned masks on exact k/255 values (where a
    float32 k/255*255 truncates to k - 1)."""
    img = lambda: rng.uniform(-30, 285, (h, w, 3)).astype(np.float32)
    soft = lambda: np.clip(rng.uniform(-0.2, 1.2, (h, w, 1)), -0.1,
                           1.1).astype(np.float32)
    out = {"H_warp": img(), "final_warp": img(), "output1": img(),
           "output2": img(), "new_blend_image": img(), "mask1": soft(),
           "mask2": soft()}
    if composition:
        k = rng.integers(0, 256, (h, w, 1)).astype(np.float32)
        out.update(composition=img(), learned_mask1=k / np.float32(255),
                   learned_mask2=soft())
    return out


@pytest.mark.parametrize("composition", [True, False])
def test_writer_writes_stitchax_files(tmp_path, composition):
    """One set of outputs through stitchax's writer (its exact-RGB uint8
    pack and unpack, then _save_outputs with Pillow) and the port's
    (`save_outputs`, its own codec): the same files, byte for byte."""
    import jax.numpy as jnp

    from stitchax.run.pack import pack_canvas_uint8, unpack_canvas_uint8
    from stitchax.run.stitcher import Stitcher as JStitcher
    from stitchax_torch.run.stitcher import output_images, save_outputs

    rng = np.random.default_rng(3)
    out = _canvas_dict(rng, composition=composition)
    img1 = rng.uniform(0, 255, (30, 44, 3)).astype(np.float32).round()
    img2 = rng.uniform(0, 255, (30, 44, 3)).astype(np.float32).round()
    names = {"H_warp": "H_warp", "final_warp": "flow_warp",
             "output1": "warp1", "output2": "warp2",
             "new_blend_image": "ave_fusion", "composition": "composition"}
    img_keys = [k for k in names if k in out]
    mask_keys = [k for k in ("mask1", "mask2", "learned_mask1",
                             "learned_mask2") if k in out]
    packed = pack_canvas_uint8([jnp.asarray(out[k]) for k in img_keys],
                               [jnp.asarray(out[k]) for k in mask_keys],
                               "rgb")
    h, w = out["mask1"].shape[:2]
    imgs, masks = unpack_canvas_uint8(np.asarray(packed), len(img_keys),
                                      len(mask_keys), "rgb", h, w)
    theirs = {names[k]: v for k, v in zip(img_keys, imgs)}
    theirs.update(zip(mask_keys, masks))
    JStitcher._save_outputs(None, theirs, img1, img2, str(tmp_path / "j"))
    save_outputs(out, img1, img2, str(tmp_path / "t"))

    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "t"))
    assert len(files) == (12 if composition else 9)
    u8 = output_images(out, img1, img2)
    for f in files:
        a = (tmp_path / "j" / f).read_bytes()
        assert a == (tmp_path / "t" / f).read_bytes(), f
        # and each file holds the uint8 image of the value path
        j = np.asarray(Image.open(tmp_path / "j" / f))
        assert j.shape == u8[f[:-4]].shape, f


@pytest.fixture(scope="module")
def demo1_root(tmp_path_factory):
    """A data root holding demo1 only, and its pair list."""
    root = tmp_path_factory.mktemp("data")
    os.symlink(os.path.join(REPO, "demo_data", "demo1"), root / "demo1")
    (root / "one.txt").write_text("demo1\n")
    return root


def test_cli_records_failed_pairs(tmp_path, demo1_root):
    """A pair that cannot be read is listed in errors.json and the exit
    code is 1; the sweep still goes over the other pairs."""
    from stitchax_torch import out

    if not os.path.isfile(CKPT):
        pytest.skip(f"{CKPT} is not in this checkout")
    (demo1_root / "bad.txt").write_text("missing\nalso_missing\n")
    rc = out.main(["--device", "cpu", "--inf_cfg", "fast_cv_g8",
                   "--data_root_path", str(demo1_root), "--txt_file",
                   "bad.txt", "--ckpt_path", CKPT, "--result_dir",
                   str(tmp_path)])
    assert rc == 1
    errors = json.load(open(tmp_path / "fast_cv_g8_g8x8_stitchax" /
                            "errors.json"))
    assert [e["pair"] for e in errors] == ["missing", "also_missing"]


def test_cli_stitches_demo1_as_stitchax(tmp_path, monkeypatch, demo1_root):
    """The CLI's sweep (`out.setup` and the stitcher's
    `stitch_and_save_many`, fp32 on the CPU, fast_cv_g8) on demo1: out.py's
    files under out.py's directory name, config.txt byte-equal to
    stitchax's for the same flags, each file Pillow's JPEG of the writer's
    uint8 image, mask1 equal to stitchax's committed one and warp2 /
    ave_fusion within one level of it (tests/test_torch_parity.py)."""
    from stitchax.run.config import build_out_config as j_out_config
    from stitchax_torch import out
    from stitchax_torch.run.stitcher import output_images

    if not os.path.isfile(CKPT):
        pytest.skip(f"{CKPT} is not in this checkout")
    flags = ["--inf_cfg", "fast_cv_g8", "--data_root_path", str(demo1_root),
             "--txt_file", "one.txt", "--ckpt_path", CKPT, "--result_dir",
             str(tmp_path)]
    save_root, logger, stitcher, jobs = out.setup(
        out.get_args(flags + ["--device", "cpu", "--fp32"]))
    results = list(stitcher.stitch_and_save_many(jobs))
    logger.close()
    assert save_root == str(tmp_path / "fast_cv_g8_g8x8_stitchax")
    assert [(os.path.basename(r), e) for r, _, e, _ in results] == [
        ("demo1", None)]
    assert sorted(os.listdir(save_root)) == ["config.txt", "demo1",
                                             "out_metrics.jsonl"]
    config = open(os.path.join(save_root, "config.txt")).read()
    assert config == j_out_config(_stitchax_out_args(monkeypatch,
                                                     flags)).dump()

    pair_dir = os.path.join(save_root, "demo1")
    assert sorted(f[:-4] for f in os.listdir(pair_dir)) == FAST_FILES
    res = results[0][1]
    img1, img2 = stitcher.load_pair(jobs[0][0])
    u8 = output_images(res, img1, img2)
    for name, a in u8.items():
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, format="JPEG")
        assert open(os.path.join(pair_dir, name + ".jpg"), "rb").read() == \
            buf.getvalue(), name

    with np.load(REF) as d:
        ref = {k.split("/", 1)[1]: d[k] for k in d.files
               if k.startswith("demo1/")}
    th, tw = ref["warp2"].shape[:2]
    assert tuple(res["true_hw"]) == (th, tw)
    assert int((res["mask1"] != ref["mask1"][:th, :tw]).sum()) == 0
    for name in ("warp2", "ave_fusion"):
        d = np.abs(u8[name].astype(int) - ref[name].astype(int))
        assert d.max() <= 1, (name, int(d.max()), int((d > 1).sum()))
