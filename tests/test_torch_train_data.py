"""The port's training data path and logger against stitchax's, on the CPU:
UDISDataset's training items, PrefetchLoader's per-epoch shuffle (the same
pairs in the same order for the same seed), fetch_dataloader, the Logger's
metrics records and the flow visualization."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(REPO, "tests", "torch_reference", "udis_synth")


@pytest.fixture
def train_dir(tmp_path):
    """A data dir whose training split is the committed 12-pair split."""
    os.symlink(os.path.join(SYNTH, "testing"), tmp_path / "training")
    return str(tmp_path)


def _order(loader, epochs):
    return [[n for b in loader for n in b["name"]] for _ in range(epochs)]


@pytest.mark.parametrize("seed", [0, 1])
def test_loader_order_equals_stitchax(train_dir, seed):
    """Two epochs, shuffled with default_rng(seed + epoch): the same names
    in the same batches as stitchax's loader (batch 5, last partial batch
    dropped)."""
    from stitchax.data.udis import PrefetchLoader as JLoader
    from stitchax.data.udis import UDISDataset as JUDIS
    from stitchax_torch.data.udis import PrefetchLoader, UDISDataset

    kw = dict(batch_size=5, shuffle=True, seed=seed, drop_last=True)
    ours = PrefetchLoader(UDISDataset(train_dir, "training", size=(64, 64)),
                          num_workers=2, **kw)
    theirs = JLoader(JUDIS(train_dir, "training", size=(64, 64)),
                     num_workers=2, **kw)
    got, want = _order(ours, 2), _order(theirs, 2)
    assert got == want
    assert len(ours) == len(theirs) == 2 and len(got[0]) == 10
    assert got[0] != got[1]


def test_training_items_equal_stitchax(train_dir):
    """A training item: the same pixels (port's JPEG decoder + Pillow-exact
    resize), the zero flow and the ones validity."""
    from stitchax.data.udis import UDISDataset as JUDIS
    from stitchax_torch.data.udis import UDISDataset

    ours = UDISDataset(train_dir, "training", size=(96, 128))
    theirs = JUDIS(train_dir, "training", size=(96, 128))
    assert not ours.is_test and len(ours) == len(theirs) == 12
    for i in (0, 7):
        a, b = ours[i], theirs[i]
        assert sorted(a) == sorted(b) == ["flow", "image1", "image2", "name",
                                          "valid"]
        for k in ("image1", "image2", "flow", "valid"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        assert a["name"] == b["name"]


def test_dataset_options(train_dir):
    """clip_num_data truncates the pair list; is_test=True drops the
    training keys; return_depth without a depth2 split raises."""
    from stitchax_torch.data.udis import UDISDataset

    assert len(UDISDataset(train_dir, "training", clip_num_data=3)) == 3
    item = UDISDataset(train_dir, "training", is_test=True,
                       size=(32, 32))[0]
    assert sorted(item) == ["image1", "image2", "name"]
    with pytest.raises(FileNotFoundError):
        UDISDataset(train_dir, "training", return_depth=True)


def test_depth_items_equal_stitchax(tmp_path):
    from stitchax.data.udis import UDISDataset as JUDIS
    from stitchax_torch.data.udis import UDISDataset

    split = tmp_path / "training"
    split.mkdir()
    for d in ("input1", "input2"):
        os.symlink(os.path.join(SYNTH, "testing", d), split / d)
    os.symlink(os.path.join(SYNTH, "testing", "input1"), split / "depth2")
    a = UDISDataset(str(tmp_path), "training", size=(32, 48),
                    return_depth=True)[2]
    b = JUDIS(str(tmp_path), "training", size=(32, 48),
              return_depth=True)[2]
    assert a["depth2"].shape == (32, 48, 1)
    assert np.array_equal(a["depth2"], b["depth2"])


class _Names:
    """A dataset of names only (no images to read)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"name": f"{i:03d}"}


def test_skip_continues_the_order():
    """`skip(n)` on a fresh loader gives what follows the first n batches
    of a loader iterated from the start, across epoch boundaries."""
    from stitchax_torch.data.udis import PrefetchLoader

    def loader():
        return PrefetchLoader(_Names(12), batch_size=5, shuffle=True,
                              seed=3, drop_last=True, num_workers=2)

    full = loader()
    names = [n for _ in range(4) for b in full for n in b["name"]]
    for n in (1, 2, 3, 5):
        part = loader()
        part.skip(n)
        got = [x for _ in range(2) for b in part for x in b["name"]]
        assert got == names[5 * n:5 * n + len(got)], n


def test_fetch_dataloader_equals_stitchax(train_dir):
    from stitchax.data.udis import fetch_dataloader as jfetch
    from stitchax_torch.data.udis import fetch_dataloader

    cfg = {"udis_dataset": {"data_dir": train_dir, "clip_num_data": 7},
           "image_size": [64, 64], "batch_size": 2}
    ours, theirs = fetch_dataloader(cfg), jfetch(cfg)
    assert (ours.shuffle, ours.drop_last, ours.batch_size, ours.seed,
            len(ours)) == (theirs.shuffle, theirs.drop_last,
                           theirs.batch_size, theirs.seed, len(theirs))
    assert _order(ours, 2) == _order(theirs, 2)


def test_logger_records_equal_stitchax(tmp_path):
    """push / write_dict write stitchax's records (the wall-clock field
    aside) and feed the sink; push prints the window means every
    sum_freq steps."""
    from stitchax.utils.logger import Logger as JLogger
    from stitchax_torch.utils.logger import Logger

    seen = []
    ours = Logger(str(tmp_path / "a"), name="train", sum_freq=2, window=3,
                  sink=seen.append)
    theirs = JLogger(str(tmp_path / "b"), name="train", sum_freq=2,
                     window=3)
    for lg in (ours, theirs):
        for i in range(5):
            lg.push({"total": np.float32(i * 0.5), "grad_norm": 3 - i})
        lg.write_dict({"psnr": 21.5}, step=9)
        lg.write_dict({"ssim": 0.75})
        lg.close()
    recs = [[json.loads(x) for x in (tmp_path / d / "train_metrics.jsonl")
             .read_text().splitlines()] for d in ("a", "b")]
    for r in recs[0] + recs[1]:
        r.pop("t", None)
    assert recs[0] == recs[1] and len(recs[0]) == 7
    assert len(seen) == 7 and seen[-1] == {"step": 5, "ssim": 0.75}


def test_flow_to_image_equals_stitchax(rng):
    from stitchax.data.flow_viz import flow_to_image as jviz
    from stitchax_torch.data.flow_viz import flow_to_image

    flow = rng.normal(0, 5, (40, 56, 2)).astype(np.float32)
    assert np.array_equal(flow_to_image(flow), jviz(flow))
    assert np.array_equal(flow_to_image(flow, clip_flow=3.0),
                          jviz(flow, clip_flow=3.0))


def test_train_dashboard_writes_a_figure(tmp_path, rng):
    from stitchax_torch.utils.logger import save_train_dashboard

    img = rng.uniform(0, 255, (32, 40, 3)).astype(np.float32)
    flow = rng.normal(0, 2, (32, 40, 2)).astype(np.float32)
    p = save_train_dashboard(str(tmp_path / "d.png"), img, img[::-1], flow,
                             valid=np.ones((32, 40)), flow_gt=flow * 0.5)
    with open(p, "rb") as fh:
        assert fh.read(8) == b"\x89PNG\r\n\x1a\n"


def test_train_config_takes_the_model_configs_batch():
    """stitchax's train.py leaves cfg.batch_size None without --batch_size
    (its config assembly copies the unset flag); the port's trainer takes
    configs/last_config.py's 1, and the flag where it is given."""
    from stitchax.run.config import build_eval_config as jbuild
    from stitchax_torch.train.__main__ import build_config, get_args

    args = get_args([])
    assert jbuild(SimpleNamespace(**vars(args))).batch_size is None
    cfg = build_config(args)
    assert cfg.batch_size == 1 and cfg.image_size == [512, 512]
    assert cfg.udis_dataset.data_dir == "./UDIS-D/"
    cfg = build_config(get_args(["--batch_size", "4", "--image_size", "256",
                                 "--data_dir", "/d"]))
    assert (cfg.batch_size, cfg.image_size, cfg.udis_dataset.data_dir) == (
        4, [256, 256], "/d")


@pytest.mark.parametrize("name", ["UDISDataset", "PrefetchLoader"])
def test_data_api_has_stitchax_signatures(name):
    """The port's dataset and loader take stitchax's parameters: the same
    names, in the same order, with the same defaults (UDISDataset's phase
    "training", then is_test, then size; PrefetchLoader's shuffle before
    num_workers, and prefetch)."""
    import inspect

    from stitchax.data import udis as j
    from stitchax_torch.data import udis as t

    params = lambda cls: [(p.name, p.default) for p in inspect.signature(
        cls.__init__).parameters.values()]
    assert params(getattr(t, name)) == params(getattr(j, name))
