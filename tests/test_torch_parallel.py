"""The port's data parallelism (stitchax_torch.parallel) on the CPU: two
gloo ranks, spawned once for the module with a file:// rendezvous, against
one process on the global batch and against stitchax's two-device mesh.

The ranks run, each on its block of the global batch: the stub-backbone
alignment step (two pairs whose mask counts differ, so that averaging the
ranks' own photometric terms would miss the global one), a TransRef step
with a small stand-in inpainter and feature extractor, the evaluation
loop over six committed synthetic pairs in batches of three (padded to
four), and the stitch path's per-pair step. Each rank saves what it got;
the tests compare rank 0's (and the replicas' agreement) here. Tolerances
are stated where they are used.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(REPO, "tests", "torch_reference", "udis_synth")
WORLD = 2
HOMO_W = 20.0          # the stub homography's gain: offsets of ~10 px
S_ALIGN, S_EVAL, S_STITCH = 64, 128, 64


# ------------------------------- the stubs -----------------------------------

class StubHomo(torch.nn.Module):
    """tests/test_train_step.py's differentiable stub homography, its gain
    raised so that the pairs' warps (and valid areas) differ."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((1, 8), HOMO_W))

    def forward(self, a, b):
        return self.w * (a.mean((1, 2, 3)) - b.mean((1, 2, 3)))[:, None]


class StubFlow(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.s = torch.nn.Parameter(torch.tensor(0.01))

    def forward(self, a, b, upsample_all=None):
        f = (a[..., :2] - b[..., :2]) * self.s
        return [f, f * 0.5], f[:, ::8, ::8]


class SmallInpainter(torch.nn.Module):
    """A stand-in for TransRefBase: the same call."""

    def __init__(self):
        from stitchax_torch.models.layers import Conv

        super().__init__()
        self.down = Conv(9, 8, 3, stride=2, padding=1)
        self.up = torch.nn.Linear(8, 12)

    def forward(self, detail, mask, reference):
        x = torch.cat([detail, (1.0 - mask).expand_as(detail), reference], -1)
        y = self.up(torch.relu(self.down(x)))
        B, h, w, _ = y.shape
        y = y.reshape(B, h, w, 2, 2, 3).permute(0, 1, 3, 2, 4, 5)
        return torch.tanh(y.reshape(B, 2 * h, 2 * w, 3))


def small_features(x):
    """Two fixed random conv maps: the loss's feature extractor."""
    g = torch.Generator().manual_seed(5)
    k1 = torch.randn(8, 3, 3, 3, generator=g) / 5.0
    k2 = torch.randn(8, 8, 3, 3, generator=g) / 8.0
    h = torch.relu(torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), k1,
                                              padding=1))
    h2 = torch.relu(torch.nn.functional.conv2d(h, k2, stride=2, padding=1))
    return [h.permute(0, 2, 3, 1), h2.permute(0, 2, 3, 1)]


def per_pair_homo(a, b):
    """Per-pair offsets from the image content (every pair lands in another
    canvas box: a step that coupled pairs would show it)."""
    from stub_backbones import OFFSETS
    scale = 0.5 + 1.5 * (a[:, 0, 0, 0][:, None] + 1.0)   # a in [-1, 1]
    return torch.from_numpy(OFFSETS)[None] * scale


def stub_flow(a, b):
    from stub_backbones import W_FLOW
    from stitchax_torch.ops.morphology import avg_pool_same
    d = avg_pool_same((a - b) / 255.0, 31)
    return [torch.tanh(d @ torch.from_numpy(W_FLOW)) * 5.0], None


# ------------------------------ the workloads --------------------------------

def align_batch():
    """Two pairs: one whose images share their mean (no warp), one whose
    img2 is darker (a warp of ~10 px), so their valid areas differ."""
    rng = np.random.default_rng(3)
    i1 = rng.uniform(0, 255, (2, S_ALIGN, S_ALIGN, 3)).astype(np.float32)
    i2 = rng.uniform(0, 255, (2, S_ALIGN, S_ALIGN, 3)).astype(np.float32)
    i2[1] = i2[1] * 0.4
    return i1, i2


def align_step():
    from stitchax_torch.align.adapter import AlignConfig
    from stitchax_torch.train import (LossConfig, OptimConfig,
                                      create_train_state, make_train_step)

    homo, flow = StubHomo(), StubFlow()
    state, tx = create_train_state({"homo": homo, "flow": flow},
                                   OptimConfig(num_steps=10,
                                               canonical_lr=1e-3))
    return state, make_train_step(homo, flow, tx, AlignConfig(), LossConfig())


def transref_batch():
    from stitchax_torch.train.transref_trainer import (draw_rect_boxes,
                                                       rect_masks)
    rng = np.random.default_rng(4)
    gt = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ref = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    boxes = draw_rect_boxes(torch.Generator().manual_seed(6), 2, 32)
    return torch.from_numpy(gt), torch.from_numpy(ref), rect_masks(*boxes,
                                                                   32)


def transref_step():
    from stitchax_torch.models.vgg import feature_total_loss
    from stitchax_torch.train.transref_trainer import (
        TransRefLossConfig, create_train_state, make_transref_train_step)

    torch.manual_seed(0)
    model = SmallInpainter()
    state, tx = create_train_state(model, 1e-3)
    return state, make_transref_train_step(model, small_features, tx,
                                           TransRefLossConfig(),
                                           total_loss=feature_total_loss)


def eval_models():
    from types import SimpleNamespace
    return SimpleNamespace(homo_model=StubHomo(), flow_model=StubFlow(),
                           dtype=torch.float32, device=torch.device("cpu"))


def evaluate(world=None):
    """(report, per-pair (name, psnr, ssim)) over the first six committed
    pairs at 128^2 in batches of three."""
    from stitchax_torch.align.adapter import AlignConfig
    from stitchax_torch.data.udis import PrefetchLoader, UDISDataset
    from stitchax_torch.evaluate import validate_with_model

    ds = UDISDataset(SYNTH, phase="testing", size=(S_EVAL, S_EVAL))
    ds.pairs = ds.pairs[:6]
    per_pair = []
    report = validate_with_model(None, PrefetchLoader(ds, batch_size=3),
                                 eval_models(), AlignConfig(),
                                 per_pair=per_pair, world=world)
    return report, per_pair


def stitch_inputs():
    rng = np.random.default_rng(5)
    return [torch.from_numpy(rng.uniform(0, 255, (4, S_STITCH, S_STITCH, 3))
                             .astype(np.float32)) for _ in range(2)]


def stitch_step(i1, i2):
    from stitchax_torch.align.adapter import AlignConfig, stitch_model_step
    return stitch_model_step(per_pair_homo, stub_flow, i1, i2,
                             AlignConfig(model_size=S_STITCH,
                                         use_fb_consistency_mask=True))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


# --------------------------------- the ranks ---------------------------------

def _rank_main(rank, init_file, out_dir):
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stitchax_torch.parallel import (all_reduce_mean_, make_mesh,
                                         make_parallel_stitch_step,
                                         make_parallel_train_step,
                                         shard_batch)

    world = make_mesh(backend="gloo", device="cpu",
                      init_method=f"file://{init_file}", rank=rank,
                      world_size=WORLD)
    out = {}
    # the alignment step: the all-reduced gradient, then two steps
    state, step = align_step()
    block = shard_batch(tuple(torch.from_numpy(x) for x in align_batch()),
                        world)
    metrics, grads = step.loss_and_grads(state, *block, world=world)
    all_reduce_mean_(list(grads.values()), world)
    out["align_grads"] = _np(grads)
    pstep = make_parallel_train_step(step, world)
    out["align_metrics"] = []
    for _ in range(2):
        state, m = pstep(state, *block)
        out["align_metrics"].append({k: float(v) for k, v in m.items()})
    out["align_params"] = _np(state.params)
    # the TransRef step
    state, step = transref_step()
    pstep = make_parallel_train_step(step, world)
    state, m = pstep(state, *shard_batch(transref_batch(), world))
    out["transref_metrics"] = {k: float(v) for k, v in m.items()}
    out["transref_params"] = _np(state.params)
    # the evaluation and the stitch step
    out["eval"] = evaluate(world)
    out["stitch"] = _np(make_parallel_stitch_step(stitch_step, world)(
        *stitch_inputs()))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results (rank 0's first)."""
    import torch.multiprocessing as mp

    d = tmp_path_factory.mktemp("ranks")
    mp.spawn(_rank_main, args=(str(d / "init"), str(d)), nprocs=WORLD,
             join=True)
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --------------------------------- the tests ---------------------------------

def _grads_close(got, want, tol):
    for k in want:
        g, w = got[k], want[k].detach().numpy()
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30), k


def test_two_rank_alignment_step_equals_one_process(ranks):
    """The all-reduced gradient within 1e-5 of max |g| (the card's
    tolerance), the metrics 3e-5 relative, the tensors after two updates
    1e-6 relative, on both replicas (readings: the gradient 6.0e-8 of max
    |g|, the metrics 3.2e-6 at worst (the second step's grad_norm), the
    tensors equal)."""
    state, step = align_step()
    i1, i2 = (torch.from_numpy(x) for x in align_batch())
    _, grads = step.loss_and_grads(state, i1, i2)
    metrics = []
    for _ in range(2):
        state, m = step(state, i1, i2)
        metrics.append({k: float(v) for k, v in m.items()})
    for r in ranks:
        _grads_close(r["align_grads"], grads, 1e-5)
        for got, want in zip(r["align_metrics"], metrics):
            assert sorted(got) == sorted(want)
            for k in want:
                assert abs(got[k] - want[k]) <= 3e-5 * abs(want[k]), k
        for k, p in state.params.items():
            np.testing.assert_allclose(r["align_params"][k],
                                       p.detach().numpy(), rtol=1e-6)


def test_naive_gradient_averaging_would_miss(ranks):
    """The test's pairs tell the global normalizer from the naive one: their
    mask counts differ by more than 20%, and the average of each pair's own
    gradient misses the batch's by more than the tolerance above."""
    from stitchax_torch.align.adapter import AlignConfig
    from stitchax_torch.train.trainer import align_train_forward

    state, step = align_step()
    i1, i2 = (torch.from_numpy(x) for x in align_batch())
    with torch.no_grad():
        homo, flow = StubHomo(), StubFlow()
        fwd = align_train_forward(homo, flow, i1, i2, AlignConfig())
    cover = fwd["output_H"][..., 3:6].mean(-1).sum((1, 2))
    assert abs(cover[0] - cover[1]) >= 0.2 * max(cover), cover
    _, batch = step.loss_and_grads(state, i1, i2)
    naive = [step.loss_and_grads(state, i1[j:j + 1], i2[j:j + 1])[1]
             for j in range(2)]
    missed = max(
        float((0.5 * (naive[0][k] + naive[1][k]) - batch[k]).abs().max()
              / batch[k].abs().max()) for k in batch)
    assert missed > 1e-3, missed
    _grads_close(ranks[0]["align_grads"], batch, 1e-5)


def test_two_rank_alignment_step_equals_stitchax_mesh_step(ranks):
    """stitchax's make_parallel_train_step over make_mesh(2) (its jitted
    step, the batch sharded over two virtual CPU devices) against the two
    ranks: metrics within 1e-4 relative, the tensors within 1e-6 (the
    one-device stub step's tolerances in test_torch_train.py)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from stitchax.align.adapter import AlignConfig as JAlign
    from stitchax.parallel import make_mesh, make_parallel_train_step
    from stitchax.parallel import shard_batch as jshard
    from stitchax.train import LossConfig as JLoss
    from stitchax.train import OptimConfig as JOpt
    from stitchax.train import create_train_state as jcreate
    from stitchax.train import make_train_step as jmake

    def homo_apply(p, a, b):
        return p["w"] * (a.mean((1, 2, 3)) - b.mean((1, 2, 3)))[:, None]

    def flow_apply(p, a, b):
        f = (a[..., :2] - b[..., :2]) * p["s"]
        return [f, f * 0.5], f[:, ::8, ::8]

    params = {"homo": {"w": jnp.full((1, 8), HOMO_W)},
              "flow": {"s": jnp.asarray(0.01)}}
    jstate, jtx = jcreate(params, JOpt(num_steps=10, canonical_lr=1e-3))
    mesh = make_mesh(2)
    pstep = make_parallel_train_step(
        jmake(homo_apply, flow_apply, jtx, JAlign(), JLoss()), mesh)
    jstate = jax.device_put(jstate, NamedSharding(mesh, PartitionSpec()))
    i1, i2 = jshard(tuple(jnp.asarray(x) for x in align_batch()), mesh)
    for i in range(2):
        jstate, jm = pstep(jstate, i1, i2)
        got = ranks[0]["align_metrics"][i]
        for k, v in jm.items():
            assert abs(got[k] - float(v)) <= 1e-4 * abs(float(v)), k
    np.testing.assert_allclose(ranks[0]["align_params"]["homo.w"],
                               np.asarray(jstate.params["homo"]["w"]),
                               rtol=1e-6)
    np.testing.assert_allclose(ranks[0]["align_params"]["flow.s"],
                               np.asarray(jstate.params["flow"]["s"]),
                               rtol=1e-6)


def test_two_rank_transref_step_equals_one_process(ranks):
    """Losses 1e-5 relative, the tensors after Adam 1e-5 relative to each
    tensor's range (readings: 1.0e-7 and 6.6e-8)."""
    state, step = transref_step()
    state, metrics = step(state, *transref_batch())
    for r in ranks:
        for k, v in metrics.items():
            assert abs(r["transref_metrics"][k] - float(v)) <= 1e-5 * abs(
                float(v)), k
        for k, p in state.params.items():
            want = p.detach().numpy()
            err = np.abs(r["transref_params"][k] - want).max()
            assert err <= 1e-5 * np.abs(want).max(), k


def test_two_rank_evaluation_gives_one_process_report(ranks):
    """The same pairs in the same order with bit-equal PSNR / SSIM, the
    same report; rank 1 returns no report."""
    report, per_pair = evaluate()
    got_report, got_pairs = ranks[0]["eval"]
    assert got_pairs == per_pair
    assert got_report == report
    assert ranks[1]["eval"][0] is None


def test_two_rank_stitch_step_equals_one_process(ranks):
    """make_parallel_stitch_step's per-pair outputs, gathered in the
    global order, equal one process's (the step is per-pair
    independent; CPU: bit-equal)."""
    with torch.no_grad():
        want = _np(stitch_step(*stitch_inputs()))
    got = ranks[0]["stitch"]
    assert sorted(got) == sorted(want)
    boxes = want["canvas_box"]
    assert len({tuple(b) for b in boxes}) > 1
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_shard_batch_takes_contiguous_blocks():
    from stitchax_torch.parallel import World, pad_to_world, shard_batch

    x = np.arange(12).reshape(6, 2)
    names = [f"p{i}" for i in range(6)]
    for r in range(3):
        got = shard_batch({"x": x, "n": names}, World(rank=r, size=3))
        np.testing.assert_array_equal(got["x"], x[2 * r:2 * r + 2])
        assert got["n"] == names[2 * r:2 * r + 2]
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(x, World(rank=0, size=4))
    (px,), n = pad_to_world([torch.from_numpy(x)], World(rank=0, size=4))
    assert n == 6 and px.shape[0] == 8
    assert (px[6:] == px[5]).all()


def test_a_rank_refuses_a_missing_card(monkeypatch):
    """A rank whose card does not exist stops; it never runs on the CPU."""
    from stitchax_torch.parallel import cli_world

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="does not exist"):
        cli_world(f"cuda:{n}", None)


# ------------------------------ the CLI, slow --------------------------------

def _train_cli_rank(rank, port, argv):
    """A rank of `python -m stitchax_torch.train` as torch.distributed.run
    starts it (its environment), with configs/last_config.py cut to
    FlowFormer++ depths 1 / 2."""
    import copy
    import types

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from configs.last_config import config_dict

    small = copy.deepcopy(config_dict)
    small["percostformer3"].update(encoder_depth=1, decoder_depth=2)
    sys.modules["configs.train_test_small"] = types.SimpleNamespace(
        config_dict=small)
    from stitchax_torch.train.__main__ import main

    if main(argv) != 0:
        raise RuntimeError(f"rank {rank}: the CLI failed")
    torch.distributed.destroy_process_group()


@pytest.mark.slow
def test_train_cli_on_two_ranks_equals_one_process(tmp_path, monkeypatch):
    """`python -m stitchax_torch.train` on two gloo ranks (batch 2, one pair
    a rank) for two steps against one process at batch 2: the same
    metrics, checkpoints and final npz, written by rank 0 alone; then two
    ranks resumed from step 1 equal the run that did not stop (~3 min)."""
    import copy
    import json
    import socket
    import types

    import torch.multiprocessing as mp

    from configs.last_config import config_dict
    from stitchax_torch import convert
    from stitchax_torch.train.__main__ import main

    data = tmp_path / "data"
    data.mkdir()
    os.symlink(os.path.join(SYNTH, "testing"), data / "training")
    base = ["--device", "cpu", "--image_size", "128", "--batch_size", "2",
            "--model_config_name", "train_test_small", "--data_dir",
            str(data), "--num_steps", "2", "--save_every", "1",
            "--log_every", "1", "--panel_every", "0", "--seed", "3"]

    def free_port():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    def ranks(ck, *extra):
        mp.spawn(_train_cli_rank, args=(free_port(), base + [
            "--ckpt_dir", str(ck), *extra]), nprocs=WORLD, join=True)

    small = copy.deepcopy(config_dict)
    small["percostformer3"].update(encoder_depth=1, decoder_depth=2)
    monkeypatch.setitem(sys.modules, "configs.train_test_small",
                        types.SimpleNamespace(config_dict=small))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert main(base + ["--ckpt_dir", str(tmp_path / "one")]) == 0
    ranks(tmp_path / "two")
    ranks(tmp_path / "resumed", "--resume",
          str(tmp_path / "two" / "step_00000001.pt"))

    def log(ck):
        with open(ck / "train_metrics.jsonl") as f:
            return {r["step"]: r for r in map(json.loads, f)}

    one, two = log(tmp_path / "one"), log(tmp_path / "two")
    assert sorted(one) == sorted(two) == [1, 2]
    for s in one:
        for k in ("total", "photometric", "rigid", "border", "grad_norm"):
            assert abs(two[s][k] - one[s][k]) <= 1e-4 * abs(one[s][k]), k
    assert log(tmp_path / "resumed")[2]["total"] == pytest.approx(
        two[2]["total"], rel=1e-6)
    final = {k: convert.load_npz(str(tmp_path / d / "final_ckpt.npz"))
             for d, k in (("one", 1), ("two", 2), ("resumed", 3))}
    flat = {k: dict(convert._flatten(t)) for k, t in final.items()}
    # 1e-5 of each tensor's range, floored at 1e-3 (the zero-initialised
    # biases are a few learning rates after two steps), except where AdamW
    # divides a gradient near eps: there an element may move by up to two
    # learning rates a step (its sign flips), in under 1e-4 of the elements
    lr = small["trainer"]["canonical_lr"] * 2      # the peak, batch 2
    for k in (2, 3):
        off = n = 0
        for path, want in flat[1].items():
            d = np.abs(flat[k][path] - want)
            assert d.max() <= 2 * 2 * lr, path
            off += int((d > 1e-5 * max(np.abs(want).max(), 1e-3)).sum())
            n += d.size
        assert off <= 1e-4 * n, off
    assert sorted(os.listdir(tmp_path / "two")) == sorted(
        os.listdir(tmp_path / "one"))
