"""The port's TransRef trainer (stitchax_torch.train.transref_trainer and
`python -m stitchax_torch.train_transref`) against stitchax's
(stitchax/train/transref_trainer.py, train_transref.py), on the CPU.

One step from the trained TransRef (results/transref_ckpt_r05_bf16.msgpack)
with a VGG of seeded He-scaled parameters (numpy, `test_torch_vgg.
vgg_params`, the same in both packages: the repository has no VGG16
weights) on the first committed synthetic pairs, with holes from stitchax's
`random_rect_masks`: each loss term, the gradient's global norm, every
leaf's gradient norm, a few leaves' whole gradients (an `SRAttention` kv,
the `DynamicOffsetEstimator`'s output conv, `clean`) and those leaves
after one Adam step, in units of lr. Also `prepare_inputs`, `rect_masks`
(bit-equal to `random_rect_masks` on the boxes jax.random drew), the Adam
update, the checkpoint, the flax msgpack export and the CLI for one step.
Tolerances are stated where they are used: readings of this file with
~10x headroom.

    python tests/test_torch_transref_train.py --write

is the only producer of the committed references: stitchax's jitted step
at 128^2, batch 2 (tests/torch_reference/transref_train_stitchax_small.npz,
held here) and at 512^2, batch 1 (transref_train_stitchax_fp32.npz, held by
chip_smoke.py's `transref_train_vs_stitchax` on the card). Neither holds
VGG parameters: they are regenerated from the seed.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_vgg import vgg_params  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRANSREF = os.path.join(REPO, "results", "transref_ckpt_r05_bf16.msgpack")
SYNTH = os.path.join(REPO, "tests", "torch_reference", "udis_synth")
SMALL_REFERENCE = os.path.join(REPO, "tests", "torch_reference",
                               "transref_train_stitchax_small.npz")
REFERENCE = os.path.join(REPO, "tests", "torch_reference",
                         "transref_train_stitchax_fp32.npz")
# TransRef's strided stages take 128^2 (at 64^2 a non-local block of the
# third RefPA meets a 1x1 map it cannot pool in flax either)
SMALL, SMALL_BATCH = 128, 2
LR = 1e-4
VGG_SEED, MASK_SEED = 0, 7
# the leaves whose gradients and updated values the references keep whole
CHOSEN = (
    "['params']['tenc']['block1_0']['attn']['kv']['kernel']",
    "['params']['tenc']['block1_0']['attn']['kv']['bias']",
    "['params']['tenc']['refpa1']['pa']['offset_estimator']['scale']"
    "['kernel']",
    "['params']['tenc']['refpa1']['pa']['offset_estimator']['scale']"
    "['bias']",
    "['params']['clean']['kernel']",
    "['params']['clean']['bias']")
LOSSES = ("total", "l1", "perceptual", "style")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    from stitchax_torch.convert import _flatten, _keystr
    return {_keystr(p): np.asarray(a, np.float32) for p, a in _flatten(tree)}


def first_pairs(size, batch):
    """The first `batch` committed pairs at size^2 as the loader reads them:
    (image1, image2) uint8 (B, S, S, 3), and their names."""
    from stitchax_torch.data.udis import UDISDataset

    ds = UDISDataset(SYNTH, phase="testing", size=(size, size))
    items = [ds[i] for i in range(batch)]
    i1, i2 = (np.stack([it[k] for it in items]).astype(np.uint8)
              for k in ("image1", "image2"))
    return i1, i2, [it["name"] for it in items]


def to_unit(pixels):
    """uint8 pixels -> float32 in [-1, 1], as the trainers scale them."""
    return pixels.astype(np.float32) / np.float32(127.5) - np.float32(1.0)


def stitchax_masks(batch, size, seed=MASK_SEED):
    """stitchax's random_rect_masks(PRNGKey(seed), batch, size) and the
    boxes it draws (its transref_trainer.py:37-42), from one jitted
    program, as numpy: ((x0, y0, w, h), mask)."""
    import jax

    from stitchax.train.transref_trainer import random_rect_masks

    def run(key):
        keys = jax.random.split(key, 4)
        lo_hi = ((0, size - 8), (0, size - 8), (8, int(size * 0.5)),
                 (8, int(size * 0.5)))
        boxes = [jax.random.randint(k, (batch, 3), lo, hi)
                 for k, (lo, hi) in zip(keys, lo_hi)]
        return boxes, random_rect_masks(key, batch, size)

    boxes, mask = jax.jit(run)(jax.random.PRNGKey(seed))
    return tuple(np.asarray(b) for b in boxes), np.asarray(mask)


# ------------------------------ stitchax's side ------------------------------

def stitchax_step(size, batch):
    """One jitted stitchax TransRef step from the trained checkpoint with
    the seeded VGG on the first pairs and stitchax's masks: (metrics, raw
    gradients, params after Adam, the mask), flat by key string. The Adam
    is chained after a transformation that keeps the raw gradients."""
    import jax
    import jax.numpy as jnp
    import optax

    from stitchax.models.transref import TransRefBase
    from stitchax.models.vgg import VGG16Features
    from stitchax.train.transref_trainer import (TransRefLossConfig,
                                                 make_transref_train_step)
    from stitchax_torch.convert import load_flax_msgpack

    params = jax.tree_util.tree_map(jnp.asarray, load_flax_msgpack(TRANSREF))
    vparams = vgg_params(VGG_SEED)
    vgg_apply = lambda x: VGG16Features().apply(vparams, x)
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    tx = optax.chain(keep, optax.adam(LR))
    step = jax.jit(make_transref_train_step(TransRefBase(), vgg_apply, tx,
                                            TransRefLossConfig()))
    i1, i2, _ = first_pairs(size, batch)
    gt, ref = to_unit(i1), to_unit(i2)
    _, mask = stitchax_masks(batch, size)
    new, opt_state, metrics = step(params, tx.init(params), jnp.asarray(gt),
                                   jnp.asarray(ref), jnp.asarray(mask))
    tree = lambda t: jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                            t)
    return ({k: float(v) for k, v in metrics.items()},
            _flat(tree(opt_state[0])), _flat(tree(new)), np.asarray(mask))


def reference(size, batch):
    """stitchax's step as the references keep it: the pairs' names, the
    boxes and the mask, the metrics, the global and every leaf's gradient
    norm, the CHOSEN leaves' gradients and values after Adam; all the
    gradients under "all_grads" (not saved)."""
    metrics, grads, updated, mask = stitchax_step(size, batch)
    i1, i2, names = first_pairs(size, batch)
    out = {"names": np.array(names), "size": np.int32(size),
           "image_sums": np.array([i1.sum(dtype=np.int64),
                                   i2.sum(dtype=np.int64)]),
           "mask": np.packbits(mask.astype(bool)),
           **{f"box/{k}": v for k, v in zip(
               ("x0", "y0", "w", "h"), stitchax_masks(batch, size)[0])}}
    out.update({f"metric/{k}": np.float32(v) for k, v in metrics.items()})
    out["metric/grad_norm"] = np.float32(np.sqrt(sum(
        float(np.sum(g.astype(np.float64) ** 2)) for g in grads.values())))
    out.update({f"gradnorm/{k}": np.float32(np.linalg.norm(g))
                for k, g in grads.items()})
    for k in CHOSEN:
        out[f"grad/{k}"] = grads[k]
        out[f"updated/{k}"] = updated[k]
    if size == SMALL:          # the tier-1 tests read the inputs from here
        out.update(image1=i1, image2=i2)
    out["all_grads"] = grads
    return out


def write_reference():
    """Both references (the small one with its input pixels ~0.6 MB, the
    512^2 one ~0.5 MB; ~2.5 min and ~6 GiB on the CPU)."""
    paths = []
    for path, size, batch in ((SMALL_REFERENCE, SMALL, SMALL_BATCH),
                              (REFERENCE, 512, 1)):
        out = reference(size, batch)
        out.pop("all_grads")
        np.savez_compressed(path, **out)
        paths.append(path)
    return paths


# -------------------------------- the port's ---------------------------------

def port_step(ref, device="cpu"):
    """The port's step on the reference's input: (metrics, raw gradients,
    tensors after Adam, the start), flat by stitchax's key strings, the
    mask and the trained model."""
    from stitchax_torch.convert import load_flax_msgpack, load_jax_params
    from stitchax_torch.models.transref import TransRefBase
    from stitchax_torch.models.vgg import VGG16Features
    from stitchax_torch.train.optim import apply_updates
    from stitchax_torch.train.transref_trainer import (
        conv_transpose_names, create_train_state, make_transref_train_step,
        rect_masks, to_stitchax)

    size, batch = int(ref["size"]), len(ref["names"])
    if "image1" in ref:
        i1, i2 = ref["image1"], ref["image2"]
    else:
        i1, i2, names = first_pairs(size, batch)
        assert names == [str(n) for n in ref["names"]]
    assert [i1.sum(dtype=np.int64), i2.sum(dtype=np.int64)] == \
        ref["image_sums"].tolist()
    gt, img2 = to_unit(i1), to_unit(i2)
    start = load_flax_msgpack(TRANSREF)
    model = load_jax_params(TransRefBase(), start).to(device)
    vgg = load_jax_params(VGG16Features(), vgg_params(VGG_SEED)).to(device)
    vgg.requires_grad_(False)
    state, tx = create_train_state(model, LR)
    step = make_transref_train_step(model, vgg, tx)
    boxes = [torch.as_tensor(ref[f"box/{k}"], device=device)
             for k in ("x0", "y0", "w", "h")]
    mask = rect_masks(*boxes, size)
    gt, img2 = (torch.as_tensor(x, device=device) for x in (gt, img2))
    metrics, grads = step.loss_and_grads(state, gt, img2, mask)
    updates, _ = tx.update(grads, state.opt_state, state.params)
    apply_updates(state.params, updates)
    ct = conv_transpose_names(model)
    flat = lambda d: {k: v.numpy() for k, v in to_stitchax(d, ct).items()}
    metrics = {k: float(v) for k, v in metrics.items()}
    metrics["grad_norm"] = float(torch.sqrt(sum(
        (g.double() ** 2).sum() for g in grads.values())))
    return (metrics, flat(grads), flat(state.params), _flat(start), mask,
            model)


@pytest.fixture(scope="module")
def small_step():
    """(stitchax's committed small step, the port's)."""
    with np.load(SMALL_REFERENCE) as f:
        ref = {k: f[k] for k in f.files}
    return ref, port_step(ref)


# readings at the small size (this file, two torch threads): the losses
# 4.9e-7 relative (the perceptual term), grad_norm 8.0e-6, per-leaf
# gradient norms 2.2e-4 (a RefPA non-local block's theta bias), the kept
# leaves' relative L2 error 1.1e-4 (the offset estimator's output conv);
# after Adam see UPDATE_TOL
SMALL_TOL = {"loss_rel": 5e-6, "grad_norm_rel": 1e-4, "leaf_norm_rel": 2e-3,
             "leaf_l2_rel": 1e-3}


def check_metrics(got, ref, tol):
    for k in (*LOSSES, "grad_norm"):
        r = float(ref[f"metric/{k}"])
        lim = tol["grad_norm_rel" if k == "grad_norm" else "loss_rel"]
        assert abs(got[k] - r) <= lim * abs(r), (k, got[k], r)


def leaf_errors(grads, ref):
    """({leaf: |norm - stitchax's| / (stitchax's + floor)} over every leaf,
    {kept leaf: relative L2 error of its gradient}); the floor, 1e-6 of the
    global norm, keeps leaves whose gradient vanishes from reading as
    noise."""
    floor = 1e-6 * float(ref["metric/grad_norm"])
    keys = [k[len("gradnorm/"):] for k in ref if k.startswith("gradnorm/")]
    assert sorted(keys) == sorted(grads) and len(keys) == 506
    norms = {k: abs(float(np.linalg.norm(grads[k]))
                    - float(ref[f"gradnorm/{k}"]))
             / (float(ref[f"gradnorm/{k}"]) + floor) for k in keys}
    l2 = {k: float(np.linalg.norm(grads[k] - ref[f"grad/{k}"]))
          / (float(np.linalg.norm(ref[f"grad/{k}"])) + floor) for k in CHOSEN}
    return norms, l2


# the kept leaves after one Adam step, in units of lr. Adam's first step is
# lr g / (|g| + eps) with eps = 1e-8: where stitchax's |g| exceeds 100 eps
# it is ~lr sign(g) and the two steps agree (reading at the small size
# 1.9e-4 lr), below it a gradient's rounding moves the step by up to 2 lr
# (reading 0.82 lr; 34 of 45467 elements off by more than 0.01 lr, 7.5e-4,
# all with |g| < 1e-7)
UPDATE_TOL = {"where_g_large_lr": 2e-3, "off_share": 1e-2}


def check_updated(got, ref, start, lr, tol=UPDATE_TOL):
    """Every kept leaf moved; where stitchax's |g| > 1e-6 each element
    within tol["where_g_large_lr"] lr, elsewhere within 2 lr; the share
    off by more than 0.01 lr within tol["off_share"]. Returns (the worst
    element where |g| > 1e-6, the worst, the share), in lr."""
    large = worst = 0.0
    off = n = 0
    for k in CHOSEN:
        d = np.abs(got[k] - ref[f"updated/{k}"]) / lr
        big = np.abs(ref[f"grad/{k}"]) > 1e-6
        if big.any():
            large = max(large, float(d[big].max()))
        worst = max(worst, float(d.max()))
        off += int((d > 0.01).sum())
        n += d.size
        assert np.any(got[k] != start[k]), k
    assert large <= tol["where_g_large_lr"], large
    assert worst <= 2.0 + 1e-3, worst
    assert off <= tol["off_share"] * n, (off, n)
    return large, worst, off / n


def test_small_step_losses_and_grad_norm(small_step):
    ref, (got, *_) = small_step
    check_metrics(got, ref, SMALL_TOL)


def test_small_step_gradients_match(small_step):
    """Every leaf's gradient norm, and the kept leaves' whole gradients."""
    ref, (_, grads, *_) = small_step
    norms, l2 = leaf_errors(grads, ref)
    worst = max(norms, key=norms.get)
    assert norms[worst] <= SMALL_TOL["leaf_norm_rel"], (worst, norms[worst])
    for k, e in l2.items():
        assert e <= SMALL_TOL["leaf_l2_rel"], (k, e)


def test_small_step_adam_update_matches(small_step):
    ref, (_, _, updated, start, mask, _) = small_step
    check_updated(updated, ref, start, LR)
    # the port's rasterised boxes are stitchax's mask
    want = np.unpackbits(ref["mask"])[:mask.numel()].reshape(mask.shape)
    assert np.array_equal(mask.numpy() > 0.5, want.astype(bool))


@pytest.mark.slow
def test_small_step_live_matches_stitchax():
    """The committed small reference regenerated live (stitchax's jitted
    step, ~1-2 min), and every leaf's whole gradient held to it: relative
    L2 within 1.5e-2 (reading 1.35e-3, a RefPA non-local block's g
    kernel)."""
    ref = reference(SMALL, SMALL_BATCH)
    with np.load(SMALL_REFERENCE) as saved:
        for k in saved.files:
            if k == "names":
                assert saved[k].tolist() == ref[k].tolist()
            else:
                np.testing.assert_allclose(saved[k], ref[k], rtol=1e-6,
                                           atol=1e-12, err_msg=k)
    got, grads, *_ = port_step(ref)
    check_metrics(got, ref, SMALL_TOL)
    all_grads = ref["all_grads"]
    floor = 1e-6 * float(ref["metric/grad_norm"])
    err = {k: float(np.linalg.norm(grads[k] - g))
           / (float(np.linalg.norm(g)) + floor) for k, g in all_grads.items()}
    worst = max(err, key=err.get)
    print(worst, err[worst])
    assert err[worst] <= 1.5e-2, (worst, err[worst])


# the full-size step on the CPU against the committed reference; the
# card's smoke holds its step to the same file with chip_smoke.py's
# TRANSREF_TRAIN_STITCHAX_TOL, these limits. Readings on this CPU (the test
# prints them): losses 2.5e-7 relative, grad_norm 1.3e-7, per-leaf norms
# 7.8e-4, the kept leaves 4.0e-4; after Adam 4.5e-4 lr where |g| > 1e-6,
# 2.0e-3 of the elements off by more than 0.01 lr
FULL_TOL = {"loss_rel": 5e-6, "grad_norm_rel": 2e-5, "leaf_norm_rel": 7e-3,
            "leaf_l2_rel": 4e-3}


@pytest.mark.slow
def test_full_size_step_matches_the_reference():
    """The port's step at 512^2, batch 1 on the CPU against the committed
    reference that the card's smoke holds its step to (~20 s)."""
    with np.load(REFERENCE) as f:
        ref = {k: f[k] for k in f.files}
    got, grads, updated, start, *_ = port_step(ref)
    norms, l2 = leaf_errors(grads, ref)
    print(got, max(norms.values()), max(l2.values()))
    check_metrics(got, ref, FULL_TOL)
    assert max(norms.values()) <= FULL_TOL["leaf_norm_rel"]
    assert max(l2.values()) <= FULL_TOL["leaf_l2_rel"]
    print(check_updated(updated, ref, start, LR,
                        {"where_g_large_lr": 7e-3, "off_share": 2e-2}))


# ----------------------------- inputs and masks ------------------------------

def test_prepare_inputs_equals_stitchax(rng):
    """The set_input mean fill, a batch item whose hole covers the whole
    image included (the visible count's floor of 1): within 1e-7 (reading
    9.3e-9, the sums' order)."""
    import jax

    from stitchax.train.transref_trainer import prepare_inputs as jprep
    from stitchax_torch.train.transref_trainer import prepare_inputs

    gt = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (3, 32, 32, 1)) > 0.6).astype(np.float32)
    mask[1] = 1.0
    ref = np.asarray(jax.jit(jprep)(gt, mask))
    got = prepare_inputs(torch.from_numpy(gt), torch.from_numpy(mask))
    assert np.abs(got.numpy() - ref).max() <= 1e-7
    assert np.array_equal(got[1].numpy(), np.zeros_like(gt[1]))


def test_rect_masks_equal_random_rect_masks():
    """Given the boxes jax.random drew, `rect_masks` rasterises exactly
    stitchax's random_rect_masks, at the CLI's 512^2, batch 4 (the held
    step checks 128^2, batch 2)."""
    from stitchax_torch.train.transref_trainer import rect_masks

    size, batch = 512, 4
    boxes, want = stitchax_masks(batch, size)
    got = rect_masks(*(torch.tensor(b) for b in boxes), size)
    assert got.dtype == torch.float32 and got.shape == (batch, size, size, 1)
    assert np.array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1


def test_drawn_boxes_keep_stitchax_bounds():
    """The port's draws (a torch.Generator, an intentional departure):
    x0, y0 in [0, S - 8), w, h in [8, S / 2); the same seed, the same
    boxes."""
    from stitchax_torch.train.transref_trainer import draw_rect_boxes

    S = 128
    a = draw_rect_boxes(torch.Generator().manual_seed(3), 500, S)
    b = draw_rect_boxes(torch.Generator().manual_seed(3), 500, S)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    x0, y0, w, h = a
    for t, lo, hi in ((x0, 0, S - 8), (y0, 0, S - 8), (w, 8, S // 2),
                      (h, 8, S // 2)):
        assert t.shape == (500, 3) and int(t.min()) == lo
        assert int(t.max()) == hi - 1


def test_adam_equals_optax(rng):
    """Three optax.adam(1e-3) updates of a small tree: within 1e-6 of the
    updates' scale (reading 1.2e-7, a float32 ulp); the tensors after each
    equal to the float32 sums of optax's updates."""
    import jax
    import optax

    from stitchax_torch.train.optim import Adam, apply_updates

    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in (("a", (4, 3)), ("b", (5,)))}
    tx = optax.adam(1e-3)
    js = tx.init(params)
    update = jax.jit(tx.update)
    opt = Adam(1e-3)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    ts = opt.init(tp)
    for i in range(3):
        g = {k: (rng.standard_normal(v.shape) * 10 ** -i).astype(np.float32)
             for k, v in params.items()}
        ju, js = update(g, js)
        tu, ts = opt.update({k: torch.tensor(v) for k, v in g.items()}, ts)
        apply_updates(tp, tu)
        for k in params:
            u = np.asarray(ju[k])
            assert np.abs(tu[k].numpy() - u).max() <= 1e-6 * np.abs(u).max()
            params[k] = params[k] + u
            assert np.array_equal(tp[k].numpy(), params[k])
    assert ts.count == 3


# ---------------------- the export and the msgpack writer --------------------

def test_export_loads_in_the_port_and_in_flax(small_step, tmp_path):
    """The trained model of the small step exported as a flax msgpack:
    `StitchModels`' loader (load_flax_msgpack + load_jax_params) gives
    TransRefBase the trained tensors, and flax.serialization.from_bytes
    restores it into the committed checkpoint's tree, every leaf equal."""
    from flax import serialization

    from stitchax_torch import convert
    from stitchax_torch.models.transref import TransRefBase
    from stitchax_torch.train.transref_trainer import export_msgpack

    *_, model = small_step[1]
    path = tmp_path / "t.msgpack"
    export_msgpack(str(path), model)
    back = convert.load_jax_params(TransRefBase(),
                                   convert.load_flax_msgpack(str(path)))
    trained = model.state_dict()
    for k, v in back.state_dict().items():
        assert torch.equal(v, trained[k]), k
    with open(TRANSREF, "rb") as f:
        template = serialization.msgpack_restore(f.read())
    restored = _flat(serialization.from_bytes(template, path.read_bytes()))
    want = _flat(convert.load_flax_msgpack(str(path)))
    assert sorted(restored) == sorted(want) and len(want) == 506
    assert all(np.array_equal(restored[k], want[k]) for k in want)


def test_msgpack_writer_equals_flax_to_bytes(rng, tmp_path):
    """save_flax_msgpack writes flax.serialization.to_bytes' bytes for a
    tree of float32 / int arrays (0-d, small and large) and tensors, in the
    dicts' order."""
    from flax import serialization

    from stitchax_torch.convert import load_flax_msgpack, save_flax_msgpack

    tree = {"params": {"b": {"kernel": rng.standard_normal(
        (3, 3, 4, 5)).astype(np.float32), "bias": np.zeros(5, np.float32)},
        "a": {"s": np.ones((), np.float32),
              "i": np.arange(70000, dtype=np.int32),
              "x": torch.arange(300, dtype=torch.float32)}}}
    path = tmp_path / "t.msgpack"
    save_flax_msgpack(str(path), tree)
    tree["params"]["a"]["x"] = tree["params"]["a"]["x"].numpy()
    assert path.read_bytes() == serialization.to_bytes(tree)
    assert np.array_equal(load_flax_msgpack(str(path))["params"]["a"]["i"],
                          tree["params"]["a"]["i"])


# ------------------------------------ CLI ------------------------------------

class SmallInpainter(torch.nn.Module):
    """A stand-in for TransRefBase in the tier-1 CLI runs (the real one's
    43M parameters take ~10 s a run on the CPU; its runs are slow twins
    below): the same call, and one leaf of each kind TransRef's export
    maps (conv, transposed conv, LayerNorm, Dense, a raw kernel)."""

    def __init__(self):
        from stitchax_torch.models.layers import Conv
        from stitchax_torch.models.transref import ConvTranspose

        super().__init__()
        self.down = Conv(9, 8, 3, stride=2, padding=1)
        self.norm = torch.nn.LayerNorm(8, eps=1e-6)
        self.up = ConvTranspose(8, 8, 4, stride=2, padding=1)
        self.deform_kernel = torch.nn.Parameter(torch.randn(8, 8) * 0.3)
        self.clean = torch.nn.Linear(8, 3)

    def forward(self, detail, mask, reference):
        x = torch.cat([detail, (1.0 - mask).expand_as(detail), reference], -1)
        x = self.up(self.norm(self.down(x))) @ self.deform_kernel
        return torch.tanh(self.clean(x))


def small_split(root, pairs=4):
    """A UDIS-D-layout split of seeded smooth 128^2 JPEG pairs (the port's
    encoder), so the CLI's reads take milliseconds."""
    from stitchax_torch.io import jpeg

    rng = np.random.default_rng(11)
    for d in ("input1", "input2"):
        os.makedirs(os.path.join(root, d))
    for i in range(pairs):
        base = rng.uniform(0, 255, (8, 8, 3))
        img = np.kron(base, np.ones((16, 16, 1)))
        for d, shift in (("input1", 0), ("input2", 5)):
            jpeg.write(os.path.join(root, d, f"{i:06d}.jpg"),
                       np.roll(img, shift, axis=1).astype(np.uint8))


def _cli(tmp_path, ckpt_dir, *extra, committed=False):
    """`python -m stitchax_torch.train_transref --device cpu` at 128^2,
    batch 1, seed 3 on `small_split`, or with `committed` on a data dir
    whose training/ links to the committed split; returns the metrics
    log's records."""
    import json

    from stitchax_torch.train_transref.__main__ import main

    data = tmp_path / "data"
    if not data.exists():
        if committed:
            data.mkdir()
            os.symlink(os.path.join(SYNTH, "testing"), data / "training")
        else:
            small_split(data / "training")
    assert main(["--device", "cpu", "--image_size", str(SMALL),
                 "--batch_size", "1", "--data_dir", str(data),
                 "--ckpt_dir", str(ckpt_dir), "--log_every", "1",
                 "--seed", "3", *extra]) == 0
    return [json.loads(line) for line in
            (ckpt_dir / "transref_metrics.jsonl").read_text().splitlines()]


def cli_runs(root, model_cls, committed=False):
    """Three runs of the CLI with `model_cls` as its TransRefBase: "a" two
    steps saving each, "b" resumed from a's step 1 to 2, "s" one step with
    `--ref_from self`; the records of each."""
    from stitchax_torch.models import transref

    saved = transref.TransRefBase
    transref.TransRefBase = model_cls
    kw = dict(committed=committed)
    try:
        logs = {"a": _cli(root, root / "a", "--num_steps", "2",
                          "--save_every", "1", **kw)}
        logs["b"] = _cli(root, root / "b", "--num_steps", "2", "--resume",
                         str(root / "a" / "step_00000001.pt"), **kw)
        logs["s"] = _cli(root, root / "s", "--num_steps", "1",
                         "--ref_from", "self", **kw)
    finally:
        transref.TransRefBase = saved
    return logs


def check_cli_runs(root, logs, model):
    """Run "b", resumed from step 1, equals "a" at step 2 (the same losses,
    tensors and Adam moments, exactly, on the CPU: the data order and the
    box draws are fast-forwarded); the checkpoint holds the tensors under
    stitchax's key strings, Adam's moments and the data order; `--ref_from
    self` trains on other inputs than the pair (its first loss differs
    from a's); final_transref.msgpack loads into `model` equal to the
    trained tensors."""
    from stitchax_torch import convert
    from stitchax_torch.train.transref_trainer import (conv_transpose_names,
                                                       from_stitchax)

    a, b = logs["a"], logs["b"]
    assert [r["step"] for r in a] == [1, 2] and [r["step"] for r in b] == [2]
    assert all(np.isfinite(r[k]) for r in a for k in LOSSES)
    assert {k: b[0][k] for k in LOSSES} == {k: a[1][k] for k in LOSSES}
    sa = torch.load(root / "a" / "step_00000002.pt", weights_only=True)
    sb = torch.load(root / "b" / "step_00000002.pt", weights_only=True)
    assert sa["step"] == sb["step"] == 2 == sa["opt_state"]["count"]
    assert sa["data"] == sb["data"] == {"seed": 3, "batch_size": 1,
                                        "batches": 2}
    for part in ("params", "mu", "nu"):
        da = sa[part] if part == "params" else sa["opt_state"][part]
        db = sb[part] if part == "params" else sb["opt_state"][part]
        assert sorted(da) == sorted(db) and len(da) == len(model.state_dict())
        assert all(torch.equal(da[k], db[k]) for k in da), part
    ct = conv_transpose_names(model)
    assert sorted(from_stitchax(sa["params"], ct)) == sorted(
        model.state_dict())
    assert np.isfinite(logs["s"][0]["total"])
    assert logs["s"][0]["total"] != a[0]["total"]
    path = str(root / "s" / "final_transref.msgpack")
    convert.load_jax_params(model, convert.load_flax_msgpack(path))
    saved = torch.load(root / "s" / "step_00000001.pt", weights_only=True)
    trained = from_stitchax(saved["params"], ct)
    for k, v in model.state_dict().items():
        assert torch.equal(v, trained[k]), k


def test_cli_resume_ref_from_self_and_export(tmp_path):
    """The CLI's loop, checkpoints, resume and export on the CPU with
    `SmallInpainter` in TransRef's place (see `check_cli_runs`)."""
    logs = cli_runs(tmp_path, SmallInpainter)
    check_cli_runs(tmp_path, logs, SmallInpainter())
    ck = torch.load(tmp_path / "a" / "step_00000001.pt", weights_only=True)
    assert "['params']['up']['kernel']" in ck["params"]
    assert ck["params"]["['params']['up']['kernel']"].shape == (4, 4, 8, 8)


@pytest.mark.slow
def test_cli_with_transref_and_stitchax_loads_the_export(tmp_path):
    """The same three runs with the real TransRefBase on the committed
    split (~40 s), and stitchax's make_default_transref_apply(ckpt=<the
    export>) loads it and inpaints as the port's model does, within 1e-4
    (~1 min: its jitted init)."""
    import jax.numpy as jnp

    from stitchax.models.transref import make_default_transref_apply
    from stitchax_torch import convert
    from stitchax_torch.models.transref import TransRefBase

    logs = cli_runs(tmp_path, TransRefBase, committed=True)
    check_cli_runs(tmp_path, logs, TransRefBase())
    path = str(tmp_path / "s" / "final_transref.msgpack")
    apply = make_default_transref_apply(size=SMALL, bf16=False, ckpt=path)
    i1, i2, _ = first_pairs(SMALL, 1)
    gt, ref = to_unit(i1), to_unit(i2)
    mask = np.zeros((1, SMALL, SMALL, 1), np.float32)
    mask[:, 40:80, 30:90] = 1
    want = np.asarray(apply(jnp.asarray(gt), jnp.asarray(mask),
                            jnp.asarray(ref)))
    model = convert.load_jax_params(TransRefBase(),
                                    convert.load_flax_msgpack(path))
    with torch.no_grad():
        got = model(*(torch.from_numpy(x) for x in (gt, mask, ref))).numpy()
    assert np.abs(got - want).max() <= 1e-4


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_transref_train.py --write")
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    print(write_reference())
