"""The port's alignment trainer (stitchax_torch.train) against stitchax's
(stitchax.train), on the CPU.

The same weights and inputs go through stitchax's jitted `make_train_step`
and the port's: losses, the raw gradients' global norm, every trained
tensor's gradient (the homography net's BatchNorm statistics included, as
stitchax trains them) and the tensors after one clip + AdamW update. The
real homography net and FlowFormer++ run at the dry-run sizes of
__graft_entry__.py (S = 128, decoder_depth 2, encoder_depth 1), FlowFormer++
with the trained weights of results/ckpt_r05_bf16.npz that exist at that
depth, the homography net from flax's initializers (its regression head
at 128^2 has no trained counterpart). Also: the losses, optax's schedule,
clip and AdamW, the stub-backbone step of tests/test_train_step.py,
checkpoints, the npz export and the CLI for one step. Tolerances are
stated where they are used: readings of this file with ~10x headroom.

    python tests/test_torch_train.py --write

runs stitchax's jitted step at full size (512^2, the shipped FlowFormer++
and homography net from results/ckpt_r05_bf16.npz, fp32, on the CPU) on the
first committed synthetic pair and writes
tests/torch_reference/train_stitchax_fp32.npz, which the card's smoke
(`train_vs_stitchax`) holds the port's step to.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "results", "ckpt_r05_bf16.npz")
SYNTH = os.path.join(REPO, "tests", "torch_reference", "udis_synth")
REFERENCE = os.path.join(REPO, "tests", "torch_reference",
                         "train_stitchax_fp32.npz")
SMALL_REFERENCE = os.path.join(REPO, "tests", "torch_reference",
                               "train_stitchax_small.npz")
SMALL = 128
SMALL_LR = 1e-3
# the leaves whose gradients and updated values the reference keeps whole
CHOSEN = (
    "['flow']['params']['context_encoder']['block0_0']['attn']['qkv']"
    "['kernel']",
    "['flow']['params']['context_encoder']['block0_0']['attn']['qkv']"
    "['bias']",
    *(f"['flow']['params']['memory_decoder']['iteration']['update_block']"
      f"['gru']['conv{g}{i}']['bias']" for i in (1, 2) for g in "zrq"),
    "['homo']['params']['regress1']['fc3']['kernel']",
    "['homo']['params']['regress1']['fc3']['bias']",
    "['homo']['batch_stats']['feature_extractor']['bn1']['mean']",
    "['homo']['batch_stats']['feature_extractor']['bn1']['var']")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The steps here are small: two intra-op threads are enough, and the
    tier-1 command's six workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    from stitchax_torch.convert import _flatten, _keystr
    return {_keystr(p): np.asarray(a, np.float32) for p, a in _flatten(tree)}


def _np_tree(tree):
    import jax
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


# ------------------------------ stitchax's side ------------------------------

def stitchax_step(params, flow_cfg, img1, img2, optim_cfg):
    """One jitted stitchax train step from `params` ({homo, flow} variables,
    numpy): (metrics, raw gradients, params after the update), flat by key
    string. The optimizer is stitchax's, chained after a transformation
    that keeps the raw gradients in its state."""
    import jax
    import jax.numpy as jnp
    import optax

    from stitchax.align.adapter import AlignConfig
    from stitchax.models import FlowFormer, UDIS2HomographyNet
    from stitchax.train import LossConfig, TrainState, make_train_step
    from stitchax.train.optim import fetch_optimizer

    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    tx = optax.chain(keep, fetch_optimizer(optim_cfg))
    homo, flow = UDIS2HomographyNet(), FlowFormer(flow_cfg)
    step = jax.jit(make_train_step(
        lambda p, a, b: homo.apply(p, a, b),
        lambda p, a, b: flow.apply(p, a, b), tx, AlignConfig(), LossConfig()))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=tx.init(params))
    new, metrics = step(state, jnp.asarray(img1), jnp.asarray(img2))
    return ({k: float(v) for k, v in metrics.items()},
            _flat({"flow": _np_tree(new.opt_state[0]["flow"]),
                   "homo": _np_tree(new.opt_state[0]["homo"])}),
            _flat(_np_tree(new.params)))


# -------------------------------- the port's ---------------------------------

def port_step(homo_vars, flow_vars, flow_cfg, size, img1, img2, optim_cfg,
              device="cpu"):
    """The port's step from the same variables: (metrics, raw gradients,
    tensors after the update), flat by stitchax's key strings."""
    from stitchax_torch.align.adapter import AlignConfig
    from stitchax_torch.convert import load_jax_params
    from stitchax_torch.models.flowformer import FlowFormer
    from stitchax_torch.models.udis2 import UDIS2HomographyNet
    from stitchax_torch.train import (LossConfig, create_train_state,
                                      make_train_step, stitchax_tree)

    homo = load_jax_params(UDIS2HomographyNet(size), homo_vars).to(device)
    flow = load_jax_params(FlowFormer(flow_cfg), flow_vars).to(device)
    state, tx = create_train_state({"homo": homo, "flow": flow}, optim_cfg)
    step = make_train_step(homo, flow, tx, AlignConfig(), LossConfig())
    a, b = (torch.as_tensor(x, device=device) for x in (img1, img2))
    _, grads = step.loss_and_grads(state, a, b)
    grads = _flat(stitchax_tree(grads))
    state, metrics = step(state, a, b)
    return ({k: float(v) for k, v in metrics.items()}, grads,
            _flat(stitchax_tree(state.params)))


def small_models():
    """{homo, flow} variables at S = 128, decoder_depth 2, encoder_depth 1,
    from the trained npz with numpy alone: FlowFormer++'s leaves that exist
    at that depth, and the homography net's with the regression head's fc1
    cut to the (128 / 128)^2 x 256 inputs it takes at 128^2."""
    from stitchax_torch.convert import load_npz

    tree = load_npz(CKPT)
    perceiver = tree["flow"]["params"]["memory_encoder"]["cost_perceiver"]
    for k in [k for k in perceiver if k[-1] in "12" and "_layer" in k]:
        del perceiver[k]
    fc1 = tree["homo"]["params"]["regress1"]["fc1"]
    fc1["kernel"] = np.ascontiguousarray(
        fc1["kernel"][:(SMALL // 128) ** 2 * 256])
    return tree["homo"], tree["flow"]


def first_pair(size):
    from stitchax_torch.data.udis import UDISDataset
    item = UDISDataset(SYNTH, phase="testing", size=(size, size))[0]
    return item["image1"][None], item["image2"][None], item["name"]


def small_port_step():
    from stitchax_torch.models.flowformer import FlowFormerConfig
    from stitchax_torch.train import OptimConfig

    homo, flow = small_models()
    i1, i2, _ = first_pair(SMALL)
    return port_step(homo, flow, FlowFormerConfig(
        decoder_depth=2, encoder_depth=1, upsample_all=True), SMALL, i1, i2,
        OptimConfig(canonical_lr=SMALL_LR))


@pytest.fixture(scope="module")
def small_step():
    """(stitchax's committed small step, the port's)."""
    with np.load(SMALL_REFERENCE) as ref:
        ref = {k: ref[k] for k in ref.files}
    return ref, small_port_step()


# readings at the small size (this file, two torch threads): losses 5.6e-7
# relative, grad_norm 9.2e-6, per-leaf gradient norms 3.8e-4, the kept
# leaves' relative L2 error 1.4e-5 / 4.1e-5 (homo / flow: a BatchNorm mean,
# the twins qkv kernel), every leaf's 1.4e-5 / 1.4e-3 live (FlowFormer++'s
# worst: the cost embedding's first convolution); after the update see
# `check_updated`
SMALL_TOL = {"loss_rel": 1e-5, "grad_norm_rel": 1e-4, "leaf_norm_rel": 5e-3,
             "leaf_l2_rel": {"homo": 2e-4, "flow": 5e-4},
             "every_leaf_l2_rel": {"homo": 2e-4, "flow": 1.5e-2}}


def check_metrics(readings, tol):
    """The losses and grad_norm of `held_to_stitchax.step_readings`."""
    for k, e in readings["metric_rel"].items():
        lim = tol["grad_norm_rel" if k == "grad_norm" else "loss_rel"]
        assert e <= lim, (k, e)


def check_updated(got, ref, start, lr0):
    """The kept tensors after one AdamW step. Its first step is ~lr0 sign(g)
    except where |g| is near eps = 1e-8, so the elements are held in units
    of lr0: each within 0.5 lr0 (+1e-6 of the tensor's scale), and those
    off by more than 0.01 lr0 under 10% of them (readings: at the small
    size 0.025 lr0 and 6.7e-5; at full size 0.179 lr0 and 0.6% on the CPU,
    0.011 lr0 and 1.0% on the card); and every tensor moved. Returns the
    worst element and that share."""
    from held_to_stitchax import adamw_first_step

    u = adamw_first_step(got, ref, start, lr0)
    assert u["over_scale_lr0"] <= 0.5, u
    assert not u["unmoved"], u["unmoved"]
    assert u["off_share"] <= 0.1, u["off_share"]
    return u["worst_lr0"], u["off_share"]


def small_readings(small_step):
    """The port's small step read against stitchax's committed one."""
    from held_to_stitchax import step_readings

    ref, (tm, tg, _) = small_step
    return step_readings(tm, tg, ref)


def test_small_step_losses_and_grad_norm(small_step):
    check_metrics(small_readings(small_step), SMALL_TOL)


@pytest.mark.parametrize("model", ["homo", "flow"])
def test_small_step_gradient_norms_match(small_step, model):
    """Every trained tensor's gradient norm (BatchNorm statistics
    included) against stitchax's."""
    err = small_readings(small_step)["leaf_norm_rel"]
    err = {k: e for k, e in err.items() if k.startswith(f"['{model}']")}
    worst = max(err, key=err.get)
    assert err[worst] <= SMALL_TOL["leaf_norm_rel"], (worst, err[worst])


def test_small_step_gradients_match(small_step):
    """Whole gradients of the kept leaves: a twins qkv, the GRU's biases,
    the homography head and every BatchNorm statistic."""
    for k, e in small_readings(small_step)["leaf_l2_rel"].items():
        assert e <= SMALL_TOL["leaf_l2_rel"][k[2:6]], (k, e)


def test_small_step_trains_batch_statistics(small_step):
    """stitchax's gradient reaches the BatchNorm running means and
    variances; the port's does too, as the stitchax's (checked whole in
    test_small_step_gradients_match), and all are nonzero."""
    ref, (_, tg, _) = small_step
    stats = [k for k in tg if "['batch_stats']" in k]
    assert len(stats) == 2 * 43      # mean and var of 43 BatchNorms
    assert all(f"grad/{k}" in ref for k in stats)
    assert all(np.abs(tg[k]).max() > 0 for k in stats)


def test_small_step_update_matches(small_step):
    ref, (_, _, tp) = small_step
    homo, flow = small_models()
    check_updated(tp, ref, _flat({"homo": homo, "flow": flow}),
                  SMALL_LR / 25)


def small_predictions(flow_vars, i1, i2):
    """The training forward's upsampled predictions at the small size."""
    from stitchax_torch.convert import load_jax_params
    from stitchax_torch.models.flowformer import FlowFormer, FlowFormerConfig

    net = load_jax_params(FlowFormer(FlowFormerConfig(
        decoder_depth=2, encoder_depth=1, upsample_all=True)), flow_vars)
    with torch.no_grad():
        got, _ = net(torch.from_numpy(i1), torch.from_numpy(i2))
    return [g.numpy() for g in got]


def test_training_forward_predictions_match(small_step):
    """All decoder_depth upsampled predictions (the mask head batched over
    the depth) against stitchax's `FlowFormer.apply` with upsample_all
    (reading 1.1e-5 px of a 2.3 px field)."""
    ref, _ = small_step
    _, flow = small_models()
    i1, i2, _ = first_pair(SMALL)
    got = small_predictions(flow, i1, np.roll(i2, 3, axis=2))
    assert len(got) == 2
    for i, g in enumerate(got):
        r = ref[f"prediction/{i}"]
        assert np.abs(g - r).max() <= 1e-4 * max(np.abs(r).max(), 1)


@pytest.mark.slow
def test_small_step_live_matches_stitchax():
    """The committed small reference regenerated live, and every leaf's
    whole gradient held to it (~1.5 min: stitchax's jitted step)."""
    from held_to_stitchax import l2_rel, step_readings

    ref = small_reference()
    tm, tg, tp = small_port_step()
    check_metrics(step_readings(tm, tg, ref), SMALL_TOL)
    with np.load(SMALL_REFERENCE) as saved:
        assert str(saved["name"]) == str(ref["name"])
        for k in saved.files:
            if k != "name":
                np.testing.assert_allclose(saved[k], ref[k], rtol=1e-6,
                                           atol=1e-12)
    grads = ref["all_grads"]
    floor = 1e-6 * float(ref["metric/grad_norm"])
    for model in ("homo", "flow"):
        err = {k: l2_rel(tg[k], g, floor) for k, g in grads.items()
               if k.startswith(f"['{model}']")}
        worst = max(err, key=err.get)
        assert err[worst] <= SMALL_TOL["every_leaf_l2_rel"][model], (
            worst, err[worst])


# ---------------------------------- losses -----------------------------------

def _loss_inputs(rng, B=2, S=32, n=3):
    img1 = rng.uniform(0, 255, (B, S, S, 3)).astype(np.float32)
    out_h = np.concatenate([rng.uniform(0, 255, (B, S, S, 3)),
                            rng.uniform(0.5, 1, (B, S, S, 3))],
                           -1).astype(np.float32)
    flows = [rng.normal(0, 2 + i, (B, S, S, 2)).astype(np.float32)
             for i in range(n)]
    flows[0][0, :4, :4] = 600.0          # diverged: left out by max_flow
    occ = (rng.uniform(0, 1, (B, S, S, 1)) > 0.3).astype(np.float32)
    return img1, out_h, flows, occ


@pytest.mark.parametrize("with_occlusion", [False, True])
def test_sequence_loss_and_its_gradient_match(rng, with_occlusion):
    """Values within 1e-5 relative; the gradient w.r.t. every flow within
    2e-4 of its scale (readings: 1.0e-6, the means' summation order, and
    1.7e-5)."""
    import jax
    import jax.numpy as jnp

    from stitchax.train.losses import LossConfig as JLoss
    from stitchax.train.losses import sequence_alignment_loss as jloss
    from stitchax_torch.train.losses import (LossConfig,
                                             sequence_alignment_loss)

    img1, out_h, flows, occ = _loss_inputs(rng)
    occ = occ if with_occlusion else None
    jfn = lambda fs: jloss(jnp.asarray(img1), jnp.asarray(out_h), fs,
                           None if occ is None else jnp.asarray(occ),
                           JLoss())
    ref = jfn([jnp.asarray(f) for f in flows])
    jgrad = jax.grad(lambda fs: jfn(fs)["total"])(
        [jnp.asarray(f) for f in flows])
    tf = [torch.tensor(f, requires_grad=True) for f in flows]
    got = sequence_alignment_loss(
        torch.from_numpy(img1), torch.from_numpy(out_h), tf,
        None if occ is None else torch.from_numpy(occ), LossConfig())
    got["total"].backward()
    got = {k: v.detach() for k, v in got.items()}
    for k in ("total", "photometric", "rigid", "border"):
        assert abs(float(got[k]) - float(ref[k])) <= 1e-5 * abs(float(ref[k]))
    for t, j in zip(tf, jgrad):
        j = np.asarray(j)
        assert np.abs(t.grad.numpy() - j).max() <= 2e-4 * np.abs(j).max()


@pytest.mark.parametrize("name", ["photometric_l1", "border_zero_flow_loss",
                                  "rigid_motion_loss", "smoothness_loss"])
def test_loss_terms_match(rng, name):
    import jax.numpy as jnp

    from stitchax.train import losses as jl
    from stitchax_torch.train import losses as tl

    img1, out_h, flows, occ = _loss_inputs(rng)
    if name == "photometric_l1":
        args = (img1, out_h[..., :3], occ)
    elif name == "border_zero_flow_loss":
        args = (flows[1], 5)
    else:
        args = (flows[1],)
    conv = lambda f, a: [f(x) if isinstance(x, np.ndarray) else x for x in a]
    ref = float(getattr(jl, name)(*conv(jnp.asarray, args)))
    got = float(getattr(tl, name)(*conv(torch.from_numpy, args)))
    assert abs(got - ref) <= 1e-5 * abs(ref), (got, ref)


# ----------------------------- schedule and AdamW ----------------------------

@pytest.mark.parametrize("count", [0, 1, 1571, 1572, 31322, 31422, 31423])
def test_schedule_equals_optax_float32(count):
    """The shipped linear one-cycle (31323 + 100 steps) as stitchax's jitted
    step evaluates it: equal, bit for bit."""
    import jax
    import jax.numpy as jnp

    from stitchax.train.optim import OptimConfig as JOpt
    from stitchax.train.optim import onecycle_schedule as jsched
    from stitchax_torch.train.optim import OptimConfig, onecycle_schedule

    ref = np.float32(jax.jit(jsched(JOpt()))(jnp.int32(count)))
    assert np.float32(onecycle_schedule(OptimConfig())(count)) == ref


def test_schedule_equals_optax_at_every_step():
    """Every 7th count of the shipped schedule, each a scalar of the jitted
    schedule as the train step evaluates it: equal. (A vmapped or
    lax.mapped schedule rounds otherwise: XLA folds the scalar program's
    constants differently.)"""
    import jax
    import jax.numpy as jnp

    from stitchax.train.optim import OptimConfig as JOpt
    from stitchax.train.optim import onecycle_schedule as jsched
    from stitchax_torch.train.optim import OptimConfig, onecycle_schedule

    counts = np.arange(0, 31500, 7, dtype=np.int32)
    sched = jax.jit(jsched(JOpt()))
    ref = np.array([sched(jnp.int32(c)) for c in counts], np.float32)
    sched = onecycle_schedule(OptimConfig())
    got = np.array([sched(int(c)) for c in counts], np.float32)
    assert int((got != ref).sum()) == 0


def test_cosine_schedule_matches_optax():
    """The cosine one-cycle within 1e-6 relative (float32's cos here,
    XLA's there)."""
    import jax
    import jax.numpy as jnp

    from stitchax.train.optim import OptimConfig as JOpt
    from stitchax.train.optim import onecycle_schedule as jsched
    from stitchax_torch.train.optim import OptimConfig, onecycle_schedule

    counts = np.arange(0, 1200, 7, dtype=np.int32)
    kw = dict(num_steps=1000, anneal_strategy="cosine", canonical_lr=1e-3)
    ref = np.asarray(jax.jit(jax.vmap(jsched(JOpt(**kw))))(
        jnp.asarray(counts)))
    got = np.array([onecycle_schedule(OptimConfig(**kw))(int(c))
                    for c in counts], np.float32)
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def _tree(rng, scale):
    shapes = {"enc_a": (4, 3), "enc_b": (5,), "rest_c": (2, 2, 3),
              "rest_d": (7,)}
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("twins_lr_factor", [None, 0.5])
def test_clip_and_adamw_match_optax(rng, twins_lr_factor):
    """Three updates of a small tree, the second clipped (norm > 1): the
    updates within 5e-7 relative and the tensors within 1e-6 of their
    scale of optax's (readings: 2.3e-7, a float32 ulp); with
    twins_lr_factor the "enc" tensors form the lower-rate group, clipped by
    their own norm."""
    import jax
    import jax.numpy as jnp
    import optax

    from stitchax.train.optim import OptimConfig as JOpt
    from stitchax.train.optim import fetch_optimizer as jfetch
    from stitchax_torch.train.optim import (OptimConfig, apply_updates,
                                            fetch_optimizer)

    kw = dict(canonical_lr=1e-2, num_steps=20,
              twins_lr_factor=twins_lr_factor)
    params = _tree(rng, 1.0)
    tx = jfetch(JOpt(**kw), (lambda p: {k: k.startswith("enc") for k in p})
                if twins_lr_factor else None)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    update = jax.jit(tx.update)
    opt = fetch_optimizer(OptimConfig(**kw), lambda n: n.startswith("enc"))
    tp = {k: torch.tensor(v) for k, v in params.items()}
    ts = opt.init(tp)
    for i in range(3):
        g = _tree(rng, 3.0 if i == 1 else 0.1)
        ju, js = update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = opt.update({k: torch.tensor(v) for k, v in g.items()}, ts,
                            tp)
        apply_updates(tp, tu)
        for k in params:
            u = np.asarray(ju[k])
            assert np.abs(tu[k].numpy() - u).max() <= \
                5e-7 * np.abs(u).max(), (i, k)
            p = np.asarray(jp[k])
            assert np.abs(tp[k].numpy() - p).max() <= 1e-6 * np.abs(p).max()
    assert ts.count == 3


@pytest.mark.parametrize("scale", [0.1, 3.0])
def test_clip_by_global_norm_equals_optax(rng, scale):
    """Below the limit the gradients pass as they are; above it each is
    `t / norm * clip`: equal to optax's, bit for bit, on this tree."""
    import jax.numpy as jnp
    import optax

    from stitchax_torch.train.optim import clip_by_global_norm

    g = _tree(rng, scale)
    ref, _ = optax.clip_by_global_norm(1.0).update(
        {k: jnp.asarray(v) for k, v in g.items()}, None)
    got = clip_by_global_norm([torch.tensor(v) for v in g.values()], 1.0)
    for t, k in zip(got, g):
        assert np.array_equal(t.numpy(), np.asarray(ref[k])), k


# ------------------------------- stub backbones -------------------------------

class StubHomo(torch.nn.Module):
    """tests/test_train_step.py's differentiable stub homography."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(1, 8))

    def forward(self, a, b):
        return self.w * (a.mean((1, 2, 3)) - b.mean((1, 2, 3)))[:, None]


class StubFlow(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.s = torch.nn.Parameter(torch.tensor(0.01))

    def forward(self, a, b, upsample_all=None):
        f = (a[..., :2] - b[..., :2]) * self.s
        return [f, f * 0.5], f[:, ::8, ::8]


def _stitchax_stub_fns():
    import jax.numpy as jnp

    def homo_apply(p, a, b):
        return p["w"] * (a.mean((1, 2, 3)) - b.mean((1, 2, 3)))[:, None]

    def flow_apply(p, a, b):
        f = (a[..., :2] - b[..., :2]) * p["s"]
        return [f, f * 0.5], f[:, ::8, ::8]

    params = {"homo": {"w": jnp.ones((1, 8))},
              "flow": {"s": jnp.asarray(0.01)}}
    return homo_apply, flow_apply, params


def _stub_port(remat=False, fb=True, **optim):
    from stitchax_torch.align.adapter import AlignConfig
    from stitchax_torch.train import (LossConfig, OptimConfig,
                                      create_train_state, make_train_step)

    homo, flow = StubHomo(), StubFlow()
    state, tx = create_train_state({"homo": homo, "flow": flow},
                                   OptimConfig(**optim))
    return state, make_train_step(homo, flow, tx, AlignConfig(),
                                  LossConfig(), use_fb_consistency_mask=fb,
                                  remat=remat)


@pytest.mark.parametrize("fb", [True, False])
def test_stub_train_step_matches_stitchax(rng, fb):
    """tests/test_train_step.py's two steps: metrics within 1e-4 relative,
    the parameters within 1e-6 (readings: grad_norm 1.1e-5 with the
    occlusion mask, the others 3e-7; the parameters 1 ulp)."""
    import jax
    import jax.numpy as jnp

    from stitchax.align.adapter import AlignConfig as JAlign
    from stitchax.train import LossConfig as JLoss
    from stitchax.train import OptimConfig as JOpt
    from stitchax.train import create_train_state as jcreate
    from stitchax.train import make_train_step as jmake

    ha, fa, params = _stitchax_stub_fns()
    jstate, jtx = jcreate(params, JOpt(num_steps=10, canonical_lr=1e-3))
    jstep = jax.jit(jmake(ha, fa, jtx, JAlign(), JLoss(),
                          use_fb_consistency_mask=fb))
    state, step = _stub_port(fb=fb, num_steps=10, canonical_lr=1e-3)
    i1 = rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    i2 = rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    for _ in range(2):
        jstate, jm = jstep(jstate, jnp.asarray(i1), jnp.asarray(i2))
        state, tm = step(state, torch.from_numpy(i1), torch.from_numpy(i2))
        for k, v in jm.items():
            assert abs(float(tm[k]) - float(v)) <= 1e-4 * abs(float(v)), k
    assert state.step == int(jstate.step) == 2
    np.testing.assert_allclose(state.params["flow.s"].detach().numpy(),
                               np.asarray(jstate.params["flow"]["s"]),
                               rtol=1e-6)
    np.testing.assert_allclose(state.params["homo.w"].detach().numpy(),
                               np.asarray(jstate.params["homo"]["w"]),
                               rtol=1e-6)
    assert state.params["flow.s"].item() != 0.01


def test_stub_remat_gives_the_same_step(rng):
    i1 = torch.from_numpy(rng.uniform(0, 255, (1, 64, 64, 3)).astype(
        np.float32))
    i2 = torch.from_numpy(rng.uniform(0, 255, (1, 64, 64, 3)).astype(
        np.float32))
    out = []
    for remat in (False, True):
        state, step = _stub_port(remat=remat, fb=False, num_steps=10)
        state, m = step(state, i1, i2)
        out.append((float(m["total"]), state.params["flow.s"].item()))
    assert out[0] == out[1]


def test_checkpoint_resume_equals_uninterrupted(rng, tmp_path):
    """Two steps, save, two more == four steps, exactly (CPU); the saved
    file restores the step, every tensor and AdamW's moments."""
    from stitchax_torch.train import restore_checkpoint, save_checkpoint

    i1 = torch.from_numpy(rng.uniform(0, 255, (1, 64, 64, 3)).astype(
        np.float32))
    i2 = torch.from_numpy(rng.uniform(0, 255, (1, 64, 64, 3)).astype(
        np.float32))
    state, step = _stub_port(num_steps=10, canonical_lr=1e-3)
    for _ in range(2):
        state, _ = step(state, i1, i2)
    path = str(tmp_path / "step_00000002.pt")
    save_checkpoint(path, state)
    for _ in range(2):
        state, m_full = step(state, i1, i2)
    fresh, step2 = _stub_port(num_steps=10, canonical_lr=1e-3)
    fresh = restore_checkpoint(path, fresh)
    assert fresh.step == 2 and fresh.opt_state.count == 2
    for _ in range(2):
        fresh, m_res = step2(fresh, i1, i2)
    assert fresh.step == 4
    assert float(m_res["total"]) == float(m_full["total"])
    for k, p in state.params.items():
        assert torch.equal(p, fresh.params[k]), k
    bad = dict(fresh.params)
    bad.pop("flow.s")
    with pytest.raises(KeyError):
        restore_checkpoint(path, type(fresh)(0, bad, fresh.opt_state))


# ------------------------------ weights export --------------------------------

def test_params_to_jax_inverts_params_from_jax():
    """The trained npz's flow and homo trees -> the port's state_dicts ->
    back: the same key strings and the same values."""
    from stitchax_torch.convert import (load_npz, params_from_jax,
                                        params_to_jax)

    tree = load_npz(CKPT)
    for name in ("flow", "homo"):
        back = params_to_jax(params_from_jax(tree[name]))
        a, b = _flat(back), _flat(tree[name])
        assert sorted(a) == sorted(b)
        assert all(np.array_equal(a[k], b[k]) for k in b), name


def test_save_params_npz_equals_stitchax(tmp_path, rng):
    """The same keys and bf16 bits as stitchax's save_params_npz (ml_dtypes'
    round to nearest even) for the homography net's regression head (dense
    and conv kernels) and its stem's BatchNorm (scale, bias, statistics)
    with noise added, carried through the port's state_dict names and
    back; stitchax's load_params_npz reads the port's file (bf16 and
    float32) into that tree's structure."""
    import jax

    from stitchax.convert import load_params_npz
    from stitchax.convert import save_params_npz as jsave
    from stitchax_torch.convert import (params_from_jax, params_to_jax,
                                        save_params_npz)

    homo, _ = small_models()
    init = {"params": {"regress1": homo["params"]["regress1"],
                       "feature_extractor": {"bn1": homo["params"][
                           "feature_extractor"]["bn1"]}},
            "batch_stats": {"feature_extractor": {"bn1": homo[
                "batch_stats"]["feature_extractor"]["bn1"]}}}
    tree = {"homo": jax.tree_util.tree_map(
        lambda a: (a + rng.normal(0, 1e-3, a.shape)).astype(np.float32),
        init)}
    tree["homo"]["params"]["regress1"]["fc3"]["bias"][:3] = [
        1.00390625, 1.01171875, -0.0]      # ties to even, signed zero
    jsave(str(tmp_path / "j.npz"), tree)
    port = {"homo": params_to_jax(params_from_jax(tree["homo"]))}
    save_params_npz(str(tmp_path / "t.npz"), port)
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        assert all(np.array_equal(j[k], t[k]) and j[k].dtype == t[k].dtype
                   for k in j.files)
    save_params_npz(str(tmp_path / "f.npz"), port, bf16=False)
    for f in ("t.npz", "f.npz"):
        back = load_params_npz(str(tmp_path / f), {"homo": init})
        assert jax.tree_util.tree_structure(back) == \
            jax.tree_util.tree_structure({"homo": init})
    back = _flat(load_params_npz(str(tmp_path / "f.npz"), {"homo": init}))
    assert all(np.array_equal(back[k], v) for k, v in _flat(tree).items())


# ------------------------------------ CLI -------------------------------------

def test_cli_takes_a_step_on_the_cpu(tmp_path, monkeypatch):
    """`python -m stitchax_torch.train --device cpu` at 128^2 for two steps
    on the committed pairs, with configs/last_config.py cut to FlowFormer++
    depths 1 / 2 (the shipped depths run in the card's smoke): metrics
    logged, resumable checkpoints, and final_ckpt.npz, which the port's
    loader reads back into the nets equal to the trained tensors."""
    import copy
    import json
    import types

    from configs.last_config import config_dict
    from stitchax_torch import convert
    from stitchax_torch.models.flowformer import FlowFormer, FlowFormerConfig
    from stitchax_torch.models.udis2 import UDIS2HomographyNet
    from stitchax_torch.train.__main__ import main

    small = copy.deepcopy(config_dict)
    small["percostformer3"].update(encoder_depth=1, decoder_depth=2)
    monkeypatch.setitem(sys.modules, "configs.train_test_small",
                        types.SimpleNamespace(config_dict=small))
    data = tmp_path / "data"
    data.mkdir()
    os.symlink(os.path.join(SYNTH, "testing"), data / "training")
    ck = tmp_path / "ck"
    assert main(["--device", "cpu", "--image_size", str(SMALL),
                 "--model_config_name", "train_test_small",
                 "--data_dir", str(data), "--ckpt_dir", str(ck),
                 "--num_steps", "2", "--save_every", "1", "--log_every", "1",
                 "--panel_every", "0", "--seed", "3"]) == 0
    recs = [json.loads(line) for line in
            (ck / "train_metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r[k]) for r in recs
               for k in ("total", "photometric", "rigid", "border",
                         "grad_norm"))
    assert (ck / "step_00000001.pt").exists()
    saved = torch.load(ck / "step_00000002.pt", weights_only=True)
    assert saved["step"] == 2 and saved["opt_state"]["count"] == 2
    tree = convert.load_npz(str(ck / "final_ckpt.npz"))
    homo = convert.load_jax_params(UDIS2HomographyNet(SMALL), tree["homo"])
    flow = convert.load_jax_params(FlowFormer(FlowFormerConfig(
        encoder_depth=1, decoder_depth=2)), tree["flow"])
    for k, p in [*(("homo." + n, p) for n, p in homo.state_dict().items()),
                 *(("flow." + n, p) for n, p in flow.state_dict().items())]:
        assert torch.equal(p, saved["params"][k]), k


# ------------------------------ full-size check -------------------------------

# the full-size step (512^2, the shipped nets) against the committed
# reference on the CPU; the card's smoke holds its step to the same file
# with chip_smoke.py's TRAIN_STITCHAX_TOL. Readings on two CPUs (the
# test prints them): losses 6.5e-6 / 6.4e-6 relative, grad_norm 1.8e-5 /
# 8.3e-5, per-leaf gradient norms 5.0e-4 / 4.8e-4, the kept leaves'
# relative L2 error 5.4e-4 / 4.5e-4 (homo / flow, the second CPU)
FULL_TOL = {"loss_rel": 1e-4, "grad_norm_rel": 1e-3, "leaf_norm_rel": 5e-3,
            "leaf_l2_rel": {"homo": 5e-3, "flow": 5e-3}}


@pytest.mark.slow
def test_full_size_step_matches_the_reference():
    """The port's step at 512^2 on the CPU against stitchax's committed one
    (~1 min, ~10 GiB)."""
    from held_to_stitchax import step_readings
    from stitchax_torch.convert import load_npz
    from stitchax_torch.models.flowformer import FlowFormerConfig
    from stitchax_torch.train import OptimConfig

    tree = load_npz(CKPT)
    with np.load(REFERENCE) as ref:
        ref = {k: ref[k] for k in ref.files}
    i1, i2, name = first_pair(512)
    assert name == str(ref["name"])
    tm, tg, tp = port_step(tree["homo"], tree["flow"],
                           FlowFormerConfig(upsample_all=True), 512, i1, i2,
                           OptimConfig())
    r = step_readings(tm, tg, ref)
    l2 = r["leaf_l2_rel"]
    print({**{f"{k}_rel": e for k, e in r["metric_rel"].items()},
           "leaf_norm_rel": max(r["leaf_norm_rel"].values()),
           **{f"leaf_l2_rel_{m}": max(e for k, e in l2.items()
                                      if k[2:6] == m)
              for m in ("homo", "flow")}})
    check_metrics(r, FULL_TOL)
    assert max(r["leaf_norm_rel"].values()) <= FULL_TOL["leaf_norm_rel"], \
        r["leaf_norm_worst"]
    for k, e in l2.items():
        assert e <= FULL_TOL["leaf_l2_rel"][k[2:6]], (k, e)
    print(check_updated(tp, ref, _flat({"homo": tree["homo"],
                                        "flow": tree["flow"]}),
                        3.125e-6 / 25))


# -------------------------------- the producer --------------------------------

def small_reference():
    """stitchax at the small size, live: its step from `small_models()` on
    the first pair at 128^2 (metrics, every gradient norm, the CHOSEN
    leaves' and every BatchNorm statistic's gradient and updated value;
    all gradients under "all_grads", not saved) and its upsample_all
    predictions on the pair with img2 rolled by 3 px."""
    import jax.numpy as jnp

    from held_to_stitchax import step_reference
    from stitchax.models import FlowFormer, FlowFormerConfig
    from stitchax.train import OptimConfig

    homo, flow = small_models()
    cfg = FlowFormerConfig(decoder_depth=2, encoder_depth=1)
    i1, i2, name = first_pair(SMALL)
    metrics, grads, updated = stitchax_step(
        {"homo": homo, "flow": flow}, cfg, i1, i2,
        OptimConfig(canonical_lr=SMALL_LR))
    keys = [*CHOSEN, *(k for k in grads if "['batch_stats']" in k
                       and k not in CHOSEN)]
    out = {"name": np.array(name),
           **step_reference(metrics, grads, updated, keys)}
    preds, _ = FlowFormer(cfg).apply({"params": flow["params"]},
                                     jnp.asarray(i1),
                                     jnp.asarray(np.roll(i2, 3, axis=2)))
    out.update({f"prediction/{i}": np.asarray(p, np.float32)
                for i, p in enumerate(preds)})
    out["all_grads"] = grads
    return out


def stitchax_masks(params, flow_cfg, img1, img2):
    """The hard thresholds inside stitchax's step, from its jitted training
    forward: the occlusion mask (occ >= 0.5), each prediction's
    |flow| < max_flow, and the warp's coverage support (warped ones > 0,
    the interior sampler's edge); each np.packbits of its (..., H, W)
    booleans."""
    import jax
    import jax.numpy as jnp

    from stitchax import ops
    from stitchax.align.adapter import AlignConfig
    from stitchax.models import FlowFormer, UDIS2HomographyNet
    from stitchax.train import LossConfig, align_train_forward

    homo, flow = UDIS2HomographyNet(), FlowFormer(flow_cfg)
    fa = lambda p, a, b: flow.apply(p, a, b)
    cfg, loss_cfg = AlignConfig(), LossConfig()

    @jax.jit
    def masks(params, a, b):
        fwd = align_train_forward(lambda p, x, y: homo.apply(p, x, y), fa,
                                  params, a, b, cfg)
        back, _ = fa(params["flow"], fwd["output_H"][..., 0:3], a)
        occ = ops.compute_occlusion_b(
            fwd["flow_predictions"][-1], back[-1], cfg.occlusion_estimation,
            occlusion_are_zeros=True, boundaries_occluded=True)
        valid = jnp.stack([jnp.sqrt((f * f).sum(-1)) < loss_cfg.max_flow
                           for f in fwd["flow_predictions"]])
        return occ[0, ..., 0] >= 0.5, valid[:, 0], fwd["output_H"][0, ..., 3] > 0

    occ, valid, cover = masks(params, jnp.asarray(img1), jnp.asarray(img2))
    return {f"mask/{k}": np.packbits(np.asarray(v))
            for k, v in (("occ", occ), ("valid_flow", valid),
                         ("cover", cover))}


def write_reference():
    """Both references: the small one (tests/torch_reference/
    train_stitchax_small.npz, ~0.4 MB) and stitchax's jitted train step at
    full size on the first committed pair (train_stitchax_fp32.npz: the
    pair's name and pixel sums, the metrics, every leaf's gradient norm,
    the CHOSEN leaves' gradients and values after the update, and the hard
    thresholds' masks (`stitchax_masks`), ~0.6 MB)."""
    from held_to_stitchax import step_reference
    from stitchax.models import FlowFormerConfig
    from stitchax.train import OptimConfig
    from stitchax_torch.convert import load_npz

    small = small_reference()
    small.pop("all_grads")
    np.savez_compressed(SMALL_REFERENCE, **small)
    tree = load_npz(CKPT)
    i1, i2, name = first_pair(512)
    metrics, grads, updated = stitchax_step(
        {"homo": tree["homo"], "flow": tree["flow"]}, FlowFormerConfig(),
        i1, i2, OptimConfig())
    out = {"name": np.array(name),
           "image_sums": np.array([i1.astype(np.int64).sum(),
                                   i2.astype(np.int64).sum()])}
    out.update(step_reference(metrics, grads, updated, CHOSEN))
    out.update(stitchax_masks({"homo": tree["homo"], "flow": tree["flow"]},
                              FlowFormerConfig(), i1, i2))
    np.savez_compressed(REFERENCE, **out)
    return metrics


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_train.py --write")
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    print(write_reference())
