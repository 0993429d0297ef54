"""The port's SD inpainting trainer (stitchax_torch.train.sd_inpaint_trainer
and `python -m stitchax_torch.train_sd_inpaint`) against stitchax's
(stitchax/train/sd_inpaint_trainer.py, tools/train_sd_inpaint_learns.py),
on the CPU.

One VAE step and one diffusion step from the same weights, on the same
crops of the demo images, the same holes (the port's seeded boxes,
rasterised by `rect_masks`) and stitchax's own timesteps and noise
(jax.random, as its step draws them from the key): the losses, each
step's gradient global norm, every leaf's gradient norm, a few leaves'
whole gradients (KEPT) and those leaves after one Adam step, in units of
lr. The diffusion step runs first, from the VAE before its step, as
stitchax's two phases start from the same VAE. Also `inpaint_model_inputs`
(the nearest mask latent), the checkpoint read by both packages'
`load_sd_checkpoint`, and the CLI. Tolerances are stated where they are
used: readings of this file with ~10x headroom.

    python tests/test_torch_sd_train.py --write

is the only producer of the committed references: stitchax's jitted steps
on a seeded w = 8 stack at 32^2, batch 2
(tests/torch_reference/sd_train_stitchax_small.npz, held here; the weights
are regenerated from the seed) and from results/sd_ckpt_r05.pt at its
training size, 128^2, batch 8 (sd_train_stitchax_fp32.npz, held by
chip_smoke.py's `sd_train_vs_stitchax` on the card).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from stitchax_torch.convert import load_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SD_CKPT = os.path.join(REPO, "results", "sd_ckpt_r05.pt")
SMALL_REFERENCE = os.path.join(REPO, "tests", "torch_reference",
                               "sd_train_stitchax_small.npz")
REFERENCE = os.path.join(REPO, "tests", "torch_reference",
                         "sd_train_stitchax_fp32.npz")
# the tool's learning rates (tools/train_sd_inpaint_learns.py)
LR_VAE, LR = 3e-4, 2e-4
SMALL_W, SMALL, SMALL_BATCH = 8, 32, 2
FULL, FULL_BATCH = 128, 8
WEIGHT_SEED, DATA_SEED = 0, 5
KEPT = (
    "['vae']['params']['encoder']['conv_in']['kernel']",
    "['vae']['params']['encoder']['mid']['attn']['to_q']['kernel']",
    "['vae']['params']['decoder']['conv_out']['kernel']",
    "['vae']['params']['decoder']['conv_out']['bias']",
    "['unet']['params']['conv_in']['kernel']",
    "['unet']['params']['mid_attn']['attn2_k']['kernel']",
    "['unet']['params']['conv_out']['kernel']",
    "['unet']['params']['conv_out']['bias']",
    "['controlnet']['params']['hint_in']['kernel']",
    "['controlnet']['params']['zero0']['kernel']")
# each step's global norm and the leaves it covers
NORMS = {"vae_grad_norm": ("['vae']",),
         "diffusion_grad_norm": ("['unet']", "['controlnet']")}
LEAVES = {"small": {"vae": 240, "diffusion": 440},
          "full": {"vae": 244, "diffusion": 440}}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    from stitchax_torch.convert import _flatten, _keystr
    return {_keystr(p): np.asarray(a, np.float32) for p, a in _flatten(tree)}


def _step_of(key):
    return "vae" if key.startswith("['vae']") else "diffusion"


# --------------------------------- the stack ---------------------------------

def configs(width):
    """The tool's configs at `width` (tools/train_sd_inpaint_learns.py);
    below 48 the small stack of tests/test_diffusion_pipeline.py: 2
    heads, 4 groups, the VAE at (w, w, w, w)."""
    unet_kw = dict(in_channels=9, out_channels=4,
                   block_channels=(width, 2 * width), layers_per_block=1,
                   attention_resolutions=(0, 1), context_dim=2 * width,
                   num_heads=4, num_train_timesteps=1000, norm_groups=8)
    vae_kw = dict(block_channels=(width, width, 2 * width, 2 * width),
                  latent_channels=4, groups=8)
    if width < 48:
        unet_kw.update(num_heads=2, norm_groups=4)
        vae_kw.update(block_channels=(width,) * 4, groups=4)
    return unet_kw, vae_kw


def port_nets(unet_kw, vae_kw):
    from stitchax_torch.models.diffusion import (ControlNet, UNet2DCondition,
                                                 UNetConfig)
    from stitchax_torch.models.vae import AutoencoderKL

    cfg = UNetConfig(**unet_kw)
    return {"unet": UNet2DCondition(cfg), "controlnet": ControlNet(cfg),
            "vae": AutoencoderKL(**vae_kw)}


def small_trees(seed=WEIGHT_SEED):
    """The small stack's variables {net: flax tree}, numpy, in the nets'
    own layout: kernels ~ N(0, 1 / fan_in), norm scales ~ 1 + 0.1 N,
    biases ~ 0.1 N (the zero convs too, so the ControlNet's paths carry
    gradient), drawn in sorted key order; and the context ~ N(0, 1)."""
    from stitchax_torch.convert import _flatten, params_to_jax

    rng = np.random.default_rng(seed)
    trees = {k: params_to_jax(m.state_dict())
             for k, m in port_nets(*configs(SMALL_W)).items()}
    for name in sorted(trees):
        for path, x in sorted(_flatten(trees[name])):
            *mods, leaf = path
            node = trees[name]
            for m in mods:
                node = node[m]
            if leaf == "kernel":
                v = rng.standard_normal(x.shape) / np.sqrt(np.prod(
                    x.shape[:-1]))
            elif leaf == "scale":
                v = 1 + 0.1 * rng.standard_normal(x.shape)
            else:
                v = 0.1 * rng.standard_normal(x.shape)
            node[leaf] = v.astype(np.float32)
    context = rng.standard_normal((1, 77, 2 * SMALL_W)).astype(np.float32)
    return trees, context


def full_trees():
    """The committed checkpoint's variables and context."""
    from stitchax_torch import convert

    blob = convert.load_sd_container(SD_CKPT)
    return ({"unet": blob["unet_vars"], "controlnet": blob["controlnet_vars"],
             "vae": blob["vae_vars"]}, np.asarray(blob["context"]))


def crops(size, batch, seed=DATA_SEED):
    """`batch` uint8 crops of the demo images (the CLI's pool at 2 size)
    from numpy's seeded draws, and the port's seeded hole boxes."""
    from stitchax_torch.train.transref_trainer import draw_rect_boxes
    from stitchax_torch.train_sd_inpaint.__main__ import (load_demo_images,
                                                          make_crops)

    rng = np.random.default_rng(seed)
    px = np.rint(make_crops(size, batch, rng,
                            load_demo_images(2 * size))).astype(np.uint8)
    boxes = draw_rect_boxes(torch.Generator().manual_seed(seed), batch, size)
    return px, [b.numpy() for b in boxes]


def step_inputs(ref):
    """(x in [-1, 1], image01, hole) of the reference's pixels and boxes,
    numpy float32 NHWC."""
    from stitchax_torch.train.transref_trainer import rect_masks

    px = ref["pixels"].astype(np.float32)
    hole = rect_masks(*(torch.as_tensor(ref[f"box/{k}"])
                        for k in ("x0", "y0", "w", "h")),
                      int(ref["size"])).numpy()
    return (px / np.float32(127.5) - np.float32(1.0),
            px / np.float32(255.0), hole)


# ------------------------------ stitchax's side ------------------------------

def stitchax_steps(trees, context, unet_kw, vae_kw, x, image01, hole, seed):
    """stitchax's jitted VAE step and diffusion step from `trees` (the
    diffusion step with the VAE before its step), each Adam chained after
    a transformation that keeps the raw gradients; the diffusion step's
    key is PRNGKey(seed). Returns (metrics, raw gradients, params after
    Adam) flat by key string, and the t and eps the step drew (eps NHWC)."""
    import jax
    import jax.numpy as jnp
    import optax

    from stitchax.models.diffusion import (ControlNet, UNet2DCondition,
                                           UNetConfig)
    from stitchax.models.vae import AutoencoderKL
    from stitchax.train.sd_inpaint_trainer import (make_diffusion_train_step,
                                                   make_vae_train_step)

    J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    cfg = UNetConfig(**unet_kw)
    unet, cnet, vae = (UNet2DCondition(cfg), ControlNet(cfg),
                       AutoencoderKL(**vae_kw))
    tree = lambda t: jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                            t)
    metrics, grads, updated = {}, {}, {}

    params = {"unet": J(trees["unet"]), "controlnet": J(trees["controlnet"])}
    tx = optax.chain(keep, optax.adam(LR))
    dstep = jax.jit(make_diffusion_train_step(unet, cnet, vae, tx,
                                              jnp.asarray(context)))
    key = jax.random.PRNGKey(seed)
    new, opt, dm = dstep(params, tx.init(params), J(trees["vae"]),
                         jnp.asarray(image01), jnp.asarray(hole), key)
    metrics["mse"] = float(dm["mse"])
    grads.update(_flat(tree(opt[0])))
    updated.update(_flat(tree(new)))

    B, S = x.shape[0], x.shape[1]

    @jax.jit
    def draws(k):          # the step's own draws (sd_inpaint_trainer.py:94)
        k_t, k_eps = jax.random.split(k)
        return (jax.random.randint(k_t, (B,), 1, 1000),
                jax.random.normal(k_eps, (B, S // 8, S // 8, 4),
                                  jnp.float32))

    t, eps = (np.asarray(a) for a in draws(key))

    tx_v = optax.chain(keep, optax.adam(LR_VAE))
    vstep = jax.jit(make_vae_train_step(vae, tx_v))
    vae_vars = J(trees["vae"])
    new_v, opt_v, vm = vstep(vae_vars, tx_v.init(vae_vars), jnp.asarray(x))
    metrics.update({f"vae_{k}": float(v) for k, v in vm.items()})
    grads.update(_flat(tree({"vae": opt_v[0]})))
    updated.update(_flat(tree({"vae": new_v})))
    return metrics, grads, updated, t, eps


def reference(kind):
    """stitchax's two steps as the references keep them: the size, the
    pixels and boxes, t and eps, the metrics, each step's global and
    every leaf's gradient norm, the KEPT leaves' gradients and values
    after Adam; all the gradients under "all_grads" (not saved)."""
    from held_to_stitchax import global_norm, step_reference

    if kind == "small":
        (unet_kw, vae_kw), (trees, context) = configs(SMALL_W), small_trees()
        size, batch = SMALL, SMALL_BATCH
    else:
        (unet_kw, vae_kw), (trees, context) = configs(48), full_trees()
        size, batch = FULL, FULL_BATCH
    px, boxes = crops(size, batch)
    out = {"size": np.int32(size), "pixels": px,
           **{f"box/{k}": b for k, b in zip(("x0", "y0", "w", "h"), boxes)}}
    x, image01, hole = step_inputs(out)
    metrics, grads, updated, t, eps = stitchax_steps(
        trees, context, unet_kw, vae_kw, x, image01, hole, DATA_SEED)
    out.update(t=t, eps=eps)
    metrics.update({n: global_norm(grads, p) for n, p in NORMS.items()})
    out.update(step_reference(metrics, grads, updated, KEPT))
    out["all_grads"] = grads
    return out


def write_reference():
    """Both references (the small one ~0.1 MB, the full one ~0.7 MB; ~1
    min and ~3 GiB on the CPU)."""
    paths = []
    for path, kind in ((SMALL_REFERENCE, "small"), (REFERENCE, "full")):
        out = reference(kind)
        out.pop("all_grads")
        np.savez_compressed(path, **out)
        paths.append(path)
    return paths


# -------------------------------- the port's ---------------------------------

def port_steps(ref, trees, context, unet_kw, vae_kw, device="cpu"):
    """The port's diffusion step and then its VAE step from `trees` on the
    reference's inputs, t and eps: (metrics, raw gradients, tensors after
    Adam), flat by stitchax's key strings."""
    from held_to_stitchax import global_norm
    from stitchax_torch.train.optim import apply_updates
    from stitchax_torch.train.sd_inpaint_trainer import (
        create_train_state, make_diffusion_train_step, make_vae_train_step)
    from stitchax_torch.train.trainer import stitchax_tree

    nets = {k: load_jax_params(m, trees[k]).to(device)
            for k, m in port_nets(unet_kw, vae_kw).items()}
    dev = lambda a: torch.tensor(a, device=device)
    x, image01, hole = (dev(a) for a in step_inputs(ref))
    t = dev(ref["t"].astype(np.int64))
    eps = dev(ref["eps"]).permute(0, 3, 1, 2)
    metrics, grads, updated = {}, {}, {}
    flat = lambda d: _flat(stitchax_tree(d))

    state, tx = create_train_state({k: nets[k] for k in ("unet",
                                                         "controlnet")}, LR)
    step = make_diffusion_train_step(nets["unet"], nets["controlnet"],
                                     nets["vae"], tx, dev(context))
    m, g = step.loss_and_grads(state, image01, hole, t, eps)
    metrics["mse"] = float(m["mse"])
    grads.update(flat(g))
    apply_updates(state.params, tx.update(g, state.opt_state)[0])
    updated.update(flat(state.params))

    state, tx = create_train_state({"vae": nets["vae"]}, LR_VAE)
    vstep = make_vae_train_step(nets["vae"], tx)
    m, g = vstep.loss_and_grads(state, x)
    metrics.update({f"vae_{k}": float(v) for k, v in m.items()})
    grads.update(flat(g))
    apply_updates(state.params, tx.update(g, state.opt_state)[0])
    updated.update(flat(state.params))
    metrics.update({n: global_norm(grads, p) for n, p in NORMS.items()})
    return metrics, grads, updated


def _load(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def small_steps():
    """(stitchax's committed small steps, the port's, the start)."""
    ref = _load(SMALL_REFERENCE)
    trees, context = small_trees()
    return ref, port_steps(ref, trees, context, *configs(SMALL_W)), trees


def readings(got, grads, ref, kind):
    """`held_to_stitchax.step_readings` of the port's two steps, each leaf
    floored by its own step's norm; each step has LEAVES[kind] leaves."""
    from held_to_stitchax import step_readings

    r = step_readings(got, grads, ref, NORMS)
    for s, n in LEAVES[kind].items():
        assert sum(_step_of(k) == s for k in r["leaf_norm_rel"]) == n, s
    return r


def check_metrics(r, tol):
    for k, e in r["metric_rel"].items():
        lim = tol["grad_norm_rel" if k in NORMS else "loss_rel"]
        assert e <= lim, (k, e)


def check_updated(got, ref, start, tol):
    """The kept leaves after one Adam step, in units of their step's lr:
    every kept leaf moved; where stitchax's |g| > 1e-6 (100 Adam eps; the
    first step is ~lr sign(g) on both sides) each element within
    tol["where_g_large_lr"], elsewhere within 2 lr; the share off by more
    than 0.01 lr within tol["off_share"]. Returns (the worst element where
    |g| > 1e-6, the worst, the share), in lr."""
    from held_to_stitchax import adam_step

    u = adam_step(got, ref, start, {k: LR_VAE if _step_of(k) == "vae"
                                    else LR for k in KEPT})
    assert not u["unmoved"], u["unmoved"]
    assert u["g_large_lr"] <= tol["where_g_large_lr"], u["g_large_lr"]
    assert u["worst_lr"] <= 2.0 + 1e-3, u["worst_lr"]
    assert u["off_share"] <= tol["off_share"], u["off_share"]
    return u["g_large_lr"], u["worst_lr"], u["off_share"]


# readings at the small size on this CPU: the losses 1.3e-7 relative (the
# VAE's l2), the grad norms 2.0e-6 (the VAE's), per-leaf gradient norms
# 3.4e-4 (the VAE mid attention's to_k bias, whose gradient is zero but
# for rounding: softmax ignores a key bias), the kept leaves' relative L2
# error 7.6e-6; after Adam 7.5e-5 lr where |g| > 1e-6, no element off by
# more than 0.01 lr. Limits ~10x
SMALL_TOL = {"loss_rel": 2e-6, "grad_norm_rel": 2e-5, "leaf_norm_rel": 4e-3,
             "leaf_l2_rel": 1e-4}
UPDATE_TOL = {"where_g_large_lr": 1e-3, "off_share": 1e-3}


def test_small_steps_losses_and_grad_norms(small_steps):
    ref, (got, grads, _), _ = small_steps
    check_metrics(readings(got, grads, ref, "small"), SMALL_TOL)


def test_small_steps_gradients_match(small_steps):
    """Every leaf's gradient norm, and the kept leaves' whole gradients."""
    ref, (got, grads, _), _ = small_steps
    r = readings(got, grads, ref, "small")
    worst = r["leaf_norm_worst"]
    assert r["leaf_norm_rel"][worst] <= SMALL_TOL["leaf_norm_rel"], (
        worst, r["leaf_norm_rel"][worst])
    for k, e in r["leaf_l2_rel"].items():
        assert e <= SMALL_TOL["leaf_l2_rel"], (k, e)


def test_small_steps_adam_update_matches(small_steps):
    ref, (_, _, updated), trees = small_steps
    check_updated(updated, ref, _flat(trees), UPDATE_TOL)


@pytest.mark.slow
def test_small_steps_live_match_stitchax():
    """The committed small reference regenerated live (stitchax's jitted
    steps), and every leaf's whole gradient held to it: relative L2
    within 1e-2 of the leaf's norm plus its step's floor."""
    ref = reference("small")
    saved = _load(SMALL_REFERENCE)
    for k in saved:
        np.testing.assert_allclose(saved[k], ref[k], rtol=1e-6, atol=1e-12,
                                   err_msg=k)
    from held_to_stitchax import l2_rel

    trees, context = small_trees()
    got, grads, _ = port_steps(ref, trees, context, *configs(SMALL_W))
    check_metrics(readings(got, grads, ref, "small"), SMALL_TOL)
    floor = {s: 1e-6 * float(ref[f"metric/{s}_grad_norm"])
             for s in ("vae", "diffusion")}
    err = {k: l2_rel(grads[k], g, floor[_step_of(k)])
           for k, g in ref["all_grads"].items()}
    worst = max(err, key=err.get)
    print(worst, err[worst])
    assert err[worst] <= 1e-2, (worst, err[worst])


# the full-size steps on the CPU against the committed reference that the
# card's smoke holds its steps to (chip_smoke.py SD_TRAIN_STITCHAX_TOL).
# Readings on this CPU (the test prints them): the losses 1.1e-6 relative
# (the VAE's l2), the grad norms 5.7e-6 (the diffusion step's), per-leaf
# norms 8.7e-5, the kept leaves 5.0e-5; after Adam 4.5e-4 lr where
# |g| > 1e-6, 1 of 29383 elements off by more than 0.01 lr
FULL_TOL = {"loss_rel": 1e-5, "grad_norm_rel": 6e-5, "leaf_norm_rel": 1e-3,
            "leaf_l2_rel": 5e-4}
FULL_UPDATE_TOL = {"where_g_large_lr": 5e-3, "off_share": 1e-3}


@pytest.mark.slow
def test_full_size_steps_match_the_reference():
    """The port's two steps from the committed checkpoint at 128^2, batch
    8, on the CPU (~10 s)."""
    ref = _load(REFERENCE)
    trees, context = full_trees()
    got, grads, updated = port_steps(ref, trees, context, *configs(48))
    r = readings(got, grads, ref, "full")
    norm, l2 = max(r["leaf_norm_rel"].values()), max(r["leaf_l2_rel"].values())
    print(got, norm, l2)
    check_metrics(r, FULL_TOL)
    assert norm <= FULL_TOL["leaf_norm_rel"]
    assert l2 <= FULL_TOL["leaf_l2_rel"]
    print(check_updated(updated, ref, _flat(trees), FULL_UPDATE_TOL))


# --------------------------- the model inputs --------------------------------

def test_inpaint_model_inputs_equal_stitchax(rng):
    """z0, the masked latents, the mask latent and the control image of a
    small VAE at 48x64 against stitchax's (jitted), holes whose edges fall
    where jax's nearest rule (source pixel 8i + 4) and torch's (8i)
    differ: the mask latent and the control image equal, the latents
    within 1e-5 of their scale (reading ~1e-6)."""
    import jax
    import jax.numpy as jnp
    import torch.nn.functional as F

    from stitchax.models.vae import AutoencoderKL as JVae
    from stitchax.train.sd_inpaint_trainer import (
        inpaint_model_inputs as j_inputs)
    from stitchax_torch.models.vae import AutoencoderKL
    from stitchax_torch.train.sd_inpaint_trainer import inpaint_model_inputs

    _, vae_kw = configs(SMALL_W)
    trees, _ = small_trees()
    image01 = rng.uniform(0, 1, (2, 48, 64, 3)).astype(np.float32)
    hole = np.zeros((2, 48, 64, 1), np.float32)
    hole[0, 2:30, 6:21] = 1      # rows 0..3 of the latent: 8i + 4 in, 8i not
    hole[1, 13:44, 37:62] = 1
    want = jax.jit(lambda v, a, b: j_inputs(JVae(**vae_kw), v, a, b))(
        jax.tree_util.tree_map(jnp.asarray, trees["vae"]),
        jnp.asarray(image01), jnp.asarray(hole))
    vae = load_jax_params(AutoencoderKL(**vae_kw), trees["vae"])
    with torch.no_grad():
        got = inpaint_model_inputs(vae, torch.from_numpy(image01),
                                   torch.from_numpy(hole))
    got = [g.permute(0, 2, 3, 1).numpy() for g in got]
    for g, w in zip(got[:2], want[:2]):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
    assert np.array_equal(got[2], np.asarray(want[2]))
    assert np.array_equal(got[3], np.asarray(want[3]))
    torch_nearest = F.interpolate(torch.from_numpy(hole).permute(0, 3, 1, 2),
                                  size=(6, 8), mode="nearest")
    assert not np.array_equal(torch_nearest.permute(0, 2, 3, 1).numpy(),
                              got[2])


def test_sd_alphas_cumprod_is_stitchax_schedule():
    """The carried 1000-step schedule equals stitchax's sd_alphas_cumprod
    (its jnp.cumprod) bit for bit."""
    from stitchax.train.sd_inpaint_trainer import sd_alphas_cumprod as j_acp
    from stitchax_torch.train.sd_inpaint_trainer import sd_alphas_cumprod

    np.testing.assert_array_equal(sd_alphas_cumprod(), np.asarray(j_acp()))


def test_drawn_timesteps_and_noise():
    """The port's draws: t in [1, 1000), eps standard normal in the latent
    shape; the same seed, the same draws."""
    from stitchax_torch.train.sd_inpaint_trainer import draw_t_eps

    a = draw_t_eps(torch.Generator().manual_seed(4), 4000, (4, 2, 2))
    b = draw_t_eps(torch.Generator().manual_seed(4), 4000, (4, 2, 2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    t, eps = a
    assert t.dtype == torch.int64 and int(t.min()) == 1
    assert int(t.max()) == 999
    assert eps.shape == (4000, 4, 2, 2) and abs(float(eps.std()) - 1) < 0.02


# ------------------------------- the checkpoint ------------------------------

def test_checkpoint_is_stitchax_container(tmp_path):
    """The committed checkpoint (written by stitchax's
    save_jax_sd_checkpoint) loaded into the port's nets and saved by
    save_sd_checkpoint gives stitchax's container back: the format, the
    configs, every leaf of the three trees (key, shape, dtype, value), the
    context and the preferred strength; the port's load_sd_models and
    stitchax's load_sd_checkpoint both read it."""
    from stitchax.models.sd_pipeline import load_sd_checkpoint as j_load
    from stitchax_torch import convert
    from stitchax_torch.models.sd_pipeline import load_sd_models
    from stitchax_torch.train.sd_inpaint_trainer import save_sd_checkpoint

    blob = convert.load_sd_container(SD_CKPT)
    configs = blob["configs"]
    nets = {k: load_jax_params(m, blob[f"{k}_vars"]) for k, m in
            port_nets(configs["unet"], configs["vae"]).items()}
    path = str(tmp_path / "sd.pt")
    save_sd_checkpoint(path, nets["unet"], nets["controlnet"], nets["vae"],
                       torch.from_numpy(blob["context"]), configs["unet"],
                       configs["vae"], blob["preferred_strength"])
    saved = torch.load(path, weights_only=False)
    assert sorted(saved) == sorted(blob)
    assert saved["format"] == "stitchax_jax" and saved["configs"] == configs
    assert saved["preferred_strength"] == blob["preferred_strength"]
    for key in ("unet_vars", "controlnet_vars", "vae_vars"):
        got, want = _flat_raw(saved[key]), _flat_raw(blob[key])
        assert sorted(got) == sorted(want), key
        for k, v in want.items():
            assert got[k].dtype == v.dtype == np.float32, k
            assert got[k].shape == v.shape and np.array_equal(got[k], v), k
    assert np.array_equal(saved["context"], blob["context"])
    models = load_sd_models(path, device="cpu")
    assert models.preferred_strength == blob["preferred_strength"]
    assert callable(j_load(path, num_steps=2))


def _flat_raw(tree):
    """{key string: leaf as stored}."""
    from stitchax_torch.convert import _flatten, _keystr
    return {_keystr(p): a for p, a in _flatten(tree)}


@pytest.mark.slow
def test_checkpoint_inpaints_as_stitchax(rng, tmp_path):
    """save_sd_checkpoint of the small stack: the port's load_sd_models
    gives every net its tensors back, equal; stitchax's load_sd_checkpoint
    reads it, and its jitted 2-step DDIM inpaint at strength 0.5 (the
    preferred one) agrees with the port's within 1e-3 of 255 (reading
    ~2e-5; ~10 s, the jit)."""
    import jax
    import jax.numpy as jnp

    from stitchax.models.sd_pipeline import load_sd_checkpoint as j_load
    from stitchax_torch.models.sd_pipeline import (load_sd_checkpoint,
                                                   load_sd_models)
    from stitchax_torch.train.sd_inpaint_trainer import save_sd_checkpoint

    unet_kw, vae_kw = configs(SMALL_W)
    trees, context = small_trees()
    nets = {k: load_jax_params(m, trees[k])
            for k, m in port_nets(unet_kw, vae_kw).items()}
    path = str(tmp_path / "sd.pt")
    save_sd_checkpoint(path, nets["unet"], nets["controlnet"], nets["vae"],
                       torch.from_numpy(context), unet_kw, vae_kw,
                       preferred_strength=0.5)
    models = load_sd_models(path, device="cpu")
    for k, m in (("unet", models.unet), ("controlnet", models.controlnet),
                 ("vae", models.vae)):
        sd = nets[k].state_dict()
        assert all(torch.equal(v, sd[n]) for n, v in m.state_dict().items())
    assert torch.equal(models.context, torch.from_numpy(context))
    assert models.preferred_strength == 0.5
    img = rng.uniform(0, 255, (SMALL, SMALL, 3)).astype(np.float32)
    mask = np.zeros((SMALL, SMALL, 1), np.float32)
    mask[6:21, 9:27] = 1
    want = np.asarray(jax.jit(j_load(path, num_steps=2))(
        jnp.asarray(img), jnp.asarray(mask)))
    got = load_sd_checkpoint(path, num_steps=2, device="cpu")(
        torch.from_numpy(img), torch.from_numpy(mask)).numpy()
    print(np.abs(got - want).max())
    assert np.abs(got - want).max() <= 1e-3 * 255
    assert np.abs(got[6:21, 9:27] - img[6:21, 9:27]).mean() > 1.0


# ------------------------------------ CLI ------------------------------------

CLI_SMALL = ["--device", "cpu", "--size", str(SMALL), "--width",
             str(SMALL_W), "--steps_vae", "2", "--steps", "2", "--n_train",
             "4", "--n_eval", "1", "--eval_ddim_steps", "2"]


def test_cli_writes_result_checkpoints_and_panel(tmp_path):
    """The CLI at 32^2, w = 8 on the CPU writes result.json with the tool's
    keys, both checkpoints (stitchax_jax containers the port loads) and
    the panel; --init_ckpt resumes from its own checkpoint with --steps_vae
    0 (the restored VAE and context kept: its step-0 PSNR is the saved
    stack's)."""
    from stitchax_torch.io import jpeg
    from stitchax_torch.models.sd_pipeline import load_sd_models
    from stitchax_torch.train_sd_inpaint.__main__ import main

    a = tmp_path / "a"
    assert main([*CLI_SMALL, "--save_ckpt", "--out", str(a)]) == 0
    res = json.loads((a / "result.json").read_text())
    assert sorted(res) == sorted([
        "steps", "steps_vae", "size", "width", "batch", "lr", "params_m",
        "vae_recon_psnr", "mse_first50", "mse_last50", "psnr_step0",
        "init_is_resumed", "psnr_push_pull", "psnr_trained",
        "psnr_refine_best", "eval_strength", "eval_ddim_steps", "history",
        "checks", "cli"])
    assert sorted(res["checks"]) == sorted([
        "diffusion_loss_decreases", "beats_random_pack",
        "beats_push_pull_fallback", "refine_beats_push_pull"])
    assert [h["step"] for h in res["history"]] == [2]
    assert all(np.isfinite(res[k]) for k in ("mse_first50", "psnr_trained",
                                             "vae_recon_psnr"))
    panel = jpeg.read_rgb(str(a / "panel_final.jpg"))
    assert panel.shape == (SMALL, 4 * SMALL, 3)
    for name in ("sd_ckpt.pt", "sd_ckpt_best.pt"):
        models = load_sd_models(str(a / name), device="cpu")
        assert models.unet.cfg.block_channels == (SMALL_W, 2 * SMALL_W)
    best = torch.load(a / "sd_ckpt_best.pt", weights_only=False)
    assert best["preferred_strength"] == 0.35

    b = tmp_path / "b"
    assert main([*CLI_SMALL, "--steps_vae", "0", "--init_ckpt",
                 str(a / "sd_ckpt.pt"), "--out", str(b)]) == 0
    resumed = json.loads((b / "result.json").read_text())
    assert resumed["init_is_resumed"] is True
    assert resumed["checks"]["beats_random_pack"] is None
    assert resumed["psnr_step0"] == round(res["history"][-1]["hole_psnr"], 2)


def test_cli_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    from stitchax_torch.train_sd_inpaint.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--out", str(tmp_path)])


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_sd_train.py --write")
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    print(write_reference())
