"""The port's MAE pretrain path (FlowFormerPretrain and its parts) against
stitchax's, on the CPU.

The same weights and noise go through both packages: `random_masking`'s ids
and masks, `GroupAttnRPEContext`, the perceiver's pretrain forward, and the
whole pretrain loss with its gradient. The weights of the whole model are
results/ckpt_r05_bf16.npz's FlowFormer++ leaves (the perceiver cut to the
depth at hand) with a pretrain head drawn from a numpy seed
(`convert.pretrain_variables`); the parts take flax's initializers. The
masking and query noise are uniforms quantized to 16 bits, so that they
are the same float32 values wherever they are read. Tolerances are stated
where they are used: readings of this file with ~10x headroom.

    python tests/test_torch_pretrain.py --write

runs stitchax's jitted loss and gradient on the CPU and writes
tests/torch_reference/pretrain_stitchax_small.npz (128^2, batch 2,
encoder_depth 1, query_num 2), which the tier-1 test holds the port to,
and pretrain_stitchax_fp32.npz (368x496, batch 2, the shipped widths:
encoder_depth 3, K = 8, query_num 30, gt_r 15, mask_ratio 0.5), which the
card's smoke (`pretrain_vs_stitchax`) holds the port's step to.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "results", "ckpt_r05_bf16.npz")
SMALL_REFERENCE = os.path.join(REPO, "tests", "torch_reference",
                               "pretrain_stitchax_small.npz")
REFERENCE = os.path.join(REPO, "tests", "torch_reference",
                         "pretrain_stitchax_fp32.npz")
SMALL = dict(hw=(128, 128), batch=2, encoder_depth=1, query_num=2)
FULL = dict(hw=(368, 496), batch=2, encoder_depth=3, query_num=30)
HEAD_SEED = 0
# the leaves whose gradients the references keep whole
CHOSEN = (
    "['params']['memory_decoder']['pretrain_head2']['kernel']",
    "['params']['memory_decoder']['pretrain_head0']['bias']",
    "['params']['memory_decoder']['memory_k']['kernel']",
    "['params']['memory_decoder']['iteration']['flow_token_enc1']['kernel']",
    "['params']['memory_encoder']['cost_perceiver']['latent_tokens']",
    "['params']['memory_encoder']['cost_perceiver']['patch_embed']['proj0']"
    "['kernel']",
    "['params']['context_encoder']['block1_1']['attn']['kv']['bias']")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    from stitchax_torch.convert import _flatten, _keystr
    return {_keystr(p): np.asarray(a, np.float32) for p, a in _flatten(tree)}


def _uniform16(rng, shape):
    """Uniforms in (0, 1) on a 2^-16 grid: (k + 0.5) / 65536, exact in
    float32 and the same float32 values in both packages."""
    k = rng.integers(0, 1 << 16, shape, dtype=np.uint16)
    return ((k.astype(np.float32) + 0.5) / 65536.0).astype(np.float32)


def textured_pair(rng, batch, hw):
    """`batch` uint8 pairs: a smooth random texture and a copy shifted by a
    few pixels with noise, (B, H, W, 3) each."""
    H, W = hw
    tex = np.zeros((batch, H + 16, W + 16, 3), np.float32)
    for cell, amp in ((32, 90.0), (8, 40.0), (2, 15.0)):
        g = rng.standard_normal((batch, (H + 16) // cell + 1,
                                 (W + 16) // cell + 1, 3))
        up = np.kron(g, np.ones((1, cell, cell, 1)))
        tex += amp * up[:, :H + 16, :W + 16]
    tex = np.clip(tex + 128.0, 0, 255)
    img1 = tex[:, 8:8 + H, 8:8 + W]
    img2 = tex[:, 5:5 + H, 11:11 + W] + rng.normal(0, 3, (batch, H, W, 3))
    return (np.round(img1).astype(np.uint8),
            np.clip(np.round(img2), 0, 255).astype(np.uint8))


def pretrain_inputs(spec, seed=0):
    """{img1, img2 (uint8), noise (B*H1*W1, L), query_noise (Q, B, H1, W1,
    2)} for a size spec."""
    rng = np.random.default_rng(seed)
    H, W = spec["hw"]
    B = spec["batch"]
    img1, img2 = textured_pair(rng, B, (H, W))
    H1, W1 = H // 8, W // 8
    L = (-(-H1 // 8)) * (-(-W1 // 8))
    return {"img1": img1, "img2": img2,
            "noise": _uniform16(rng, (B * H1 * W1, L)),
            "query_noise": _uniform16(rng, (spec["query_num"], B, H1, W1, 2))}


def pretrain_tree(spec):
    from stitchax_torch.convert import load_npz, pretrain_variables
    from stitchax_torch.models.flowformer import FlowFormerConfig
    return pretrain_variables(
        load_npz(CKPT, "flow"),
        FlowFormerConfig(encoder_depth=spec["encoder_depth"]),
        seed=HEAD_SEED)


# ------------------------------ stitchax's side ------------------------------

def stitchax_loss_and_grads(variables, spec, inputs):
    """stitchax's jitted pretrain loss and its gradient (flat by key
    string)."""
    import jax
    import jax.numpy as jnp

    from stitchax.models.flowformer import FlowFormerConfig, FlowFormerPretrain

    model = FlowFormerPretrain(FlowFormerConfig(
        encoder_depth=spec["encoder_depth"], query_num=spec["query_num"]))
    args = [jnp.asarray(inputs[k], jnp.float32)
            for k in ("img1", "img2", "noise", "query_noise")]
    fn = jax.jit(jax.value_and_grad(
        lambda p: model.apply({"params": p}, *args)))
    loss, grads = fn(jax.tree_util.tree_map(jnp.asarray,
                                            variables["params"]))
    grads = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), grads)
    return float(loss), _flat({"params": grads})


# -------------------------------- the port's ---------------------------------

def port_loss_and_grads(variables, spec, inputs, device="cpu"):
    """The port's loss and gradient from the same variables, flat by
    stitchax's key strings."""
    from stitchax_torch.convert import load_jax_params, params_to_jax
    from stitchax_torch.models.flowformer import (FlowFormerConfig,
                                                  FlowFormerPretrain)

    model = load_jax_params(FlowFormerPretrain(FlowFormerConfig(
        encoder_depth=spec["encoder_depth"], query_num=spec["query_num"])),
        variables).to(device)
    args = [torch.as_tensor(np.asarray(inputs[k], np.float32), device=device)
            for k in ("img1", "img2", "noise", "query_noise")]
    loss = model(*args)
    loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters()}
    return float(loss.detach()), _flat(params_to_jax(grads))


def _summary(loss, grads, inputs):
    out = {k: np.asarray(v) for k, v in inputs.items()}
    out["loss"] = np.float64(loss)
    names = sorted(grads)
    out["leaf_names"] = np.array(names)
    out["leaf_norms"] = np.array([np.linalg.norm(grads[k].astype(np.float64))
                                  for k in names])
    for k in CHOSEN:
        out["grad/" + k] = grads[k]
    return out


@pytest.fixture(scope="module")
def small():
    with np.load(SMALL_REFERENCE) as ref:
        ref = {k: ref[k] for k in ref.files}
    return ref, port_loss_and_grads(pretrain_tree(SMALL), SMALL, ref)


# readings (this file, two torch threads): loss 1.3e-6 relative, leaf norms
# 2.1e-4 relative at worst and the kept leaves 3.9e-4 of their max |g|, both
# at the cost maps' first patch-embedding conv (the other kept leaves below
# 5e-6)


def test_small_pretrain_loss_matches_stitchax(small):
    ref, (loss, _) = small
    assert abs(loss - float(ref["loss"])) <= 1e-5 * abs(float(ref["loss"]))


def test_small_pretrain_gradient_norms_match_stitchax(small):
    """Every leaf's gradient norm, relative to the leaf's (leaves whose
    norm is below 1e-6 of the largest, by the largest)."""
    ref, (_, grads) = small
    names = list(ref["leaf_names"])
    assert sorted(grads) == names
    want = ref["leaf_norms"]
    got = np.array([np.linalg.norm(grads[k].astype(np.float64))
                    for k in names])
    scale = np.maximum(want, 1e-6 * want.max())
    worst = np.max(np.abs(got - want) / scale)
    assert worst <= 2e-3, names[int(np.argmax(np.abs(got - want) / scale))]


def test_small_pretrain_kept_gradients_match_stitchax(small):
    ref, (_, grads) = small
    for k in CHOSEN:
        want = ref["grad/" + k]
        err = np.abs(grads[k] - want).max()
        assert err <= 4e-3 * np.abs(want).max(), k


def test_random_masking_ids_and_masks_equal_stitchax(rng):
    import jax.numpy as jnp

    from stitchax.models import flowformer as jff
    from stitchax_torch.models.flowformer import random_masking

    # 20 x 28 pads to 24 x 32: 3 x 4 patches; ties in the noise keep
    # their order in both (stable sorts)
    B, H2, W2 = 6, 20, 28
    noise = np.round(rng.uniform(0, 1, (B, 12)) * 8).astype(np.float32) / 8
    want = jff.random_masking(jnp.asarray(noise), H2, W2, 8, 0.5)
    got = random_masking(torch.from_numpy(noise), H2, W2, 8, 0.5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_group_attn_rpe_context_matches_stitchax(rng):
    import jax
    import jax.numpy as jnp

    from stitchax.models.twins import GroupAttnRPEContext as JGroup
    from stitchax_torch.convert import load_jax_params
    from stitchax_torch.models.twins import GroupAttnRPEContext

    # 5 groups of 2 samples, a context per sample; 10 x 9 pads to 14 x 14
    x = rng.standard_normal((10, 10, 9, 128)).astype(np.float32)
    ctx = rng.standard_normal((2, 10, 9, 256)).astype(np.float32)
    jm = JGroup(128, 8, ws=7, vert_c_dim=64)
    variables = jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                         jnp.asarray(ctx)))
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x),
                                        jnp.asarray(ctx)))
    tm = load_jax_params(GroupAttnRPEContext(128, 8, 7, 64), variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(ctx)).numpy()
    # read 5.6e-7 of the output's range
    assert np.abs(got - want).max() <= 5e-6 * np.abs(want).max()


def test_cost_perceiver_pretrain_matches_stitchax(rng):
    import jax
    import jax.numpy as jnp

    from stitchax.models import flowformer as jff
    from stitchax_torch.convert import load_jax_params
    from stitchax_torch.models import flowformer as tff

    B, H1, W1, H2, W2 = 1, 4, 5, 20, 12
    cv = rng.standard_normal((B, H1, W1, H2, W2, 1)).astype(np.float32)
    ctx = rng.standard_normal((B, H1, W1, 256)).astype(np.float32)
    noise = rng.uniform(0, 1, (B * H1 * W1, 6)).astype(np.float32)
    jm = jff.CostPerceiverEncoder(jff.FlowFormerConfig(encoder_depth=1))
    variables = jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(cv),
                         jnp.asarray(ctx)))
    want, _, _ = jax.jit(lambda v, a, b, n: jm.apply(
        v, a, b, n, method=jff.CostPerceiverEncoder.pretrain))(
        variables, jnp.asarray(cv), jnp.asarray(ctx), jnp.asarray(noise))
    tm = load_jax_params(tff.CostPerceiverEncoder(
        tff.FlowFormerConfig(encoder_depth=1)), variables)
    with torch.no_grad():
        got = tm.pretrain(torch.from_numpy(cv), torch.from_numpy(ctx),
                          torch.from_numpy(noise))
    want = np.asarray(want)
    assert got.shape == want.shape
    # read 4.5e-7 of the output's range
    assert np.abs(got.numpy() - want).max() <= 5e-6 * np.abs(want).max()


def test_pretrain_tree_loads_into_both_models():
    """One pretrain tree fills FlowFormerPretrain, and its shared leaves are
    FlowFormer's (the same names and shapes)."""
    from stitchax_torch.convert import load_jax_params, load_npz
    from stitchax_torch.models.flowformer import (FlowFormer,
                                                  FlowFormerConfig,
                                                  FlowFormerPretrain)

    tree = pretrain_tree(FULL)
    pre = load_jax_params(FlowFormerPretrain(FlowFormerConfig()), tree)
    flow = load_jax_params(FlowFormer(), load_npz(CKPT, "flow"))
    fsd = flow.state_dict()
    shared = [k for k in pre.state_dict() if "pretrain_head" not in k]
    assert len(shared) > 350
    for k in shared:
        assert torch.equal(pre.state_dict()[k], fsd[k]), k


@pytest.mark.slow
def test_small_pretrain_live_matches_stitchax():
    """The small reference regenerated live: stitchax's jitted loss and
    gradient against the port's (~1 min)."""
    inputs = pretrain_inputs(SMALL)
    tree = pretrain_tree(SMALL)
    want_loss, want = stitchax_loss_and_grads(tree, SMALL, inputs)
    loss, got = port_loss_and_grads(tree, SMALL, inputs)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    # leaves whose gradient is zero in exact arithmetic (a key bias under
    # softmax) by the largest |g| of all, as the norms above
    top = max(np.abs(w).max() for w in want.values())
    for k in want:
        err = np.abs(got[k] - want[k]).max()
        assert err <= 4e-3 * max(np.abs(want[k]).max(), 1e-6 * top), k


def write_reference():
    """Both references (~0.2 MB and ~2.7 MB): the inputs, the loss, every
    leaf's gradient norm and the CHOSEN leaves' gradients."""
    out = {}
    for spec, path in ((SMALL, SMALL_REFERENCE), (FULL, REFERENCE)):
        inputs = pretrain_inputs(spec)
        loss, grads = stitchax_loss_and_grads(pretrain_tree(spec), spec,
                                              inputs)
        np.savez_compressed(path, **_summary(loss, grads, inputs))
        out[os.path.basename(path)] = loss
    return out


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_pretrain.py --write")
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    print(write_reference())
