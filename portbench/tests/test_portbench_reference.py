"""The plain reference against the program's plain path on the CPU, at a
small size, for each cell's entry: the evaluation step
(`stitchax_torch.evaluate.make_eval_step`) and the alignment train step's
losses and gradient (`make_train_step(...).loss_and_grads`, whole batch)
against the reference's micro-batched ones. On the CPU the program's
kernel wrappers take their plain versions too, so the two agree to
float32 round-off."""

import numpy as np
import pytest
import torch

from portbench.tests.small import ROOT, overrides


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ctx(cell):
    from portbench.harness import Context
    o = overrides(cell)
    return Context(root=ROOT, cell={"name": cell}, bench={}, config=o["config"],
                   traffic=o["traffic"], limits=o["limits"], seed=3,
                   seconds=0.0, trace=False, device=torch.device("cpu"),
                   t0=0.0)


def test_reference_eval_matches_the_program_eval_step():
    from stitchax_torch.align.adapter import AlignConfig
    from stitchax_torch.evaluate import make_eval_step

    from portbench.loops import eval as drv

    ctx = _ctx("eval.ffpp_udis2.b12")
    _, img1, img2 = drv.pool(ctx)
    a, b = img1[:2], img2[:2]
    step = make_eval_step(drv.program_models(ctx), AlignConfig())
    warped, valid = (t.numpy() for t in step(a, b))
    r_warped, r_valid, _, _ = drv.reference_eval(ctx, a, b)
    assert np.array_equal(valid >= 1.0, r_valid >= 1.0)
    assert np.abs(warped - r_warped).max() < 1e-3


def test_reference_train_gradient_matches_the_program_step():
    from stitchax_torch.align.adapter import AlignConfig
    from stitchax_torch.train import LossConfig, make_train_step

    from portbench.loops import train as drv
    from portbench.reference.align import AlignConfig as RefAlign
    from portbench.reference.nets import build_nets, trained_params
    from portbench.reference.train import loss_and_grads
    from portbench.traffic import make_pairs

    ctx = _ctx("train.ffpp_udis2.b8")
    img1, img2 = make_pairs(ctx.traffic, 3, 2, ctx.device)
    state, _ = drv.program_step(ctx)
    homo_flow = {k.split(".")[0] for k in state.params}
    assert homo_flow == {"homo", "flow"}
    cfg = ctx.config
    from stitchax_torch.models.flowformer import FlowFormer, FlowFormerConfig
    from stitchax_torch.models.udis2 import UDIS2HomographyNet
    from stitchax_torch.train import create_train_state, OptimConfig
    from portbench.reference.nets import seeded_state

    sd = seeded_state(cfg)
    models = {"homo": UDIS2HomographyNet(input_size=cfg["image_size"]),
              "flow": FlowFormer(FlowFormerConfig(**cfg["flowformer"],
                                                  upsample_all=True))}
    for k, m in models.items():
        m.load_state_dict(sd[k])
    st, tx = create_train_state(models, OptimConfig())
    l = cfg["loss"]
    step = make_train_step(models["homo"], models["flow"], tx, AlignConfig(),
                           LossConfig(**l))
    losses, grads = step.loss_and_grads(st, img1, img2)

    nets = build_nets(cfg, ROOT, upsample_all=True)
    params = trained_params(nets)
    r_losses, r_grads = loss_and_grads(nets, params, img1, img2, RefAlign(),
                                       l, True, micro=1)
    assert abs(float(losses["total"]) - r_losses["total"]) < 1e-4 * abs(
        r_losses["total"])
    assert sorted(grads) == sorted(r_grads)
    med = np.median([float(g.norm()) for g in r_grads.values()])
    worst = max(float((grads[n] - r_grads[n]).norm()) / max(
        float(r_grads[n].norm()), med) for n in grads)
    assert worst < 1e-3
