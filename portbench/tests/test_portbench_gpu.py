"""On the card only (marker `gpu`; skips without one): the traced slice
keeps every kernel launch the program's counters see, at a small size.

    python3 -m pytest --noconftest -p no:cacheprovider -m gpu \
        portbench/tests/test_portbench_gpu.py
"""

import pytest
import torch


@pytest.mark.gpu
def test_the_profiled_slice_keeps_every_kernel_launch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from stitchax_torch.evaluate import make_eval_step
    from stitchax_torch.ops.kernels import library

    from portbench.loops import eval as drv
    from portbench.harness import Context, profiled_slice
    from portbench.tests.small import ROOT, overrides

    o = overrides("eval.ffpp_udis2.b12")
    dev = torch.device("cuda:0")
    ctx = Context(root=ROOT, cell={"name": "x"}, bench={}, config=o["config"],
                  traffic=o["traffic"], limits=o["limits"], seed=1,
                  seconds=0.0, trace=True, device=dev, t0=0.0)
    from stitchax_torch.align.adapter import AlignConfig
    step = make_eval_step(drv.program_models(ctx), AlignConfig())
    _, img1, img2 = drv.pool(ctx)
    step(img1[:2], img2[:2])
    sl = profiled_slice(lambda: step(img1[:2], img2[:2]), dev,
                        lambda: library.launches)
    for k in ("gsa_attention", "cost_lookup", "window_attention"):
        assert sl["launches"][k] > 0
        assert sl["kernel_count"][k] == sl["launches"][k], k
    assert 0 < sl["busy_s"] <= sl["window_s"]
