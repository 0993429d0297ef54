"""The traffic generator and the window's arithmetic on the CPU."""

import time

import numpy as np
import pytest
import torch

from portbench.harness import Window
from portbench.tests.small import ROOT, overrides
from portbench.traffic import homographies, make_pairs

MIX = overrides("eval.ffpp_udis2.b12")["traffic"]


def test_pairs_are_deterministic_per_seed():
    a1, a2 = make_pairs(MIX, 2 ** 31 + 77, 3, "cpu")
    b1, b2 = make_pairs(MIX, 2 ** 31 + 77, 3, "cpu")
    c1, _ = make_pairs(MIX, 2 ** 31 + 78, 3, "cpu")
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    assert not torch.equal(a1, c1)
    assert a1.shape == (3, 128, 128, 3) and a1.dtype == torch.float32
    assert torch.equal(a1, torch.round(a1)) and a1.min() >= 0 and a1.max() <= 255


def test_homographies_stay_in_the_mix_ranges():
    H, W = 512, 512
    m = MIX["pairs"]
    hs = homographies(m, 200, (H, W), np.random.default_rng(1), m["margin"])
    centre = hs @ np.array([W / 2, H / 2, 1.0])
    centre = centre[:, :2] / centre[:, 2:]
    shift = (centre[:, 0] - m["margin"] - W / 2) / W
    assert shift.min() >= m["shift_frac"][0] - 1e-9
    assert shift.max() <= m["shift_frac"][1] + 1e-9
    assert shift.max() - shift.min() > 0.2          # the overlaps vary


def test_both_sides_get_the_same_pairs():
    from portbench.loops import eval as drv
    from portbench.harness import Context
    o = overrides("eval.ffpp_udis2.b12")
    ctx = Context(root=ROOT, cell={"name": "x"}, bench={}, config=o["config"],
                  traffic=o["traffic"], limits=o["limits"], seed=9,
                  seconds=0.0, trace=False, device=torch.device("cpu"),
                  t0=0.0)
    batches, img1, img2 = drv.pool(ctx)
    k, B = drv.sample_index(ctx), o["traffic"]["batch"]
    # the program is handed batches[k]; the reference img1/img2[kB:(k+1)B]
    assert np.array_equal(batches[k]["image1"], img1[k * B:(k + 1) * B].numpy())
    assert np.array_equal(batches[k]["image2"], img2[k * B:(k + 1) * B].numpy())
    assert drv.sample_index(ctx) == k


def test_rate_counts_the_item_in_flight_to_its_end():
    w = Window(0.05)
    w.open()
    n = 0
    while not n or w.is_open():
        time.sleep(0.03)              # an item that outlasts the window
        n += 1
    w.close()
    w.done(n * 4)
    assert w.elapsed >= 0.05                       # time to the last end
    assert w.rate == pytest.approx(n * 4 / w.elapsed)
    assert n == 2


def test_window_rate_divides_by_the_time_to_the_end():
    w = Window(10.0)
    w.start, w.end = 100.0, 112.5
    w.done(25)
    assert w.rate == 2.0
