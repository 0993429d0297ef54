"""The frozen yardstick against hand counts at one shape each: the
kernels' operations and bytes, the model FLOPs, the peaks, and the
trace's reduction and completeness check."""

import pytest
import torch

from portbench.harness import kernel_share
from portbench.yardstick import kernels, peaks
from portbench.yardstick.trace import gaps, reduce_events, union_s


def test_peaks_table():
    assert peaks.FLOPS["bfloat16"] == 989e12
    assert peaks.FLOPS["tf32"] == 495e12
    assert peaks.model_peak("float32") == pytest.approx(165e12)
    assert peaks.HBM_BYTES_PER_S == 3.35e12


def test_gsa_counts_by_hand():
    # B 2, N 16, M 4, C 8, 2 heads, fp32: q and out 2*16*8, k and v 2*4*8
    nb, nf, ne = kernels.gsa_counts(2, 16, 4, 8, 2, "float32")
    assert nb == 4 * (2 * 256 + 2 * 64)
    assert nf == 4.0 * 2 * 16 * 4 * 8          # QK^T and PV, 2 flops a MAC
    assert ne == 2 * 16 * 4 * 2                # one exp per logit and head
    assert kernels.gsa_counts(2, 16, 4, 8, 2, "bfloat16")[0] == nb / 2


def test_window_counts_by_hand():
    # B 1, 14x7 tokens, C 4: two 7x7 windows of 49 tokens
    nb, nf, ne = kernels.window_counts(1, 14, 7, 4, 1, "float32")
    assert nb == 4 * (4 * 98 * 4 + 2 * 49 * 4 + 4)
    assert nf == 4.0 * 2 * 49 * 49 * 4
    assert ne == 2 * 49 * 49


def test_cost_counts_at_zero_flow_by_hand():
    # side 3, r 1: patches of 4 cells from p - 1; in bounds per axis
    # p=0: 0..2 -> 3, p=1: 0..2 -> 3, p=2: 1..2 -> 2; sum 8, squared 64
    nb, nf, _ = kernels.cost_counts(1, 3, 1, "float32")
    assert nb == 64 * 4 + 9 * 2 * 4 + 9 * 9 * 4
    assert nf == 9 * (3 * 3 * 4 + 3 * 9)


def test_bound_takes_the_larger_term():
    # 3.35e12 bytes take one second; 165e12 fp32 flops (3xTF32) one second
    assert kernels.bound_s(3.35e12, 0, 0, "float32", 1, 1.0) == pytest.approx(1.0)
    assert kernels.bound_s(0, 165e12, 0, "float32", 1, 1.0) == pytest.approx(1.0)
    # 16 exponentials a clock an SM
    assert kernels.bound_s(0, 0, 32.0, "float32", 2, 1.0) == pytest.approx(1.0)
    assert kernels.bound_s(0, 989e12, 0, "bfloat16", 1, 1.0) == pytest.approx(1.0)
    assert kernels.bound_s(0, 67e12, 0, "float32", 1, 1.0,
                           matrix=False) == pytest.approx(1.0)


def test_flow_call_launches_match_the_port_counters():
    # the smoke's per-batch expectation: 18 / 24 / 18 for two flow calls
    _, count = kernels.slice_bounds(kernels.flow_call(12, 512, "float32", 12)
                                    * 2, 132, 1.98e9, "float32")
    assert count == {"gsa_attention": 18, "window_attention": 18,
                     "cost_lookup": 24}


def test_model_flops_count_by_hand():
    from torch.utils.flop_counter import FlopCounterMode
    lin = torch.nn.Linear(8, 4)
    conv = torch.nn.Conv2d(3, 5, 3)
    with FlopCounterMode(display=False) as fc:
        lin(torch.zeros(2, 8))
        conv(torch.zeros(1, 3, 6, 6))
    assert fc.get_total_flops() == 2 * 2 * 8 * 4 + 2 * 16 * 5 * 27


def test_frozen_model_flops_are_the_rule():
    from portbench.yardstick.flops import load
    f = load("ffpp_udis2_fp32")
    assert f["eval_pair"] == f["homo"] + 2 * f["flow_last"]
    assert f["train_pair"] == 3 * (f["homo"] + f["flow_all"]) + f["flow_last"]


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6)]
    assert union_s(iv) == 4
    assert gaps(iv) == [(3, 5)]


def test_reduce_events_attributes_kernels_and_gaps():
    dev = [("void gsa_attention_tf32_kernel<32>", 0, 10),
           ("cost_lookup_kernel", 20, 25), ("memcpy", 25, 30)]
    host = [("aten::outer", 0, 40), ("aten::inner", 12, 18)]
    r = reduce_events(dev, host, kernels.SYMBOLS)
    assert r["busy_s"] == pytest.approx(20e-6)
    assert r["kernel_count"]["gsa_attention"] == 1
    assert r["kernel_s"]["cost_lookup"] == pytest.approx(5e-6)
    assert r["idle_gaps"] == [["aten::inner", pytest.approx(10e-6)]]


def _layer(traced, counted):
    return {"slice": {"kernel_count": traced, "launches": counted,
                      "kernel_s": {"gsa_attention": 2.0, "cost_lookup": 1.0,
                                   "window_attention": 1.0}},
            "expected_launches": {"gsa_attention": 2, "cost_lookup": 1,
                                  "window_attention": 1},
            "bound_s": {"gsa_attention": 1.0, "cost_lookup": 0.5,
                        "window_attention": 0.5}}


def test_roofline_share_needs_a_complete_trace():
    full = {"gsa_attention": 2, "cost_lookup": 1, "window_attention": 1}
    assert kernel_share(_layer(full, full)) == pytest.approx(50.0)
    lost = dict(full, gsa_attention=1)
    assert kernel_share(_layer(lost, full)) is None
    assert kernel_share(_layer(full, lost)) is None
