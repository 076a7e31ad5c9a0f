"""FLOP and byte counts against values worked by hand at a tiny size, the
trace's interval arithmetic on a synthetic trace, and the metric readers
on a made-up summary."""

import pytest

from benchmark import counts, peaks, spec
from benchmark.trace import gaps, summarize, union_length


def test_dense_flops_by_hand():
    # one layer 3 -> 2 over 5 rows: forward 2*5*3*2 = 60
    assert counts.dense_flops([(5, 3, 2, False)], train=False) == 60
    # training adds the weight gradient (60), and the input's (60)
    assert counts.dense_flops([(5, 3, 2, False)], train=True) == 120
    assert counts.dense_flops([(5, 3, 2, True)], train=True) == 180


def test_buddy_flops_by_hand():
    # sf 2 -> 2; SIGN k=1 of 3 -> 4 on both endpoints; mix 8 -> 4 on both;
    # Hadamard 4 -> 4; the last layer 6 -> 1
    fwd = 2 * (2 * 2 + 2 * 2 * 3 * 4 + 2 * 8 * 4 + 4 * 4 + 6)
    shape = {"model": "BUDDY", "sf_dim": 2, "features": 3, "hidden": 4,
             "sign_k": 1}
    assert counts.model_flops(shape, 1, train=False) == fwd == 276
    # multiply-adds: the first layers forward and weight gradient (x2),
    # the others also the input gradient (x3)
    macs = 2 * 4 + 2 * 48 + 3 * 64 + 3 * 16 + 3 * 6
    assert counts.model_flops(shape, 10, train=True) == 10 * 2 * macs


def test_elph_flops_by_hand():
    shape = {"model": "ELPH", "sf_dim": 2, "hidden": 4, "features": 3,
             "nodes": 10, "nnz": 25, "hops": 2}
    head_fwd = 2 * (2 * 2 + 4 * 4 + 6)
    assert counts.model_flops(shape, 1, train=False) == head_fwd
    head_train = 2 * (2 * 2 * 2 + 3 * 4 * 4 + 3 * 6)
    gcn = (2 * 2 * 10 * 3 * 4          # conv 0: forward + weight grad
           + 3 * 2 * 10 * 4 * 4        # conv 1: + input grad
           + 2 * 25 * 4 * 2 * 2)       # SpMMs: forward and transposed
    assert counts.model_flops(shape, 7, train=True) == 7 * head_train + gcn


def test_bytes_by_hand():
    assert counts.k1_add_bytes(6, 4, 2) == 6 * 2 * 4 + 4 * 2 * 4 + 8 * 5
    assert counts.spmm_pass_bytes(3, 7, 2) == 2 * 3 * 2 * 4 + 7 * 12


def test_interval_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert union_length(iv) == pytest.approx(3.0)
    assert gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]
    assert union_length([]) == 0.0


def test_summarize_synthetic_trace():
    dev = [("k_a", 0.0, 1.0), ("k_b", 0.5, 2.0), ("k_a", 3.0, 4.0),
           ("k_a", 9.0, 11.0)]
    host = [("outer", 0.0, 10.0, 0), ("aten::sync", 2.0, 3.0, 1)]
    s = summarize(dev, host, 0.0, 5.0)
    assert s["busy_s"] == pytest.approx(3.0)
    assert s["window_s"] == 5.0
    assert s["kernel_n"] == {"k_a": 2, "k_b": 1}
    assert s["kernel_s"]["k_a"] == pytest.approx(2.0)
    gaps_ = s["breakdown"]["idle_gaps"]
    assert gaps_[0] == ["aten::sync", pytest.approx(1.0)]
    assert gaps_[1] == ["outer", pytest.approx(1.0)]
    assert s["breakdown"]["device_ops"][0][0] == "k_a"


def test_readers_on_a_made_up_summary():
    shape = {"model": "ELPH", "sf_dim": 8, "hidden": 4, "features": 3,
             "nodes": 10, "nnz": 25, "hops": 2}
    s = {"train": True, "steps": 3, "batch": 7, "window_s": 2.0,
         "busy_s": 1.5, "shape": shape,
         "plan": {"fwd_subruns": 6, "bwd_subruns": 5, "nodes": 10},
         "k1_launches": {"segscan_add_f32": 15},
         "kernel_n": {"void segscan_kernel<x>": 15},
         "kernel_s": {"void segscan_kernel<x>": 1e-6,
                      "carry_kernel": 1e-6}}
    mfu = spec.load_metric("train_mfu").read(s)
    assert mfu == pytest.approx(100 * 3 * counts.model_flops(shape, 7, True)
                                / 2.0 / peaks.FP32_FLOPS_PER_S)
    assert spec.load_metric("device_idle.train").read(s) == \
        pytest.approx(25.0)
    per_step = 2 * (counts.k1_add_bytes(6, 10, 4)
                    + counts.k1_add_bytes(5, 10, 4)) \
        + counts.k1_add_bytes(14, 10, 4)
    assert spec.load_metric("k1_roofline").read(s) == pytest.approx(
        100 * 3 * per_step / peaks.HBM_BYTES_PER_S / 2e-6)
    # a trace that lost a kernel has nothing to read
    s["kernel_n"] = {"void segscan_kernel<x>": 14}
    assert spec.load_metric("k1_roofline").read(s) is None
    assert spec.load_metric("spmm_roofline").read(s) is None
