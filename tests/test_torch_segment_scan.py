"""The port's plan builder and chunk-streamed plan
(subgraph_sketching_tpu_torch/ops/segment_scan.py) against numpy, the
port's one-shot plan and the JAX package's ``ChunkedSegmentPlan``, on the
CPU.

  * the C++ builder (csrc/plan_build.cpp, built here with g++) gives the
    numpy construction's tables, equal in dtype and value;
  * ``ChunkedSegmentPlan`` is bit-equal to the JAX package's chunked plan
    and to the port's one-shot plan for min (biased int32 against uint32)
    and max (int8); the float32 add agrees within rtol = atol = 1e-5, the
    tolerance of the one-shot SpMM in tests/test_torch_segscan.py (the
    per-chunk merge sums in another order than either reference);
  * each chunk holds at most ``max_slots`` slots, the sub-runs spread
    evenly, and a destination whose sub-runs straddle chunks stays exact.

On the CPU each chunk's merge is K1's plain version; the card holds the
kernel against it (chip_smoke.py, ``datasets`` phase).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subgraph_sketching_tpu.ops.segment_scan import make_plan
from subgraph_sketching_tpu_torch.ops import cuda_build, segscan
from subgraph_sketching_tpu_torch.ops import segment_scan as ss
from subgraph_sketching_tpu_torch.sketch.minhash import from_biased, to_biased

# (n, edges, hub in-edges): plain, a hub whose sub-runs span many chunks,
# and nodes with no in-edge inside every window
GRAPHS = [(200, 1500, 0), (300, 2000, 700), (500, 400, 0)]


def _graph(seed, n, e, hub):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]).astype(
        np.int32)
    ei[1, :hub] = 11
    return ei


@pytest.mark.parametrize("n,e,hub", GRAPHS)
@pytest.mark.parametrize("sub_len", [8, 16, 3])
def test_native_tables_equal_numpy(n, e, hub, sub_len):
    ei = _graph(0, n, e, hub)
    native = ss.plan_tables_native(ei[0], ei[1], n, sub_len)
    plain = ss.plan_tables_plain(ei[0], ei[1], n, sub_len)
    for got, want in zip(native, plain):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    order, _, _, run_starts, sub_starts = plain
    got = ss.slot_edge_native(order, run_starts, sub_starts, sub_len)
    want = ss.slot_edge_plain(order, run_starts, sub_starts, sub_len)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_native_tables_equal_the_jax_plans():
    n, e, hub = GRAPHS[1]
    ei = _graph(1, n, e, hub)
    order, gather_idx, sub_dst, run_starts, sub_starts = \
        ss.plan_tables_native(ei[0], ei[1], n, ss.SUB_LEN)
    slot_edge = ss.slot_edge_native(order, run_starts, sub_starts,
                                    ss.SUB_LEN)
    plan = ss.SortedSegmentPlan(ei, n, device="cpu")    # numpy on the CPU
    jp = make_plan(ei, n)
    for name, got in (("order", order), ("_gather_idx_np", gather_idx),
                      ("_sub_dst_np", sub_dst), ("_slot_edge", slot_edge)):
        np.testing.assert_array_equal(got, getattr(plan, name))
        np.testing.assert_array_equal(got, np.asarray(getattr(jp, name)))
    np.testing.assert_array_equal(sub_starts, plan.sub_starts)


def test_native_builder_refuses_bad_input_and_a_failed_build_raises(
        monkeypatch, tmp_path):
    ei = np.array([[0, 1], [1, 5]], np.int32)     # destination 5 of n = 3
    with pytest.raises(ValueError, match="refused"):
        ss.plan_tables_native(ei[0], ei[1], 3, 8)

    # no compiler: the builder of the card's plans raises, it takes no numpy
    def no_gxx():
        raise RuntimeError("g++ not found")
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(cuda_build, "library_path",
                        lambda name: str(tmp_path / f"{name}.so"))
    monkeypatch.setattr(cuda_build, "_gxx", no_gxx)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        ss.plan_tables_native(ei[0], np.array([1, 2], np.int32), 3, 8)


def _inputs(seed, n):
    rng = np.random.default_rng(seed)
    mh = rng.integers(0, 2 ** 32 - 1, (n, 32), dtype=np.uint32)
    hl = rng.integers(0, 56, (n, 16)).astype(np.int8)
    xf = rng.standard_normal((n, 8)).astype(np.float32)
    return mh, hl, xf


@pytest.mark.parametrize("n,e,hub", GRAPHS)
@pytest.mark.parametrize("max_slots", [16, 200, 1000])
def test_chunked_bit_equal_to_jax_and_one_shot(n, e, hub, max_slots):
    ei = _graph(3, n, e, hub)
    sub_len = ss.CHUNK_SUB_LEN
    ch = ss.SortedSegmentPlan(ei, n, sub_len, device="cpu").chunk(max_slots)
    one = ss.SortedSegmentPlan(ei, n, device="cpu")
    jch = make_plan(ei, n, sub_len=sub_len).chunk(max_slots)
    assert ch.num_chunks == jch.num_chunks > 1
    assert ch.per_chunk == jch.per_chunk
    assert all((s1 - s0) * sub_len <= max_slots
               for s0, s1, _, _ in ch.bounds)
    mh, hl, xf = _inputs(4, n)
    got = from_biased(ch.reduce(torch.from_numpy(to_biased(mh)), "min"))
    np.testing.assert_array_equal(
        got, np.asarray(jch.reduce(jnp.asarray(mh), "min")))
    np.testing.assert_array_equal(
        got, from_biased(one.reduce(torch.from_numpy(to_biased(mh)), "min")))
    got = ch.reduce(torch.from_numpy(hl), "max").numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jch.reduce(jnp.asarray(hl), "max")))
    np.testing.assert_array_equal(
        got, one.reduce(torch.from_numpy(hl), "max").numpy())
    w = np.random.default_rng(5).random(e).astype(np.float32)
    got = ch.reduce(torch.from_numpy(xf), "add",
                    edge_data_slots=ch.stage_edge_data(w)).numpy()
    want = np.asarray(jch.reduce(jnp.asarray(xf), "add",
                                 edge_data_slots=jch.stage_edge_data(w)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want = one.reduce(torch.from_numpy(xf), "add",
                      edge_data_slots=one.stage_edge_data(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_chunk_merge_is_k1_per_chunk_and_straddles_exactly():
    """A hub whose sub-runs straddle chunks: every chunk goes through the
    merge once, on the chunk's window, and the hub's row equals the exact
    min over its closed neighbourhood."""
    n, e, hub = GRAPHS[1]
    ei = _graph(6, n, e, hub)
    ch = ss.make_auto_plan(ei, n, max_slots=64, device="cpu")
    assert isinstance(ch, ss.ChunkedSegmentPlan) and ch.sub_len == 16
    windows = [(lo, hi) for s0, s1, lo, hi in ch.bounds]
    assert sum(lo <= 11 < hi for lo, hi in windows) > 1   # the hub straddles
    sizes = [s1 - s0 for s0, s1, _, _ in ch.bounds]       # spread evenly
    assert sizes[:-1] == [ch.per_chunk] * (ch.num_chunks - 1)
    assert 0 < sizes[-1] <= ch.per_chunk
    assert ch.per_chunk == -(-ch.base.num_subruns // ch.num_chunks)
    calls = []

    def merge(v, x, op, ptr):
        calls.append((tuple(v.shape), tuple(x.shape), tuple(ptr.shape)))
        return segscan.segment_combine_plain(v, x, op, ptr)

    mh, _, _ = _inputs(7, n)
    got = from_biased(ch.reduce(torch.from_numpy(to_biased(mh)), "min",
                                merge=merge))
    assert calls == [((s1 - s0, 32), (hi - lo, 32), (hi - lo + 1,))
                     for s0, s1, lo, hi in ch.bounds]
    closed = np.concatenate([ei[0][ei[1] == 11], [11]])
    np.testing.assert_array_equal(got[11], mh[closed].min(axis=0))


def test_chunked_edge_cases():
    n = 40
    mh, hl, xf = _inputs(8, n)
    # an empty graph: no chunks; min/max give x, add gives zeros
    ch = ss.SortedSegmentPlan(np.zeros((2, 0), np.int32), n,
                              device="cpu").chunk(16)
    assert ch.num_chunks == 0
    np.testing.assert_array_equal(ch.reduce(torch.from_numpy(hl), "max"), hl)
    np.testing.assert_array_equal(ch.reduce(torch.from_numpy(xf), "add"),
                                  np.zeros_like(xf))
    # one chunk: the chunked plan is the one-shot plan
    ei = _graph(9, n, 60, 0)
    one = ss.SortedSegmentPlan(ei, n, device="cpu")
    ch = one.chunk(1 << 20)
    assert ch.num_chunks == 1
    np.testing.assert_array_equal(ch.reduce(torch.from_numpy(hl), "max"),
                                  one.reduce(torch.from_numpy(hl), "max"))
    # make_auto_plan keeps the one-shot form (SUB_LEN) when it fits
    plan = ss.make_auto_plan(ei, n, max_slots=1 << 20, device="cpu")
    assert isinstance(plan, ss.SortedSegmentPlan)
    assert plan.sub_len == ss.SUB_LEN
