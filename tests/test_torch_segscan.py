"""K1 port (subgraph_sketching_tpu_torch/ops/segscan.py) against the JAX
Pallas merge, and the port's plan tables against the JAX plan's.

On the CPU the port's merge is its plain torch version; the JAX side runs
the Pallas kernel in interpret mode, as tests/test_ops.py does.  Min/max
results must be bit-equal; the float32 add agrees to rtol=atol=1e-5 (the
Pallas ladder sums each run as a balanced tree, the port in order).

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subgraph_sketching_tpu.ops import pallas_segscan as pss
from subgraph_sketching_tpu.ops.segment_scan import make_plan
from subgraph_sketching_tpu_torch.ops import segscan
from subgraph_sketching_tpu_torch.ops.segment_scan import (
    ChunkedSegmentPlan, SortedSegmentPlan, make_auto_plan,
)
from subgraph_sketching_tpu_torch.sketch.minhash import from_biased, to_biased

# (n, deg, sub_len, hub): the shapes of tests/test_ops.py plus a hub whose
# run spans many sub-runs (and many Pallas blocks)
SHAPES = [(300, 4, 8, False), (150, 200, 4, False), (200, 12, 8, True)]


def _graph(rng, n, deg, hub):
    e = n * deg
    ei = np.stack([rng.integers(0, n, e),
                   rng.integers(0, n, e)]).astype(np.int32)
    # leave some nodes with no in-edges (empty segments)
    ei[1] = np.where(ei[1] < 10, 10, ei[1]).astype(np.int32)
    if hub:
        ei[1, : e // 4] = 17
    return ei


def _plans(seed, n, deg, sub_len, hub):
    ei = _graph(np.random.default_rng(seed), n, deg, hub)
    return ei, make_plan(ei, n, sub_len=sub_len), \
        SortedSegmentPlan(ei, n, sub_len, device="cpu")


def _subrun_results(plan, x, op, w=None):
    """Slot gather + slot-axis reduce in numpy (the merge's input)."""
    ident = {"min": np.iinfo(x.dtype).max if x.dtype.kind in "iu" else 0,
             "max": np.iinfo(x.dtype).min if x.dtype.kind in "iu" else 0,
             "add": 0}[op]
    rows = np.concatenate([x, np.full((1,) + x.shape[1:], ident, x.dtype)])
    v = rows[plan._gather_idx_np]
    if w is not None:
        v = v * w[:, None]
    v = v.reshape(plan.num_subruns, plan.sub_len, x.shape[1])
    return {"min": v.min, "max": v.max, "add": v.sum}[op](axis=1)


@pytest.mark.parametrize("n,deg,sub_len,hub", SHAPES)
def test_plan_tables_equal_jax(n, deg, sub_len, hub):
    _, jp, tp = _plans(1, n, deg, sub_len, hub)
    assert tp.num_subruns == jp.num_subruns
    np.testing.assert_array_equal(tp._gather_idx_np, jp._gather_idx_np)
    np.testing.assert_array_equal(tp._sub_dst_np, jp._sub_dst_np)
    np.testing.assert_array_equal(tp.order.astype(np.int64),
                                  np.asarray(jp.order, dtype=np.int64))
    np.testing.assert_array_equal(tp._slot_edge.astype(np.int64),
                                  np.asarray(jp._slot_edge, dtype=np.int64))
    # the sub-run pointer K1 reads is the prefix of sub-runs per node
    counts = np.bincount(tp._sub_dst_np, minlength=n)
    np.testing.assert_array_equal(np.diff(tp.sub_starts), counts)
    np.testing.assert_array_equal(tp.sub_ptr.numpy(), tp.sub_starts)
    np.testing.assert_array_equal(segscan.segment_ids(tp.sub_ptr).numpy(),
                                  tp._sub_dst_np)


@pytest.mark.parametrize("n,deg,sub_len,hub", SHAPES)
@pytest.mark.parametrize("kind", ["min_u32", "max_i8", "max_i32"])
def test_minmax_merge_bit_equal_to_pallas(n, deg, sub_len, hub, kind):
    _, jp, tp = _plans(3, n, deg, sub_len, hub)
    rid2d, last_idx, empty = jp._pallas_tables()
    assert bool(np.asarray(empty)[:10].all())
    rng = np.random.default_rng(4)
    op = kind[:3]
    if kind == "min_u32":
        x = rng.integers(0, 2 ** 32 - 1, (n, 128), dtype=np.uint32)
    elif kind == "max_i8":
        x = rng.integers(0, 56, (n, 256)).astype(np.int8)
    else:
        x = rng.integers(-2 ** 31, 2 ** 31 - 1, (n, 128), dtype=np.int32)
    v = _subrun_results(jp, x, op)
    want = np.asarray(pss.sorted_segment_combine(
        jnp.asarray(v), jnp.asarray(x), op, rid2d, last_idx, empty,
        jp._seg_depth, interpret=True))
    if kind == "min_u32":
        tv, tx = torch.from_numpy(to_biased(v)), torch.from_numpy(to_biased(x))
    else:
        tv, tx = torch.from_numpy(v), torch.from_numpy(x)
    got = segscan.segment_combine(tv, tx, op, tp.sub_ptr)
    got = from_biased(got) if kind == "min_u32" else got.numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,deg,sub_len,hub", SHAPES)
def test_add_merge_matches_pallas(n, deg, sub_len, hub):
    ei, jp, tp = _plans(5, n, deg, sub_len, hub)
    rid2d, last_idx, empty = jp._pallas_tables()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    w = rng.random(ei.shape[1]).astype(np.float32)
    v = _subrun_results(jp, x, "add", np.asarray(jp.stage_edge_data(w)))
    want = np.asarray(pss.sorted_segment_combine(
        jnp.asarray(v), jnp.asarray(x), "add", rid2d, last_idx, empty,
        jp._seg_depth, interpret=True))
    got = segscan.segment_combine(torch.from_numpy(v), torch.from_numpy(x),
                                  "add", tp.sub_ptr).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(got[:10] == 0.0)  # empty segments -> 0
    # the whole plan reduce, weights staged by the port's own plan
    got = tp.reduce(torch.from_numpy(x), "add",
                    edge_data_slots=tp.stage_edge_data(w)).numpy()
    want = np.asarray(jp.reduce(jnp.asarray(x), "add",
                                edge_data_slots=jp.stage_edge_data(w)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,deg,sub_len,hub", SHAPES)
def test_plan_reduce_bit_equal_to_jax(n, deg, sub_len, hub):
    _, jp, tp = _plans(7, n, deg, sub_len, hub)
    rng = np.random.default_rng(8)
    mh = rng.integers(0, 2 ** 32 - 1, (n, 64), dtype=np.uint32)
    hl = rng.integers(0, 56, (n, 64)).astype(np.int8)
    got = from_biased(tp.reduce(torch.from_numpy(to_biased(mh)), "min"))
    np.testing.assert_array_equal(got, np.asarray(jp.reduce(jnp.asarray(mh),
                                                            "min")))
    got = tp.reduce(torch.from_numpy(hl), "max").numpy()
    np.testing.assert_array_equal(got, np.asarray(jp.reduce(jnp.asarray(hl),
                                                            "max")))


def test_zero_edge_plan():
    n = 12
    ei = np.zeros((2, 0), np.int32)
    jp = make_plan(ei, n)
    tp = SortedSegmentPlan(ei, n, device="cpu")
    assert tp.num_subruns == jp.num_subruns == 0
    for name in ("_gather_idx_np", "_sub_dst_np", "order", "_slot_edge"):
        assert len(getattr(tp, name)) == len(np.asarray(getattr(jp, name))) == 0
    np.testing.assert_array_equal(tp.sub_starts, np.zeros(n + 1))
    assert tp.stage_edge_data(np.zeros(0, np.float32)).shape == (0,)
    x = np.random.default_rng(0).standard_normal((n, 4)).astype(np.float32)
    np.testing.assert_array_equal(tp.reduce(torch.from_numpy(x), "max"), x)
    np.testing.assert_array_equal(tp.reduce(torch.from_numpy(x), "add"),
                                  np.zeros_like(x))


def test_auto_plan_rejects_oversized_slot_table():
    """A slot table past max_slots is not gathered at once: make_auto_plan
    streams it in chunks of at most max_slots slots, as the JAX package
    does (tests/test_torch_segment_scan.py holds the chunked results)."""
    ei = _graph(np.random.default_rng(0), 100, 20, False)
    plan = make_auto_plan(ei, 100, max_slots=1 << 20, device="cpu")
    assert isinstance(plan, SortedSegmentPlan)
    assert plan.num_subruns * plan.sub_len <= 1 << 20
    chunked = make_auto_plan(ei, 100, max_slots=64, device="cpu")
    assert isinstance(chunked, ChunkedSegmentPlan)
    assert chunked.num_chunks > 1
    assert all((s1 - s0) * chunked.sub_len <= 64
               for s0, s1, _, _ in chunked.bounds)


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    v = torch.zeros((4, 8), dtype=torch.int16)
    ptr = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="no kernel"):
        segscan._check_cuda_args(v, torch.zeros((2, 8), dtype=torch.int16),
                                 ptr, "max")
    v8 = torch.zeros((4, 6), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of 4"):
        segscan._check_cuda_args(v8, torch.zeros((2, 6), dtype=torch.int8),
                                 ptr, "max")
    with pytest.raises(ValueError, match="ptr"):
        segscan._check_cuda_args(v8, torch.zeros((3, 6), dtype=torch.int8),
                                 ptr, "max")
