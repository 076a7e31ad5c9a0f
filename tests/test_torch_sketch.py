"""Sketch engine of the port (subgraph_sketching_tpu_torch/sketch/) against
the JAX package on the same inputs, on the CPU.

Integer sketch state is bit-equal (MinHash compared after un-biasing).
Cardinalities agree to rtol=1e-5 and subgraph features to rtol=1e-5,
atol=1e-4: the register sums and the ladder's float32 arithmetic run in
another order than XLA's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subgraph_sketching_tpu.graph.synthetic import (
    barabasi_albert_graph, watts_strogatz_graph,
)
from subgraph_sketching_tpu.ops.segment_scan import make_plan
from subgraph_sketching_tpu.sketch import elph as jelph
from subgraph_sketching_tpu.sketch import hll as jhll
from subgraph_sketching_tpu.sketch import minhash as jminhash
from subgraph_sketching_tpu.sketch.params import SketchParams as JParams
from subgraph_sketching_tpu_torch.ops.segment_scan import SortedSegmentPlan
from subgraph_sketching_tpu_torch.sketch import elph, hll, minhash
from subgraph_sketching_tpu_torch.sketch.params import SketchParams, Sketches

GRAPHS = {
    "ba": lambda: (barabasi_albert_graph(200, 4, seed=1), 200),
    "ws": lambda: (watts_strogatz_graph(300, 8, 0.2, seed=2), 300),
}


def _both_params(**kw):
    return JParams(**kw), SketchParams(**kw)


def _build_both(graph, K, num_perm=64, hll_p=8, hops_only=False):
    ei, n = GRAPHS[graph]()
    jp, tp = _both_params(max_hops=K, num_perm=num_perm, hll_p=hll_p)
    jsk = jelph.build_hash_tables(jnp.asarray(ei), n, jp,
                                  plan=make_plan(ei, n), hops_only=hops_only)
    tsk = elph.build_hash_tables(ei, n, tp,
                                 plan=SortedSegmentPlan(ei, n, device="cpu"),
                                 hops_only=hops_only)
    return ei, n, jp, tp, jsk, tsk


def _to_torch(jsk) -> Sketches:
    """JAX sketches in the port's layout (biased int32 MinHash)."""
    return Sketches(
        minhash=torch.from_numpy(minhash.to_biased(np.array(jsk.minhash))),
        hll=torch.from_numpy(np.array(jsk.hll)),
        cards=torch.from_numpy(np.array(jsk.cards)))


def test_hop0_bit_equal():
    n, P, p = 257, 96, 7
    np.testing.assert_array_equal(minhash.minhash_init(n, P),
                                  jminhash.minhash_init(n, P))
    np.testing.assert_array_equal(hll.hll_init(n, p), jhll.hll_init(n, p))
    ids = np.array([5, 0, 256, 17])
    np.testing.assert_array_equal(minhash.minhash_init_rows(ids, P),
                                  jminhash.minhash_init_rows(ids, P))
    mh0, hl0 = elph.initialise_sketches(n, SketchParams(num_perm=P, hll_p=p),
                                        device="cpu")
    assert mh0.dtype == torch.int32 and hl0.dtype == torch.int8
    np.testing.assert_array_equal(minhash.from_biased(mh0),
                                  jminhash.minhash_init(n, P))
    np.testing.assert_array_equal(hl0.numpy(), jhll.hll_init(n, p))


def test_bias_preserves_uint32_order():
    u = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], np.uint32)
    b = minhash.to_biased(u)
    assert np.all(np.diff(b.astype(np.int64)) > 0)
    np.testing.assert_array_equal(minhash.from_biased(b), u)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("K", [1, 2, 3])
def test_build_hash_tables_bit_equal(graph, K):
    *_, jsk, tsk = _build_both(graph, K)
    np.testing.assert_array_equal(minhash.from_biased(tsk.minhash),
                                  np.asarray(jsk.minhash))
    np.testing.assert_array_equal(tsk.hll.numpy(), np.asarray(jsk.hll))
    np.testing.assert_allclose(tsk.cards.numpy(), np.asarray(jsk.cards),
                               rtol=1e-5)


def test_hops_only_stacks_bit_equal():
    *_, jsk, tsk = _build_both("ws", 2, hops_only=True)
    assert tsk.minhash.shape[0] == 2
    np.testing.assert_array_equal(minhash.from_biased(tsk.minhash),
                                  np.asarray(jsk.minhash))
    np.testing.assert_array_equal(tsk.hll.numpy(), np.asarray(jsk.hll))


@pytest.mark.parametrize("p", [4, 8, 10])
def test_hll_count_matches_jax(p):
    rng = np.random.default_rng(p)
    m = 1 << p
    # from nearly-empty (linear counting) to saturated (bias-corrected and
    # raw estimates)
    fill = rng.random((64, 1)) ** 3
    regs = np.where(rng.random((64, m)) < fill,
                    rng.integers(1, 20, (64, m)), 0).astype(np.int8)
    got = hll.hll_count(torch.from_numpy(regs), p).numpy()
    want = np.asarray(jhll.hll_count(jnp.asarray(regs), p))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    e = np.linspace(1.0, 6.0 * m, 997, dtype=np.float32)
    np.testing.assert_allclose(
        hll.bias_correct(torch.from_numpy(e), p).numpy(),
        np.asarray(jhll.bias_correct(jnp.asarray(e), p)), rtol=1e-6)


def test_pow2_neg_is_exact():
    regs = torch.arange(0, 64, dtype=torch.int8)
    np.testing.assert_array_equal(hll.pow2_neg(regs).numpy(),
                                  2.0 ** -np.arange(64, dtype=np.float32))


@pytest.mark.parametrize("use_zero_one,floor_sf", [
    (False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("K", [1, 2, 3])
def test_subgraph_features_match_jax(K, use_zero_one, floor_sf):
    ei, n = GRAPHS["ba"]()
    kw = dict(max_hops=K, num_perm=64, use_zero_one=use_zero_one,
              floor_sf=floor_sf)
    jp, tp = _both_params(**kw)
    jsk = jelph.build_hash_tables(jnp.asarray(ei), n, jp,
                                  plan=make_plan(ei, n))
    links = np.random.default_rng(K).integers(0, n, (300, 2)).astype(np.int32)
    links[:50] = ei.T[:50]                   # true edges: overlapping hoods
    want = np.asarray(jelph.subgraph_features(jnp.asarray(links), jsk, jp))
    got = elph.subgraph_features(torch.from_numpy(links).long(),
                                 _to_torch(jsk), tp).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_features_from_port_sketches_batched(graph):
    ei, n, jp, tp, jsk, tsk = _build_both(graph, 2)
    links = np.random.default_rng(0).integers(0, n, (700, 2)).astype(np.int32)
    want = np.asarray(jelph.subgraph_features_batched(links, jsk, jp))
    got = elph.subgraph_features_batched(links, tsk, tp, batch_size=256)
    assert got.shape == (700, tp.sf_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_hll_merge_matches_jax():
    rng = np.random.default_rng(3)
    a, b = (rng.integers(0, 40, (50, 256)).astype(np.int8) for _ in range(2))
    want = np.asarray(jhll.hll_merge(jnp.asarray(a), jnp.asarray(b)))
    got = hll.hll_merge(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("K,hops_only", [(1, False), (2, True), (3, False)])
def test_packed_sketches_match_jax(K, hops_only):
    """``pack_sketches`` equals JAX's lanes (the MinHash lanes after the
    bias is removed, the packed HLL lanes as they are), and
    ``subgraph_features_packed`` equals the unpacked path bit for bit and
    JAX's packed features to rtol 1e-6 (float32 estimator arithmetic in
    another order than XLA's; atol 1e-4 where a ladder difference is
    near 0)."""
    ei, n, jp, tp, jsk, tsk = _build_both("ba", K, hops_only=hops_only)
    want = np.asarray(jelph.pack_sketches(jsk, jp))
    got = elph.pack_sketches(tsk, tp)
    assert got.dtype == torch.int32 and got.shape == want.shape
    lanes = got.numpy().view(np.uint32).copy()
    stride = tp.num_perm + tp.m // 4
    for k in range(K):
        mh = slice(k * stride, k * stride + tp.num_perm)
        lanes[:, mh] = minhash.from_biased(got[:, mh])
    np.testing.assert_array_equal(lanes, want)
    links = np.random.default_rng(K).integers(0, n, (300, 2)).astype(np.int32)
    links[:50] = ei.T[:50]
    tl = torch.from_numpy(links).long()
    sf = elph.subgraph_features_packed(tl, got, tsk.cards, tp)
    torch.testing.assert_close(sf, elph.subgraph_features(tl, tsk, tp),
                               rtol=0, atol=0)
    jsf = np.asarray(jelph.subgraph_features_packed(
        jnp.asarray(links), jnp.asarray(want), jsk.cards, jp))
    np.testing.assert_allclose(sf.numpy(), jsf, rtol=1e-6, atol=1e-4)


def test_package_reexports():
    """The JAX package's package-level names (not its submodules) at the
    same places in the port."""
    import types

    import subgraph_sketching_tpu as jpkg
    import subgraph_sketching_tpu.ops as jops
    import subgraph_sketching_tpu.sketch as jsketch
    import subgraph_sketching_tpu_torch as pkg
    import subgraph_sketching_tpu_torch.ops as ops
    import subgraph_sketching_tpu_torch.sketch as sketch
    from subgraph_sketching_tpu_torch.ops import graph_ops
    for mine, theirs in ((pkg, jpkg), (ops, jops), (sketch, jsketch)):
        names = {k for k, v in vars(theirs).items()
                 if not k.startswith("_")
                 and not isinstance(v, types.ModuleType)}
        assert names and names <= set(vars(mine)), names - set(vars(mine))
    assert pkg.__version__ == jpkg.__version__
    assert ops.spmm is graph_ops.spmm
    assert sketch.hll_merge is hll.hll_merge
    assert sketch.propagate_minhash is elph.propagate_minhash
