"""The host side of the port's node-sharded sketch state
(subgraph_sketching_tpu_torch/parallel/node_sharded.py, scaling.py) and
its single-rank build, against the JAX package; no ranks.

Tolerances: the partitions (every array of the plan, its halo width and
shard size), ``pad_init``, ``to_node_order``, ``lane_row_bytes`` and the
scaling efficiency: equal; the D = 1 build: MinHash and HLL bit-equal in
node order to ``build_hash_tables`` (the port's and JAX's), cardinalities
equal to the port's and within rtol 1e-6, atol 1e-4 of JAX's; its
subgraph features equal to the port's single-device features; the plan
over another source table (the halo plan): bit-equal to a scatter
min / max.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subgraph_sketching_tpu.graph.synthetic import barabasi_albert_graph
from subgraph_sketching_tpu.parallel import node_sharded as jns
from subgraph_sketching_tpu.parallel import scaling as jscaling
from subgraph_sketching_tpu.sketch import SketchParams as JSketchParams
from subgraph_sketching_tpu.sketch.elph import (
    build_hash_tables as jbuild_hash_tables,
)
from subgraph_sketching_tpu_torch.ops.segment import segment_max, segment_min
from subgraph_sketching_tpu_torch.ops.segment_scan import make_auto_plan
from subgraph_sketching_tpu_torch.parallel import node_sharded as ns
from subgraph_sketching_tpu_torch.parallel import scaling
from subgraph_sketching_tpu_torch.parallel.collectives import (
    halo_exchange, halo_route,
)
from subgraph_sketching_tpu_torch.parallel.mesh import make_mesh
from subgraph_sketching_tpu_torch.sketch.elph import (
    build_hash_tables, initialise_sketches, subgraph_features,
)
from subgraph_sketching_tpu_torch.sketch.minhash import from_biased
from subgraph_sketching_tpu_torch.sketch.params import SketchParams

PLAN_FIELDS = ("send_idx", "send_mask", "local_src", "local_dst",
               "local_mask", "halo_src", "halo_dst", "halo_mask", "perm")


def _graph(kind: str):
    if kind == "ba64":       # the BA-64 graph of tests/test_parallel.py
        return barabasi_albert_graph(64, 4, seed=0), 64
    rng = np.random.default_rng(5)
    n, e = 97, 400
    return np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]), n


@pytest.mark.parametrize("graph", ["ba64", "random"])
@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("method", ["contiguous", "locality"])
def test_make_node_partition_matches_jax(method, D, graph):
    ei, n = _graph(graph)
    want = jns.make_node_partition(ei, n, D, method)
    got = ns.make_node_partition(ei, n, D, method)
    assert (got.halo_width, got.shard_size, got.padded_nodes) == (
        want.halo_width, want.shard_size, want.padded_nodes)
    assert got.halo_rows_per_dev == want.halo_rows_per_dev
    assert got.is_identity_perm == want.is_identity_perm
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


@pytest.mark.parametrize("graph", ["ba64", "random"])
@pytest.mark.parametrize("D", [2, 4])
def test_balanced_partition_matches_jax(D, graph):
    ei, n = _graph(graph)
    np.testing.assert_array_equal(ns.balanced_partition(ei, n, D),
                                  jns.balanced_partition(ei, n, D))
    src, dst = (np.asarray(a, np.int64) for a in ei)
    part = ns.balanced_partition(ei, n, D)
    assert ns._padded_halo_width(src, dst, part, D) == \
        jns._padded_halo_width(src, dst, part, D)


@pytest.mark.parametrize("method", ["contiguous", "locality"])
def test_pad_init_and_to_node_order_match_jax(method):
    """On the random graph (97 nodes do not split evenly, so the tables
    are padded) and uint32 MinHash as the JAX package holds it; the port's
    biased int32 padding is the image of JAX's uint32 padding."""
    ei, n = _graph("random")
    p = JSketchParams()
    want_plan = jns.make_node_partition(ei, n, 4, method)
    got_plan = ns.make_node_partition(ei, n, 4, method)
    from subgraph_sketching_tpu.sketch.elph import initialise_sketches as ji
    mh0, hll0 = (np.asarray(a) for a in ji(n, p))
    want = want_plan.pad_init(mh0, hll0)
    got = got_plan.pad_init(mh0, hll0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    biased, hll = got_plan.pad_init(*(t.numpy() for t in initialise_sketches(
        n, SketchParams(), "cpu")))
    np.testing.assert_array_equal(from_biased(biased), want[0])
    np.testing.assert_array_equal(hll, want[1])
    np.testing.assert_array_equal(got_plan.to_node_order(want[0]),
                                  want_plan.to_node_order(want[0]))
    np.testing.assert_array_equal(got_plan.to_node_order(want[0]), mh0)
    # each shard's own rows, built by id alone, are pad_init's rows
    S = got_plan.shard_size
    for r in range(4):
        mh, hl = got_plan.shard_init(SketchParams(), r)
        np.testing.assert_array_equal(mh, biased[r * S:(r + 1) * S])
        np.testing.assert_array_equal(hl, hll[r * S:(r + 1) * S])


@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_lane_row_bytes_and_efficiency_match_jax(lanes):
    for p in (JSketchParams(), JSketchParams(hll_p=10)):
        port = SketchParams(hll_p=p.hll_p)
        assert scaling.lane_row_bytes(port, lanes) == \
            jscaling.lane_row_bytes(p, lanes)
    results = {1: 3.0e6, 2: 5.1e6, 4: 9.0e6}
    assert scaling.scaling_efficiency(results) == \
        jscaling.scaling_efficiency(results)


@pytest.mark.parametrize("max_gather_rows", [None, 64])
@pytest.mark.parametrize("max_hops", [2, 3])
def test_single_rank_build_equals_build_hash_tables(max_hops,
                                                    max_gather_rows):
    """At D = 1 (no process group) the node-sharded build is the whole
    table: bit-equal in node order to the port's and JAX's single-device
    builds, one-shot and chunk-streamed; its features equal the port's."""
    ei, n = _graph("ba64")
    p = SketchParams(max_hops=max_hops)
    mesh = make_mesh([1], ["graph"], "cpu")
    plan = ns.make_node_partition(ei, n, 1)
    assert plan.is_identity_perm and plan.halo_rows_per_dev == 0
    sk = ns.node_sharded_build_hash_tables(plan, p, mesh,
                                           max_gather_rows=max_gather_rows)
    want = build_hash_tables(ei, n, p, device="cpu")
    for f in ("minhash", "hll", "cards"):
        assert torch.equal(getattr(sk, f), getattr(want, f)), f
    jsk = jbuild_hash_tables(jnp.asarray(ei), n, JSketchParams(
        max_hops=max_hops))
    np.testing.assert_array_equal(
        plan.to_node_order(from_biased(sk.minhash)), np.asarray(jsk.minhash))
    np.testing.assert_array_equal(plan.to_node_order(sk.hll.numpy()),
                                  np.asarray(jsk.hll))
    np.testing.assert_allclose(sk.cards.numpy(), np.asarray(jsk.cards),
                               rtol=1e-6, atol=1e-4)
    links = torch.from_numpy(np.random.default_rng(1).integers(0, n,
                                                               (40, 2)))
    assert torch.equal(
        ns.node_sharded_subgraph_features(links, sk, p, mesh,
                                          perm=plan.perm),
        subgraph_features(links, want, p))


@pytest.mark.parametrize("op", ["min", "max"])
def test_plan_over_another_source_table(op):
    """The halo plan's reduce: sources index a table of another length
    (num_sources), the destinations' rows folded in: equal to the scatter
    route, one-shot and chunk-streamed."""
    rng = np.random.default_rng(2)
    S, R, E = 30, 45, 200
    src, dst = rng.integers(0, R, E), rng.integers(0, S, E)
    dtype = torch.int32 if op == "min" else torch.int8
    hi = 2 ** 31 - 1 if op == "min" else 60
    table = torch.randint(-hi, hi, (R, 8), dtype=dtype)
    acc = torch.randint(-hi, hi, (S, 8), dtype=dtype)
    seg = segment_min if op == "min" else segment_max
    comb = torch.minimum if op == "min" else torch.maximum
    want = comb(acc, seg(table[torch.from_numpy(src)], torch.from_numpy(dst),
                         S))
    for max_slots in (None, 64):
        plan = make_auto_plan(np.stack([src, dst]), S, max_slots=max_slots,
                              device="cpu", num_sources=R)
        assert torch.equal(plan.reduce(acc, op, sources=table), want)


def test_halo_exchange_without_a_group_is_local():
    send = torch.arange(12, dtype=torch.int32).view(1, 3, 4)
    assert halo_route(None, "cpu") == "local"
    assert halo_route(None, "cuda") == "local"
    assert torch.equal(halo_exchange(send, None, "min").wait(), send)
