"""Exact streaming edge inserts and deletes on the port's ``LinkScorer``
(subgraph_sketching_tpu_torch/serving.py), on the CPU: the counterparts of
tests/test_serving.py's streaming tests, and one test of the same update
sequence through both packages' scorers.

After any sequence of updates the resident MinHash and HLL stacks are
bit-equal to a from-scratch build on the graph the sequence produced;
cardinalities agree to rtol 1e-6 / atol 1e-4 and scores to 1e-5 (as in
the JAX tests); degrees equal a rebuild's (integer weights, summed exactly
in any order).  Across packages the MinHash stacks compare after
``from_biased``.

The node-sharded case of tests/test_serving.py
(``test_streaming_updates_on_node_sharded_state``) waits for the port's
multi-device layer: the port's serving state is not node-sharded yet.
Card variants are in tests/test_torch_cuda.py.
"""

import jax
import numpy as np
import pytest

from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.graph.container import Graph
from subgraph_sketching_tpu_torch.graph.preprocess import build_link_dataset
from subgraph_sketching_tpu_torch.graph.splits import SplitData
from subgraph_sketching_tpu_torch.graph.synthetic import watts_strogatz_graph
from subgraph_sketching_tpu_torch.serving import LinkScorer
from subgraph_sketching_tpu_torch.sketch.minhash import from_biased
from subgraph_sketching_tpu_torch.train.loops import BuddyTrainer

BASE = dict(dataset_name="synth-ws", hidden_channels=16, batch_size=256,
            eval_batch_size=1024, model="BUDDY", K=20, use_feature=False)


def _scorer(cfg, ei, n, links, w=None):
    """A LinkScorer on the CPU over the message graph ``ei`` (weights
    ``w``), its model initialised from seed 0 (the same weights for every
    graph)."""
    ei = np.asarray(ei)
    order = np.lexsort((ei[1], ei[0]))
    g = Graph(np.ascontiguousarray(ei[:, order]), n,
              None if w is None else np.asarray(w)[order])
    half = len(links) // 2
    sd = SplitData(graph=g, pos_edges=links[:half], neg_edges=links[half:])
    ds = build_link_dataset(sd, cfg, "train", device="cpu")
    model = BuddyTrainer(cfg, ds, None, device="cpu").init_model(0)
    return LinkScorer(cfg, model, ds, min_bucket=64, device="cpu")


def _links(rng, n, count):
    return np.stack([rng.integers(0, n, count),
                     rng.integers(0, n, count)], 1).astype(np.int32)


def _assert_sketches_equal(a, b):
    np.testing.assert_array_equal(a.sk.minhash.numpy(), b.sk.minhash.numpy())
    np.testing.assert_array_equal(a.sk.hll.numpy(), b.sk.hll.numpy())
    np.testing.assert_allclose(a.sk.cards.numpy(), b.sk.cards.numpy(),
                               rtol=1e-6, atol=1e-4)


def _sym(e, w=None):
    """Both directions of the undirected pairs ``e`` [2, M]."""
    ei = np.concatenate([e, e[::-1]], axis=1)
    return ei if w is None else (ei, np.concatenate([w, w]))


def _held_out(n, k, seed, count, rng_seed):
    """A Watts-Strogatz graph, ``count`` of its undirected pairs held out:
    (full edge_index, the reduced one, the held-out pairs [count, 2])."""
    ei_full = watts_strogatz_graph(n, k, 0.1, seed=seed)
    und = ei_full[:, ei_full[0] < ei_full[1]]
    rng = np.random.default_rng(rng_seed)
    drop = rng.choice(und.shape[1], count, replace=False)
    keep = np.ones(und.shape[1], bool)
    keep[drop] = False
    return ei_full, _sym(und[:, keep]), und[:, drop].T, rng


def test_insert_edges_exact_vs_rebuild():
    n = 300
    ei_full, ei_small, dropped, rng = _held_out(n, 8, 9, 20, 0)
    cfg = Config(**BASE)
    links = _links(rng, n, 200)
    small, full = _scorer(cfg, ei_small, n, links), _scorer(cfg, ei_full, n,
                                                             links)
    queries = _links(rng, n, 128)
    before = small.score(queries)
    small.insert_edges(dropped)                  # undirected pairs
    _assert_sketches_equal(small, full)
    np.testing.assert_allclose(small.deg.numpy(), full.deg.numpy())
    want = full.score(queries)
    np.testing.assert_allclose(small.score(queries), want, rtol=1e-5,
                               atol=1e-5)
    assert not np.allclose(before, want)         # the insert mattered
    assert small.last_update_stats["op"] == "insert"
    assert len(small.last_update_stats["rows"]) == cfg.max_hash_hops
    # a second batch goes through the accumulated extra edges
    two = _scorer(cfg, ei_small, n, links)
    two.insert_edges(dropped[:7])
    two.insert_edges(dropped[7:])
    _assert_sketches_equal(two, full)


def _weighted(n, rng_seed):
    ei_full = watts_strogatz_graph(n, 6, 0.1, seed=11)
    und = ei_full[:, ei_full[0] < ei_full[1]]
    rng = np.random.default_rng(rng_seed)
    w_und = rng.integers(1, 4, und.shape[1]).astype(np.float32)
    drop = rng.choice(und.shape[1], 10, replace=False)
    keep = np.ones(und.shape[1], bool)
    keep[drop] = False
    return und, w_und, drop, keep, rng


@pytest.mark.parametrize("op", ["insert", "delete"])
def test_weighted_updates_with_RA(op):
    """Weighted insertion and deletion with use_RA: degrees, the RA CSR
    and the sketches equal a from-scratch scorer's on the changed weighted
    graph (the weights doubled for undirected pairs, the CSR's (src, dst)
    orientation)."""
    n = 200
    und, w_und, drop, keep, rng = _weighted(n, 1)
    small = _sym(und[:, keep], w_und[keep])
    full = _sym(und, w_und)
    cfg = Config(**BASE, use_RA=True)
    links = _links(rng, n, 100)
    start, goal = (small, full) if op == "insert" else (full, small)
    a = _scorer(cfg, start[0], n, links, start[1])
    b = _scorer(cfg, goal[0], n, links, goal[1])
    update = a.insert_edges if op == "insert" else a.delete_edges
    update(und[:, drop].T, weights=w_und[drop])
    np.testing.assert_allclose(a.deg.numpy(), b.deg.numpy())
    np.testing.assert_allclose((a.ra_csr - b.ra_csr).toarray(), 0)
    _assert_sketches_equal(a, b)
    q = _links(rng, n, 96)
    np.testing.assert_allclose(a.score(q), b.score(q), rtol=1e-5, atol=1e-5)


def test_delete_edges_exact_vs_rebuild():
    n = 300
    ei_full, ei_small, dropped, rng = _held_out(n, 8, 9, 20, 0)
    cfg = Config(**BASE)
    links = _links(rng, n, 200)
    full, small = _scorer(cfg, ei_full, n, links), _scorer(cfg, ei_small, n,
                                                            links)
    queries = _links(rng, n, 128)
    before = full.score(queries)
    full.delete_edges(dropped)
    _assert_sketches_equal(full, small)
    np.testing.assert_allclose(full.deg.numpy(), small.deg.numpy())
    want = small.score(queries)
    np.testing.assert_allclose(full.score(queries), want, rtol=1e-5,
                               atol=1e-5)
    assert not np.allclose(before, want)         # the delete mattered
    # two sequential delete batches: tombstones over tombstones
    two = _scorer(cfg, ei_full, n, links)
    two.delete_edges(dropped[:7])
    two.delete_edges(dropped[7:])
    _assert_sketches_equal(two, small)
    # insert then delete restores the original state bit for bit (a
    # delete out of the extra edges before their fold)
    rt = _scorer(cfg, ei_small, n, links)
    golden_mh = rt.sk.minhash.clone()
    golden_deg = rt.deg.clone()
    rt.insert_edges(dropped)
    rt.delete_edges(dropped)
    np.testing.assert_array_equal(rt.sk.minhash.numpy(), golden_mh.numpy())
    np.testing.assert_array_equal(rt.sk.hll.numpy(), small.sk.hll.numpy())
    np.testing.assert_allclose(rt.deg.numpy(), golden_deg.numpy())


@pytest.mark.parametrize("hops_only,max_hops", [
    (False, 1), (True, 1), (False, 2), (True, 2), (False, 3), (True, 3)])
def test_streaming_random_interleaved_sequence_vs_rebuild(hops_only,
                                                          max_hops):
    """After an arbitrary interleaved sequence of insert and delete
    batches (deletes of edges inserted earlier, re-inserts of deleted
    ones) the state is bit-equal to a build on the final graph, on full
    and hops-only stacks."""
    n = 200
    ei0 = watts_strogatz_graph(n, 6, 0.1, seed=4)
    cfg = Config(**BASE, hops_only_sketches=hops_only,
                 max_hash_hops=max_hops, use_zero_one=(max_hops == 1))
    rng = np.random.default_rng(7)
    links = _links(rng, n, 200)
    scorer = _scorer(cfg, ei0, n, links)
    current = set(map(tuple, np.sort(
        ei0.T[ei0[0] < ei0[1]], axis=1).tolist()))
    for step in range(8):
        if step % 2 == 0 or len(current) < 50:
            pairs = []
            while len(pairs) < 5:
                u, v = sorted(rng.integers(0, n, 2).tolist())
                if u != v and (u, v) not in current:
                    pairs.append((u, v))
                    current.add((u, v))
            scorer.insert_edges(np.array(pairs))
        else:
            pairs = [list(current)[i] for i in
                     rng.choice(len(current), 5, replace=False)]
            for p in pairs:
                current.discard(p)
            scorer.delete_edges(np.array(pairs))
    fresh = _scorer(cfg, _sym(np.array(sorted(current)).T), n, links)
    _assert_sketches_equal(scorer, fresh)
    np.testing.assert_allclose(scorer.deg.numpy(), fresh.deg.numpy(),
                               rtol=1e-5)
    q = _links(rng, n, 128)
    np.testing.assert_allclose(scorer.score(q), fresh.score(q), rtol=1e-5,
                               atol=1e-5)


def test_streaming_tombstones_compaction_and_directed_updates():
    """Queries under live tombstones, a re-insert of a tombstoned pair, a
    forced compaction, and a directed (undirected=False) update that takes
    the scorer off the symmetric fast path for good, each checked bit for
    bit against a from-scratch build."""
    n = 150
    ei0 = watts_strogatz_graph(n, 6, 0.1, seed=11)
    cfg = Config(**BASE)
    rng = np.random.default_rng(3)
    links = _links(rng, n, 200)

    def check(scorer, current):
        fresh = _scorer(cfg, _sym(np.array(sorted(current)).T), n, links)
        np.testing.assert_array_equal(scorer.sk.minhash.numpy(),
                                      fresh.sk.minhash.numpy())
        np.testing.assert_array_equal(scorer.sk.hll.numpy(),
                                      fresh.sk.hll.numpy())

    scorer = _scorer(cfg, ei0, n, links)
    current = set(map(tuple, np.sort(
        ei0.T[ei0[0] < ei0[1]], axis=1).tolist()))
    scorer._ensure_adj()
    assert scorer._is_symmetric()
    # 1. delete CSR pairs: live tombstones, which every walk filters
    pairs = sorted(current)[:5]
    for p in pairs:
        current.discard(p)
    scorer.delete_edges(np.array(pairs))
    assert len(scorer._del_keys) == 10  # 5 pairs x 2 directions
    check(scorer, current)
    # 2. re-insert two of the tombstoned pairs (extras under tombstones)
    back = pairs[:2]
    for p in back:
        current.add(p)
    scorer.insert_edges(np.array(back))
    assert len(scorer._del_keys) > 0
    check(scorer, current)
    # 3. a forced compaction changes nothing observable
    scorer._compact()
    assert len(scorer._del_keys) == 0
    check(scorer, current)
    # 4. a directed delete of one direction, then its restore: off the
    # symmetric path, and it stays off
    u, v = sorted(current)[10]
    scorer.delete_edges(np.array([[u, v]]), undirected=False)
    assert scorer._symmetric is False
    scorer.insert_edges(np.array([[u, v]]), undirected=False)
    assert scorer._symmetric is False
    check(scorer, current)
    # 5. more undirected churn on the dst-sorted path
    pairs = sorted(current)[20:24]
    for p in pairs:
        current.discard(p)
    scorer.delete_edges(np.array(pairs))
    check(scorer, current)


def test_streaming_delete_on_empty_base_csr():
    """A scorer grown from a zero-edge graph: a delete of freshly
    inserted pairs finds them in the extras (the empty key table is not
    indexed), a second delete raises, and the round trip restores the
    original state."""
    n = 60
    cfg = Config(**BASE)
    links = _links(np.random.default_rng(0), n, 60)
    sc = _scorer(cfg, np.zeros((2, 0), np.int32), n, links)
    mh0, hll0 = sc.sk.minhash.clone(), sc.sk.hll.clone()
    pairs = np.array([[1, 2], [3, 4]])
    sc.insert_edges(pairs)
    sc.delete_edges(pairs)
    with pytest.raises(ValueError, match="not present"):
        sc.delete_edges(pairs)
    np.testing.assert_array_equal(sc.sk.minhash.numpy(), mh0.numpy())
    np.testing.assert_array_equal(sc.sk.hll.numpy(), hll0.numpy())


def test_streaming_updates_on_hops_only_stacks():
    """K-row hops-only stacks: hop-0 source rows are recomputed per
    touched id, and inserts and deletes stay bit-equal to a hops-only
    rebuild."""
    n = 300
    ei_full, ei_small, dropped, rng = _held_out(n, 8, 9, 20, 0)
    cfg = Config(**BASE, hops_only_sketches=True)
    links = _links(rng, n, 200)
    small, full = _scorer(cfg, ei_small, n, links), _scorer(cfg, ei_full, n,
                                                             links)
    assert small.sk.minhash.shape[0] == cfg.max_hash_hops
    queries = _links(rng, n, 128)
    small.insert_edges(dropped)
    _assert_sketches_equal(small, full)
    np.testing.assert_allclose(small.score(queries), full.score(queries),
                               rtol=1e-5, atol=1e-5)
    golden = _scorer(cfg, ei_small, n, links)
    small.delete_edges(dropped)
    _assert_sketches_equal(small, golden)
    np.testing.assert_allclose(small.deg.numpy(), golden.deg.numpy())


def test_delete_edges_missing_edge_is_atomic():
    """Deleting a pair that is not in the graph, or inserting with a
    weight count that does not match the edges, raises before any state
    changes: degrees, sketches and adjacency are untouched."""
    n = 100
    ei = watts_strogatz_graph(n, 4, 0.1, seed=3)
    cfg = Config(**BASE)
    links = _links(np.random.default_rng(2), n, 60)
    scorer = _scorer(cfg, ei, n, links)
    mh0, deg0 = scorer.sk.minhash.clone(), scorer.deg.clone()
    have = set(map(tuple, ei.T.tolist()))
    missing = next((u, v) for u in range(n) for v in range(n)
                   if u != v and (u, v) not in have)
    present = tuple(ei[:, 0].tolist())
    with pytest.raises(ValueError, match="not present"):
        scorer.delete_edges(np.array([present, missing]))
    with pytest.raises(ValueError, match="weights"):
        scorer.insert_edges(np.array([missing]), weights=[1.0, 2.0])
    np.testing.assert_array_equal(scorer.sk.minhash.numpy(), mh0.numpy())
    np.testing.assert_allclose(scorer.deg.numpy(), deg0.numpy())
    assert scorer._out_sorted.shape[1] == ei.shape[1]
    assert not scorer._del_keys.size


@pytest.mark.parametrize("hops_only", [False, True])
def test_same_updates_through_both_packages(hops_only):
    """One graph and one update sequence through the JAX package's scorer
    and the port's, with the JAX model's weights carried across by
    models/convert.py: the stacks bit-equal (MinHash after from_biased),
    cards to rtol 1e-5 (HLL estimates in another float order), degrees
    equal, scores within 1e-5."""
    from subgraph_sketching_tpu.config import Config as JConfig
    from subgraph_sketching_tpu.graph import Graph as JGraph
    from subgraph_sketching_tpu.graph.preprocess import (
        build_link_dataset as jbuild,
    )
    from subgraph_sketching_tpu.graph.splits import SplitData as JSplitData
    from subgraph_sketching_tpu.serving import LinkScorer as JLinkScorer
    from subgraph_sketching_tpu.train.loops import BuddyTrainer as JTrainer
    from subgraph_sketching_tpu_torch.models import (
        BUDDY, buddy_state_dict_from_flax,
    )

    n = 250
    ei_full, ei_small, dropped, rng = _held_out(n, 8, 5, 30, 4)
    kw = {**BASE, "hops_only_sketches": hops_only}
    jcfg, cfg = JConfig(**kw), Config(**kw)
    links = _links(rng, n, 200)
    order = np.lexsort((ei_small[1], ei_small[0]))
    ei = np.ascontiguousarray(ei_small[:, order])
    jds = jbuild(JSplitData(graph=JGraph(ei, n), pos_edges=links[:100],
                            neg_edges=links[100:]), jcfg, "train")
    tr = JTrainer(jcfg, jds, None)
    state = tr.init_state(jax.random.PRNGKey(0))
    jscorer = JLinkScorer(tr, jds, state, min_bucket=64)
    ds = build_link_dataset(SplitData(graph=Graph(ei, n),
                                      pos_edges=links[:100],
                                      neg_edges=links[100:]), cfg, "train",
                            device="cpu")
    model = BUDDY.from_config(cfg, None)
    model.load_state_dict(buddy_state_dict_from_flax(
        jax.tree.map(np.asarray, state.params),
        jax.tree.map(np.asarray, state.batch_stats)))
    scorer = LinkScorer(cfg, model, ds, device="cpu")
    queries = _links(rng, n, 128)
    for op, batch in (("insert", dropped[:12]), ("insert", dropped[12:]),
                      ("delete", dropped[5:20]), ("insert", dropped[8:15]),
                      ("delete", ei_small[:, :6].T[ei_small[0, :6]
                                                   < ei_small[1, :6]])):
        for s in (jscorer, scorer):
            getattr(s, f"{op}_edges")(batch)
        np.testing.assert_array_equal(from_biased(scorer.sk.minhash),
                                      np.asarray(jscorer.sk.minhash))
        np.testing.assert_array_equal(scorer.sk.hll.numpy(),
                                      np.asarray(jscorer.sk.hll))
        np.testing.assert_allclose(scorer.sk.cards.numpy(),
                                   np.asarray(jscorer.sk.cards), rtol=1e-5)
        np.testing.assert_array_equal(scorer.deg.numpy(),
                                      np.asarray(jscorer.deg))
        np.testing.assert_allclose(scorer.score(queries),
                                   jscorer.score(queries), rtol=1e-5,
                                   atol=1e-5)
