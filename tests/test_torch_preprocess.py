"""The port's BUDDY preprocessing on the reference's datasets
(subgraph_sketching_tpu_torch/graph/preprocess.py, heuristics.py) against
the JAX package's, on the CPU, over the fixtures of
tests/test_torch_datasets.py.

Tolerances:
  * integer sketch state (MinHash, HLL registers): bit-equal;
  * cardinalities rtol 1e-5 and subgraph features rtol 1e-5, atol 1e-4,
    as in tests/test_torch_sketch.py: the register sums, the log of the
    linear-counting estimate and the ladder's float32 arithmetic run in
    another order, or another implementation, than XLA's, so they agree
    to the last bits only;
  * SIGN features: rtol 1e-5, atol 1e-6 (float32 sums in another order);
  * RA: rtol 1e-6 (the same scipy products; equal in practice);
  * ``make_train_eval_dataset``, the cache files' names and what a cache
    written by one package gives the other: equal.
"""

import os

import numpy as np
import pytest
import torch

from ogb_fixture import (
    write_citation2_fixture, write_collab_fixture, write_ddi_fixture,
    write_ppa_fixture,
)
from subgraph_sketching_tpu.config import Config as JConfig
from subgraph_sketching_tpu.graph import preprocess as jpre
from subgraph_sketching_tpu.graph.datasets import get_data as jget_data
from subgraph_sketching_tpu.heuristics import (
    resource_allocation as jresource_allocation,
)
from subgraph_sketching_tpu_torch import heuristics
from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.graph import preprocess
from subgraph_sketching_tpu_torch.graph.container import Graph
from subgraph_sketching_tpu_torch.graph.datasets import get_data
from subgraph_sketching_tpu_torch.sketch.minhash import from_biased
from test_torch_datasets import _write_planetoid

# fixture family -> (dataset name, writer, Config overrides)
FAMILIES = {
    "cora": ("Cora", None, {}),
    "pubmed_3hop": ("Pubmed", None, {"max_hash_hops": 3}),
    "collab_year": ("ogbl-collab", write_collab_fixture,
                    {"year": 2007, "add_normed_features": True}),
    "citation2": ("ogbl-citation2", write_citation2_fixture,
                  {"num_negs": 3, "sign_k": 3}),
    "ddi": ("ogbl-ddi", write_ddi_fixture, {"num_negs": 2, "sign_k": 2}),
    "ppa_RA": ("ogbl-ppa", write_ppa_fixture,
               {"use_RA": True, "use_feature": False, "use_zero_one": True}),
}


def _write(root, family):
    name, writer, _ = FAMILIES[family]
    if writer is None:
        _write_planetoid(str(root), name, name.lower())
    else:
        writer(str(root))


def _configs(root, family, **extra):
    name, _, overrides = FAMILIES[family]
    kw = dict(dataset_name=name, data_root=str(root), model="BUDDY",
              **overrides, **extra)
    return JConfig(**kw), Config(**kw)


def _build_both(root, family, jextra=None, extra=None):
    jcfg, _ = _configs(root, family, **(jextra or {}))
    _, cfg = _configs(root, family, **(extra or {}))
    jsplits, jdirected, _ = jget_data(jcfg)
    splits, directed, _ = get_data(cfg)
    return (jpre.build_all_splits(jsplits, jcfg, directed=jdirected),
            preprocess.build_all_splits(splits, cfg, directed=directed,
                                        device="cpu"))


def _assert_sketches_equal(t, j):
    np.testing.assert_array_equal(from_biased(t.minhash),
                                  np.asarray(j.minhash))
    np.testing.assert_array_equal(t.hll.numpy(), np.asarray(j.hll))
    np.testing.assert_allclose(t.cards.numpy(), np.asarray(j.cards),
                               rtol=1e-5)


def _assert_split_equal(t, j, sketches=True):
    np.testing.assert_array_equal(t.links, j.links)
    np.testing.assert_array_equal(t.labels, j.labels)
    np.testing.assert_array_equal(t.edge_index, j.edge_index)
    np.testing.assert_array_equal(t.edge_weight, j.edge_weight)
    np.testing.assert_array_equal(t.degrees, j.degrees)
    np.testing.assert_allclose(t.x, j.x, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t.subgraph_features, j.subgraph_features,
                               rtol=1e-5, atol=1e-4)
    assert (t.RA is None) == (j.RA is None)
    if j.RA is not None:
        np.testing.assert_allclose(t.RA, j.RA, rtol=1e-6)
    if sketches:
        _assert_sketches_equal(t.sketches, j.sketches)


def test_resource_allocation_matches_jax():
    rng = np.random.default_rng(0)
    n, e = 300, 3000
    ei = rng.integers(0, n, (2, e)).astype(np.int32)
    w = rng.integers(1, 4, e).astype(np.float32)
    g = Graph(ei, n, w).to_undirected()
    links = rng.integers(0, n, (1000, 2))
    for batch in (64, 2000000):
        got = heuristics.resource_allocation(g.csr(), links, batch)
        want = jresource_allocation(g.csr(), links, batch)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert heuristics.resource_allocation(g.csr(), links[:0]).shape == (0,)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_build_all_splits_matches_jax(tmp_path, family):
    _write(tmp_path, family)
    jds, ds = _build_both(tmp_path, family)
    assert set(ds) == set(jds) == {"train", "valid", "test"}
    for split in ds:
        _assert_split_equal(ds[split], jds[split])
    if family == "ppa_RA":
        assert ds["train"].RA is not None and ds["train"].RA.any()


def test_make_train_eval_dataset_matches_jax(tmp_path):
    _write(tmp_path, "citation2")
    jds, ds = _build_both(tmp_path, "citation2", {"use_RA": True},
                          {"use_RA": True})
    for n_pos in (7, 5000):
        got = preprocess.make_train_eval_dataset(ds["train"], n_pos)
        want = jpre.make_train_eval_dataset(jds["train"], n_pos)
        _assert_split_equal(got, want)
        assert len(got.links) == min(n_pos, 60) * 4
    # a train split that is not block-aligned is refused, as in JAX
    bad = preprocess.make_train_eval_dataset(ds["train"])
    bad.labels = np.ones_like(bad.labels)
    bad.labels[-1] = 0
    with pytest.raises(ValueError, match="not per-positive-block aligned"):
        preprocess.make_train_eval_dataset(bad)


# flag -> (file kind, files each package writes): one for each split with a
# message graph of its own (train, test), and for the per-link subgraph
# features, on the port, valid's too (the JAX package skips the split that
# reuses the train split's sketches)
CACHE_FLAGS = {"load_features": ("k0_features", 2, 2),
               "load_hashes": ("hashes", 2, 2),
               "cache_subgraph_features": ("subgraph_features", 2, 3)}


@pytest.mark.parametrize("flag", list(CACHE_FLAGS))
def test_caches_cross_between_packages(tmp_path, flag):
    """Each cache flag writes the JAX package's file names under
    ``cache_dir``, and a file written by either package loads in the other
    with the same arrays as a build without caches."""
    _write(tmp_path, "collab_year")
    plain_j, plain_t = _build_both(tmp_path, "collab_year")
    on = {flag: True}
    for writer in ("jax", "port"):
        d = str(tmp_path / writer)
        jcfg, cfg = _configs(tmp_path, "collab_year", cache_dir=d, **on)
        if writer == "jax":
            splits, directed, _ = jget_data(jcfg)
            jpre.build_all_splits(splits, jcfg, directed=directed)
        else:
            splits, directed, _ = get_data(cfg)
            preprocess.build_all_splits(splits, cfg, directed=directed,
                                        device="cpu")
    names = set(os.listdir(tmp_path / "jax"))
    port_names = set(os.listdir(tmp_path / "port"))
    kind, jax_count, port_count = CACHE_FLAGS[flag]
    assert names <= port_names
    assert sum(n.endswith(f"{kind}.npz") for n in names) == jax_count
    assert sum(n.endswith(f"{kind}.npz") for n in port_names) == port_count
    # each package reads the other's files
    for reader, d in (("port", "jax"), ("jax", "port")):
        jcfg, cfg = _configs(tmp_path, "collab_year",
                             cache_dir=str(tmp_path / d), **on)
        if reader == "port":
            splits, directed, _ = get_data(cfg)
            got = preprocess.build_all_splits(splits, cfg, directed=directed,
                                              device="cpu")
            for split in got:
                _assert_split_equal(got[split], plain_j[split],
                                    sketches=flag == "load_hashes")
        else:
            splits, directed, _ = jget_data(jcfg)
            got = jpre.build_all_splits(splits, jcfg, directed=directed)
            for split in got:
                _assert_split_equal(plain_t[split], got[split],
                                    sketches=flag == "load_hashes")


def test_subgraph_feature_cache_skips_the_sketches(tmp_path, monkeypatch):
    """With --cache_subgraph_features and a cache present, no sketch is
    built, and the cached features are the built ones."""
    _write(tmp_path, "cora")
    _, cfg = _configs(tmp_path, "cora", cache_dir=str(tmp_path / "c"),
                      cache_subgraph_features=True)
    splits, _, _ = get_data(cfg)
    first = preprocess.build_all_splits(splits, cfg, device="cpu")

    def no_sketches(*a, **k):
        raise AssertionError("sketches built despite the cache")
    monkeypatch.setattr(preprocess, "build_hash_tables", no_sketches)
    again = preprocess.build_all_splits(splits, cfg, device="cpu")
    for split in first:
        np.testing.assert_array_equal(again[split].subgraph_features,
                                      first[split].subgraph_features)
        assert again[split].sketches is None
    # a cache that does not match the links is refused
    np.savez(preprocess._cache_name(cfg, "train", "subgraph_features"),
             sf=np.zeros((3, 8), np.float32))
    with pytest.raises(ValueError, match="delete the cache file"):
        preprocess.build_all_splits(splits, cfg, device="cpu")


def test_use_plan_false_takes_the_scatter_route(tmp_path, monkeypatch):
    """--use_plan false on a graph past a small max_gather_slots: no plan
    is built, and the scatter route equals the (chunk-streamed) plan
    route."""
    _write(tmp_path, "collab_year")
    _, cfg = _configs(tmp_path, "collab_year", max_gather_slots=64)
    splits, directed, _ = get_data(cfg)
    planned = preprocess.build_all_splits(splits, cfg, device="cpu")
    plan = preprocess.make_auto_plan(planned["train"].edge_index,
                                     planned["train"].num_nodes,
                                     max_slots=64, device="cpu")
    assert plan.num_chunks > 1

    def no_plan(*a, **k):
        raise AssertionError("a plan was built under use_plan false")
    monkeypatch.setattr(preprocess, "make_auto_plan", no_plan)
    _, cfg = _configs(tmp_path, "collab_year", max_gather_slots=64,
                      use_plan=False)
    scattered = preprocess.build_all_splits(splits, cfg, device="cpu")
    for split in planned:
        t, p = scattered[split], planned[split]
        np.testing.assert_allclose(t.x, p.x, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(t.subgraph_features,
                                      p.subgraph_features)
        for a, b in zip(t.sketches, p.sketches):
            assert torch.equal(a, b)
