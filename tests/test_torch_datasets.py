"""The port's dataset loading (subgraph_sketching_tpu_torch/graph/
datasets.py, graph/lcc.py) against the JAX package's, on the CPU.

Inputs are written in the exact on-disk layouts: the standard Planetoid
raw files (``_write_planetoid``, a copy of tests/test_datasets.py's) and
the raw OGB layout of tests/ogb_fixture.py.  The JAX package reads the OGB
files with pandas (the ``ogb`` package is not installed here), the port
with ``np.loadtxt``.  Every split (message graph, edge weights, node
features, positives, negatives), ``directed`` and ``eval_metric`` must be
equal, bit for bit; so must ``use_lcc``.  Each package samples the train
negatives on its own (separate ``cache_dir``s), from the same seed.
"""

import gzip
import os
import pickle

import numpy as np
import pytest
import scipy.sparse as ssp

from ogb_fixture import (
    write_citation2_fixture, write_collab_fixture, write_ddi_fixture,
    write_ppa_fixture,
)
from subgraph_sketching_tpu.config import Config as JConfig
from subgraph_sketching_tpu.graph import datasets as jdatasets
from subgraph_sketching_tpu.graph.container import Graph as JGraph
from subgraph_sketching_tpu.graph.lcc import use_lcc as juse_lcc
from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.graph import datasets
from subgraph_sketching_tpu_torch.graph.container import Graph
from subgraph_sketching_tpu_torch.graph.lcc import use_lcc

OGB_WRITERS = {"ogbl-collab": write_collab_fixture,
               "ogbl-citation2": write_citation2_fixture,
               "ogbl-ddi": write_ddi_fixture,
               "ogbl-ppa": write_ppa_fixture}


def _write_planetoid(root: str, name: str, key: str, n_all: int = 40,
                     n_test: int = 10, d: int = 8, gap: bool = False):
    """Synthesize ind.<key>.* files in the standard Planetoid layout:
    allx [n_all, d] + tx [n_test, d]; graph dict; shuffled test.index
    (a copy of tests/test_datasets.py's writer)."""
    rng = np.random.default_rng(3)
    raw = os.path.join(root, name, "raw")
    os.makedirs(raw, exist_ok=True)
    n = n_all + n_test + (2 if gap else 0)  # gap: isolated trailing nodes
    allx = ssp.csr_matrix(rng.random((n_all, d)).astype(np.float32))
    tx = ssp.csr_matrix(
        rng.random((n_test, d)).astype(np.float32) + 1.0)  # distinguishable
    # ring + chords so the LCC covers everything connected
    graph = {v: [(v + 1) % (n_all + n_test)] for v in range(n_all + n_test)}
    graph[0].append(n_all)  # chord into the test region
    if gap:
        graph[n - 2] = []
        graph[n - 1] = []
    test_index = rng.permutation(np.arange(n_all, n_all + n_test))
    if gap:  # citeseer-style: test indices skip some ids entirely
        test_index = np.concatenate([test_index[:-1], [n - 1]])
    for obj, payload in (("x", allx[:5]), ("tx", tx), ("allx", allx),
                         ("graph", graph)):
        with open(os.path.join(raw, f"ind.{key}.{obj}"), "wb") as f:
            pickle.dump(payload, f)
    with open(os.path.join(raw, f"ind.{key}.test.index"), "w") as f:
        f.write("\n".join(str(i) for i in test_index))
    return test_index, np.asarray(tx.todense())


def _assert_graphs_equal(got, want):
    assert got.num_nodes == want.num_nodes
    np.testing.assert_array_equal(got.edge_index, want.edge_index)
    assert (got.edge_weight is None) == (want.edge_weight is None)
    if want.edge_weight is not None:
        np.testing.assert_array_equal(got.edge_weight, want.edge_weight)
    assert (got.x is None) == (want.x is None)
    if want.x is not None:
        assert got.x.dtype == want.x.dtype
        np.testing.assert_array_equal(got.x, want.x)


def _assert_data_equal(got, want):
    (splits, directed, metric), (jsplits, jdirected, jmetric) = got, want
    assert (directed, metric) == (jdirected, jmetric)
    assert set(splits) == set(jsplits) == {"train", "valid", "test"}
    for name, sd in splits.items():
        _assert_graphs_equal(sd.graph, jsplits[name].graph)
        np.testing.assert_array_equal(sd.pos_edges, jsplits[name].pos_edges)
        np.testing.assert_array_equal(sd.neg_edges, jsplits[name].neg_edges)


@pytest.mark.parametrize("name,key,gap", [
    ("Cora", "cora", False), ("Citeseer", "citeseer", True),
    ("Pubmed", "pubmed", False)])
def test_planetoid_get_data_equal_to_jax(tmp_path, name, key, gap):
    _write_planetoid(str(tmp_path), name, key, gap=gap)
    kw = dict(dataset_name=name, data_root=str(tmp_path))
    g = datasets.load_planetoid(name, str(tmp_path))
    _assert_graphs_equal(g, jdatasets.load_planetoid(name, str(tmp_path)))
    assert np.isfinite(g.x).all()
    _assert_data_equal(datasets.get_data(Config(**kw)),
                       jdatasets.get_data(JConfig(**kw)))


def test_use_lcc_equal_to_jax():
    rng = np.random.default_rng(0)
    n = 90
    # three components of different sizes, plus isolated nodes
    parts = [np.arange(0, 40), np.arange(40, 60), np.arange(60, 85)]
    # each part a ring plus random chords
    edges = [np.concatenate([np.stack([p, np.roll(p, 1)]),
                             rng.choice(p, (2, 2 * len(p)))], axis=1)
             for p in parts]
    ei = np.concatenate(edges, axis=1).astype(np.int32)
    w = rng.random(ei.shape[1]).astype(np.float32)
    x = rng.standard_normal((n, 5)).astype(np.float32)
    got = use_lcc(Graph(ei, n, w, x))
    _assert_graphs_equal(got, juse_lcc(JGraph(ei, n, w, x)))
    assert got.num_nodes == 40
    unweighted = use_lcc(Graph(ei, n, None, None))
    _assert_graphs_equal(unweighted, juse_lcc(JGraph(ei, n, None, None)))


@pytest.mark.parametrize("name,year", [
    ("ogbl-collab", 0), ("ogbl-collab", 2007), ("ogbl-citation2", 0),
    ("ogbl-ddi", 0), ("ogbl-ppa", 0)])
def test_ogb_get_data_equal_to_jax(tmp_path, name, year):
    root = tmp_path / "data"
    OGB_WRITERS[name](str(root))
    kw = dict(dataset_name=name, data_root=str(root), year=year,
              num_negs=3 if name == "ogbl-citation2" else 1)
    got = datasets.get_data(Config(**kw, cache_dir=str(tmp_path / "port")))
    want = jdatasets.get_data(JConfig(**kw, cache_dir=str(tmp_path / "jax")))
    _assert_data_equal(got, want)
    splits, directed, metric = got
    assert directed == (name == "ogbl-citation2")
    assert metric == ("mrr" if directed else "hits")
    if directed:   # same-source negatives, one block per positive
        pos, neg = splits["train"].pos_edges, splits["train"].neg_edges
        np.testing.assert_array_equal(np.repeat(pos[:, 0], 3), neg[:, 0])
    if name == "ogbl-ddi":
        np.testing.assert_array_equal(splits["train"].graph.x, 1.0)
    # the train-negative cache: same file name in both packages, and each
    # reads the other's file
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax")
    (fname,) = os.listdir(tmp_path / "port")
    for src in ("jax", "port"):
        negs = np.load(tmp_path / src / fname)["negs"][::-1].copy()
        np.savez(tmp_path / src / fname, negs=negs)
        cfg = dict(kw, cache_dir=str(tmp_path / src))
        mine = (datasets.get_data(Config(**cfg)) if src == "jax"
                else jdatasets.get_data(JConfig(**cfg)))
        np.testing.assert_array_equal(mine[0]["train"].neg_edges, negs)


def test_collab_year_filter_and_test_graph(tmp_path):
    """The year filter drops old train edges (and the message graph's),
    and only collab's test graph adds the valid edges."""
    write_collab_fixture(str(tmp_path))
    kw = dict(dataset_name="ogbl-collab", data_root=str(tmp_path),
              cache_dir=str(tmp_path / "cache"))
    all_years, _, _ = datasets.get_data(Config(**kw))
    recent, _, _ = datasets.get_data(Config(**kw, year=2010))
    assert len(recent["train"].pos_edges) < len(all_years["train"].pos_edges)
    assert recent["train"].graph.num_edges < \
        all_years["train"].graph.num_edges
    n_valid = len(recent["valid"].pos_edges)
    assert recent["test"].graph.num_edges == \
        recent["train"].graph.num_edges + 2 * n_valid
    assert recent["valid"].graph.num_edges == recent["train"].graph.num_edges


def test_float_parser_is_correctly_rounded(tmp_path):
    """The port parses a float as float(str) does (then casts to float32),
    also on strings near a float32 rounding boundary and with 17
    significant digits."""
    rng = np.random.default_rng(0)
    f = rng.standard_normal(3000).astype(np.float32)
    mid = (f.astype(np.float64)
           + np.nextafter(f, np.float32(np.inf)).astype(np.float64)) / 2
    wide = rng.standard_normal(3000) * 10.0 ** rng.integers(-8, 8, 3000)
    strs = ([f"{m:.25g}" for m in mid] + [f"{m:.9g}" for m in mid]
            + [repr(float(v)) for v in wide])
    path = tmp_path / "f.csv.gz"
    with gzip.open(path, "wt") as fh:
        fh.write("\n".join(f"{a},{b}" for a, b in
                           zip(strs[0::2], strs[1::2])) + "\n")
    got = datasets._read_csv_gz(str(path), np.float32)
    want = np.array([float(s) for s in strs]).astype(np.float32)
    assert got.shape == (len(strs) // 2, 2)
    np.testing.assert_array_equal(got.ravel(), want)


def test_missing_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="Planetoid raw files"):
        datasets.get_data(Config(dataset_name="Pubmed",
                                 data_root=str(tmp_path)))
    with pytest.raises(FileNotFoundError, match="raw ogbl-ppa layout"):
        datasets.get_data(Config(dataset_name="ogbl-ppa",
                                 data_root=str(tmp_path)))
    with pytest.raises(ValueError, match="unknown dataset"):
        datasets.get_data(Config(dataset_name="Photo"))


def test_default_data_root(monkeypatch):
    monkeypatch.delenv("SKETCH_DATA_ROOT", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert datasets.default_data_root() == os.path.join(repo, "dataset")
    assert datasets.default_data_root() == jdatasets.default_data_root()
    monkeypatch.setenv("SKETCH_DATA_ROOT", "/data/graphs")
    assert datasets.default_data_root() == "/data/graphs"
