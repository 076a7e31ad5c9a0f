"""The plain reference against the program at a tiny size on the CPU, and
a whole run of every cell there (the chip's look skipped), correct."""

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark.inputs import graphs
from benchmark.reference import models, sketches
from benchmark.tests.tiny import tiny_cell

CPU = torch.device("cpu")
CELLS = ["elph-collab.train", "buddy-citation2.train"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _graph(seed=11):
    spec_ = dict(kind="multi", nodes=500, edges=3000, features=4,
                 exponent=0.5, weight_p=0.7, feature_dist="uniform")
    g = graphs.make_graph(spec_, seed, CPU)
    sym, w = graphs.symmetric(g["edges"], g["weight"], 500, sort=False)
    return g, sym, w


def test_sketches_equal_the_programs():
    from subgraph_sketching_tpu_torch.sketch.elph import (
        build_hash_tables, subgraph_features,
    )
    from subgraph_sketching_tpu_torch.sketch.minhash import from_biased
    from subgraph_sketching_tpu_torch.sketch.params import SketchParams
    g, sym, _ = _graph()
    sk = build_hash_tables(sym.numpy(), 500, SketchParams(), device="cpu")
    mh, hll, cards = sketches.sketch_tables(sym[0], sym[1], 500, 128, 8, 2)
    for k in range(3):
        assert np.array_equal(from_biased(sk.minhash[k]).astype(np.int64),
                              mh[k].numpy())
        assert torch.equal(sk.hll[k].int(), hll[k])
    assert torch.allclose(sk.cards, cards, rtol=1e-6)
    links = torch.randint(0, 500, (2000, 2), generator=torch.Generator()
                          .manual_seed(3))
    ref = sketches.link_features(links, mh, hll, cards, 8)
    prog = subgraph_features(links, sk, SketchParams())
    assert torch.allclose(prog, ref, rtol=1e-4, atol=1e-3)


def test_hll_table_equals_the_programs():
    """The reference simulates the table the port's estimator reads, bit
    for bit, and reads the same six-neighbour windows from it."""
    from subgraph_sketching_tpu_torch.sketch.hll import (
        _bias_step_tables, _load_tables,
    )
    raw, bias = sketches.bias_table(8)
    prog_raw, prog_bias = _load_tables(8)
    assert np.array_equal(raw, prog_raw) and np.array_equal(bias, prog_bias)
    bp, _ = _bias_step_tables(8)
    # rows of every fill, from mostly empty to full: estimates across the
    # linear-counting and the bias-corrected ranges
    g = torch.Generator().manual_seed(5)
    top = torch.randint(1, 9, (20000, 1), generator=g)
    regs = (torch.randint(0, 1 << 20, (20000, 256), generator=g) % top
            ).to(torch.int32)
    from subgraph_sketching_tpu_torch.sketch.hll import hll_count
    assert torch.equal(sketches.hll_count(regs, 8),
                       hll_count(regs.to(torch.int8), 8).float())
    assert len(bp) == len(raw) - 6


def test_gcn_adjacency_equals_the_programs():
    from subgraph_sketching_tpu_torch.graph.container import Graph
    from subgraph_sketching_tpu_torch.ops.graph_ops import gcn_norm, spmm
    g, sym, w = _graph()
    coal = Graph(sym.numpy(), 500, edge_weight=w.numpy()).coalesce()
    ei = torch.from_numpy(coal.edge_index.astype(np.int64))
    nei, nw = gcn_norm(ei, torch.from_numpy(coal.weights), 500)
    x = torch.randn(500, 3, generator=torch.Generator().manual_seed(1))
    adj = models.gcn_adjacency(sym[0], sym[1], w, 500)
    assert torch.allclose(torch.sparse.mm(adj, x), spmm(nei, nw, x, 500),
                          rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cell", CELLS)
def test_whole_run_is_correct(cell):
    res = bench_run.run(cell, 2 ** 33 + 5, 0.3, False, device="cpu",
                        cell=tiny_cell(cell))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_layers(cell):
    res = bench_run.run(cell, 77, 0.3, True, device="cpu",
                        cell=tiny_cell(cell))
    assert res["correct"]
    assert "setup_s" not in res["metrics"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0
