"""The port's heuristics tier (subgraph_sketching_tpu_torch/heuristics.py,
runners/run_heuristics.py) against the JAX package's, on the CPU.

Tolerances:
  * CN, AA, RA on the host: equal (the same scipy products on both
    sides); PPR rtol 1e-6;
  * ``DeviceHeuristics`` (here its torch code on the CPU) against JAX's
    and the host functions: rtol 1e-4, atol 1e-5, as tests/test_ops.py
    holds JAX's (float32 sums in another order); its padded neighbour
    lists equal JAX's;
  * the runner's summaries on synth-ba within 1e-4 of the JAX runner's
    (``--device cpu`` runs the host functions, as the JAX runner does by
    default, so they come out equal).
"""

import json
import os

import numpy as np
import pytest
import scipy.sparse as ssp
import torch

from subgraph_sketching_tpu import heuristics as jheur
from subgraph_sketching_tpu.config import Config as JConfig
from subgraph_sketching_tpu.graph.synthetic import barabasi_albert_graph
from subgraph_sketching_tpu.runners import run_heuristics as jrun
from subgraph_sketching_tpu_torch import heuristics as heur
from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.heuristics import DeviceHeuristics
from subgraph_sketching_tpu_torch.runners import run_heuristics

HOST = {"CN": "common_neighbours", "AA": "adamic_adar",
        "RA": "resource_allocation"}


def _hub_graph(n=400):
    """The weighted BA hub graph of tests/test_ops.py (symmetric integer
    weights), and 200 links, 8 of them at the hub."""
    ei = barabasi_albert_graph(n, 6, seed=2)
    rng = np.random.default_rng(0)
    w = rng.integers(1, 4, ei.shape[1]).astype(np.float32)
    key = np.minimum(ei[0], ei[1]) * n + np.maximum(ei[0], ei[1])
    _, first = np.unique(key, return_index=True)
    wmap = dict(zip(key[first], w[first]))
    w = np.array([wmap[k] for k in key], np.float32)
    A = ssp.csr_matrix((w, (ei[0], ei[1])), shape=(n, n))
    links = np.stack([rng.integers(0, n, 200),
                      rng.integers(0, n, 200)], axis=1)
    links[:8, 0] = 0
    return A, links


@pytest.mark.parametrize("kind", list(HOST))
def test_host_functions_match_jax(kind):
    A, links = _hub_graph()
    want = getattr(jheur, HOST[kind])(A, links, batch_size=64)
    got = getattr(heur, HOST[kind])(A, links, batch_size=64)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_ppr_matches_jax():
    A, links = _hub_graph(120)
    want, wl = jheur.personalized_pagerank(A, links)
    got, gl = heur.personalized_pagerank(A, links)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("kind", list(HOST))
def test_device_heuristics_match_jax_and_host(kind):
    """The bucketed compare-all on the weighted hub graph (several
    buckets) against JAX's DeviceHeuristics and the host function."""
    A, links = _hub_graph()
    dev = DeviceHeuristics(A, device="cpu")
    jdev = jheur.DeviceHeuristics(A)
    assert dev.buckets == jdev.buckets and len(dev.buckets) > 1
    got = dev.scores(links, kind)
    np.testing.assert_allclose(got, jdev.scores(links, kind), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got, getattr(heur, HOST[kind])(A, links),
                               rtol=1e-4, atol=1e-5)
    # chunking changes nothing: one link per chunk
    small = DeviceHeuristics(A, chunk_elems=1, device="cpu")
    np.testing.assert_allclose(small.scores(links[:40], kind), got[:40],
                               rtol=1e-6, atol=1e-7)


def test_padded_lists_match_jax():
    """The [B, D] neighbour ids and weights built from the CSR (on the
    device, in the port) equal JAX's per-node loop's."""
    A, links = _hub_graph()
    dev = DeviceHeuristics(A, device="cpu")
    jdev = jheur.DeviceHeuristics(A)
    nodes = np.concatenate([links[:, 0], [0, 399]])
    for D in dev.buckets:
        fit = nodes[dev.deg[nodes] <= D]
        nbr, w = dev._padded(torch.from_numpy(fit), D)
        jnbr, jw = jdev._padded(fit, D)
        np.testing.assert_array_equal(nbr.numpy(), jnbr)
        np.testing.assert_array_equal(w.numpy(), jw)
    np.testing.assert_array_equal(dev.bucket_of(links),
                                  np.searchsorted(np.asarray(jdev.buckets),
                                                  np.maximum(
                                                      jdev.deg[links[:, 0]],
                                                      jdev.deg[links[:, 1]])))


def test_heuristics_hand_computed():
    # 4-node path graph 0-1-2-3 plus edge 0-2 (undirected)
    edges = [(0, 1), (1, 2), (2, 3), (0, 2)]
    ei = np.array(edges + [(b, a) for a, b in edges]).T
    A = ssp.csr_matrix((np.ones(ei.shape[1]), (ei[0], ei[1])), shape=(4, 4))
    links = np.array([[0, 3], [1, 3], [0, 1]])
    # every link has the one common neighbour 2, of degree 3
    want = {"CN": [1, 1, 1], "RA": [1 / 3] * 3, "AA": [1 / np.log(3)] * 3}
    dev = DeviceHeuristics(A, device="cpu")
    for kind, value in want.items():
        np.testing.assert_allclose(getattr(heur, HOST[kind])(A, links),
                                   value, rtol=1e-6)
        np.testing.assert_allclose(dev.scores(links, kind), value, rtol=1e-6)


def test_device_heuristics_bucket_pad_uses_own_bucket():
    """A partial chunk is padded with a link of its own bucket: a global
    link 0 at the hub would not fit the narrow bucket's width."""
    n = 140
    hub_dst = np.arange(1, 101)
    ring = np.stack([np.arange(101, n), np.roll(np.arange(101, n), -1)])
    src = np.concatenate([np.zeros(100, np.int64), ring[0]])
    dst = np.concatenate([hub_dst, ring[1]])
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    A = ssp.csr_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    links = np.concatenate([
        np.array([[0, 5]]),
        np.stack([np.arange(101, 131), np.arange(102, 132)], axis=1),
    ]).astype(np.int32)
    dh = DeviceHeuristics(A, chunk_elems=8 * 32 * 32, device="cpu")
    np.testing.assert_allclose(dh.scores(links, "CN"),
                               heur.common_neighbours(A, links), rtol=1e-5,
                               atol=1e-5)


def test_device_heuristics_rejects_undersized_buckets():
    n = 120
    hub_dst = np.arange(1, 101)
    src = np.concatenate([np.zeros(100, np.int64), hub_dst])
    dst = np.concatenate([hub_dst, np.zeros(100, np.int64)])
    A = ssp.csr_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    with pytest.raises(ValueError, match="max.*degree"):
        DeviceHeuristics(A, buckets=(32, 64), device="cpu")
    DeviceHeuristics(A, buckets=(32, 128), device="cpu")  # covering is fine


def test_heuristics_automorphic_nodes_score_equal():
    """Links related by a graph automorphism score the same under every
    heuristic, on the host and by DeviceHeuristics (reference
    test_heuristics.py test_iso_graph)."""
    # two squares joined by the bridge 3-4: v -> 7-v is an automorphism
    und = np.array([[0, 1], [1, 2], [2, 3], [3, 0],
                    [4, 5], [5, 6], [6, 7], [7, 4], [3, 4]])
    src = np.concatenate([und[:, 0], und[:, 1]])
    dst = np.concatenate([und[:, 1], und[:, 0]])
    A = ssp.csr_matrix((np.ones(len(src)), (src, dst)), shape=(8, 8))
    links = np.array([[0, 2], [7, 5]], dtype=np.int64)
    dev = DeviceHeuristics(A, device="cpu")
    for kind, name in HOST.items():
        s = getattr(heur, name)(A, links)
        assert s[0] == s[1], (kind, s)
        d = dev.scores(links, kind)
        assert d[0] == d[1], (kind, d)
    s, _ = heur.personalized_pagerank(A, links)
    np.testing.assert_allclose(s[0], s[1], rtol=1e-8)


def test_ppr_scores_in_input_order():
    ei = np.asarray(barabasi_albert_graph(40, 3, seed=2))
    A = ssp.csr_matrix((np.ones(ei.shape[1]), (ei[0], ei[1])), shape=(40, 40))
    links = np.array([[7, 3], [2, 9], [7, 5], [1, 4]], np.int32)  # unsorted
    s, out_links = heur.personalized_pagerank(A, links)
    np.testing.assert_array_equal(out_links, links)
    assert (s >= 0).all() and (s <= 1).all()
    for i, (u, v) in enumerate(links):
        s1, _ = heur.personalized_pagerank(A, np.array([[u, v]], np.int32))
        np.testing.assert_allclose(s[i], s1[0], rtol=1e-6)


def _assert_summaries_match(got, want):
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys(), name
        for key, value in want[name].items():
            assert abs(got[name][key] - value) <= 1e-4, (key, got[name][key],
                                                         value)


@pytest.mark.parametrize("heuristics,K", [
    (("RA", "CN", "AA", "PPR"), 100),   # the reference's K: no extra
    (("CN", "RA"), 50)])                # cfg.K rides along
def test_runner_matches_jax(heuristics, K):
    want = jrun.run(JConfig(dataset_name="synth-ba", reps=1, K=K),
                    heuristics=heuristics)
    got = run_heuristics.run(Config(dataset_name="synth-ba", reps=1, K=K),
                             heuristics=heuristics, device="cpu")
    _assert_summaries_match(got, want)
    extra = [k for k in got[heuristics[0]] if "hits" in k]
    assert extra == ([] if K == 100 else [f"{heuristics[0]}_hits50_test_mean"])


def test_runner_reference_flags_and_run_dir(tmp_path):
    """The reference heuristics CLI surface (run_heuristics.py:110-120)
    parses, with the summaries mirrored to the JSONL sink by
    --run_dir."""
    run_dir = str(tmp_path / "heur")
    results = run_heuristics.main([
        "--dataset_name", "synth-ba", "--reps", "1", "--heuristics", "CN",
        "--wandb_entity", "link-prediction", "--wandb_project",
        "link-prediction", "--sample_size", "5", "--run_dir", run_dir,
        "--platform", "cpu", "--device", "cpu"])
    assert "CN" in results and "CN_test_mean" in results["CN"]
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert any("CN_test_mean" in rec for rec in lines)
    want = jrun.run(JConfig(dataset_name="synth-ba", reps=1),
                    heuristics=("CN",))
    _assert_summaries_match(results, want)


@pytest.mark.parametrize("argv,device", [
    ([], "cuda"), (["--device"], "cuda"), (["--device", "cpu"], "cpu"),
    (["--device", "cuda:0"], "cuda:0"), (["--device", "--reps", "2"], "cuda")])
def test_device_flag_spellings(argv, device):
    """Both the JAX package's bare ``--device`` and the port's
    ``--device <name>`` parse."""
    args = run_heuristics.make_parser().parse_args(argv)
    assert args.device == device


def test_entry_points_need_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    A, _ = _hub_graph(50)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceHeuristics(A)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_heuristics.run(Config(dataset_name="synth-ba"), ("CN",))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_heuristics.main(["--dataset_name", "synth-ba", "--heuristics",
                             "CN", "--device"])
