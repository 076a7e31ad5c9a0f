"""The port's production-scale equality tool
(subgraph_sketching_tpu_torch/tools/scale_equality.py) at small scale on
the CPU: the whole tool once per test run at synth-ws-3000, its ``buddy``
phase on two gloo ranks and its ELPH runs on a ``1,2`` data,graph mesh
(two gloo ranks) against one process, cut to one epoch of 4,096 links;
held against the JAX package on the conftest's virtual CPU devices
(computed here while the ranks run) and against the JAX tool's report.

Tolerances:
  * the partition (positions, halo width, halo rows a rank): equal to
    JAX's ``make_node_partition(..., 2)``;
  * the MinHash and HLL tables, in node order: bit-equal to JAX's
    ``build_hash_tables`` (MinHash after the bias is removed);
  * the probe features: rtol 1e-5, atol 1e-4 of JAX's
    ``subgraph_features`` (float32 estimator arithmetic in another order
    than XLA's), and within 1e-4 of the port's one-process features;
  * the sharded ELPH run against the single one: epoch losses within
    1e-4, metrics within 0.01 (the JAX tool's own test envelope).
"""

import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subgraph_sketching_tpu.graph.datasets import (
    synthetic_graph as jsynthetic_graph,
)
from subgraph_sketching_tpu.parallel.node_sharded import (
    make_node_partition as jmake_node_partition,
)
from subgraph_sketching_tpu.sketch.elph import (
    build_hash_tables as jbuild_hash_tables,
    subgraph_features as jsubgraph_features,
)
from subgraph_sketching_tpu.sketch.params import SketchParams as JParams
from subgraph_sketching_tpu_torch.sketch.minhash import from_biased
from subgraph_sketching_tpu_torch.tools import scale_equality as tool
from test_torch_parallel import run_once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 3000
JAX_REPORT = os.path.join(REPO, "tools", "scale_equality_500k.json")
# the keys the port's report adds to the JAX tool's, by section
EXTRA_KEYS = {
    "": {"device", "graph_ranks", "launch_s"},
    "buddy_preprocessing": {
        "graph_ranks", "hll_tables_bit_equal", "plans_s", "halo_route",
        "halo_exchange_s", "edges_by_rank", "k1_launches_build",
        "graph_s", "save_s", "rank_s", "reference_s", "compare_s",
        "rss_gb", "peak_card_gb", "reference_peak_card_gb"},
    "elph_shard_bytes": set(),
    "elph_memory_sharded": set(),
    "elph_memory_sharded.sharded": {
        "stages_s", "rss_gb_by_rank", "peak_card_gb_by_rank", "collectives",
        "edge_shard_sum"},
    "elph_memory_sharded.single_device": {"stages_s", "peak_card_gb"},
}

torch.set_num_threads(1)


def _jax_reference() -> dict:
    g = jsynthetic_graph(f"synth-ws-{N}")
    ei = np.asarray(g.edge_index)
    part = jmake_node_partition(ei, N, 2)
    params = JParams(max_hops=2)
    sk = jbuild_hash_tables(jnp.asarray(ei), N, params)
    sf = jsubgraph_features(jnp.asarray(tool.probe_links(N)), sk, params)
    return {"edge_index": ei, "perm": np.asarray(part.perm),
            "halo_width": int(part.halo_width),
            "halo_rows_per_dev": int(part.halo_rows_per_dev),
            "shard_size": int(part.shard_size),
            "minhash": np.asarray(sk.minhash), "hll": np.asarray(sk.hll),
            "features": np.asarray(sf)}


def _run_tool(work: str) -> dict:
    """The tool (in a thread: its phases are subprocesses) beside JAX's
    reference; the report and the phases' files."""
    box = {}

    def go():
        try:
            box["report"] = tool.run(N, None, "1,2", "cpu", graph_ranks=2,
                                     epochs=1, train_samples=4096,
                                     timeout=300, work=work)
        except Exception as e:   # raised below, in the test's thread
            box["error"] = e

    th = threading.Thread(target=go)
    th.start()
    want = _jax_reference()
    th.join(900)
    assert not th.is_alive(), "the tool did not end"
    if "error" in box:
        raise box["error"]
    part = tool.load_partition(os.path.join(work, "partition.npz"))
    shards = [np.load(os.path.join(work, f"shard{r}.npz")) for r in range(2)]
    return {"report": box["report"], "want": want,
            "perm": part.perm, "halo_width": part.halo_width,
            "shard_size": part.shard_size,
            "minhash": part.to_node_order(np.concatenate(
                [s["minhash"] for s in shards], axis=1)),
            "hll": part.to_node_order(np.concatenate(
                [s["hll"] for s in shards], axis=1)),
            "features": np.load(os.path.join(work, "features.npy"))}


@pytest.fixture(scope="module")
def ran(request, tmp_path_factory):
    return run_once(request, tmp_path_factory, "scale_equality", _run_tool)


def test_buddy_phase_equals_jax(ran):
    """The partition, the tables in node order and the probe features
    against JAX's; each rank holds half of the tables."""
    want, buddy = ran["want"], ran["report"]["buddy_preprocessing"]
    np.testing.assert_array_equal(ran["perm"], want["perm"])
    assert ran["halo_width"] == want["halo_width"]
    assert ran["shard_size"] == want["shard_size"]
    assert buddy["halo_rows_per_dev"] == want["halo_rows_per_dev"]
    assert buddy["edges"] == want["edge_index"].shape[1]
    np.testing.assert_array_equal(from_biased(ran["minhash"]),
                                  want["minhash"])
    np.testing.assert_array_equal(ran["hll"], want["hll"])
    assert buddy["minhash_tables_bit_equal"] is True
    assert buddy["hll_tables_bit_equal"] is True
    assert ran["features"].shape == (tool.PROBE_LINKS, 8)
    np.testing.assert_allclose(ran["features"], want["features"],
                               rtol=1e-5, atol=1e-4)
    assert buddy["max_feature_delta"] <= 1e-4
    assert buddy["per_device_fraction"] == 0.5
    assert buddy["halo_route"] == "all_to_all_single"   # gloo, CPU tensors


def test_sharded_elph_matches_one_process(ran):
    report = ran["report"]
    for name in ("sk_minhash", "sk_hll"):
        assert report["elph_shard_bytes"][name]["fraction"] == 0.5
    ms = report["elph_memory_sharded"]
    assert len(ms["sharded"]["losses"]) == 1
    assert len(ms["single_device"]["losses"]) == 1
    assert np.isfinite(ms["sharded"]["losses"]).all()
    assert ms["max_loss_delta"] <= 1e-4
    assert ms["max_metric_delta"] <= 0.01
    assert len(ms["sharded"]["results"]) == 3


def _section(report: dict, path: str) -> dict:
    for key in filter(None, path.split(".")):
        report = report[key]
    return report


def test_report_keys_are_the_jax_tools(ran):
    """Every section of the JAX report, with the JAX report's keys and the
    port's additions (EXTRA_KEYS) besides."""
    with open(JAX_REPORT) as f:
        want = json.load(f)
    extra = dict(EXTRA_KEYS, **{f"elph_shard_bytes.{k}": set()
                                for k in ("sk_minhash", "sk_hll")})
    for path, added in extra.items():
        assert set(_section(ran["report"], path)) == \
            set(_section(want, path)) | added, path


def test_raises_without_a_card(tmp_path):
    """No ``--device``: the card, which this CPU-only run lacks; nothing
    is launched and nothing written."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = tmp_path / "report.json"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main([str(N), str(out)])
    assert not out.exists()
