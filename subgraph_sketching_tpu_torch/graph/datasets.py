"""Dataset registry of the port: the bundled synthetic graphs.

``get_data`` keeps the JAX package's contract (returns ``(splits, directed,
eval_metric)``) and produces byte-identical splits for every ``synth-*``
dataset.  Planetoid and OGB loading is not ported yet and raises.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.graph.container import Graph
from subgraph_sketching_tpu_torch.graph.splits import SplitData, random_link_split
from subgraph_sketching_tpu_torch.graph.synthetic import (
    barabasi_albert_graph, erdos_renyi_graph, watts_strogatz_graph,
    watts_strogatz_graph_fast,
)


def synthetic_graph(name: str, seed: int = 0) -> Graph:
    """Deterministic synthetic dataset with random node features."""
    rng = np.random.default_rng(seed + 17)
    if name == "synth-ba":
        ei = barabasi_albert_graph(1000, 5, seed=seed)
        n = 1000
    elif name == "synth-ba-large":
        ei = barabasi_albert_graph(20000, 10, seed=seed)
        n = 20000
    elif name == "synth-er":
        ei = erdos_renyi_graph(1000, 0.01, seed=seed)
        n = 1000
    elif name == "synth-ws":
        # small-world: high clustering -> informative structure features
        ei = watts_strogatz_graph(2000, 10, 0.1, seed=seed)
        n = 2000
    elif name.startswith("synth-ws-"):
        # parameterised scale testbed: synth-ws-<num_nodes> (vectorised
        # generator)
        n = int(name[len("synth-ws-"):])
        ei = watts_strogatz_graph_fast(n, 10, 0.1, seed=seed)
    else:
        raise ValueError(f"unknown synthetic dataset {name}")
    x = (rng.random((n, 128)) < 0.05).astype(np.float32)  # sparse bag-of-words-like
    return Graph(ei, n, x=x)


def get_data(cfg: Config) -> Tuple[Dict[str, SplitData], bool, str]:
    """Load + split a dataset (reference get_data, src/data.py:67-119)."""
    name = cfg.dataset_name
    if not name.startswith("synth"):
        raise NotImplementedError(
            f"dataset {name}: only the synth-* datasets are ported so far "
            f"(Planetoid and OGB loading are queued)")
    g = synthetic_graph(name, seed=cfg.seed)
    splits = random_link_split(g, cfg.val_pct, cfg.test_pct, seed=cfg.seed,
                               neg_ratio=cfg.num_negs)
    return splits, False, "hits"
