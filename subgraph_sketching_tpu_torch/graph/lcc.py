"""Largest-connected-component extraction (host).

A copy of the JAX package's graph/lcc.py: a vectorised replacement for the
reference's python-set BFS (src/lcc.py:7-44), applied to the Planetoid
datasets only (reference src/data.py:83,102-103).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as ssp

from subgraph_sketching_tpu_torch.graph.container import Graph


def largest_connected_component(g: Graph) -> np.ndarray:
    """Sorted node ids of the largest connected component."""
    adj = ssp.csr_matrix(
        (np.ones(g.num_edges), (g.edge_index[0], g.edge_index[1])),
        shape=(g.num_nodes, g.num_nodes))
    n_comp, labels = ssp.csgraph.connected_components(adj, directed=False)
    sizes = np.bincount(labels, minlength=n_comp)
    return np.nonzero(labels == sizes.argmax())[0]


def use_lcc(g: Graph) -> Graph:
    """Restrict the graph to its LCC, remapping node ids to 0..n-1
    (reference src/data.py:241-260)."""
    lcc = largest_connected_component(g)
    mapper = np.full(g.num_nodes, -1, dtype=np.int64)
    mapper[lcc] = np.arange(len(lcc))
    keep = (mapper[g.edge_index[0]] >= 0) & (mapper[g.edge_index[1]] >= 0)
    ei = mapper[g.edge_index[:, keep]].astype(np.int32)
    w = g.edge_weight[keep] if g.edge_weight is not None else None
    x = g.x[lcc] if g.x is not None else None
    return Graph(ei, len(lcc), w, x)
