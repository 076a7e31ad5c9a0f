"""Host graph container: numpy COO plus scipy CSR views for preprocessing.

A copy of the JAX package's graph/container.py.  Replaces the reference's
mix of pyg ``Data`` objects and scipy CSR matrices
(src/datasets/elph.py:69-74).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import scipy.sparse as ssp


@dataclass
class Graph:
    """COO graph with optional node features and edge weights (host)."""

    edge_index: np.ndarray              # [2, E] int32
    num_nodes: int
    edge_weight: Optional[np.ndarray] = None  # [E] float32
    x: Optional[np.ndarray] = None      # [n, d] float32 node features
    _csr: Optional[ssp.csr_matrix] = field(default=None, repr=False)

    def __post_init__(self):
        self.edge_index = np.asarray(self.edge_index, dtype=np.int32)
        if self.edge_weight is not None:
            self.edge_weight = np.asarray(self.edge_weight, dtype=np.float32)

    @property
    def num_edges(self) -> int:
        return self.edge_index.shape[1]

    @property
    def weights(self) -> np.ndarray:
        if self.edge_weight is None:
            return np.ones(self.num_edges, dtype=np.float32)
        return self.edge_weight

    def csr(self) -> ssp.csr_matrix:
        """Adjacency as scipy CSR, A[src, dst] = w (datasets/elph.py:69-74)."""
        if self._csr is None:
            self._csr = ssp.csr_matrix(
                (self.weights, (self.edge_index[0], self.edge_index[1])),
                shape=(self.num_nodes, self.num_nodes))
        return self._csr

    def degrees(self) -> np.ndarray:
        """Weighted degree A.sum(axis=0) (datasets/elph.py:74)."""
        return np.asarray(self.csr().sum(axis=0), dtype=np.float32).ravel()

    def to_undirected(self) -> "Graph":
        """Symmetrise + coalesce duplicate edges by summing weights."""
        ei = np.concatenate([self.edge_index, self.edge_index[::-1]], axis=1)
        w = np.concatenate([self.weights, self.weights])
        return Graph(ei, self.num_nodes, w, self.x).coalesce()

    def coalesce(self) -> "Graph":
        """Merge duplicate (src, dst) pairs, summing weights; sort by (src, dst)."""
        key = self.edge_index[0].astype(np.int64) * self.num_nodes + self.edge_index[1]
        order = np.argsort(key, kind="stable")
        key_sorted = key[order]
        uniq, first = np.unique(key_sorted, return_index=True)
        w_sorted = self.weights[order]
        w_out = np.add.reduceat(w_sorted, first)
        ei = np.stack([(uniq // self.num_nodes).astype(np.int32),
                       (uniq % self.num_nodes).astype(np.int32)])
        return Graph(ei, self.num_nodes, w_out.astype(np.float32), self.x)
