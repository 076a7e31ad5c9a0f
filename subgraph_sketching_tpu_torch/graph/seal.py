"""SEAL subgraph extraction: per-link k-hop enclosing subgraphs (the JAX
package's graph/seal.py).

Reference: src/datasets/seal.py.  The extraction itself (BFS over CSR,
target-edge removal, node labelling) is host work.  Every subgraph is
padded to a fixed (max_nodes, max_edges), so a batch is a dense [B, N, ...]
stack, the same arrays as the JAX package's on either path: the C++
extractor (``graph/native.py``, built at first use; a failed build raises)
wherever the JAX package takes it, and the python path for a directed
graph, a label the C++ lacks, or ``native=False``.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import scipy.sparse as ssp

from subgraph_sketching_tpu_torch.graph.native import (
    NODE_LABELS, TWO_DIM_LABELS, seal_extract_batch_native,
)
from subgraph_sketching_tpu_torch.labelling import (
    de_node_labeling, de_plus_node_labeling, drnl_node_labeling,
)
from subgraph_sketching_tpu_torch.utils import neighbors


def k_hop_subgraph(src: int, dst: int, num_hops: int, A: ssp.csr_matrix,
                   sample_ratio: float = 1.0,
                   max_nodes_per_hop: Optional[int] = None,
                   node_features: Optional[np.ndarray] = None,
                   y: int = 1, directed: bool = False,
                   A_csc: Optional[ssp.csc_matrix] = None):
    """Enclosing subgraph around link (src, dst); nodes[0:2] = (src, dst)
    and the target edge is removed (reference src/datasets/seal.py:291-348).
    """
    nodes = [src, dst]
    dists = [0, 0]
    visited = {src, dst}
    fringe = {src, dst}
    for hop in range(1, num_hops + 1):
        if not directed:
            fringe = neighbors(fringe, A)
        else:
            fringe = neighbors(fringe, A) | neighbors(fringe, A_csc, False)
        fringe = fringe - visited
        visited = visited | fringe
        if sample_ratio < 1.0:
            fringe = set(random.sample(sorted(fringe),
                                       int(sample_ratio * len(fringe))))
        if max_nodes_per_hop is not None and max_nodes_per_hop < len(fringe):
            fringe = set(random.sample(sorted(fringe), max_nodes_per_hop))
        if not fringe:
            break
        nodes = nodes + sorted(fringe)
        dists = dists + [hop] * len(fringe)
    subgraph = A[nodes, :][:, nodes].tolil()
    subgraph[0, 1] = 0  # remove the target link
    subgraph[1, 0] = 0
    subgraph = subgraph.tocsr()
    x = node_features[nodes] if node_features is not None else None
    return nodes, subgraph, dists, x, y


def label_nodes(adj: ssp.csr_matrix, dists: List[int], node_label: str,
                max_dist: int) -> np.ndarray:
    """z labels for one subgraph (reference construct_pyg_graph,
    src/datasets/seal.py:372-386)."""
    if node_label == "drnl":
        return drnl_node_labeling(adj, 0, 1, max_dist)
    if node_label == "hop":
        return np.asarray(dists, dtype=np.int64)
    if node_label == "zo":
        return (np.asarray(dists) == 0).astype(np.int64)
    if node_label == "de":
        return de_node_labeling(adj, 0, 1, max_dist)
    if node_label == "de+":
        return de_plus_node_labeling(adj, 0, 1, max_dist)
    if node_label == "degree":
        z = np.asarray(adj.sum(axis=0)).ravel().astype(np.int64)
        return np.minimum(z, 100)
    return np.zeros(len(dists), dtype=np.int64)


@dataclass
class SealBatchArrays:
    """Dense padded batch of enclosing subgraphs."""

    z: np.ndarray            # [B, N] int32 node labels (0 where padded);
                             # [B, N, 2] for de/de+ (dist-to-src, dist-to-dst)
    node_mask: np.ndarray    # [B, N] bool
    edge_index: np.ndarray   # [B, E, 2] int32 local node ids
    edge_weight: np.ndarray  # [B, E] float32 (0 where padded)
    edge_mask: np.ndarray    # [B, E] bool
    x: Optional[np.ndarray]  # [B, N, d] float32
    node_ids: np.ndarray     # [B, N] int32 global ids (-1 where padded)
    y: np.ndarray            # [B] float32
    src_degree: np.ndarray   # [B] float32
    dst_degree: np.ndarray   # [B] float32


class SEALDataset:
    """Per-link enclosing subgraphs with fixed padding.

    ``dynamic=False`` extracts everything up front (reference SEALDataset,
    seal.py:26-86); ``dynamic=True`` extracts per batch on the fly
    (reference SEALDynamicDataset, seal.py:89-146).  ``native=False``
    takes the python path for every batch (the JAX package takes it only
    where the C++ extractor cannot serve).
    """

    def __init__(self, graph, pos_edges: np.ndarray, neg_edges: np.ndarray,
                 num_hops: int = 1, node_label: str = "drnl",
                 ratio_per_hop: float = 1.0,
                 max_nodes_per_hop: Optional[int] = None,
                 max_dist: int = 1000, max_nodes: int = 64,
                 max_edges: int = 256, use_feature: bool = True,
                 directed: bool = False, dynamic: bool = True,
                 native: bool = True):
        self.A = graph.csr()
        self.A_csc = self.A.tocsc() if directed else None
        self.x = graph.x if use_feature else None
        self.links = np.concatenate([pos_edges, neg_edges], axis=0)
        self.labels = np.concatenate([
            np.ones(len(pos_edges)), np.zeros(len(neg_edges))]).astype(np.float32)
        self.num_hops = num_hops
        self.node_label = node_label
        self.ratio_per_hop = ratio_per_hop
        self.max_nodes_per_hop = max_nodes_per_hop
        self.max_dist = max_dist
        self.max_nodes = max_nodes
        self.max_edges = max_edges
        self.directed = directed
        self.native = native
        self._degs = None
        self._cache = None
        if not dynamic:
            self._cache = self.extract_batch(np.arange(len(self.links)))

    def __len__(self) -> int:
        return len(self.links)

    def extract_one(self, idx: int, max_nodes: Optional[int] = None):
        if max_nodes is None:
            # default to the dataset's cap so EVERY caller sees labels
            # consistent with what batch() feeds the model
            max_nodes = self.max_nodes
        src, dst = int(self.links[idx, 0]), int(self.links[idx, 1])
        nodes, adj, dists, x, y = k_hop_subgraph(
            src, dst, self.num_hops, self.A, self.ratio_per_hop,
            self.max_nodes_per_hop, self.x, self.labels[idx],
            self.directed, self.A_csc)
        if max_nodes is not None and len(nodes) > max_nodes:
            # truncate BEFORE labelling: the batch keeps only the first
            # max_nodes nodes (centres + earliest hops), so z must describe
            # the subgraph the model actually sees — distances through
            # dropped nodes would be inconsistent with the kept edge set,
            # and the native extractor (which stops discovery at the cap)
            # would disagree with the python path
            nodes = nodes[:max_nodes]
            dists = dists[:max_nodes]
            adj = adj[:max_nodes, :][:, :max_nodes]
            if x is not None:
                x = x[:max_nodes]
        z = label_nodes(adj, dists, self.node_label, self.max_dist)
        u, v = adj.nonzero()
        w = np.asarray(adj[u, v]).ravel()
        sd = min(self.A[src].sum(), self.max_nodes_per_hop or np.inf)
        dd = min(self.A[dst].sum(), self.max_nodes_per_hop or np.inf)
        return nodes, z, (u, v, w), x, y, float(sd), float(dd)

    def extract_batch(self, indices: np.ndarray) -> SealBatchArrays:
        if (self.native and self.node_label in NODE_LABELS
                and not self.directed):
            return self._extract_batch_native(indices)
        return self._extract_batch_python(indices)

    def _extract_batch_native(self, indices: np.ndarray) -> SealBatchArrays:
        """C++ OpenMP extraction (graph/native.py) — same semantics, node
        ordering within a subgraph may differ from the python path (both are
        valid: labels/pooling are order-invariant, center nodes stay at
        0/1)."""
        B, N, E = len(indices), self.max_nodes, self.max_edges
        links = self.links[np.asarray(indices)]
        seed = 0
        if self.ratio_per_hop < 1.0 or self.max_nodes_per_hop is not None:
            # fresh per-extraction seed from the (set_seed-seeded) stdlib
            # stream: the reference resamples fringes via global random
            # state on every extraction; a fixed seed would freeze the
            # subsample per link forever
            seed = random.getrandbits(63)
        nodes, z, src, dst, w, counts = seal_extract_batch_native(
            self.A.indptr, self.A.indices,
            np.asarray(self.A.data, dtype=np.float32), self.A.shape[0],
            links, self.num_hops, N, E, self.max_dist, self.node_label,
            self.ratio_per_hop, self.max_nodes_per_hop, seed=seed)
        n_arange = np.arange(N)
        e_arange = np.arange(E)
        node_mask = n_arange[None, :] < counts[:, :1]
        edge_mask = e_arange[None, :] < counts[:, 1:2]
        x = None
        if self.x is not None:
            safe = np.maximum(nodes, 0)
            x = self.x[safe] * node_mask[..., None]
        if self._degs is None:   # the graph's degrees, summed once
            self._degs = np.asarray(self.A.sum(axis=1)).ravel()
        degs = self._degs
        cap = self.max_nodes_per_hop or np.inf
        zmask = node_mask[..., None] if z.ndim == 3 else node_mask
        return SealBatchArrays(
            z=z * zmask, node_mask=node_mask,
            edge_index=np.stack([src, dst], axis=-1) * edge_mask[..., None],
            edge_weight=w * edge_mask, edge_mask=edge_mask,
            x=x.astype(np.float32) if x is not None else None,
            node_ids=np.where(node_mask, nodes, -1),
            y=self.labels[np.asarray(indices)],
            src_degree=np.minimum(degs[links[:, 0]], cap).astype(np.float32),
            dst_degree=np.minimum(degs[links[:, 1]], cap).astype(np.float32))

    def _extract_batch_python(self, indices: np.ndarray) -> SealBatchArrays:
        B, N, E = len(indices), self.max_nodes, self.max_edges
        d = self.x.shape[1] if self.x is not None else 0
        z_shape = (B, N, 2) if self.node_label in TWO_DIM_LABELS else (B, N)
        out = SealBatchArrays(
            z=np.zeros(z_shape, np.int32),
            node_mask=np.zeros((B, N), bool),
            edge_index=np.zeros((B, E, 2), np.int32),
            edge_weight=np.zeros((B, E), np.float32),
            edge_mask=np.zeros((B, E), bool),
            x=np.zeros((B, N, d), np.float32) if d else None,
            node_ids=np.full((B, N), -1, np.int32),
            y=np.zeros(B, np.float32),
            src_degree=np.zeros(B, np.float32),
            dst_degree=np.zeros(B, np.float32),
        )
        for bi, idx in enumerate(indices):
            nodes, z, (u, v, w), x, y, sd, dd = self.extract_one(
                int(idx), max_nodes=N)
            # extract_one truncates BEFORE labelling, so len(nodes) <= N and
            # the adjacency (hence u/v) is already within range — only the
            # edge-count cap remains
            n = len(nodes)
            u, v, w = u[:E], v[:E], w[:E]
            e = len(u)
            out.z[bi, :n] = z[:n]
            out.node_mask[bi, :n] = True
            out.edge_index[bi, :e, 0] = u
            out.edge_index[bi, :e, 1] = v
            out.edge_weight[bi, :e] = w
            out.edge_mask[bi, :e] = True
            if out.x is not None and x is not None:
                out.x[bi, :n] = x[:n]
            out.node_ids[bi, :n] = np.asarray(nodes[:n])
            out.y[bi] = y
            out.src_degree[bi] = sd
            out.dst_degree[bi] = dd
        return out

    def batch(self, indices: np.ndarray) -> SealBatchArrays:
        if self._cache is not None:
            sl = indices
            c = self._cache
            return SealBatchArrays(
                z=c.z[sl], node_mask=c.node_mask[sl],
                edge_index=c.edge_index[sl], edge_weight=c.edge_weight[sl],
                edge_mask=c.edge_mask[sl],
                x=None if c.x is None else c.x[sl],
                node_ids=c.node_ids[sl], y=c.y[sl],
                src_degree=c.src_degree[sl], dst_degree=c.dst_degree[sl])
        return self.extract_batch(indices)
