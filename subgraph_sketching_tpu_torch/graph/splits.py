"""Train/val/test link splitting and negative sampling (host, numpy).

A copy of the JAX package's graph/splits.py (numpy only).  Replacement for PyG ``RandomLinkSplit`` / ``negative_sampling`` as
used by the reference (src/data.py:18-22,112-117,199-217).  Edge-role
semantics follow the reference docstring (src/data.py:69-78):

  * train message passing edges = train supervision edges
  * val   message passing edges = train supervision edges
  * val   supervision edges are disjoint from training edges
  * test  message passing edges = train + val supervision edges
  * test  supervision edges are disjoint from both
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from subgraph_sketching_tpu_torch.graph.container import Graph


@dataclass
class SplitData:
    """One split: its message-passing graph + supervision links."""

    graph: Graph            # message-passing edges (symmetric for undirected)
    pos_edges: np.ndarray   # [Np, 2] supervision positives
    neg_edges: np.ndarray   # [Nn, 2] supervision negatives

    @property
    def links(self) -> np.ndarray:
        """pos ‖ neg, matching HashDataset.links (datasets/elph.py:51)."""
        return np.concatenate([self.pos_edges, self.neg_edges], axis=0)

    @property
    def labels(self) -> np.ndarray:
        return np.concatenate([
            np.ones(len(self.pos_edges), dtype=np.float32),
            np.zeros(len(self.neg_edges), dtype=np.float32)])


def _edge_set(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    return (edge_index[0].astype(np.int64) * num_nodes
            + edge_index[1].astype(np.int64))


def negative_sampling(edge_index: np.ndarray, num_nodes: int,
                      num_neg_samples: int, rng: np.random.Generator,
                      forbid_self_loops: bool = True) -> np.ndarray:
    """Uniform negative edges avoiding existing edges (hash-set rejection).

    Replaces PyG ``negative_sampling`` (reference src/data.py:213-216 adds
    self-loops to the forbidden set first, which ``forbid_self_loops``
    reproduces).  Returns [num_neg_samples, 2].
    """
    existing = np.unique(_edge_set(edge_index, num_nodes))  # sorted
    out = np.empty((num_neg_samples, 2), dtype=np.int64)
    filled = 0
    while filled < num_neg_samples:
        need = int((num_neg_samples - filled) * 1.5) + 16
        src = rng.integers(0, num_nodes, need)
        dst = rng.integers(0, num_nodes, need)
        key = src * num_nodes + dst
        # sorted-array membership instead of per-element python set lookups
        # (collab-scale sampling draws millions of candidates per round)
        if len(existing):
            pos = np.minimum(np.searchsorted(existing, key),
                             len(existing) - 1)
            ok = existing[pos] != key
        else:
            ok = np.ones(need, bool)
        if forbid_self_loops:
            ok &= src != dst
        take = min(int(ok.sum()), num_neg_samples - filled)
        sel = np.nonzero(ok)[0][:take]
        out[filled:filled + take, 0] = src[sel]
        out[filled:filled + take, 1] = dst[sel]
        # avoid duplicate negatives within the sample (PyG allows them;
        # we also allow them — no dedup — to match)
        filled += take
    return out.astype(np.int32)


def same_source_negatives(num_nodes: int, num_negs_per_pos: int,
                          pos_edges: np.ndarray,
                          rng: np.random.Generator) -> np.ndarray:
    """citation2-style negatives: same src, random dst
    (reference src/utils.py:88-99 — note it does not reject true edges)."""
    src = np.repeat(pos_edges[:, 0], num_negs_per_pos)
    dst = rng.integers(0, num_nodes, len(src))
    return np.stack([src, dst], axis=1).astype(np.int32)


def random_link_split(g: Graph, val_pct: float = 0.1, test_pct: float = 0.2,
                      seed: int = 0, neg_ratio: int = 1,
                      is_undirected: bool = True) -> Dict[str, SplitData]:
    """Split supervision edges and build per-split message-passing graphs.

    For undirected graphs the unique (src < dst) edges are shuffled and
    partitioned; message-passing graphs contain both directions.  Negatives
    are sampled per split avoiding all true edges (like PyG RandomLinkSplit
    with add_negative_train_samples=True, reference src/data.py:114-116).
    """
    rng = np.random.default_rng(seed)
    ei = g.edge_index
    if is_undirected:
        uniq = ei[:, ei[0] < ei[1]]
    else:
        uniq = ei
    n_edges = uniq.shape[1]
    perm = rng.permutation(n_edges)
    n_val = int(np.floor(val_pct * n_edges))
    n_test = int(np.floor(test_pct * n_edges))
    n_train = n_edges - n_val - n_test
    train_e = uniq[:, perm[:n_train]]
    val_e = uniq[:, perm[n_train:n_train + n_val]]
    test_e = uniq[:, perm[n_train + n_val:]]

    def sym(e):
        return np.concatenate([e, e[::-1]], axis=1)

    def make_graph(mp_edges):
        mp = sym(mp_edges) if is_undirected else mp_edges
        return Graph(mp.astype(np.int32), g.num_nodes, x=g.x)

    splits = {}
    mp_edges = {"train": train_e, "valid": train_e,
                "test": np.concatenate([train_e, val_e], axis=1)}
    sup_edges = {"train": train_e, "valid": val_e, "test": test_e}
    for name in ("train", "valid", "test"):
        pos = sup_edges[name].T.astype(np.int32)
        neg = negative_sampling(g.edge_index, g.num_nodes,
                                len(pos) * neg_ratio, rng)
        splits[name] = SplitData(graph=make_graph(mp_edges[name]),
                                 pos_edges=pos, neg_edges=neg)
    return splits
