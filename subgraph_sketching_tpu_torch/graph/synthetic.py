"""Synthetic graph generators (host, numpy).

The reference test-suite builds Barabási–Albert graphs via networkx
(test/test_hashing.py:22-31); we generate them directly so CI needs neither
networkx nor a network connection.
"""

from __future__ import annotations

import numpy as np


def barabasi_albert_graph(n: int, m: int, seed: int = 0) -> np.ndarray:
    """Undirected BA preferential-attachment graph.

    Returns a symmetric edge_index [2, 2*E] int32 (both directions, no
    self-loops, no duplicates).
    """
    rng = np.random.default_rng(seed)
    targets = list(range(m))
    repeated: list[int] = []
    edges = set()
    for v in range(m, n):
        for t in set(targets):
            if v != t:
                edges.add((min(v, t), max(v, t)))
        repeated.extend(targets)
        repeated.extend([v] * m)
        # sample m targets (with preferential attachment) for the next node
        targets = [repeated[rng.integers(len(repeated))] for _ in range(m)]
    e = np.array(sorted(edges), dtype=np.int32).T
    both = np.concatenate([e, e[::-1]], axis=1)
    order = np.lexsort((both[1], both[0]))
    return both[:, order]


def watts_strogatz_graph(n: int, k: int, p: float, seed: int = 0) -> np.ndarray:
    """Watts-Strogatz small-world graph (ring of k-nearest neighbours with
    rewiring probability p).  High clustering -> strong common-neighbour
    signal, which makes it the right synthetic testbed for link-prediction
    *quality* (BA graphs have near-zero clustering)."""
    rng = np.random.default_rng(seed)
    edges = set()
    for v in range(n):
        for j in range(1, k // 2 + 1):
            t = (v + j) % n
            if rng.random() < p:  # rewire
                t = int(rng.integers(0, n))
                while t == v or (min(v, t), max(v, t)) in edges:
                    t = int(rng.integers(0, n))
            if t != v:
                edges.add((min(v, t), max(v, t)))
    e = np.array(sorted(edges), dtype=np.int32).T
    both = np.concatenate([e, e[::-1]], axis=1)
    order = np.lexsort((both[1], both[0]))
    return both[:, order]


def watts_strogatz_graph_fast(n: int, k: int, p: float,
                              seed: int = 0) -> np.ndarray:
    """Vectorised Watts-Strogatz for large n (numpy, no python loop).

    Same model as ``watts_strogatz_graph`` (ring of k nearest neighbours,
    each ring edge rewired to a random target with probability p; self
    loops and duplicate undirected edges dropped) but O(n k) vectorised —
    millions of nodes in seconds.  Small-n callers keep the loop version
    so existing synthetic datasets stay byte-identical.
    """
    rng = np.random.default_rng(seed)
    base = np.arange(n, dtype=np.int64)
    src = np.repeat(base, k // 2)
    off = np.tile(np.arange(1, k // 2 + 1, dtype=np.int64), n)
    dst = (src + off) % n
    rw = rng.random(len(src)) < p
    dst[rw] = rng.integers(0, n, int(rw.sum()))
    keep = src != dst
    src, dst = src[keep], dst[keep]
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    code = np.unique(lo * n + hi)          # dedupe undirected pairs
    e = np.stack([code // n, code % n]).astype(np.int32)
    both = np.concatenate([e, e[::-1]], axis=1)
    order = np.lexsort((both[1], both[0]))
    return both[:, order]


def erdos_renyi_graph(n: int, p: float, seed: int = 0) -> np.ndarray:
    """Undirected G(n, p) graph as a symmetric edge_index [2, 2*E] int32."""
    rng = np.random.default_rng(seed)
    upper = rng.random((n, n)) < p
    upper = np.triu(upper, k=1)
    r, c = np.nonzero(upper)
    e = np.stack([r, c]).astype(np.int32)
    both = np.concatenate([e, e[::-1]], axis=1)
    order = np.lexsort((both[1], both[0]))
    return both[:, order]
