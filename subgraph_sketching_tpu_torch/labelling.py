"""Node labelling tricks for SEAL-style subgraph classification: the
port's own copy of the JAX package's labelling.py.

Host-side (numpy/scipy) implementations of DRNL, DE, DE+ (reference
src/labelling_tricks.py).  These run during subgraph extraction, which is
host work (per-link BFS over CSR); the integer labels are embedded on the
device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from scipy.sparse.csgraph import shortest_path


def drnl_hash_function(dist2src: np.ndarray, dist2dst: np.ndarray) -> np.ndarray:
    """z = 1 + min(d) + (d//2)(d//2 + d%2 - 1), d = d_src + d_dst; the src
    and dst nodes themselves get z = 1 (reference labelling_tricks.py:11-27).
    """
    dist2src = np.asarray(dist2src)
    dist2dst = np.asarray(dist2dst)
    d = dist2src + dist2dst
    d2, dm2 = d // 2, d % 2
    z = 1 + np.minimum(dist2src, dist2dst) + d2 * (d2 + dm2 - 1)
    z = np.where((dist2src == 0) | (dist2dst == 0), 1, z)
    return z.astype(np.int64)


def get_max_label(method: str, max_dist: int, num_hops: int = 2) -> int:
    """(reference labelling_tricks.py:53-60.)"""
    if method in ("de", "de+"):
        return max_dist
    if method in ("drnl", "drnl-"):
        return int(drnl_hash_function(np.array([num_hops]),
                                      np.array([max_dist]))[0])
    raise NotImplementedError(method)


def get_drnl_lookup(max_dist: int, num_hops: int
                    ) -> Tuple[Dict[int, int], Dict[int, Tuple[int, int]]]:
    """DRNL labels are not contiguous; map them onto a dense index
    (reference labelling_tricks.py:30-50)."""
    max_label = get_max_label("drnl", max_dist, num_hops)
    res_arr = [None] * (max_label + 1)
    res_arr[1] = (1, 0)
    for src in range(1, num_hops + 1):
        for dst in range(1, max_dist + 1):
            label = int(drnl_hash_function(np.array([src]), np.array([dst]))[0])
            res_arr[label] = (src, dst)
    z_to_idx, idx_to_dst = {}, {}
    counter = 0
    for idx, elem in enumerate(res_arr):
        if elem is not None:
            z_to_idx[idx] = counter
            idx_to_dst[counter] = elem
            counter += 1
    return z_to_idx, idx_to_dst


def _masked_distances(adj, src: int, dst: int):
    """Distances to src with dst removed, and to dst with src removed
    (the DRNL/DE+ masking scheme, reference labelling_tricks.py:75-91)."""
    n = adj.shape[0]
    idx_wo_src = list(range(src)) + list(range(src + 1, n))
    adj_wo_src = adj[idx_wo_src, :][:, idx_wo_src]
    idx_wo_dst = list(range(dst)) + list(range(dst + 1, n))
    adj_wo_dst = adj[idx_wo_dst, :][:, idx_wo_dst]

    dist2src = shortest_path(adj_wo_dst, directed=False, unweighted=True,
                             indices=src)
    dist2src = np.insert(dist2src, dst, 0, axis=0)
    dist2dst = shortest_path(adj_wo_src, directed=False, unweighted=True,
                             indices=dst - 1)
    dist2dst = np.insert(dist2dst, src, 0, axis=0)
    return dist2src, dist2dst


def drnl_node_labeling(adj, src: int, dst: int, max_dist: int = 100) -> np.ndarray:
    """(reference labelling_tricks.py:63-94; src/dst swapped so src < dst.)"""
    src, dst = (dst, src) if src > dst else (src, dst)
    dist2src, dist2dst = _masked_distances(adj, src, dst)
    dist2src = np.minimum(np.nan_to_num(dist2src, posinf=max_dist), max_dist)
    dist2dst = np.minimum(np.nan_to_num(dist2dst, posinf=max_dist), max_dist)
    return drnl_hash_function(dist2src.astype(np.int64),
                              dist2dst.astype(np.int64))


def de_node_labeling(adj, src: int, dst: int, max_dist: int = 3) -> np.ndarray:
    """Distance Encoding: [n, 2] distances to (src, dst), capped
    (reference labelling_tricks.py:97-108)."""
    src, dst = (dst, src) if src > dst else (src, dst)
    dist = shortest_path(adj, directed=False, unweighted=True,
                         indices=[src, dst])
    dist = np.asarray(dist)
    out = np.where(np.isnan(dist) | np.isinf(dist), max_dist + 1,
                   np.minimum(dist, max_dist))
    return out.T.astype(np.int64)


def de_plus_node_labeling(adj, src: int, dst: int,
                          max_dist: int = 100) -> np.ndarray:
    """DE with src/dst masking, like DRNL (labelling_tricks.py:111-133)."""
    src, dst = (dst, src) if src > dst else (src, dst)
    dist2src, dist2dst = _masked_distances(adj, src, dst)
    # reference inserts 1 (not 0) for the masked positions here
    dist2src[dst] = 1
    dist2dst[src] = 1
    dist = np.stack([dist2src, dist2dst], axis=1)
    dist = np.where(np.isnan(dist) | np.isinf(dist), max_dist, dist)
    return np.minimum(dist, max_dist).astype(np.int64)
