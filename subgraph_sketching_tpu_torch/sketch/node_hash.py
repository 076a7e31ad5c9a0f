"""Deterministic 64-bit node-ID hashing (host side).

The reference seeds its sketches from ``pandas.util.hash_array`` over
1-indexed node IDs (src/hashing.py:121,128).  For numeric input pandas
applies the SplitMix64 finalizer; we implement it directly in numpy uint64
arithmetic, so sketch initialisation is bit-exact with the reference without
a pandas dependency.  This runs on host: it is O(n) and computed once.  A copy of the JAX
package's sketch/node_hash.py.
"""

from __future__ import annotations

import numpy as np


def splitmix64(v: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer over a uint64 array (wraps mod 2^64)."""
    v = np.asarray(v, dtype=np.uint64).copy()
    with np.errstate(over="ignore"):
        v ^= v >> np.uint64(30)
        v *= np.uint64(0xBF58476D1CE4E5B9)
        v ^= v >> np.uint64(27)
        v *= np.uint64(0x94D049BB133111EB)
        v ^= v >> np.uint64(31)
    return v


def node_base_hashes(num_nodes: int) -> np.ndarray:
    """64-bit base hash per node.

    Nodes are hashed 1-indexed because the hash maps 0 -> 0, which would
    corrupt the HLL registers (reference src/hashing.py:128).
    """
    return node_base_hashes_for(np.arange(num_nodes, dtype=np.uint64))


def node_base_hashes_for(ids: np.ndarray) -> np.ndarray:
    """Base hashes for an arbitrary subset of node ids (same 1-indexing).

    The hash is a pure per-id function, so hop-0 sketch rows are O(1)
    recomputable per node — this is what lets serving's streaming updates
    work on hops-only stacks (which drop the hop-0 tables to save HBM)."""
    return splitmix64(np.asarray(ids, dtype=np.uint64) + np.uint64(1))
