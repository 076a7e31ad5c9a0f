"""MinHash signatures: host init (bit-exact with the reference) + device math.

Reference semantics (src/hashing.py:58-63,106-124): num_perm universal-hash
permutations h(x) = ((a*x + b) mod (2^61 - 1)) & (2^32 - 1), with a,b drawn
from np.random.RandomState(seed=1); the arithmetic wraps in uint64 exactly as
numpy does.  A node's hop-0 signature is its own permuted hash; the k-hop
signature is the elementwise min over the closed k-hop neighbourhood.

On the device the lanes are int32 holding ``u32 ^ 0x80000000`` (see
``Sketches``); ``to_biased``/``from_biased`` convert at the boundaries.
"""

from __future__ import annotations

import numpy as np
import torch

from subgraph_sketching_tpu_torch.sketch.node_hash import node_base_hashes_for

_MERSENNE_PRIME = np.uint64((1 << 61) - 1)
_MAX_MINHASH = np.uint64((1 << 32) - 1)
_SIGN_BIT = np.uint32(0x80000000)


def init_permutations(num_perm: int, seed: int = 1) -> np.ndarray:
    """[2, num_perm] uint64 (a, b) rows.

    Drawn interleaved (a then b per permutation) from RandomState(seed) to be
    bit-exact with the reference (src/hashing.py:106-116).
    """
    gen = np.random.RandomState(seed)
    ab = np.array(
        [(gen.randint(1, _MERSENNE_PRIME, dtype=np.uint64),
          gen.randint(0, _MERSENNE_PRIME, dtype=np.uint64))
         for _ in range(num_perm)],
        dtype=np.uint64,
    ).T
    return ab


def minhash_init(num_nodes: int, num_perm: int, seed: int = 1) -> np.ndarray:
    """Hop-0 signatures [num_nodes, num_perm] uint32 (host, bit-exact)."""
    return minhash_init_rows(np.arange(num_nodes, dtype=np.int64),
                             num_perm, seed)


def minhash_init_rows(ids: np.ndarray, num_perm: int,
                      seed: int = 1) -> np.ndarray:
    """Hop-0 signatures for an arbitrary id subset: [len(ids), num_perm]
    uint32, bit-identical to the matching rows of ``minhash_init``."""
    a, b = init_permutations(num_perm, seed)
    hv = node_base_hashes_for(ids)  # uint64 [len(ids)]
    with np.errstate(over="ignore"):
        phv = ((a[None, :] * hv[:, None] + b[None, :]) % _MERSENNE_PRIME) & _MAX_MINHASH
    # values are already <= 2^32-1, so uint32 is exact
    return phv.astype(np.uint32)


def to_biased(u32: np.ndarray) -> np.ndarray:
    """uint32 -> the int32 device representation (u32 ^ 0x80000000)."""
    return (np.asarray(u32, dtype=np.uint32) ^ _SIGN_BIT).view(np.int32)


def from_biased(lanes) -> np.ndarray:
    """Device representation (tensor or array) -> uint32 on the host."""
    if isinstance(lanes, torch.Tensor):
        lanes = lanes.cpu().numpy()
    return np.asarray(lanes, dtype=np.int32).view(np.uint32) ^ _SIGN_BIT


def jaccard(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """MinHash Jaccard estimate: fraction of matching lanes.

    Reference src/hashing.py:247-256.  The bias is a bijection, so lane
    equality is the same on biased lanes.
    src, dst: [..., num_perm] -> [...] float32.
    """
    matches = (src == dst).to(torch.float32).sum(dim=-1)
    return matches / src.shape[-1]
