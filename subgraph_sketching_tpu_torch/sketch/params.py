"""Sketch hyper-parameters and the per-node sketch state."""

from __future__ import annotations

from typing import NamedTuple

import torch

# feature-vector layout per max_hops: index -> (hops-from-u, hops-from-v)
# (reference src/hashing.py:22-25)
LABEL_LOOKUP = {
    1: {0: (1, 1), 1: (0, 1), 2: (1, 0)},
    2: {0: (1, 1), 1: (2, 1), 2: (1, 2), 3: (2, 2), 4: (0, 1), 5: (1, 0),
        6: (0, 2), 7: (2, 0)},
    3: {0: (1, 1), 1: (2, 1), 2: (1, 2), 3: (2, 2), 4: (3, 1), 5: (1, 3),
        6: (3, 2), 7: (2, 3), 8: (3, 3), 9: (0, 1), 10: (1, 0), 11: (0, 2),
        12: (2, 0), 13: (0, 3), 14: (3, 0)},
}


class SketchParams(NamedTuple):
    """Static sketch configuration.

    Defaults match the reference CLI (src/runners/run.py:231-240).
    """

    max_hops: int = 2           # max_hash_hops in {1,2,3} (hashing.py:54)
    num_perm: int = 128         # minhash permutations (run.py:236)
    hll_p: int = 8              # HLL precision; m = 2^p registers (run.py:235)
    use_zero_one: bool = False  # keep (0,1)/(1,0) features (run.py:231)
    floor_sf: bool = False      # clamp negative features to 0 (run.py:233)
    minhash_seed: int = 1       # permutation RNG seed (hashing.py:61)

    @property
    def m(self) -> int:
        return 1 << self.hll_p

    @property
    def max_rank(self) -> int:
        # ranks are leading-zero counts of (64-p)-bit hashes (hashing.py:73-76)
        return 64 - self.hll_p

    @property
    def sf_dim(self) -> int:
        return self.max_hops * (self.max_hops + 2)


class Sketches(NamedTuple):
    """Per-node, per-hop sketch state, hops stacked on the leading axis.

    MinHash lanes are int32 holding ``u32 ^ 0x80000000``: an order
    isomorphism from uint32 (which torch cannot take the min of), so every
    min and every equality test gives the uint32 answer.  Convert with
    ``sketch.minhash.from_biased`` to compare with the uint32 reference.
    """

    minhash: torch.Tensor  # [max_hops+1, n, num_perm] int32 (biased u32)
    hll: torch.Tensor      # [max_hops+1, n, m] int8
    cards: torch.Tensor    # [n, max_hops] float32 — per-hop HLL cardinalities

    @property
    def num_nodes(self) -> int:
        return self.minhash.shape[1]

    @property
    def max_hops(self) -> int:
        return self.minhash.shape[0] - 1
