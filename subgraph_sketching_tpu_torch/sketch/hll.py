"""HyperLogLog++ registers: host init (bit-exact) + branchless estimator.

Reference semantics (src/hashing.py:65-81,126-137,191-232):
  * m = 2^p int8 registers per node; register index = low p bits of the node's
    64-bit hash; rank = max_rank - bit_length(hash >> p) + 1, max_rank = 64-p.
  * count estimator: if any register is zero, linear counting m*ln(m/V); keep
    it only if <= threshold[p].  Otherwise raw estimate alpha*m^2 / sum(2^-reg)
    with empirical bias subtracted when e <= 5m (bias = mean of the 6
    nearest-neighbour entries of a raw-estimate table).
  * union of sketches = elementwise register max.

The estimator is the JAX package's branchless form, on torch tensors.  The
bias tables are this package's own copy of ``_hll_tables.npz``.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from subgraph_sketching_tpu_torch.sketch.node_hash import node_base_hashes_for

# linear-counting/raw-estimate crossover thresholds per p, from the HLL++
# paper (Heule et al., "HyperLogLog in Practice", Table: threshold(p)).
_THRESHOLDS = {4: 10, 5: 20, 6: 40, 7: 80, 8: 220, 9: 400, 10: 900, 11: 1800,
               12: 3100, 13: 6500, 14: 11500, 15: 20000, 16: 50000,
               17: 120000, 18: 350000}

_TABLES_PATH = os.path.join(os.path.dirname(__file__), "_hll_tables.npz")


def hll_alpha(m: int) -> float:
    """Standard HLL alpha constant (same formula datasketch uses)."""
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)


@functools.lru_cache(maxsize=None)
def _load_tables(p: int):
    if p not in _THRESHOLDS:
        raise ValueError(f"hll_p must be in [4, 18], got {p}")
    with np.load(_TABLES_PATH) as z:
        key = f"raw_estimate_p{p}"
        if key not in z:
            raise NotImplementedError(
                f"no empirical bias table for p={p}")
        return np.asarray(z[key]), np.asarray(z[f"bias_p{p}"])


def hll_init(num_nodes: int, p: int) -> np.ndarray:
    """Hop-0 registers [num_nodes, m] int8 (host, bit-exact with reference)."""
    return hll_init_rows(np.arange(num_nodes, dtype=np.int64), p)


def hll_init_rows(ids: np.ndarray, p: int) -> np.ndarray:
    """Hop-0 registers for an arbitrary id subset: [len(ids), m] int8,
    bit-identical to the matching rows of ``hll_init``.  Keeps the
    reference's float bit-length ceil(log2(bits+1)) (src/hashing.py:83-89)."""
    m = 1 << p
    max_rank = 64 - p
    hv = node_base_hashes_for(ids)
    n = len(hv)
    reg_index = (hv & np.uint64(m - 1)).astype(np.int64)
    bits = hv >> np.uint64(p)
    bit_length = np.ceil(np.log2(bits.astype(np.float64) + 1.0)).astype(np.int64)
    ranks = max_rank - bit_length + 1
    if n and ranks.min() <= 0:
        raise ValueError(f"hash value overflow, maximum size is {max_rank} bits")
    regs = np.zeros((n, m), dtype=np.int8)
    regs[np.arange(n), reg_index] = ranks.astype(np.int8)
    return regs


def hll_merge(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Union of sketches = register max (src/hashing.py:234-237)."""
    return torch.maximum(src, dst)


@functools.lru_cache(maxsize=None)
def _bias_step_tables(p: int):
    """Exact step-function form of the reference's 6-NN bias correction.

    The raw-estimate table is sorted, so the 6 nearest neighbours of any
    estimate e form a contiguous window [j, j+6); the window advances by one
    exactly at the midpoints (raw[j-1] + raw[j+5]) / 2.  The 6-NN-mean bias
    (reference src/hashing.py:197-204) is therefore a step function of e.

    Returns (breakpoints [T-6] f32, window_means [T-5] f32).
    """
    raw, bias = _load_tables(p)
    T = raw.shape[0]
    if T <= 6:
        return (np.zeros((0,), np.float32),
                np.full((1,), bias.astype(np.float64).mean(), np.float32))
    w = np.lib.stride_tricks.sliding_window_view(bias.astype(np.float32), 6)
    window_means = w.mean(axis=1, dtype=np.float64).astype(np.float32)
    breakpoints = ((raw[:-6].astype(np.float64)
                    + raw[6:].astype(np.float64)) / 2.0).astype(np.float32)
    return breakpoints, window_means


@functools.lru_cache(maxsize=None)
def _bias_grid_tables(p: int):
    """Uniform-grid evaluation of the exact step function above.

    Grid resolution is doubled until every cell contains at most ONE
    breakpoint; each cell stores (breakpoint-in-cell, bias left of it, bias
    right of it, pad), so the correction is one row lookup + one compare per
    element, exactly.

    Returns (rows f32 [G, 4], scale, lo).
    """
    bp, wm = _bias_step_tables(p)
    m = 1 << p
    lo, hi = 0.0, 5.0 * m + 1.0   # correction only applies for e <= 5m
    # breakpoints past hi can never be crossed by a corrected estimate
    bp = bp[bp < hi]
    G = 1 << 10
    while True:
        cells = np.clip(((bp - lo) * (G / (hi - lo))).astype(np.int64), 0,
                        G - 1)
        if len(np.unique(cells)) == len(cells) or G >= (1 << 20):
            break
        G *= 2
    cell_bp = np.full(G, np.inf, np.float32)
    for c, b in zip(cells, bp):
        cell_bp[c] = b
    # base[g] = number of breakpoints strictly left of cell g
    counts = np.zeros(G + 1, np.int64)
    np.add.at(counts, cells + 1, 1)
    base = np.cumsum(counts)[:G]
    bias_lo = wm[np.minimum(base, len(wm) - 1)]
    bias_hi = wm[np.minimum(base + 1, len(wm) - 1)]
    bias_hi = np.where(np.isinf(cell_bp), bias_lo, bias_hi)
    rows = np.stack([cell_bp, bias_lo, bias_hi,
                     np.zeros(G, np.float32)], axis=1).astype(np.float32)
    return rows, np.float32(G / (hi - lo)), np.float32(lo)


@functools.lru_cache(maxsize=None)
def _bias_rows_on(p: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_bias_grid_tables(p)[0]).to(device)


def bias_correct(e: torch.Tensor, p: int) -> torch.Tensor:
    """Subtract the empirical 6-NN-mean bias where e <= 5m (exact to f32
    with reference src/hashing.py:197-210, through the grid tables)."""
    m = 1 << p
    _, scale, lo = _bias_grid_tables(p)
    rows = _bias_rows_on(p, e.device)
    cell = ((e - float(lo)) * float(scale)).to(torch.int32).clamp(
        0, rows.shape[0] - 1)
    r = rows[cell]                                  # [..., 4] one row lookup
    bias = torch.where(e > r[..., 0], r[..., 2], r[..., 1])
    return torch.where(e <= 5 * m, e - bias, e)


def hll_count_from_stats(num_zero: torch.Tensor, pow_sum: torch.Tensor,
                         p: int) -> torch.Tensor:
    """Estimator core given per-row register statistics.

    num_zero: [...] count of zero registers; pow_sum: [...] sum of 2^-reg.
    Branchless rewrite of reference src/hashing.py:191-232.  Both divisions
    are tensor / tensor: torch computes ``scalar / tensor`` as a reciprocal
    times the scalar, which rounds differently from the JAX package.
    """
    m = 1 << p
    threshold = float(_THRESHOLDS[p])
    # linear counting (guard the log against num_zero == 0)
    lc = m * torch.log(torch.full_like(num_zero, m)
                       / torch.clamp(num_zero, min=1.0))
    use_lc = (num_zero > 0) & (lc <= threshold)
    # raw HLL estimate with empirical bias correction (e <= 5m)
    raw = torch.full_like(pow_sum, hll_alpha(m) * m * m) / pow_sum
    e = bias_correct(raw, p)
    return torch.where(use_lc, lc, e).to(torch.float32)


def hll_count(regs: torch.Tensor, p: int) -> torch.Tensor:
    """Cardinality estimate for a batch of register vectors.

    regs: [..., m] int8 -> [...] float32.  (Reference src/hashing.py:191-232.)
    """
    num_zero = (regs == 0).to(torch.float32).sum(dim=-1)
    pow_sum = pow2_neg(regs).sum(dim=-1)
    return hll_count_from_stats(num_zero, pow_sum, p)


def pow2_neg(regs: torch.Tensor) -> torch.Tensor:
    """2.0 ** (-regs) for small non-negative integer registers, built by
    writing the float32 exponent field directly (exact for regs in
    [0, 126]; HLL ranks are < 64)."""
    exp_bits = (127 - regs.to(torch.int32)) << 23
    return exp_bits.view(torch.float32)
