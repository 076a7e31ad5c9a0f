"""Plain MinHash and HyperLogLog sketches and the subgraph features of
ELPH and BUDDY (Chamberlain et al., "Graph Neural Networks for Link
Prediction with Subgraph Sketching", ICLR 2023; the authors' hashing.py).

  * a node's 64-bit hash is SplitMix64's finalizer over its id + 1;
  * MinHash: ``num_perm`` universal hashes ((a·h + b) mod (2^61 - 1)) &
    (2^32 - 1), (a, b) drawn interleaved from ``RandomState(1)``, the
    arithmetic wrapping in 64 bits; a k-hop signature is the lane-wise min
    over the closed k-hop neighbourhood;
  * HyperLogLog: 2^p registers, the register the hash's low p bits, the
    rank 64 - p - bit_length(h >> p) + 1 with the bit length taken as
    ceil(log2(x + 1)) in float64; union is the register max; the count is
    linear counting below the HLL++ threshold, else the raw estimate less
    the mean bias of its six nearest neighbours in the HLL++ table where
    the estimate is at most 5m.  The six nearest of an estimate are the
    window of six table entries that the midpoints of the entries six
    apart, taken in float32, place it in (on a midpoint: the lower);
  * the HLL++ table is simulated here (``bias_table``) by the procedure
    of Heule, Nunkesser and Hall ("HyperLogLog in Practice", 2013,
    appendix): for a grid of true cardinalities, many sketches filled
    with uniform 64-bit hashes, and at each grid point the mean raw
    estimate and the mean bias (raw - true) over the sketches, rounded to
    float32.  The draws are those the port's estimator table was made
    with (``TABLE_SEED`` + p, ``TABLE_TRIALS[p]`` sketches, ``TABLE_POINTS``
    cardinalities from m/8 to 5.5m), so a fault in that table shows;
  * the feature of hops (k1, k2) of a link (u, v) is Jaccard(MinHash) ×
    count(union of HLL), turned into disjoint counts by
    inclusion-exclusion, with the authors' double subtraction of f(1,1)
    in the (2, 0) column, and the (0, 1), (1, 0) columns set to zero.

Signatures are int64 holding the uint32 value; registers int32.  The
estimates and the features are float32, the configuration's precision,
in the authors' order of operations: the (2, 0) column cancels 2-hop
counts of up to 10^6 to a few units, so a float64 ladder departs from any
float32 one by a few of float32's steps at that size.  The work runs on
the device of its inputs, in chunks.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

MERSENNE = (1 << 61) - 1
_CHUNK_BYTES = 1 << 31

# the HLL++ linear-counting thresholds (Heule et al., 2013) and the draws
# of the estimator's bias table
THRESHOLDS = {8: 220}
TABLE_SEED = 20260816
TABLE_TRIALS = {8: 4000}
TABLE_POINTS = 201


def _bit_length(v: np.ndarray) -> np.ndarray:
    """Exact bit length of uint64 values, by halving."""
    out = np.zeros(v.shape, dtype=np.int64)
    v = v.copy()
    for s in (32, 16, 8, 4, 2, 1):
        big = v >= (np.uint64(1) << np.uint64(s))
        out += np.where(big, s, 0)
        v = np.where(big, v >> np.uint64(s), v)
    return out + (v > 0)


@functools.lru_cache(maxsize=None)
def bias_table(p: int):
    """(mean raw estimates, mean biases), float32 [TABLE_POINTS], of
    precision ``p``: ``TABLE_TRIALS[p]`` sketches, each filled with the
    next hashes of the stream ``default_rng(TABLE_SEED + p)`` up to each
    grid cardinality in turn, the draws [sketches, new hashes] a point."""
    m, trials = 1 << p, TABLE_TRIALS[p]
    rng = np.random.default_rng(TABLE_SEED + p)
    grid = np.unique(np.round(np.linspace(max(1, m // 8), 5.5 * m,
                                          TABLE_POINTS)).astype(np.int64))
    regs = np.zeros((trials, m), dtype=np.int64)
    rows = np.arange(trials)[:, None]
    weight = 2.0 ** -np.arange(66, dtype=np.float64)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    raw_mean, bias_mean, filled = [], [], 0
    for card in grid:
        new = int(card) - filled
        if new > 0:
            h = rng.integers(0, 2 ** 64, size=(trials, new), dtype=np.uint64)
            reg = (h & np.uint64(m - 1)).astype(np.int64)
            rank = (64 - p) - _bit_length(h >> np.uint64(p)) + 1
            np.maximum.at(regs, (np.broadcast_to(rows, reg.shape), reg),
                          rank)
        filled = int(card)
        raw = alpha * m * m / weight[regs].sum(axis=1)
        raw_mean.append(raw.mean())
        bias_mean.append((raw - card).mean())
    return (np.asarray(raw_mean).astype(np.float32),
            np.asarray(bias_mean).astype(np.float32))


def splitmix64(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, dtype=np.uint64).copy()
    with np.errstate(over="ignore"):
        v ^= v >> np.uint64(30)
        v *= np.uint64(0xBF58476D1CE4E5B9)
        v ^= v >> np.uint64(27)
        v *= np.uint64(0x94D049BB133111EB)
        v ^= v >> np.uint64(31)
    return v


def node_hashes(n: int) -> np.ndarray:
    return splitmix64(np.arange(n, dtype=np.uint64) + np.uint64(1))


def permutations(num_perm: int, seed: int = 1):
    gen = np.random.RandomState(seed)
    a, b = [], []
    for _ in range(num_perm):
        a.append(int(gen.randint(1, MERSENNE, dtype=np.uint64)))
        b.append(int(gen.randint(0, MERSENNE, dtype=np.uint64)))
    return a, b


def _mod_mersenne(y: torch.Tensor) -> torch.Tensor:
    """y mod (2^61 - 1) for int64 ``y`` read as unsigned: 2^61 ≡ 1."""
    r = (y & MERSENNE) + ((y >> 61) & 7)
    return torch.where(r >= MERSENNE, r - MERSENNE, r)


def minhash0(n: int, num_perm: int, device) -> torch.Tensor:
    """[n, num_perm] int64 hop-0 signatures."""
    hv = torch.from_numpy(node_hashes(n).view(np.int64)).to(device)
    a, b = permutations(num_perm)
    at = torch.tensor(a, dtype=torch.int64, device=device)
    bt = torch.tensor(b, dtype=torch.int64, device=device)
    out = torch.empty((n, num_perm), dtype=torch.int64, device=device)
    step = max(1, (_CHUNK_BYTES // 8) // num_perm)
    for s in range(0, n, step):
        y = hv[s:s + step, None] * at[None, :] + bt[None, :]
        out[s:s + step] = _mod_mersenne(y) & 0xFFFFFFFF
    return out


def hll0(n: int, p: int, device) -> torch.Tensor:
    """[n, 2^p] int32 hop-0 registers."""
    m = 1 << p
    hv = node_hashes(n)
    reg = (hv & np.uint64(m - 1)).astype(np.int64)
    bits = hv >> np.uint64(p)
    length = np.ceil(np.log2(bits.astype(np.float64) + 1.0)).astype(np.int64)
    rank = (64 - p) - length + 1
    out = torch.zeros((n, m), dtype=torch.int32, device=device)
    out[torch.arange(n, device=device), torch.from_numpy(reg).to(device)] = \
        torch.from_numpy(rank.astype(np.int32)).to(device)
    return out


def propagate(table: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              reduce: str) -> torch.Tensor:
    """One hop: out[v] = reduce(table[v], table[u] for edges (u, v))."""
    out = table.clone()
    row = table.shape[1] * table.element_size()
    step = max(1, _CHUNK_BYTES // row)
    for s in range(0, src.numel(), step):
        vals = table.index_select(0, src[s:s + step])
        idx = dst[s:s + step, None].expand(-1, table.shape[1])
        out.scatter_reduce_(0, idx, vals, reduce, include_self=True)
    return out


def hll_count(regs: torch.Tensor, p: int) -> torch.Tensor:
    """Cardinality estimates [...] float32 of registers [..., 2^p]."""
    m = 1 << p
    flat = regs.reshape(-1, m)
    out = torch.empty(flat.shape[0], dtype=torch.float32, device=regs.device)
    table_raw, table_bias = bias_table(p)
    raw_t = torch.from_numpy(table_raw).to(regs.device)
    # the table is sorted, so the six nearest neighbours of e are the
    # window [j, j + 6) where j counts the float32 midpoints
    # (raw[i] + raw[i+6]) / 2 below e; e on a midpoint keeps the lower
    # window; a window's bias is its six entries' mean, summed in float64
    mids = (raw_t[:-6] + raw_t[6:]) * 0.5
    b = torch.from_numpy(table_bias.astype(np.float64)).to(regs.device)
    means = (sum(b[i:len(b) - 5 + i] for i in range(6)) / 6).float()
    alpha = 0.7213 / (1.0 + 1.079 / m)
    step = 1 << 19
    for s in range(0, flat.shape[0], step):
        r = flat[s:s + step]
        zeros = (r == 0).sum(-1).float()
        # float32, the configuration's precision; the sum of powers of two
        # is exact
        raw = (torch.full_like(zeros, alpha * m * m)
               / torch.pow(2.0, -r.double()).sum(-1).float())
        lc = m * torch.log(torch.full_like(zeros, m) / zeros.clamp(min=1.0))
        use_lc = (zeros > 0) & (lc <= THRESHOLDS[p])
        window = torch.searchsorted(mids, raw.contiguous(), right=False)
        corrected = torch.where(raw <= 5 * m, raw - means[window], raw)
        out[s:s + step] = torch.where(use_lc, lc, corrected)
    return out.view(regs.shape[:-1])


def sketch_tables(src: torch.Tensor, dst: torch.Tensor, n: int,
                  num_perm: int, p: int, hops: int):
    """(MinHash [hops+1] of [n, P], HLL [hops+1] of [n, m], cards [n,
    hops]) over the edges (src, dst) (give both directions of an
    undirected graph)."""
    dev = src.device
    mh: List[torch.Tensor] = [minhash0(n, num_perm, dev)]
    hll: List[torch.Tensor] = [hll0(n, p, dev)]
    cards = []
    for _ in range(hops):
        mh.append(propagate(mh[-1], src, dst, "amin"))
        hll.append(propagate(hll[-1], src, dst, "amax"))
        cards.append(hll_count(hll[-1], p))
    return mh, hll, torch.stack(cards, dim=1)


def link_features(links: torch.Tensor, mh, hll, cards: torch.Tensor,
                  p: int) -> torch.Tensor:
    """[B, 8] float32 features of 2-hop sketches for links [B, 2]."""
    assert len(mh) == 3, "the reference ladder is the 2-hop one"
    out = []
    for s in range(0, links.shape[0], 1 << 17):
        u, v = links[s:s + (1 << 17), 0], links[s:s + (1 << 17), 1]
        inter = {}
        for k1 in (1, 2):
            for k2 in (1, 2):
                jac = ((mh[k1][u] == mh[k2][v]).float().sum(-1)
                       / mh[k1].shape[1])
                union = torch.maximum(hll[k1][u], hll[k2][v])
                inter[k1, k2] = jac * hll_count(union, p)
        cu, cv = cards[u], cards[v]
        f11 = inter[1, 1]
        f21 = inter[2, 1] - f11
        f12 = inter[1, 2] - f11
        f22 = inter[2, 2] - f11 - f21 - f12
        f01 = cv[:, 0] - f11 - f21
        f10 = cu[:, 0] - f11 - f12
        f02 = cv[:, 1] - (f11 + f21 + f12 + f22 + f01)
        f20 = cu[:, 1] - f11 - (f11 + f21 + f12 + f22) - f10
        zero = torch.zeros_like(f11)
        out.append(torch.stack([f11, f21, f12, f22, zero, zero, f02, f20],
                               dim=1))
    return torch.cat(out)
