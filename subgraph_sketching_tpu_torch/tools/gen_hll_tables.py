"""Empirical HyperLogLog++ bias-correction tables, simulated on the card.

Counterpart of the JAX repository's ``tools/gen_hll_tables.py``, which
made the tables the estimator reads (``sketch/_hll_tables.npz``).  The
reference takes the Google HLL++ tables vendored by datasketch; these
are regenerated the same way (Heule, Nunkesser, Hall: "HyperLogLog in
Practice", appendix): for a grid of true cardinalities many HLL sketches
are simulated, and the mean raw estimate, the mean bias (raw - true)
and the bias's standard error are recorded.

The simulation is the JAX tool's, draw for draw:

  * on the host, per precision p, ``np.random.default_rng(seed + p)``
    draws each grid point's new uint64 hashes, ``[trials, chunk]``, in the
    JAX tool's order;
  * on the device, each draw's register index (its low p bits) and rank
    (``64 - p - bit_length(h >> p) + 1``), an in-place
    ``scatter_reduce_(..., "amax")`` of the ranks into the ``[trials, m]``
    int8 registers over the flat index ``t * m + reg`` (a max is
    order-free, so this is exact), and each trial's raw estimate
    ``alpha * m * m / sum(2^-reg)`` in float64;
  * on the host, the mean, the bias mean and the standard error of the
    ``[trials]`` raw vector with numpy, as the JAX tool takes them.

A trial's sum is a sum of powers of two, exact in float64 in any order
while ``m * 2^max_reg < 2^53``, and the division is correctly rounded on
both sides, so the tables equal the JAX tool's bit for bit.

torch has no unsigned 64-bit shift, so the draws travel as int64 (the
same bits): an arithmetic shift followed by a mask of the low 64 - s bits
is the logical shift.

    python -m subgraph_sketching_tpu_torch.tools.gen_hll_tables

runs on the card (``--device cpu`` on the CPU) and writes
``hll_tables_torch.npz`` in the working directory (``--out``), never the
package's committed ``sketch/_hll_tables.npz``.  ``--only-p P`` makes one
precision and merges it into an existing ``--out``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from subgraph_sketching_tpu_torch.device import (
    device_from_flags, resolve_device,
)

OUT = "hll_tables_torch.npz"

# simulation budget per precision (accuracy ~ sigma/sqrt(trials))
TRIALS = {4: 6000, 5: 6000, 6: 5000, 7: 5000, 8: 4000, 9: 1500, 10: 1500,
          11: 600, 12: 600, 13: 200, 14: 200, 15: 80, 16: 80}
GRID_POINTS = 201

_LOW32 = 0xFFFFFFFF


def alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)


def _bit_length32(v: torch.Tensor) -> torch.Tensor:
    """Exact bit length of values in [0, 2^32), int64: the exponent of
    ``frexp`` of the value in float64 (exact there), 0 for 0."""
    _, exp = torch.frexp(v.to(torch.float64))
    return torch.where(v > 0, exp.to(torch.int64), torch.zeros_like(v))


def bit_length_u64(x: torch.Tensor) -> torch.Tensor:
    """Exact bit length of uint64 values carried as int64 (the same
    bits), by 32-bit halves as the JAX tool's ``bit_length_u64``."""
    hi = (x >> 32) & _LOW32
    lo = x & _LOW32
    return torch.where(hi > 0, 32 + _bit_length32(hi), _bit_length32(lo))


def shift_right_u64(x: torch.Tensor, s: int) -> torch.Tensor:
    """The logical right shift of uint64 values carried as int64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def gen_for_p(p: int, rng: np.random.Generator, scale: int = 1,
              device="cuda"):
    """(raw-estimate means, bias means, bias standard errors), float32
    [grid], for precision ``p``: ``TRIALS[p] * scale`` simulated sketches
    filled to each grid cardinality in turn, hashes drawn from ``rng``."""
    dev = resolve_device(device)
    m = 1 << p
    trials = TRIALS[p] * scale
    max_rank = 64 - p
    cards = np.unique(np.round(np.linspace(max(1, m // 8), 5.5 * m,
                                           GRID_POINTS)).astype(np.int64))

    # one stream of hashes per trial; registers updated in place so each
    # grid point sees the prefix of inserts
    regs = torch.zeros((trials, m), dtype=torch.int8, device=dev)
    flat_regs = regs.view(-1)
    raw_means = np.zeros(len(cards))
    biases = np.zeros(len(cards))
    bias_se = np.zeros(len(cards))
    row_base = (torch.arange(trials, device=dev) * m)[:, None]
    pow2 = torch.from_numpy(2.0 ** (-np.arange(0, max_rank + 2))).to(dev)
    prev = 0
    for gi, c in enumerate(cards):
        chunk = int(c) - prev
        if chunk > 0:
            h = rng.integers(0, 2 ** 64, size=(trials, chunk),
                             dtype=np.uint64)
            h = torch.from_numpy(h.view(np.int64)).to(dev)
            flat = (row_base + (h & (m - 1))).view(-1)
            ranks = (max_rank - bit_length_u64(shift_right_u64(h, p)) + 1
                     ).to(torch.int8)
            flat_regs.scatter_reduce_(0, flat, ranks.view(-1), "amax")
        prev = int(c)
        sums = pow2[regs.long()].sum(dim=1)
        raw = (alpha(m) * m * m / sums).cpu().numpy()
        raw_means[gi] = raw.mean()
        biases[gi] = (raw - c).mean()
        # per-grid-point Monte-Carlo standard error of the mean bias (numpy's
        # std, ddof 0, as the JAX tool takes it)
        bias_se[gi] = raw.std() / np.sqrt(trials)
    return (raw_means.astype(np.float32), biases.astype(np.float32),
            bias_se.astype(np.float32))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only-p", type=int, default=None,
                    help="generate a single precision instead of all")
    ap.add_argument("--scale", type=int, default=1,
                    help="multiply the per-p trial budget (SE ~ 1/sqrt)")
    ap.add_argument("--seed", type=int, default=20260816,
                    help="base seed (per-p seed = seed + p)")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without one)")
    args = ap.parse_args(argv)
    device = resolve_device(device_from_flags(args.device))
    out_path = os.path.abspath(args.out)
    out = {}
    if args.only_p and os.path.exists(out_path):
        # --only-p regenerates ONE precision: merge into the existing file
        # instead of clobbering the other precisions' tables
        with np.load(out_path) as z:
            out = {k: np.asarray(z[k]) for k in z.files}
    ps = [args.only_p] if args.only_p else sorted(TRIALS)
    for p in ps:
        rng = np.random.default_rng(args.seed + p)
        raw, bias, se = gen_for_p(p, rng, scale=args.scale, device=device)
        out[f"raw_estimate_p{p}"] = raw
        out[f"bias_p{p}"] = bias
        out[f"bias_se_p{p}"] = se
        print(f"p={p}: grid {len(raw)} entries, raw [{raw[0]:.1f}, "
              f"{raw[-1]:.1f}], bias [{bias.min():.1f}, {bias.max():.1f}], "
              f"bias SE [{se.min():.3f}, {se.max():.3f}] "
              f"({TRIALS[p] * args.scale} trials, {device})", flush=True)
    np.savez_compressed(out_path, **out)
    print(f"wrote {out_path}")
    return out


if __name__ == "__main__":
    main()
