"""K4: the per-row gather rate, with the study's CLI.

Counterpart of the JAX study ``studies/pallas_dma_gather_rate.py``, which
measures how many arbitrary rows per second a kernel can gather one row at
a time, against the framework's own gather (``rows[idx].min(0)``).  Its
kernel walks ``n_blocks`` blocks of ``BLOCK`` indices and folds each
block's rows into an elementwise min, but writes every block's min to the
same output row, so :func:`dma_gather` returns the min over the LAST
block's rows only.  The port returns the same function.

On the card this is ``csrc/dma_gather.cu``: one CTA per block, which
stores its block's min to row b of an [n_blocks, W] output
(:func:`block_mins`); :func:`dma_gather` returns the last row.  A CPU
tensor takes the plain versions.

The kernel does not gather in index order: each CTA first sorts its
block's indices on their top bits, so that the CTAs, all resident at
once, sweep the table together and a row gathered by several blocks is
read from HBM about once.  The min is the same bits in any order, but the
study's rows/s is then the rate of the block-min function at the study's
inputs, not the rate of gathering arbitrary rows in the order given.

    python -m subgraph_sketching_tpu_torch.studies.dma_gather_rate

prints the kernel's rows/s beside ``rows[idx].min(0)`` in torch at the
study's shape (200000 rows of 128 int32, 2^20 indices), on the card.  The
yardstick computes another function (the min over every index); it is a
yardstick of time only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import time

import numpy as np
import torch

from subgraph_sketching_tpu_torch.device import resolve_device
from subgraph_sketching_tpu_torch.ops import cuda_build

BLOCK = 2048          # indices per block, as in the study
W = 128               # int32 lanes per row (a MinHash row)
MAX_WORDS = 128

_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int64,) * 3 + (ctypes.c_void_p,)

# kernel launches, counted where block_mins launches
launches = {"dma_gather": 0}


def block_mins_plain(rows: torch.Tensor, idx: torch.Tensor,
                     n_blocks: int) -> torch.Tensor:
    """[n_blocks, W]: row b is the min over rows[idx[b*BLOCK:(b+1)*BLOCK]]."""
    picked = rows.index_select(0, idx[:n_blocks * BLOCK])
    return picked.view(n_blocks, BLOCK, rows.shape[1]).amin(dim=1)


def dma_gather_plain(rows: torch.Tensor, idx: torch.Tensor,
                     n_blocks: int) -> torch.Tensor:
    """[1, W]: the min over the last block's rows, the study's function."""
    last = idx[(n_blocks - 1) * BLOCK:n_blocks * BLOCK]
    return rows.index_select(0, last).amin(dim=0, keepdim=True)


def _check_args(rows, idx, n_blocks):
    if n_blocks < 1 or idx.dim() != 1 or idx.shape[0] < n_blocks * BLOCK:
        raise ValueError(f"dma_gather: {n_blocks} blocks need at least "
                         f"{max(n_blocks, 1) * BLOCK} indices, got "
                         f"{tuple(idx.shape)}")
    if rows.device.type == "cpu":
        return
    if rows.device.type != "cuda":
        raise ValueError(f"dma_gather: unsupported device {rows.device}")
    if rows.dtype != torch.int32 or idx.dtype != torch.int32:
        raise ValueError(f"dma_gather: rows and idx must be int32, got "
                         f"{rows.dtype} and {idx.dtype}")
    if rows.dim() != 2 or not 0 < rows.shape[1] <= MAX_WORDS \
            or rows.shape[0] < 1:
        raise ValueError(f"dma_gather: rows must be [N, 1..{MAX_WORDS}], "
                         f"got {tuple(rows.shape)}")
    cuda_build.check_tensors("dma_gather", rows=rows, idx=idx)


def block_mins(rows: torch.Tensor, idx: torch.Tensor,
               n_blocks: int) -> torch.Tensor:
    """K4: every block's min, [n_blocks, W] int32.  ``rows`` [N, W] int32,
    ``idx`` int32 [>= n_blocks * BLOCK] with entries in [0, N)."""
    _check_args(rows, idx, n_blocks)
    if rows.device.type == "cpu":
        return block_mins_plain(rows, idx, n_blocks)
    out = torch.empty((n_blocks, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    cuda_build.launch(
        cuda_build.entry("dma_gather", "dma_gather_block_min", _ARGTYPES),
        "dma_gather", rows.device, rows.data_ptr(), idx.data_ptr(),
        out.data_ptr(), rows.shape[0], n_blocks, rows.shape[1])
    launches["dma_gather"] += 1
    return out


def dma_gather(rows: torch.Tensor, idx: torch.Tensor,
               n_blocks: int) -> torch.Tensor:
    """The study's function: [1, W], the min over the last block's rows."""
    return block_mins(rows, idx, n_blocks)[-1:]


def _timed_ms(fn, device: torch.device, iters: int = 20) -> float:
    """Mean ms per call over ``iters`` calls, after two warm-up calls; CUDA
    events on the card, the host clock on the CPU."""
    for _ in range(2):
        fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def study_inputs(num_rows: int = 200_000, num_indices: int = 1 << 20,
                 seed: int = 0, device="cuda"):
    """The study's seeded inputs on ``device``: rows [num_rows, W] int32 in
    [0, 2^31 - 1) and int32 indices [num_indices] in [0, num_rows)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    rows = torch.from_numpy(
        rng.integers(0, 2 ** 31 - 1, (num_rows, W)).astype(np.int32)).to(dev)
    idx = torch.from_numpy(
        rng.integers(0, num_rows, num_indices).astype(np.int32)).to(dev)
    return rows, idx


def measure(num_rows: int = 200_000, num_indices: int = 1 << 20,
            seed: int = 0, device="cuda") -> dict:
    """The study: the kernel (all ``num_indices // BLOCK`` blocks) and
    ``rows[idx].min(0)`` timed on ``device`` over :func:`study_inputs`;
    the kernel's result held against its plain version."""
    dev = resolve_device(device)
    rows, idx = study_inputs(num_rows, num_indices, seed, dev)
    n_blocks = num_indices // BLOCK
    got = dma_gather(rows, idx, n_blocks)
    if not torch.equal(got, dma_gather_plain(rows, idx, n_blocks)):
        raise AssertionError("dma_gather disagrees with its plain version")
    kernel_ms = _timed_ms(lambda: dma_gather(rows, idx, n_blocks), dev)
    gather_ms = _timed_ms(lambda: rows[idx].min(0), dev)
    gathered = n_blocks * BLOCK
    return {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
            "rows": num_rows, "width": W, "indices": gathered,
            "blocks": n_blocks, "kernel_ms": kernel_ms,
            "kernel_rows_per_s": gathered / kernel_ms * 1e3,
            "torch_gather_min_ms": gather_ms,
            "torch_gather_min_rows_per_s": num_indices / gather_ms * 1e3}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--indices", type=int, default=1 << 20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = measure(args.rows, args.indices, device=args.device)
    print(f"device={r['device']}", flush=True)
    name = ("per-row gather kernel" if r["device"] != "cpu"
            else "plain version (CPU)")
    print(f"{name}: {r['kernel_rows_per_s'] / 1e6:7.1f}M "
          f"rows/s ({r['kernel_ms']:.4f} ms for {r['indices'] / 1e6:.2f}M "
          f"rows)", flush=True)
    print(f"torch rows[idx].min(0): "
          f"{r['torch_gather_min_rows_per_s'] / 1e6:7.1f}M rows/s "
          f"({r['torch_gather_min_ms']:.4f} ms)", flush=True)
    print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
