"""K2: block-accumulator sketch propagation.

Counterpart of the JAX study ``studies/pallas_sketch_prop.py``.  The
destinations are cut into blocks of ``BLOCK_ROWS`` rows; the edges, with
one self-loop per node, are sorted by (destination block, src); each
block's running min/max is accumulated from identity over its edges:

    out[v] = op over (u, v) in edges + self-loops of rows[u]

On the card this is ``csrc/block_prop.cu``: one CTA per block, its
accumulator tile in shared memory, shared-memory atomics for the updates.
The TPU kernel's 4096-row VMEM block does not fit a Hopper block's shared
memory (2 MB at W = 128 int32 against 227 KB), so the block here is 128
rows: a 64 KB tile for a MinHash row of 512 bytes, 32 KB for an int8 HLL
row of 256, which stays int8 (no widening, in shared memory or in HBM).

The host layout is vectorised (one ``lexsort``, ``bincount`` and
``cumsum``): the sorted src, the row within the block (``dstl``) and a
per-block edge pointer ``blk_ptr``.  The TPU layout's tile padding and its
identity-chunk sentinel served only the TPU grid and are gone.

Dispatch as in ``ops/segscan.py``: a CPU tensor takes
:func:`block_prop_plain`; a CUDA tensor launches the kernel, or raises on
what it does not take.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from subgraph_sketching_tpu_torch.device import resolve_device
from subgraph_sketching_tpu_torch.ops import cuda_build
from subgraph_sketching_tpu_torch.ops.segment import identity

BLOCK_ROWS = 128   # destination rows per CTA: a tile of at most 64 KB
MAX_WORDS = 128    # the kernel keeps a row's words in four registers

# (op, dtype) -> (C entry point, elements per 32-bit word)
_ENTRY = {
    ("min", torch.int32): ("block_prop_min_i32", 1),
    ("max", torch.int8): ("block_prop_max_i8", 4),
}
_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int64,) * 3 + (ctypes.c_void_p,)

# kernel launches per instance, counted where block_prop launches
launches = {name: 0 for name, _ in _ENTRY.values()}


def prepare_block_edges(edge_index: np.ndarray, num_nodes: int,
                        block_rows: int = BLOCK_ROWS):
    """Edges plus self-loops sorted by (dst block, src), stably, as the JAX
    study's ``prepare_block_edges`` sorts them, without its padding.

    Returns (src int32 [E + n], dstl int32 [E + n], blk_ptr int64
    [num_blocks + 1], num_blocks): block b's edges are
    ``blk_ptr[b]:blk_ptr[b + 1]``, ``dstl`` is the row within the block."""
    edge_index = np.asarray(edge_index)
    loops = np.arange(num_nodes, dtype=np.int32)
    src = np.concatenate([edge_index[0].astype(np.int32), loops])
    dst = np.concatenate([edge_index[1].astype(np.int32), loops])
    blk = dst // block_rows
    order = np.lexsort((src, blk))
    src, dst, blk = src[order], dst[order], blk[order]
    num_blocks = -(-num_nodes // block_rows)
    blk_ptr = np.zeros(num_blocks + 1, dtype=np.int64)
    np.cumsum(np.bincount(blk, minlength=num_blocks), out=blk_ptr[1:])
    return src, (dst - blk * block_rows).astype(np.int32), blk_ptr, num_blocks


def block_prop_plain(rows: torch.Tensor, src: torch.Tensor,
                     dstl: torch.Tensor, blk_ptr: torch.Tensor, *,
                     is_min: bool) -> torch.Tensor:
    """The same function in plain torch: the gathered rows scatter-reduced
    into an identity-filled [n, W] at their global destination rows."""
    n, w = rows.shape
    starts = torch.arange(blk_ptr.shape[0] - 1, device=rows.device) \
        * BLOCK_ROWS
    dst = torch.repeat_interleave(starts, blk_ptr.diff()) + dstl
    out = torch.full((n, w), identity("min" if is_min else "max", rows.dtype),
                     dtype=rows.dtype, device=rows.device)
    return out.scatter_reduce(0, dst[:, None].expand(-1, w),
                              rows.index_select(0, src),
                              "amin" if is_min else "amax", include_self=True)


def _check_cuda_args(rows, src, dstl, blk_ptr, is_min):
    op = "min" if is_min else "max"
    if (op, rows.dtype) not in _ENTRY:
        raise ValueError(f"block_prop: no kernel for op={op} "
                         f"dtype={rows.dtype}")
    if rows.dim() != 2:
        raise ValueError(f"block_prop: rows must be [n, W], got "
                         f"{tuple(rows.shape)}")
    per_word = _ENTRY[(op, rows.dtype)][1]
    if rows.shape[1] % per_word:
        raise ValueError(f"block_prop: int8 rows need a width that is a "
                         f"multiple of 4, got {rows.shape[1]}")
    words = rows.shape[1] // per_word
    if not 0 < words <= MAX_WORDS:
        raise ValueError(f"block_prop: rows of 1 to {MAX_WORDS} 32-bit "
                         f"words, got {words}")
    if src.dtype != torch.int32 or dstl.dtype != torch.int32 \
            or src.shape != dstl.shape or src.dim() != 1:
        raise ValueError("block_prop: src and dstl must be int32 [E + n]")
    if blk_ptr.dtype != torch.int64 or blk_ptr.dim() != 1 \
            or blk_ptr.shape[0] != -(-rows.shape[0] // BLOCK_ROWS) + 1:
        raise ValueError("block_prop: blk_ptr must be int64 "
                         "[ceil(n / BLOCK_ROWS) + 1]")
    cuda_build.check_tensors("block_prop", rows=rows, src=src, dstl=dstl,
                             blk_ptr=blk_ptr)


def block_prop(rows: torch.Tensor, src: torch.Tensor, dstl: torch.Tensor,
               blk_ptr: torch.Tensor, *, is_min: bool) -> torch.Tensor:
    """K2.  ``rows`` [n, W]; ``src``, ``dstl`` and ``blk_ptr`` from
    :func:`prepare_block_edges`.  Returns a new [n, W]."""
    if rows.device.type == "cpu":
        return block_prop_plain(rows, src, dstl, blk_ptr, is_min=is_min)
    if rows.device.type != "cuda":
        raise ValueError(f"block_prop: unsupported device {rows.device}")
    _check_cuda_args(rows, src, dstl, blk_ptr, is_min)
    fn_name, per_word = _ENTRY[("min" if is_min else "max", rows.dtype)]
    out = torch.empty_like(rows)
    cuda_build.launch(cuda_build.entry("block_prop", fn_name, _ARGTYPES),
                      fn_name, rows.device, rows.data_ptr(), src.data_ptr(),
                      dstl.data_ptr(), blk_ptr.data_ptr(), out.data_ptr(),
                      rows.shape[0], rows.shape[1] // per_word, BLOCK_ROWS)
    launches[fn_name] += 1
    return out


class BlockPropPlan:
    """Host-prepared layout for repeated propagation over one graph, on
    ``device``."""

    def __init__(self, edge_index: np.ndarray, num_nodes: int,
                 device="cuda"):
        dev = resolve_device(device)
        src, dstl, blk_ptr, nb = prepare_block_edges(edge_index, num_nodes)
        self.src = torch.from_numpy(src).to(dev)
        self.dstl = torch.from_numpy(dstl).to(dev)
        self.blk_ptr = torch.from_numpy(blk_ptr).to(dev)
        self.num_blocks = nb
        self.num_nodes = num_nodes
        self.num_edges = np.asarray(edge_index).shape[1]

    def propagate_minhash(self, mh: torch.Tensor) -> torch.Tensor:
        """Closed-neighbourhood elementwise min over biased int32 lanes."""
        return block_prop(mh, self.src, self.dstl, self.blk_ptr, is_min=True)

    def propagate_hll(self, hll: torch.Tensor) -> torch.Tensor:
        """Closed-neighbourhood elementwise max over int8 registers."""
        return block_prop(hll, self.src, self.dstl, self.blk_ptr,
                          is_min=False)
