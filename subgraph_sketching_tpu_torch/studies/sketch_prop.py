"""K2: block-accumulator sketch propagation.

Counterpart of the JAX study ``studies/pallas_sketch_prop.py``.  The
destinations are cut into blocks of ``BLOCK_ROWS`` rows; the edges, with
one self-loop per node, are sorted by (destination block, src); each
block's running min/max is accumulated from identity over its edges:

    out[v] = op over (u, v) in edges + self-loops of rows[u]

On the card this is ``csrc/block_prop.cu``.  Each block's edge range is
cut into pieces of at most ``steps`` edges (the kernel's own constant,
``cuda_build.share_steps("block_prop")``), one CTA per piece with the
block's tile in shared memory.  A block of one piece writes its tile to
``out``; the pieces of a longer block (a hub's) write their tiles to
scratch and a second launch folds them in piece order.  The TPU kernel's
4096-row VMEM block does not fit a Hopper block's shared memory (2 MB at
W = 128 int32 against 227 KB), so the block here is 64 rows: a 32 KB tile
for a MinHash row of 512 bytes, 16 KB for an int8 HLL row of 256, which
stays int8 (no widening, in shared memory or in HBM).

The host layout is vectorised (one ``lexsort``, ``bincount`` and
``cumsum``): the sorted src, the row within the block (``dstl``) and a
per-block edge pointer ``blk_ptr``; :func:`block_pieces` cuts it into the
piece table once per graph (:class:`BlockPropPlan` holds both).  The TPU
layout's tile padding and its identity-chunk sentinel served only the TPU
grid and are gone.

Dispatch as in ``ops/segscan.py``: a CPU tensor takes
:func:`block_prop_plain`; a CUDA tensor launches the kernel, or raises on
what it does not take.  :func:`block_prop_pieces_plain` computes the same
function the kernel's way, piece by piece, so the CPU tests can hold the
piece table against the JAX kernel.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from subgraph_sketching_tpu_torch.device import resolve_device
from subgraph_sketching_tpu_torch.ops import cuda_build
from subgraph_sketching_tpu_torch.ops.segment import identity

BLOCK_ROWS = 64    # destination rows per tile: at most 32 KB
MAX_WORDS = 128    # the widest row the kernel takes, in 32-bit words

# (op, dtype) -> (C entry point, its fold's entry point, elements per
# 32-bit word)
_ENTRY = {
    ("min", torch.int32): ("block_prop_min_i32", "block_prop_fold_min_i32", 1),
    ("max", torch.int8): ("block_prop_max_i8", "block_prop_fold_max_i8", 4),
}
_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int64,) * 5 + (ctypes.c_void_p,)
_FOLD_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int64,) * 4 \
    + (ctypes.c_void_p,)

# kernel launches per entry point, the fold's under its own name, counted
# where block_prop launches
launches = {name: 0 for entry in _ENTRY.values() for name in entry[:2]}


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


@dataclass
class BlockPieces:
    """The piece table of one block layout: piece p holds the edges
    ``ptr[p]:ptr[p + 1]`` of block ``blk[p]``, at most ``steps`` of them,
    and writes its tile to ``out`` (``slot[p] == -1``: its block has one
    piece) or to scratch tile ``slot[p]``.  Fold m combines the scratch
    tiles ``fold_ptr[m]:fold_ptr[m + 1]`` of block ``fold_blk[m]``."""

    steps: int
    ptr: torch.Tensor        # int64 [pieces + 1]
    blk: torch.Tensor        # int32 [pieces]
    slot: torch.Tensor       # int32 [pieces]
    fold_ptr: torch.Tensor   # int32 [folds + 1]
    fold_blk: torch.Tensor   # int32 [folds]

    @property
    def num_pieces(self) -> int:
        return self.blk.shape[0]

    @property
    def num_folds(self) -> int:
        return self.fold_blk.shape[0]

    @property
    def num_slots(self) -> int:
        return int(self.fold_ptr[-1])

    def tensors(self):
        return (self.ptr, self.blk, self.slot, self.fold_ptr, self.fold_blk)


def block_pieces(blk_ptr: np.ndarray, steps: int, device="cpu") -> BlockPieces:
    """Cut each block's edge range ``blk_ptr[b]:blk_ptr[b + 1]`` into
    ceil(its edges / ``steps``) pieces in order (one for a block with no
    edges), vectorised on the host."""
    blk_ptr = np.asarray(blk_ptr, dtype=np.int64)
    count = np.maximum(1, -(-np.diff(blk_ptr) // steps))
    blk = np.repeat(np.arange(len(count), dtype=np.int32), count)
    first = np.cumsum(count) - count          # each block's first piece
    within = np.arange(len(blk)) - first[blk]
    ptr = np.append(blk_ptr[blk] + within * steps, blk_ptr[-1])
    multi = count > 1
    slot = np.full(len(blk), -1, dtype=np.int32)
    slot[multi[blk]] = np.arange(int(count[multi].sum()), dtype=np.int32)
    fold_ptr = np.zeros(int(multi.sum()) + 1, dtype=np.int32)
    np.cumsum(count[multi], out=fold_ptr[1:])
    dev = torch.device(device)
    return BlockPieces(steps, *(torch.from_numpy(a).to(dev) for a in (
        ptr, blk, slot, fold_ptr, np.flatnonzero(multi).astype(np.int32))))


def _reduce_name(is_min: bool) -> str:
    return "amin" if is_min else "amax"


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
                              _reduce_name(is_min), include_self=True)


def block_prop_pieces_plain(rows: torch.Tensor, src: torch.Tensor,
                            dstl: torch.Tensor, pieces: BlockPieces, *,
                            is_min: bool) -> torch.Tensor:
    """The same function the kernel's way, in plain torch: each piece's
    edges op-ed into its block's rows of ``out`` or into its scratch tile,
    then each fold's tiles op-ed into its block's rows."""
    n, w = rows.shape
    ident = identity("min" if is_min else "max", rows.dtype)
    red = _reduce_name(is_min)
    piece = torch.repeat_interleave(
        torch.arange(pieces.num_pieces, device=rows.device), pieces.ptr.diff())
    slot = pieces.slot.long()[piece]
    direct = slot < 0
    dst = pieces.blk.long()[piece] * BLOCK_ROWS + dstl
    vals = rows.index_select(0, src)
    nb_rows = (int(pieces.blk[-1]) + 1) * BLOCK_ROWS if n else 0
    out = torch.full((nb_rows, w), ident, dtype=rows.dtype, device=rows.device)
    out.scatter_reduce_(0, dst[direct, None].expand(-1, w), vals[direct], red)
    scratch = torch.full((pieces.num_slots * BLOCK_ROWS, w), ident,
                         dtype=rows.dtype, device=rows.device)
    tile_row = slot[~direct] * BLOCK_ROWS + dstl[~direct]
    scratch.scatter_reduce_(0, tile_row[:, None].expand(-1, w), vals[~direct],
                            red)
    slot_blk = torch.repeat_interleave(pieces.fold_blk.long(),
                                       pieces.fold_ptr.diff())
    rows_of = (slot_blk[:, None] * BLOCK_ROWS
               + torch.arange(BLOCK_ROWS, device=rows.device)).reshape(-1)
    out.scatter_reduce_(0, rows_of[:, None].expand(-1, w), scratch, red)
    return out[:n]


def _check_cuda_args(rows, src, dstl, blk_ptr, is_min):
    op = "min" if is_min else "max"
    if (op, rows.dtype) not in _ENTRY:
        raise ValueError(f"block_prop: no kernel for op={op} "
                         f"dtype={rows.dtype}")
    if rows.dim() != 2:
        raise ValueError(f"block_prop: rows must be [n, W], got "
                         f"{tuple(rows.shape)}")
    per_word = _ENTRY[(op, rows.dtype)][2]
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


def _check_pieces(pieces, rows, blk_ptr):
    if pieces is None:
        raise ValueError("block_prop: the kernel needs the piece table "
                         "(block_pieces, or BlockPropPlan on the card)")
    steps = cuda_build.share_steps("block_prop")
    if pieces.steps != steps:
        raise ValueError(f"block_prop: pieces of {pieces.steps} steps, the "
                         f"kernel takes {steps}")
    if pieces.num_pieces < blk_ptr.shape[0] - 1:
        raise ValueError("block_prop: the piece table is not of this "
                         "block layout")
    cuda_build.check_tensors("block_prop", rows=rows, **dict(zip(
        ("ptr", "blk", "slot", "fold_ptr", "fold_blk"), pieces.tensors())))


def block_prop(rows: torch.Tensor, src: torch.Tensor, dstl: torch.Tensor,
               blk_ptr: torch.Tensor, *, is_min: bool,
               pieces: BlockPieces | None = None) -> torch.Tensor:
    """K2.  ``rows`` [n, W]; ``src``, ``dstl`` and ``blk_ptr`` from
    :func:`prepare_block_edges`; on the card, ``pieces`` from
    :func:`block_pieces` of that ``blk_ptr`` at the kernel's steps.
    Returns a new [n, W]."""
    if rows.device.type == "cpu":
        return block_prop_plain(rows, src, dstl, blk_ptr, is_min=is_min)
    if rows.device.type != "cuda":
        raise ValueError(f"block_prop: unsupported device {rows.device}")
    _check_cuda_args(rows, src, dstl, blk_ptr, is_min)
    _check_pieces(pieces, rows, blk_ptr)
    fn_name, fold_name, per_word = _ENTRY[("min" if is_min else "max",
                                           rows.dtype)]
    n, words = rows.shape[0], rows.shape[1] // per_word
    out = torch.empty_like(rows)
    scratch = torch.empty((pieces.num_slots * BLOCK_ROWS, words),
                          dtype=torch.int32, device=rows.device)
    cuda_build.launch(cuda_build.entry("block_prop", fn_name, _ARGTYPES),
                      fn_name, rows.device, rows.data_ptr(), src.data_ptr(),
                      dstl.data_ptr(), pieces.ptr.data_ptr(),
                      pieces.blk.data_ptr(), pieces.slot.data_ptr(),
                      out.data_ptr(), scratch.data_ptr(), n,
                      pieces.num_pieces, words, BLOCK_ROWS, pieces.steps)
    launches[fn_name] += 1
    if pieces.num_folds:
        cuda_build.launch(
            cuda_build.entry("block_prop", fold_name, _FOLD_ARGTYPES),
            fold_name, rows.device, scratch.data_ptr(),
            pieces.fold_ptr.data_ptr(), pieces.fold_blk.data_ptr(),
            out.data_ptr(), n, pieces.num_folds, words, BLOCK_ROWS)
        launches[fold_name] += 1
    return out


class BlockPropPlan:
    """Host-prepared layout for repeated propagation over one graph, on
    ``device``; on the card also its piece table, cut at the kernel's own
    steps (the plain version on the CPU needs none)."""

    def __init__(self, edge_index: np.ndarray, num_nodes: int,
                 device="cuda"):
        dev = resolve_device(device)
        src, dstl, blk_ptr, nb = prepare_block_edges(edge_index, num_nodes)
        self.src = torch.from_numpy(src).to(dev)
        self.dstl = torch.from_numpy(dstl).to(dev)
        self.blk_ptr = torch.from_numpy(blk_ptr).to(dev)
        self.pieces = block_pieces(
            blk_ptr, cuda_build.share_steps("block_prop"), dev) \
            if dev.type == "cuda" else None
        self.num_blocks = nb
        self.num_nodes = num_nodes
        self.num_edges = np.asarray(edge_index).shape[1]

    def propagate_minhash(self, mh: torch.Tensor) -> torch.Tensor:
        """Closed-neighbourhood elementwise min over biased int32 lanes."""
        return block_prop(mh, self.src, self.dstl, self.blk_ptr, is_min=True,
                          pieces=self.pieces)

    def propagate_hll(self, hll: torch.Tensor) -> torch.Tensor:
        """Closed-neighbourhood elementwise max over int8 registers."""
        return block_prop(hll, self.src, self.dstl, self.blk_ptr,
                          is_min=False, pieces=self.pieces)
