"""K3: fused row gather and segmented min/max over dst-sorted edges.

Replaces the JAX study's Pallas kernel ``studies/pallas_gather_reduce.py``
(``gather_reduce``).  One hop of sketch propagation in one pass over the
edges sorted by destination:

    out[v] = op(rows[v], rows[u] for (u, v) in edges)

with ``rows`` [n + 1, W] holding the identity in its last row, and pad
edges (src = dst = n) that touch only that row.  On the card this is
``csrc/gather_reduce.cu`` over ``csrc/merge_path.cuh``, driven by a
per-destination pointer that ``prepare_csr_edges`` derives on the host
(the JAX layout has only the two sorted arrays).  The pad edges fold row n
into itself, a no-op under min/max, so the pointer stops at the real edges
and row n is copied.  The n + 1 row ends and the E_pad edges form one merge
path, cut into equal shares of steps whatever the degrees; a team of lanes
copies its share's src slab to shared memory, gathers 8 source rows at a
time (16-byte units where a row's bytes are a multiple of 16, else 32-bit
words), reduces the rows that end in its share, and leaves the row open at
its end as a carry-out that a second launch folds into the output in share
order.  A hub's edges spread over many shares, so its time is its gathers
(E*W*b bytes, from L2 or HBM) and not one warp's walk.  The wrapper
allocates the carry-out scratch with ``torch.empty``.

Instances: biased int32 min (MinHash) and int8 max (HLL).  Dispatch as in
``ops/segscan.py``: a CPU tensor takes :func:`gather_reduce_plain`; a CUDA
tensor launches the kernel, or raises on what it does not take.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from subgraph_sketching_tpu_torch.ops import cuda_build
from subgraph_sketching_tpu_torch.ops.segment import identity

BLOCK_EDGES = 4096   # the JAX study's edge tile; only the padding keeps it

# (op, dtype) -> (C entry point, elements per 32-bit word)
_ENTRY = {
    ("min", torch.int32): ("gather_reduce_min_i32", 1),
    ("max", torch.int8): ("gather_reduce_max_i8", 4),
}
_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int64,) * 4 + (ctypes.c_void_p,)
MAX_WORDS = 128   # the study's widest row (kMaxWords in the kernel)

# kernel launches per instance, counted where gather_reduce launches
launches = {name: 0 for name, _ in _ENTRY.values()}


def prepare_csr_edges(edge_index: np.ndarray, num_nodes: int,
                      block_edges: int = BLOCK_EDGES):
    """Host layout: the edges stably sorted by dst and padded to a multiple
    of ``block_edges`` with the sentinel n, as the JAX study's
    ``prepare_csr_edges`` returns them, plus the per-destination pointer
    ``ptr`` int64 [n + 2] over the real edges: row v's edges are
    ``ptr[v]:ptr[v + 1]``, and row n (the identity row) has none.

    Returns (src int32 [E_pad], dst int32 [E_pad], ptr int64 [n + 2])."""
    edge_index = np.asarray(edge_index)
    order = np.argsort(edge_index[1], kind="stable")
    src = edge_index[0][order].astype(np.int32)
    dst = edge_index[1][order].astype(np.int32)
    e = len(src)
    e_pad = max(block_edges, -(-e // block_edges) * block_edges)
    ptr = np.zeros(num_nodes + 2, dtype=np.int64)
    np.cumsum(np.bincount(dst, minlength=num_nodes), out=ptr[1:num_nodes + 1])
    ptr[num_nodes + 1] = e
    pad = np.full(e_pad - e, num_nodes, np.int32)
    return np.concatenate([src, pad]), np.concatenate([dst, pad]), ptr


def append_identity_row(x: torch.Tensor, *, is_min: bool) -> torch.Tensor:
    row = torch.full((1, x.shape[1]), identity("min" if is_min else "max",
                                               x.dtype),
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, row])


def gather_reduce_plain(rows: torch.Tensor, src: torch.Tensor,
                        dst: torch.Tensor, *, is_min: bool) -> torch.Tensor:
    """The same function in plain torch: the gathered rows scatter-reduced
    into a copy of ``rows`` (pads included, as the JAX kernel walks
    them)."""
    index = dst.long()[:, None].expand(-1, rows.shape[1])
    return rows.scatter_reduce(0, index, rows.index_select(0, src),
                               "amin" if is_min else "amax",
                               include_self=True)


def _check_cuda_args(rows, src, dst, ptr, is_min):
    op = "min" if is_min else "max"
    if (op, rows.dtype) not in _ENTRY:
        raise ValueError(f"gather_reduce: no kernel for op={op} "
                         f"dtype={rows.dtype}")
    if rows.dim() != 2:
        raise ValueError(f"gather_reduce: rows must be [n + 1, W], got "
                         f"{tuple(rows.shape)}")
    per_word = _ENTRY[(op, rows.dtype)][1]
    if rows.shape[1] % per_word:
        raise ValueError(f"gather_reduce: int8 rows need a width that is a "
                         f"multiple of 4, got {rows.shape[1]}")
    if not 0 < rows.shape[1] // per_word <= MAX_WORDS:
        raise ValueError(f"gather_reduce: rows of 1 to {MAX_WORDS} 32-bit "
                         f"words, got {rows.shape[1] // per_word}")
    if src.dtype != torch.int32 or src.dim() != 1 or dst.dim() != 1:
        raise ValueError("gather_reduce: src must be int32 [E]")
    if ptr.dtype != torch.int64 or ptr.dim() != 1 \
            or ptr.shape[0] != rows.shape[0] + 1:
        raise ValueError("gather_reduce: ptr must be int64 [n + 2]")
    cuda_build.check_tensors("gather_reduce", rows=rows, src=src, dst=dst,
                             ptr=ptr)


def gather_reduce(rows: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  ptr: torch.Tensor, *, is_min: bool) -> torch.Tensor:
    """K3.  ``rows`` [n + 1, W] (identity row n), ``src``/``dst`` [E_pad]
    sorted by dst with pads at n, ``ptr`` int64 [n + 2] from
    :func:`prepare_csr_edges`.  Returns a new [n + 1, W]."""
    if rows.device.type == "cpu":
        return gather_reduce_plain(rows, src, dst, is_min=is_min)
    if rows.device.type != "cuda":
        raise ValueError(f"gather_reduce: unsupported device {rows.device}")
    _check_cuda_args(rows, src, dst, ptr, is_min)
    fn_name, per_word = _ENTRY[("min" if is_min else "max", rows.dtype)]
    n, e, words = rows.shape[0], src.shape[0], rows.shape[1] // per_word
    shares, carry, carry_row = cuda_build.merge_path_scratch(
        "gather_reduce", n, e, words, rows.device)
    out = torch.empty_like(rows)
    cuda_build.launch(cuda_build.entry("gather_reduce", fn_name, _ARGTYPES),
                      fn_name, rows.device, rows.data_ptr(), src.data_ptr(),
                      ptr.data_ptr(), out.data_ptr(), carry.data_ptr(),
                      carry_row.data_ptr(), n, e, words, shares)
    launches[fn_name] += 1
    return out


def propagate_min(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  ptr: torch.Tensor) -> torch.Tensor:
    """Closed-neighbourhood elementwise min over biased int32 MinHash lanes
    [n, W] (the study's ``propagate_min_pallas``; the lanes are already
    biased here)."""
    rows = append_identity_row(x, is_min=True)
    return gather_reduce(rows, src, dst, ptr, is_min=True)[:-1]


def propagate_max(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  ptr: torch.Tensor) -> torch.Tensor:
    """Closed-neighbourhood elementwise max over int8 HLL registers [n, W]
    (the study's ``propagate_max_pallas``)."""
    rows = append_identity_row(x, is_min=False)
    return gather_reduce(rows, src, dst, ptr, is_min=False)[:-1]
