"""K1: the sorted-segment merge of the padded-tree plan.

Replaces the JAX package's Pallas kernel ``ops/pallas_segscan.py``
(``_segscan_totals`` and its glue ``segment_aggregates`` /
``sorted_segment_combine``).  Given the [S, W] sub-run results ``v`` of a
plan and each destination's sub-run range ``ptr`` ([N + 1], the plan's
``sub_starts``), it computes

    min / max:  out[n] = op(x[n], op over v[ptr[n]:ptr[n+1]])
    add:        out[n] = sum over v[ptr[n]:ptr[n+1]]    (0 when empty)

On the card this is ``csrc/segscan.cu``, a per-destination segment
reduction with no cross-block carry.  It is bound by HBM bytes: S*W*b read
of v, N*W*b read of x (min/max only), N*W*b write, plus the (N+1)-entry
pointer.  It streams each row once and writes no [S, W] totals array, which
the TPU version wrote and then gathered.

Dispatch: a CPU tensor takes :func:`segment_combine_plain`; a CUDA tensor
launches the kernel, or raises on an (op, dtype, shape, layout) it does not
take.  Nothing falls back from the card.
"""

from __future__ import annotations

import ctypes

import torch

from subgraph_sketching_tpu_torch.ops import cuda_build

# (op, dtype) -> (C entry point, elements per 32-bit word)
_ENTRY = {
    ("min", torch.int32): ("segscan_min_i32", 1),
    ("max", torch.int32): ("segscan_max_i32", 1),
    ("max", torch.int8): ("segscan_max_i8", 4),
    ("add", torch.float32): ("segscan_add_f32", 1),
}
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int64,) * 2 + (ctypes.c_void_p,)

# kernel launches per instance, counted where segment_combine launches
# (the plain version never counts)
launches = {name: 0 for name, _ in _ENTRY.values()}

_IDENTITY = {
    ("min", torch.int32): torch.iinfo(torch.int32).max,
    ("max", torch.int32): torch.iinfo(torch.int32).min,
    ("max", torch.int8): torch.iinfo(torch.int8).min,
    ("add", torch.float32): 0.0,
}

_REDUCE = {"min": "amin", "max": "amax", "add": "sum"}


def supported(op: str, dtype: torch.dtype) -> bool:
    """The four K1 instances: biased-int32 min (MinHash), int8 max (HLL),
    int32 max and float32 add (SpMM)."""
    return (op, dtype) in _ENTRY


def identity(op: str, dtype: torch.dtype):
    return _IDENTITY[(op, dtype)]


def segment_ids(ptr: torch.Tensor) -> torch.Tensor:
    """[S] int64 destination of each sub-run, from the [N + 1] pointer."""
    n = ptr.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n, device=ptr.device),
                                   ptr.diff())


def segment_combine_plain(v: torch.Tensor, x: torch.Tensor, op: str,
                          ptr: torch.Tensor) -> torch.Tensor:
    """The same function as the kernel in plain torch: a segment
    amin/amax/sum of ``v`` over the sub-runs' destinations (from ``ptr``)
    with ``scatter_reduce``, then the closed-neighbourhood fold-in of ``x``
    for min/max."""
    n, w = x.shape
    init = torch.full((n, w), identity(op, v.dtype), dtype=v.dtype,
                      device=v.device)
    agg = init.scatter_reduce(0, segment_ids(ptr)[:, None].expand(-1, w), v,
                              _REDUCE[op], include_self=True)
    if op == "min":
        return torch.minimum(x, agg)
    if op == "max":
        return torch.maximum(x, agg)
    return agg


def _check_cuda_args(v, x, ptr, op):
    if not supported(op, v.dtype):
        raise ValueError(f"segment_combine: no kernel for op={op} "
                         f"dtype={v.dtype}")
    if v.dim() != 2 or x.dim() != 2 or v.shape[1] != x.shape[1]:
        raise ValueError(f"segment_combine: v {tuple(v.shape)} and x "
                         f"{tuple(x.shape)} must be [S, W] and [N, W]")
    if x.dtype != v.dtype:
        raise ValueError("segment_combine: v and x differ in dtype")
    if ptr.dtype != torch.int64 or ptr.dim() != 1 \
            or ptr.shape[0] != x.shape[0] + 1:
        raise ValueError("segment_combine: ptr must be int64 [N + 1]")
    cuda_build.check_tensors("segment_combine", x=x, v=v, ptr=ptr)
    per_word = _ENTRY[(op, v.dtype)][1]
    if v.shape[1] % per_word:
        raise ValueError(f"segment_combine: int8 rows need a width that is "
                         f"a multiple of 4, got {v.shape[1]}")


def segment_combine(v: torch.Tensor, x: torch.Tensor, op: str,
                    ptr: torch.Tensor) -> torch.Tensor:
    """K1.  ``v`` [S, W] sub-run results, ``x`` [N, W] node rows (read for
    min/max only), ``ptr`` [N + 1] int64 sub-run pointer.  Returns
    [N, W]."""
    if v.device.type == "cpu":
        return segment_combine_plain(v, x, op, ptr)
    if v.device.type != "cuda":
        raise ValueError(f"segment_combine: unsupported device {v.device}")
    _check_cuda_args(v, x, ptr, op)
    fn_name, per_word = _ENTRY[(op, v.dtype)]
    out = torch.empty_like(x)
    cuda_build.launch(cuda_build.entry("segscan", fn_name, _ARGTYPES),
                      fn_name, x.device, v.data_ptr(), x.data_ptr(),
                      ptr.data_ptr(), out.data_ptr(), x.shape[0],
                      x.shape[1] // per_word)
    launches[fn_name] += 1
    return out
