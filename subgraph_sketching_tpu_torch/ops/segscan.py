"""K1: the sorted-segment merge of the padded-tree plan.

Replaces the JAX package's Pallas kernel ``ops/pallas_segscan.py``
(``_segscan_totals`` and its glue ``segment_aggregates`` /
``sorted_segment_combine``).  Given the [S, W] sub-run results ``v`` of a
plan and each destination's sub-run range ``ptr`` ([N + 1], the plan's
``sub_starts``), it computes

    min / max:  out[n] = op(x[n], op over v[ptr[n]:ptr[n+1]])
    add:        out[n] = sum over v[ptr[n]:ptr[n+1]]    (0 when empty)

On the card this is ``csrc/segscan.cu`` over ``csrc/merge_path.cuh``: the
N row ends and S sub-runs form one merge path, cut into equal shares of
steps whatever the rows' lengths; a team of lanes reduces the rows that
end in its share (x folded in once, there), and the row open at a share's
end leaves a carry-out that a second launch folds into ``out`` in share
order.  No atomics on values: min/max are exact and the float32 add is the
same from run to run.  Rows whose bytes are a multiple of 16 are read as
16-byte units, others as 32-bit words; float64 add (the float64 reference
runs of training) takes 16-byte units only, two lanes a unit.  The
bfloat16 add (the ``--dtype bfloat16`` SpMMs and row-gather backwards)
reads bfloat16 and sums in float32 into float32 scratch ([2 shares, W]:
carry-outs, then the heads of rows that cross a share), rounding each
row once; it takes any width, those that are not a multiple of 8 as one
16-bit element a lane, so DGCNN's W = 1 is neither refused nor padded.
The float16 add (``--dtype float16``) is the same kernel over float16:
a sum past float16's largest finite value (65,504) rounds to ``inf``
once, on the row's store, as the plain version's rounding does.  Their
plain version upcasts, sums and rounds, which is what the kernel
computes.  It is
bound by HBM bytes: S*W*b read of v, N*W*b read of x (min/max only),
N*W*b write, plus the (N+1)-entry pointer; the carry-outs add one row per
share that ends inside a row.  A hub's sub-runs spread over many shares, so its time is
its bytes and not one warp's walk.  No [S, W] totals array is written, as
the TPU version wrote and then gathered.  The wrapper allocates the
carry-out scratch ([shares, words] and [shares]) with ``torch.empty``.

Dispatch: a CPU tensor takes :func:`segment_combine_plain`; a CUDA tensor
launches the kernel, or raises on an (op, dtype, shape, layout) it does not
take.  Nothing falls back from the card.
"""

from __future__ import annotations

import ctypes

import torch

from subgraph_sketching_tpu_torch.ops import cuda_build

# (op, dtype) -> (C entry point, the multiple a row's width must be: int8
# rows are read as 32-bit words, float64 rows as 16-byte units, bfloat16
# and float16 rows element by element where they are not whole 16-byte
# units)
_ENTRY = {
    ("min", torch.int32): ("segscan_min_i32", 1),
    ("max", torch.int32): ("segscan_max_i32", 1),
    ("max", torch.int8): ("segscan_max_i8", 4),
    ("add", torch.float32): ("segscan_add_f32", 1),
    ("add", torch.float64): ("segscan_add_f64", 2),
    ("add", torch.bfloat16): ("segscan_add_bf16", 1),
    ("add", torch.float16): ("segscan_add_f16", 1),
}
# the instances whose sums are taken in a wider type than they store
# (float32 scratch, one rounding a row)
_WIDE = {torch.bfloat16, torch.float16}
_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int64,) * 4 + (ctypes.c_void_p,)

# kernel launches per instance, counted where segment_combine launches
# (the plain version never counts)
launches = {name: 0 for name, _ in _ENTRY.values()}

_IDENTITY = {
    ("min", torch.int32): torch.iinfo(torch.int32).max,
    ("max", torch.int32): torch.iinfo(torch.int32).min,
    ("max", torch.int8): torch.iinfo(torch.int8).min,
    ("add", torch.float32): 0.0,
    ("add", torch.float64): 0.0,
    ("add", torch.bfloat16): 0.0,
    ("add", torch.float16): 0.0,
}

_REDUCE = {"min": "amin", "max": "amax", "add": "sum"}


def supported(op: str, dtype: torch.dtype) -> bool:
    """The seven K1 instances: biased-int32 min (MinHash), int8 max (HLL),
    int32 max, float32 add (SpMM), float64 add (the float64 reference
    runs of training), and bfloat16 and float16 add, each summed in
    float32 (the bfloat16 and float16 compute dtypes)."""
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
    for min/max.  A bfloat16 or float16 add is summed in float32 and
    rounded once."""
    if v.dtype in _WIDE:
        return segment_combine_plain(v.float(), x.float(), op,
                                     ptr).to(v.dtype)
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
    cuda_build.check_tensors("segment_combine",
                             align=2 if v.dtype in _WIDE else 4,
                             x=x, v=v, ptr=ptr)
    multiple = _ENTRY[(op, v.dtype)][1]
    if v.shape[1] % multiple:
        raise ValueError(f"segment_combine: {v.dtype} rows need a width "
                         f"that is a multiple of {multiple}, got "
                         f"{v.shape[1]}")


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
    fn_name = _ENTRY[(op, v.dtype)][0]
    n, s = x.shape[0], v.shape[0]
    wide = v.dtype in _WIDE
    # a wide instance takes its width in elements and sums into float32
    # scratch rows of that width, twice as many (the heads)
    words = x.shape[1] if wide else x.shape[1] * x.element_size() // 4
    shares, carry, carry_row = cuda_build.merge_path_scratch(
        "segscan", n, s, words, x.device, heads=wide)
    out = torch.empty_like(x)
    cuda_build.launch(cuda_build.entry("segscan", fn_name, _ARGTYPES),
                      fn_name, x.device, v.data_ptr(), x.data_ptr(),
                      ptr.data_ptr(), out.data_ptr(), carry.data_ptr(),
                      carry_row.data_ptr(), n, s, words, shares)
    launches[fn_name] += 1
    return out
