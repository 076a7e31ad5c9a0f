"""Padded-tree segmented min/max/sum for static graphs.

The graph is static, so the whole reduction schedule is known up front:

  1. host: split each destination's in-edge list into sub-runs of SUB_LEN
     slots, padding the tail of each sub-run with a sentinel that points at
     an identity row appended to the node table
  2. device: one gather rows[slot_idx] -> [S, SUB_LEN, W], then a reduce
     over the slot axis (plain torch ops)
  3. the merge of the S sub-run results per destination, with the node's
     own row folded in for min/max: K1, ``ops/segscan.py``

Used for minhash (min, biased int32), HLL (max, int8) and weighted SpMM
(add, in the input's dtype: float32, bfloat16 or float16 under ``--dtype``
with the float32 staged weights cast to it, as the JAX package casts
them, float64 in the reference runs).  The host tables come from the C++ builder
``csrc/plan_build.cpp`` (a stable counting sort, built by
``ops/cuda_build.py`` at first use) or from its plain numpy version; both
give the tables of the JAX package's plan (``ops/segment_scan.py``
there), bit for bit.  A plan on the card takes the C++ builder and raises
if it does not build; a plan on the CPU takes numpy.

A graph whose slot table exceeds ``max_slots`` rows streams it in chunks
(:class:`ChunkedSegmentPlan`): per chunk one gather and slot reduce, then
K1 merges the chunk's sub-runs into its contiguous window of destinations.

:class:`PlanSpmm` is the differentiable weighted SpMM of ELPH's GCN: a
plan's add reduce forward, the same reduce on the plan of the transposed
edges backward, both merged by K1, each at its input's dtype (a
16-bit forward has a 16-bit backward).  :func:`gather_rows` is a row gather
whose backward sums the gradient rows of each source row by a stable sort
and K1's add, so it is the same from run to run on the card.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from subgraph_sketching_tpu_torch.device import resolve_device
from subgraph_sketching_tpu_torch.ops import cuda_build
from subgraph_sketching_tpu_torch.ops.segscan import identity, segment_combine

SUB_LEN = 8         # slots per sub-run (power of two), as in the JAX package
CHUNK_SUB_LEN = 16  # slots per sub-run of a chunk-streamed plan, as there

_SLOT_REDUCE = {"min": torch.amin, "max": torch.amax, "add": torch.sum}

_P = ctypes.c_void_p
_I32, _I64 = ctypes.c_int32, ctypes.c_int64
# C entry point -> (argument types, result type) of csrc/plan_build.cpp
_PLAN_ENTRIES = {
    "plan_phase1": ((_P, _I64, _I32, _I32, _P, _P), _I64),
    "plan_phase2": ((_P, _P, _I64, _I32, _I32, _P, _P, _I64, _P, _P, _P),
                    ctypes.c_int),
    "plan_slot_edge": ((_P, _P, _P, _I32, _I32, _I64, _P), ctypes.c_int),
}


def _plan_fn(name: str):
    fn = getattr(cuda_build.load("plan_build"), name)
    fn.argtypes, fn.restype = _PLAN_ENTRIES[name]
    return fn


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def plan_tables_native(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                       sub_len: int) -> tuple:
    """(order, gather_idx, sub_dst, run_starts, sub_starts) by the C++
    builder: ``order`` [E] int32 (the stable dst-sort of the edges),
    ``gather_idx`` [S*L] int32 (source row per slot, sentinel
    ``num_nodes``), ``sub_dst`` [S] int32, and the [N + 1] int64 prefix
    sums of edges and sub-runs per destination.  Raises where the builder
    refuses (a destination out of range, 2^31 edges or more)."""
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    e = len(src)
    run_starts = np.empty(num_nodes + 1, dtype=np.int64)
    sub_starts = np.empty(num_nodes + 1, dtype=np.int64)
    S = _plan_fn("plan_phase1")(_ptr(dst), e, num_nodes, sub_len,
                                _ptr(run_starts), _ptr(sub_starts))
    if S < 0:
        raise ValueError(f"plan builder: refused {e} edges over {num_nodes} "
                         f"nodes (a destination out of range, or 2^31 "
                         f"edges or more)")
    order = np.empty(e, dtype=np.int32)
    gather_idx = np.empty(S * sub_len, dtype=np.int32)
    sub_dst = np.empty(S, dtype=np.int32)
    rc = _plan_fn("plan_phase2")(_ptr(src), _ptr(dst), e, num_nodes, sub_len,
                                 _ptr(run_starts), _ptr(sub_starts), S,
                                 _ptr(order), _ptr(gather_idx), _ptr(sub_dst))
    if rc != 0:
        raise RuntimeError(f"plan builder: plan_phase2 returned {rc}")
    return order, gather_idx, sub_dst, run_starts, sub_starts


def plan_tables_plain(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                      sub_len: int) -> tuple:
    """The same tables as :func:`plan_tables_native`, by numpy: a stable
    argsort by destination, then the slot of each edge is
    ``sub_starts[dst] * L + (its rank among dst's in-edges)``."""
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    e = len(src)
    order = np.argsort(dst, kind="stable").astype(np.int32)
    src, dst = src[order], dst[order]
    counts = np.bincount(dst, minlength=num_nodes)
    run_starts = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=run_starts[1:])
    sub_starts = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum((counts + sub_len - 1) // sub_len, out=sub_starts[1:])
    offset = sub_starts[:-1] * sub_len - run_starts[:-1]   # per node
    slot_idx = np.arange(e, dtype=np.int64) + offset[dst]  # per edge
    S = int(sub_starts[-1])
    gather_idx = np.full(S * sub_len, num_nodes, dtype=np.int32)
    gather_idx[slot_idx] = src
    sub_dst = np.zeros(S, dtype=np.int32)
    sub_dst[slot_idx // sub_len] = dst
    return order, gather_idx, sub_dst, run_starts, sub_starts


def slot_edge_native(order, run_starts, sub_starts, sub_len: int
                     ) -> np.ndarray:
    """[S*L] int32 original edge of each slot (sentinel E) by the C++
    builder, from the tables above."""
    n = len(run_starts) - 1
    out = np.empty(int(sub_starts[-1]) * sub_len, dtype=np.int32)
    rc = _plan_fn("plan_slot_edge")(
        _ptr(np.ascontiguousarray(order, dtype=np.int32)), _ptr(run_starts),
        _ptr(sub_starts), n, sub_len, len(order), _ptr(out))
    if rc != 0:
        raise RuntimeError(f"plan builder: plan_slot_edge returned {rc}")
    return out


def slot_edge_plain(order, run_starts, sub_starts, sub_len: int
                    ) -> np.ndarray:
    """The same table as :func:`slot_edge_native`, by numpy."""
    e = len(order)
    counts = np.diff(run_starts)
    offset = sub_starts[:-1] * sub_len - run_starts[:-1]
    slot_idx = np.arange(e, dtype=np.int64) + np.repeat(offset, counts)
    out = np.full(int(sub_starts[-1]) * sub_len, e, dtype=np.int32)
    out[slot_idx] = order
    return out


def _reduce_slots(rows: torch.Tensor, idx: torch.Tensor,
                  weights: Optional[torch.Tensor], sub_len: int,
                  op: str) -> torch.Tensor:
    """Steps 1-2 on one slot range: gather ``rows[idx]`` ([S*L, W]),
    weight it, and reduce over the slot axis -> [S, W]."""
    v = rows.index_select(0, idx)
    if weights is not None:
        v.mul_(weights.to(v.dtype)[:, None])   # in place: v is fresh
    v = v.view(-1, sub_len, *rows.shape[1:])
    return _SLOT_REDUCE[op](v, dim=1)


def with_identity_row(x: torch.Tensor, op: str) -> torch.Tensor:
    """``x`` with the op's identity row appended (the slots' sentinel)."""
    return torch.cat([x, torch.full((1,) + x.shape[1:],
                                    identity(op, x.dtype), dtype=x.dtype,
                                    device=x.device)])


class SortedSegmentPlan:
    """Host-precomputed static reduction schedule for one edge list.

    Host tables (numpy): ``order`` (the stable dst-sort of the edges),
    ``_gather_idx_np`` ([S*L] source row per slot, sentinel N),
    ``_sub_dst_np`` ([S] destination per sub-run), ``sub_starts`` ([N+1],
    the per-node sub-run pointer K1 reads) and ``_slot_edge`` ([S*L]
    original edge per slot, sentinel E; built at first use, since only the
    SpMM's staging reads it).  The tables come from the C++ builder on
    the card (``native``) and from numpy on the CPU.  Device copies of the
    tables the reduce reads (``gather_idx``, ``sub_ptr``) are made on
    ``device`` at first use.

    ``num_sources``: the edges' sources index another table than the
    destinations, of that many rows (the halo buffer of a node-sharded
    hop, ``parallel/node_sharded.py``); the slots' sentinel is then
    ``num_sources``, and ``reduce`` gathers from ``sources``.
    """

    def __init__(self, edge_index: np.ndarray, num_nodes: int,
                 sub_len: int = SUB_LEN, device="cuda",
                 num_sources: Optional[int] = None):
        self.device = resolve_device(device)
        self.num_segments = num_nodes
        self.sub_len = sub_len
        self.native = self.device.type == "cuda"
        build = plan_tables_native if self.native else plan_tables_plain
        (self.order, self._gather_idx_np, self._sub_dst_np,
         self._run_starts, self.sub_starts) = build(
            edge_index[0], edge_index[1], num_nodes, sub_len)
        self.num_subruns = len(self._sub_dst_np)
        self._slot_edge_np: Optional[np.ndarray] = None
        self._gather_idx: Optional[torch.Tensor] = None
        self._sub_ptr: Optional[torch.Tensor] = None
        if num_sources is not None:
            # the slots re-pointed at the source table, sentinel
            # num_sources (the builder's sentinel is num_nodes)
            src = np.asarray(edge_index[0], dtype=np.int32)
            self._gather_idx_np = np.concatenate(
                [src, np.array([num_sources], np.int32)])[self._slot_edge]

    @property
    def gather_idx(self) -> torch.Tensor:
        if self._gather_idx is None:
            self._gather_idx = torch.from_numpy(self._gather_idx_np).to(
                self.device)
        return self._gather_idx

    @property
    def sub_ptr(self) -> torch.Tensor:
        if self._sub_ptr is None:
            self._sub_ptr = torch.from_numpy(self.sub_starts).to(self.device)
        return self._sub_ptr

    @property
    def _slot_edge(self) -> np.ndarray:
        if self._slot_edge_np is None:
            build = slot_edge_native if self.native else slot_edge_plain
            self._slot_edge_np = build(self.order, self._run_starts,
                                       self.sub_starts, self.sub_len)
        return self._slot_edge_np

    def stage_edge_data(self, edge_data) -> torch.Tensor:
        """Permute per-edge data (original edge order) into slot order on
        the host.  Do this ONCE per weight set and pass the result to
        reduce."""
        if isinstance(edge_data, torch.Tensor):
            edge_data = edge_data.cpu().numpy()
        edge_data = np.asarray(edge_data)
        wz = np.concatenate([edge_data, np.zeros(1, dtype=edge_data.dtype)])
        return torch.from_numpy(wz[self._slot_edge]).to(self.device)

    def reduce_subruns(self, x: torch.Tensor, op: str,
                       edge_data_slots: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """Steps 1-2 of :meth:`reduce`: the slot gather and the reduce over
        the slot axis -> [S, W] sub-run results."""
        return _reduce_slots(with_identity_row(x, op), self.gather_idx,
                             edge_data_slots, self.sub_len, op)

    def merge_subruns(self, v: torch.Tensor, x: torch.Tensor,
                      op: str) -> torch.Tensor:
        """Step 3 of :meth:`reduce`: segment-op the [S, W] sub-run results
        per destination and (for min/max) fold in the node's own row."""
        return segment_combine(v.contiguous(), x.contiguous(), op,
                               self.sub_ptr)

    def reduce(self, x: torch.Tensor, op: str,
               edge_data_slots: Optional[torch.Tensor] = None,
               sources: Optional[torch.Tensor] = None) -> torch.Tensor:
        """min/max: out[v] = op(x[v], in-neighbour rows) — closed
        neighbourhood, matching sketch propagation (self always included).
        add: out[v] = sum over in-edges of w_e * x[src_e] (SpMM; self NOT
        included — put self-loops in the edge list).
        ``edge_data_slots`` comes from ``stage_edge_data``.  ``sources``:
        the table the in-neighbour rows come from, where it is not ``x``
        (a plan built with ``num_sources``); ``x`` is then only folded
        in."""
        if self.num_subruns == 0:
            return x.clone() if op != "add" else torch.zeros_like(x)
        table = x if sources is None else sources
        v = _reduce_slots(with_identity_row(table, op), self.gather_idx,
                          edge_data_slots, self.sub_len, op)
        return self.merge_subruns(v, x, op)

    def chunk(self, max_slots: int) -> "ChunkedSegmentPlan":
        """This plan streamed in chunks of at most ``max_slots`` slots (see
        :class:`ChunkedSegmentPlan`)."""
        return ChunkedSegmentPlan(self, max_slots)


class ChunkedSegmentPlan:
    """Bounded-memory execution of a SortedSegmentPlan (the JAX package's
    ``ChunkedSegmentPlan``).

    ``SortedSegmentPlan.reduce`` gathers the whole [S*L, W] slot table at
    once.  This plan cuts the sub-runs into the fewest chunks of at most
    ``max_slots`` slots, with the sub-runs spread evenly over them, and
    walks the chunks in a Python loop: per chunk one gather and slot
    reduce, then K1 merges the chunk's sub-runs into the chunk's
    contiguous window of destinations ``[lo, hi)`` (the slot table is
    dst-sorted) through a window pointer built on the host.  For min/max
    the window of the output is K1's ``x``, so one launch folds the chunk
    into it: a destination whose sub-runs straddle chunks stays exact,
    since min and max are idempotent, and the output starts as ``x``
    (the closed neighbourhood).  For add the window gets
    ``cur + K1(v, ..., "add", ptr)`` from an output that starts at zero.

    The transient is the chunk's gather, at most ``max_slots`` x W; the
    chunk pointers go to the device once, at the first reduce.
    """

    def __init__(self, base: SortedSegmentPlan, max_slots: int):
        self.base = base
        self.device = base.device
        self.num_segments = base.num_segments
        self.sub_len = L = base.sub_len
        S = base.num_subruns
        cap = max(1, max_slots // L)                # sub-runs per chunk, most
        C = -(-S // cap)
        self.num_chunks = C
        self.per_chunk = -(-S // C) if C else 0     # spread evenly
        sd, starts = base._sub_dst_np, base.sub_starts
        # (s0, s1, lo, hi): the chunk's sub-runs and destination window
        self.bounds = []
        self._ptr_np = []
        for c in range(C):
            s0, s1 = c * self.per_chunk, min((c + 1) * self.per_chunk, S)
            lo, hi = int(sd[s0]), int(sd[s1 - 1]) + 1
            self.bounds.append((s0, s1, lo, hi))
            self._ptr_np.append(np.clip(starts[lo:hi + 1], s0, s1) - s0)
        self.window = max((hi - lo for _, _, lo, hi in self.bounds),
                          default=0)
        self._ptr: Optional[list] = None

    @property
    def ptrs(self) -> list:
        """Each chunk's [hi - lo + 1] int64 window pointer, on the
        device."""
        if self._ptr is None:
            self._ptr = [torch.from_numpy(p).to(self.device)
                         for p in self._ptr_np]
        return self._ptr

    def stage_edge_data(self, edge_data) -> torch.Tensor:
        """Per-edge data in slot order (the base plan's staging); each
        chunk reads its slice."""
        return self.base.stage_edge_data(edge_data)

    def chunk_subruns(self, rows: torch.Tensor, c: int, op: str,
                      edge_data_slots: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """The [s1 - s0, W] sub-run results of chunk ``c``: its slot
        gather and slot reduce over ``rows`` (``with_identity_row(x)``)."""
        s0, s1, _, _ = self.bounds[c]
        L = self.sub_len
        w = (None if edge_data_slots is None
             else edge_data_slots[s0 * L:s1 * L])
        return _reduce_slots(rows, self.base.gather_idx[s0 * L:s1 * L], w,
                             L, op)

    def reduce(self, x: torch.Tensor, op: str,
               edge_data_slots: Optional[torch.Tensor] = None,
               merge: Callable = segment_combine,
               sources: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Same contract as SortedSegmentPlan.reduce.  ``merge`` is the
        per-chunk merge, K1 (``segment_combine``) unless a check asks for
        its plain version."""
        out = x.clone() if op != "add" else torch.zeros_like(x)
        rows = with_identity_row(x if sources is None else sources, op)
        for c, ((_, _, lo, hi), ptr) in enumerate(zip(self.bounds,
                                                      self.ptrs)):
            v = self.chunk_subruns(rows, c, op, edge_data_slots)
            cur = out[lo:hi]
            if op == "add":
                cur += merge(v, cur, op, ptr)
            else:
                cur.copy_(merge(v, cur, op, ptr))
        return out


def _estimated_slots(dst: np.ndarray, num_nodes: int, sub_len: int) -> int:
    """Slot-table rows a plan over these destinations would hold."""
    counts = np.bincount(dst, minlength=num_nodes)
    return int(((counts + sub_len - 1) // sub_len).sum()) * sub_len


def make_auto_plan(edge_index: np.ndarray, num_nodes: int,
                   max_slots: Optional[int] = None,
                   sub_len: Optional[int] = None,
                   device="cuda", num_sources: Optional[int] = None):
    """Plan with bounded device memory, chosen as the JAX package chooses
    it: one-shot when the slot table fits ``max_slots`` rows,
    chunk-streamed (:class:`ChunkedSegmentPlan`) otherwise.  With
    ``sub_len=None`` the sub-run length is SUB_LEN for a one-shot plan and
    CHUNK_SUB_LEN for one that will chunk, decided from a degree
    histogram.  ``num_sources``: as ``SortedSegmentPlan`` takes it."""
    ei = np.asarray(edge_index)
    if sub_len is None:
        sub_len = SUB_LEN
        if max_slots and ei.shape[1] and \
                _estimated_slots(np.asarray(ei[1], dtype=np.int64),
                                 num_nodes, SUB_LEN) > max_slots:
            sub_len = CHUNK_SUB_LEN
    plan = SortedSegmentPlan(ei, num_nodes, sub_len, device=device,
                             num_sources=num_sources)
    if max_slots and plan.num_subruns * plan.sub_len > max_slots:
        return plan.chunk(max_slots)
    return plan


# ------------------------------------------------- differentiable SpMM --

class PlanSpmm:
    """Differentiable weighted SpMM over a static plan pair (the JAX
    package's ``PlanSpmm``).

    Forward: ``out[v] = sum over edges (u, v) of w_e x[u]``, the add reduce
    of the plan of ``edge_index``; backward: ``dL/dx = A^T g``, the add
    reduce of a second plan built on the transposed edges.  The edge
    weights (gcn_norm's, staged in slot order once) are data and get no
    gradient.  On the card both directions end in K1.  The forward keeps
    no [S*L, W] gather for the backward: only the plans are held.

    Construct through :meth:`try_build`, which returns None where either
    direction's one-shot slot table would exceed ``max_slots`` (the caller
    then takes the scatter ``spmm``, as the JAX package does).
    """

    def __init__(self, edge_index: np.ndarray, edge_weight: np.ndarray,
                 num_nodes: int, sub_len: int = SUB_LEN, device="cuda"):
        ei = np.asarray(edge_index)
        w = np.asarray(edge_weight, dtype=np.float32)
        self.num_nodes = num_nodes
        self.fwd = SortedSegmentPlan(ei, num_nodes, sub_len, device=device)
        self.bwd = SortedSegmentPlan(ei[::-1], num_nodes, sub_len,
                                     device=device)
        self.device = self.fwd.device
        self._w_fwd = self.fwd.stage_edge_data(w)
        self._w_bwd = self.bwd.stage_edge_data(w)

    @classmethod
    def try_build(cls, edge_index: np.ndarray, edge_weight: np.ndarray,
                  num_nodes: int, max_slots: Optional[int] = None,
                  sub_len: int = SUB_LEN, device="cuda"
                  ) -> Optional["PlanSpmm"]:
        """Build, or return None when either direction's slot table
        exceeds ``max_slots`` rows; the slot counts come from the two
        degree histograms, as in the JAX package."""
        if max_slots:
            ei = np.asarray(edge_index)
            for deg_axis in (ei[1], ei[0]):       # fwd dst, bwd dst (= src)
                if _estimated_slots(np.asarray(deg_axis, dtype=np.int64),
                                    num_nodes, sub_len) > max_slots:
                    return None
        return cls(edge_index, edge_weight, num_nodes, sub_len, device)

    @property
    def tables(self) -> tuple:
        """The staged device tables of both directions: (gather_idx_f,
        sub_ptr_f, w_f, gather_idx_b, sub_ptr_b, w_b)."""
        return (self.fwd.gather_idx, self.fwd.sub_ptr, self._w_fwd,
                self.bwd.gather_idx, self.bwd.sub_ptr, self._w_bwd)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 2 or x.shape[0] != self.num_nodes:
            raise ValueError(f"PlanSpmm: x must be [{self.num_nodes}, W], "
                             f"got {tuple(x.shape)}")
        return _PlanSpmmFn.apply(x, self)


class _PlanSpmmFn(torch.autograd.Function):
    """``PlanSpmm``'s forward and backward: one add reduce each way."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, ps: PlanSpmm) -> torch.Tensor:
        ctx.ps = ps
        return ps.fwd.reduce(x, "add", edge_data_slots=ps._w_fwd)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        ps = ctx.ps
        # the gradient of a row gather downstream may arrive strided
        return ps.bwd.reduce(g.contiguous(), "add",
                             edge_data_slots=ps._w_bwd), None


def segment_order(seg: torch.Tensor, n: int) -> tuple:
    """(perm, ptr): a stable sort of the [E] segment ids ``seg`` (values in
    [0, n)) and the [n + 1] int64 pointer of its runs, so that
    ``rows[perm]`` lists each segment's rows in their original order and
    K1's add sums them in that order: the same sums from run to run,
    where a scatter adds with atomics on the card.  The pointer is a
    search of the sorted ids (``bincount`` would read their maximum back
    to the host, a sync in every call on the card), so an id outside [0,
    n) would drop its row silently: the bounds are asserted on the
    device instead, without a sync."""
    s, perm = torch.sort(seg, stable=True)
    if s.numel():
        torch._assert_async((s[0] >= 0) & (s[-1] < n))
    ptr = torch.searchsorted(s, torch.arange(n + 1, dtype=s.dtype,
                                             device=s.device))
    return perm, ptr


def ordered_segment_add(v: torch.Tensor, ptr: torch.Tensor,
                        n: int) -> torch.Tensor:
    """[n, W]: the sum of each segment's rows of ``v`` ([E, W], grouped by
    ``segment_order``), by K1's add.  K1's float64 add reads 16-byte
    units, so an odd float64 width (DGCNN's one channel in a float64
    run) is summed with one zero column added."""
    if v.shape[0] == 0:
        return v.new_zeros((n, v.shape[1]))
    if v.dtype == torch.float64 and v.shape[1] % 2:
        return ordered_segment_add(F.pad(v, (0, 1)), ptr, n)[:, :-1]
    # K1's add reads x for its shape only
    return segment_combine(v.contiguous(), v.new_empty((n, v.shape[1])),
                           "add", ptr)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` ([*idx.shape, W]) whose gradient in ``table`` is the
    same from run to run: the backward sorts the indices (stably) and sums
    each row's gradient rows in that order by K1's add, where indexing's
    own backward adds them with atomics on the card."""
    return _RowGather.apply(table, idx)


class _RowGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        flat = idx.reshape(-1)
        ctx.save_for_backward(flat)
        ctx.num_rows = table.shape[0]
        return table.index_select(0, flat).view(*idx.shape, table.shape[1])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (flat,) = ctx.saved_tensors
        perm, ptr = segment_order(flat, ctx.num_rows)
        v = g.reshape(-1, g.shape[-1]).index_select(0, perm)
        return ordered_segment_add(v, ptr, ctx.num_rows), None
