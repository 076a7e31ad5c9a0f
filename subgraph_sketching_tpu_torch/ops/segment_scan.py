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
(add, float32).  The tables are built with numpy exactly as the JAX
package's numpy path builds them (``ops/segment_scan.py`` there), so every
table is equal to the JAX plan's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from subgraph_sketching_tpu_torch.device import resolve_device
from subgraph_sketching_tpu_torch.ops.segscan import identity, segment_combine

SUB_LEN = 8   # slots per sub-run (power of two), as in the JAX package

_SLOT_REDUCE = {"min": torch.amin, "max": torch.amax, "add": torch.sum}


class SortedSegmentPlan:
    """Host-precomputed static reduction schedule for one edge list.

    Host tables (numpy): ``order`` (the stable dst-sort of the edges),
    ``_gather_idx_np`` ([S*L] source row per slot, sentinel N),
    ``_slot_edge`` ([S*L] original edge per slot, sentinel E),
    ``_sub_dst_np`` ([S] destination per sub-run) and ``sub_starts``
    ([N+1], the per-node sub-run pointer K1 reads).  Device copies of the
    tables the reduce reads (``gather_idx``, ``sub_ptr``) live on
    ``device``.
    """

    def __init__(self, edge_index: np.ndarray, num_nodes: int,
                 sub_len: int = SUB_LEN, device="cuda"):
        self.device = resolve_device(device)
        self.num_segments = num_nodes
        self.sub_len = sub_len
        src = np.ascontiguousarray(edge_index[0], dtype=np.int32)
        dst = np.ascontiguousarray(edge_index[1], dtype=np.int32)
        e = len(src)
        order = np.argsort(dst, kind="stable").astype(np.int64)
        self.order = order
        src, dst = src[order], dst[order]
        # Slot index of edge i (dst-sorted): with pos = i - run_starts[dst]
        # the slot is sub_starts[dst]*L + pos
        counts = np.bincount(dst, minlength=num_nodes)
        run_starts = np.zeros(num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=run_starts[1:])
        subruns_per_node = (counts + sub_len - 1) // sub_len
        sub_starts = np.zeros(num_nodes + 1, dtype=np.int64)
        np.cumsum(subruns_per_node, out=sub_starts[1:])
        offset = sub_starts[:-1] * sub_len - run_starts[:-1]   # per node
        slot_idx = np.arange(e, dtype=np.int64) + offset[dst]  # per edge
        S = int(sub_starts[-1])
        self.num_subruns = S
        self.sub_starts = sub_starts
        # slot table: sentinel = row num_nodes (identity row)
        gather_idx = np.full(S * sub_len, num_nodes, dtype=np.int32)
        gather_idx[slot_idx] = src
        self._gather_idx_np = gather_idx
        # slot -> original edge index (sentinel e -> zero weight)
        se = np.full(S * sub_len, e, dtype=np.int64)
        se[slot_idx] = order
        self._slot_edge = se
        sub_dst = np.zeros(S, dtype=np.int32)
        sub_dst[slot_idx // sub_len] = dst
        self._sub_dst_np = sub_dst
        dev = self.device
        self.gather_idx = torch.from_numpy(gather_idx).to(dev)
        self.sub_ptr = torch.from_numpy(sub_starts).to(dev)

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
        ident = identity(op, x.dtype)
        rows = torch.cat([x, torch.full((1,) + x.shape[1:], ident,
                                        dtype=x.dtype, device=x.device)])
        v = rows.index_select(0, self.gather_idx)          # [S * L, W]
        if edge_data_slots is not None:
            v = v * edge_data_slots.to(v.dtype)[:, None]
        v = v.view(self.num_subruns, self.sub_len, *x.shape[1:])
        return _SLOT_REDUCE[op](v, dim=1)                  # [S, W]

    def merge_subruns(self, v: torch.Tensor, x: torch.Tensor,
                      op: str) -> torch.Tensor:
        """Step 3 of :meth:`reduce`: segment-op the [S, W] sub-run results
        per destination and (for min/max) fold in the node's own row."""
        return segment_combine(v.contiguous(), x.contiguous(), op,
                               self.sub_ptr)

    def reduce(self, x: torch.Tensor, op: str,
               edge_data_slots: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """min/max: out[v] = op(x[v], in-neighbour rows) — closed
        neighbourhood, matching sketch propagation (self always included).
        add: out[v] = sum over in-edges of w_e * x[src_e] (SpMM; self NOT
        included — put self-loops in the edge list).
        ``edge_data_slots`` comes from ``stage_edge_data``."""
        if self.num_subruns == 0:
            return x.clone() if op != "add" else torch.zeros_like(x)
        v = self.reduce_subruns(x, op, edge_data_slots)
        return self.merge_subruns(v, x, op)


def _estimated_slots(dst: np.ndarray, num_nodes: int, sub_len: int) -> int:
    """Slot-table rows a plan over these destinations would hold."""
    counts = np.bincount(dst, minlength=num_nodes)
    return int(((counts + sub_len - 1) // sub_len).sum()) * sub_len


def make_auto_plan(edge_index: np.ndarray, num_nodes: int,
                   max_slots: Optional[int] = None,
                   sub_len: Optional[int] = None,
                   device="cuda") -> SortedSegmentPlan:
    """One-shot plan whose slot table fits ``max_slots`` rows.  Graphs
    whose table would exceed it need the chunk-streamed plan, which is not
    ported yet: they raise."""
    ei = np.asarray(edge_index)
    sub_len = sub_len or SUB_LEN
    if max_slots and ei.shape[1]:
        slots = _estimated_slots(np.asarray(ei[1], dtype=np.int64),
                                 num_nodes, sub_len)
        if slots > max_slots:
            raise ValueError(
                f"the plan's slot table needs {slots} rows, over "
                f"max_slots={max_slots}; chunk-streamed plans are not "
                f"ported yet — raise max_gather_slots if device memory "
                f"allows the {slots}-row gather")
    return SortedSegmentPlan(ei, num_nodes, sub_len, device=device)
