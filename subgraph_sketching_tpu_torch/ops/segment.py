"""Segment reductions over padded edge lists: the plain scatter route.

Counterpart of the JAX package's ops/segment.py.  Edge arrays may be
padded, with a boolean ``mask`` selecting real edges; padded lanes
contribute the reduction identity.  As in ``jax.ops.segment_*``, segment
ids outside ``[0, num_segments)`` are dropped, and a segment with no edges
holds the identity (0, the dtype max for min, the dtype min for max).

Each is one ``scatter_reduce`` into an identity-filled output, with no
host synchronisation: out-of-range ids are clamped and masked to the
identity rather than filtered.
"""

from __future__ import annotations

from typing import Optional

import torch

_REDUCE = {"sum": "sum", "min": "amin", "max": "amax"}


def identity(op: str, dtype: torch.dtype):
    """The value a segment with no edges holds."""
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _segment_reduce(op: str, data: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, mask: Optional[torch.Tensor]
                    ) -> torch.Tensor:
    ident = identity(op, data.dtype)
    ids = segment_ids.to(device=data.device, dtype=torch.int64)
    keep = (ids >= 0) & (ids < num_segments)
    if mask is not None:
        keep = keep & mask.to(device=data.device, dtype=torch.bool)
    tail = (1,) * (data.dim() - 1)
    data = torch.where(keep.view(-1, *tail), data,
                       torch.full((), ident, dtype=data.dtype,
                                  device=data.device))
    index = ids.clamp(0, max(num_segments - 1, 0)).view(-1, *tail)
    out = torch.full((num_segments,) + tuple(data.shape[1:]), ident,
                     dtype=data.dtype, device=data.device)
    if num_segments == 0:
        return out
    return out.scatter_reduce(0, index.expand_as(data), data, _REDUCE[op],
                              include_self=True)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum_{e : seg[e]=v} data[e] with padded lanes contributing 0."""
    return _segment_reduce("sum", data, segment_ids, num_segments, mask)


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """min_{e : seg[e]=v} data[e]; segments with no edges get the dtype
    max."""
    return _segment_reduce("min", data, segment_ids, num_segments, mask)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """max_{e : seg[e]=v} data[e]; segments with no edges get the dtype
    min."""
    return _segment_reduce("max", data, segment_ids, num_segments, mask)
