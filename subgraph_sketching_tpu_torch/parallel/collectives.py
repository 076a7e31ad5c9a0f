"""The collectives of the multi-process layer, and their count.

GSPMD inserted the collectives of a sharded step for the JAX package;
here they are written out.  Every one names its process group: the
mesh's group of one axis (``parallel/mesh.py`` ``Mesh.group``).  A sum
over the batch runs over the data axis's group, since the graph and lane
peers of a rank hold the same block of the batch; a sum over an edge
shard or a node shard runs over the graph axis's; a sum over a sketch
width's slices over the lane axis's.  Each is counted in
``collectives``; with the group None (no process group) it is the
identity.  The differentiable ones:

  * :func:`sum_across_ranks`, whose backward sums the gradient over the
    group too (the batch statistics of a BatchNorm, which every rank's
    rows read);
  * :func:`sum_replicated`, whose backward passes the gradient as it is
    (a loss that every rank computes whole from the sum: each rank's
    gradient is then its own rows' share, and the gradient all-reduce
    adds the shares; ELPH's GCN over an edge shard, whose sum every
    graph peer consumes whole);
  * :func:`replicate_into`, the identity whose backward sums over the
    group (the input of an edge shard's SpMM: each shard contributes
    its A_rᵀ g to the gradient);
  * :func:`gather_replicated`, the global batch assembled in rank order
    for the AUC loss, whose backward keeps this rank's block.

Gloo reduces CUDA tensors (through host copies) but neither gathers nor
exchanges them, so the gather is an all-reduce of zero-padded blocks:
x + 0 is x, so the result is the concatenation bit for bit (a -0.0 comes
back as +0.0).  For the same reason :func:`halo_exchange` (the sketch
hop's exchange of boundary rows, ``parallel/node_sharded.py``) takes one
of two routes, picked by :func:`halo_route` from the group's backend and
the tensor's device: ``all_to_all_single`` where the backend exchanges
such tensors (NCCL; gloo on the CPU), else one MIN or MAX ``all_reduce``
of a [D, D, H, w] buffer that holds the rank's [D, H, w] send rows in
its own slot and the op's identity elsewhere, of which each rank keeps
its column: min and max are idempotent and the identity changes nothing,
so both routes give the same bits.

This module imports nothing of the models, which import it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from subgraph_sketching_tpu_torch.parallel import multihost

# collectives issued by the multi-process layer, counted where each is
# issued: calls and bytes (all_reduce and all_to_all alike)
collectives = {"calls": 0, "bytes": 0}

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def reset_collectives() -> None:
    for k in collectives:
        collectives[k] = 0


def _count(t: torch.Tensor) -> None:
    collectives["calls"] += 1
    collectives["bytes"] += t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, op: str = "sum", group=None,
               async_op: bool = False):
    """``t`` reduced over ``group`` by ``op`` (sum, min or max), in place
    (the identity with ``group`` None or without a process group).
    Returns ``t``, or with ``async_op`` the work handle (None where
    nothing was issued)."""
    if group is None or not multihost.initialized():
        return None if async_op else t
    work = dist.all_reduce(t, op=_OPS[op], group=group, async_op=async_op)
    _count(t)
    return work if async_op else t


class _SumAcrossRanks(torch.autograd.Function):
    """Forward: the sum over the group.  Backward: the gradient summed
    over the group, since each rank's downstream work (its own rows)
    contributes to it."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return all_reduce(x.clone(), group=group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return all_reduce(g.clone(), group=ctx.group), None


class _SumReplicated(torch.autograd.Function):
    """Forward: the sum over the group.  Backward: the gradient as it
    is: every rank computes the same function of the sum, so each
    rank's gradient already is the whole one, and what flows back is
    this rank's rows' share."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        return all_reduce(x.clone(), group=group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


class _ReplicateInto(torch.autograd.Function):
    """Forward: the identity.  Backward: the gradient summed over the
    group (each rank's consumer saw a part of the whole)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return all_reduce(g.contiguous().clone(), group=ctx.group), None


class _GatherReplicated(torch.autograd.Function):
    """Forward: every data rank's block of dim 0 in rank order, by an
    all-reduce of zero-padded blocks over the data axis.  Backward: this
    rank's block of the gradient (every rank computes the same function
    of the whole)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh) -> torch.Tensor:
        ctx.mesh = mesh
        full = x.new_zeros((x.shape[0] * mesh.data_size, *x.shape[1:]))
        mesh.shard(full).copy_(x)
        return all_reduce(full, group=mesh.group("data"))

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return ctx.mesh.shard(g), None


def sum_across_ranks(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over ``group``; the backward sums over it too."""
    return _SumAcrossRanks.apply(x, group)


def sum_replicated(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over ``group``, for a replicated consumer; the
    backward is the identity."""
    return _SumReplicated.apply(x, group)


def replicate_into(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` as it is, for consumers that each see a part of the whole;
    the backward sums the gradient over ``group``."""
    return _ReplicateInto.apply(x, group)


def gather_replicated(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch from every data rank's block (dim 0) of ``mesh``
    (a ``parallel.mesh.Mesh``), for a replicated consumer; the backward
    keeps this rank's block."""
    return _GatherReplicated.apply(x, mesh)


# ------------------------------------------------------- halo exchange --

def halo_route(group, device) -> str:
    """The route of :func:`halo_exchange` over ``group`` for tensors on
    ``device``, the one place it is chosen: ``all_to_all_single`` where
    the group's backend exchanges such tensors (NCCL; gloo on the CPU),
    ``all_reduce`` where it does not (gloo with CUDA tensors), and
    ``local`` without a group (no process group)."""
    if group is None or not multihost.initialized():
        return "local"
    if dist.get_backend(group) == "gloo" and \
            torch.device(device).type == "cuda":
        return "all_reduce"
    return "all_to_all_single"


def _identity(op: str, dtype: torch.dtype):
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


class HaloExchange:
    """A halo exchange in flight: ``wait()`` returns the [D, H, w] rows
    received, slot s from the rank at index s of the group."""

    def __init__(self, recv: torch.Tensor, work=None, full=None,
                 index: int = 0):
        self._recv, self._work = recv, work
        self._full, self._index = full, index

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._full is not None:
            # slot s of the reduced [D, D, H, w] buffer: what rank s sent
            # to this one
            self._recv = self._full[:, self._index].contiguous()
            self._full = None
        return self._recv


def halo_exchange(send: torch.Tensor, group, op: str) -> HaloExchange:
    """Exchange the [D, H, w] boundary rows ``send`` (slot d: the rows for
    the rank at index d of ``group``) over ``group``: the result's slot s
    holds what the rank at index s sent to this one.  ``op`` (min or max)
    is the merge the rows are for; the all-reduce route pads with its
    identity.  Issued asynchronously: the caller overlaps work with it
    and calls ``wait()`` on the result.  The route is
    :func:`halo_route`'s."""
    route = halo_route(group, send.device)
    send = send.contiguous()
    if route == "local":
        return HaloExchange(send)
    d = send.shape[0]
    if route == "all_to_all_single":
        recv = torch.empty_like(send)
        work = dist.all_to_all_single(recv, send, group=group,
                                      async_op=True)
        _count(send)
        return HaloExchange(recv, work)
    index = dist.get_group_rank(group, dist.get_rank())
    full = torch.full((d, *send.shape), _identity(op, send.dtype),
                      dtype=send.dtype, device=send.device)
    full[index] = send
    work = all_reduce(full, op=op, group=group, async_op=True)
    return HaloExchange(None, work, full, index)
