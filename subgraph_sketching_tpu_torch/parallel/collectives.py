"""The collectives of the data-parallel layer, and their count.

GSPMD inserted the collectives of a data-parallel step for the JAX
package; here they are written out.  Every one goes through
:func:`all_reduce`, which counts it in ``collectives``; without a process
group (world size 1, no ``initialize``) they are the identity.  The
differentiable ones:

  * :func:`sum_across_ranks`, whose backward sums the gradient over the
    ranks too (the batch statistics of a BatchNorm, which every rank's
    rows read);
  * :func:`sum_replicated`, whose backward passes the gradient as it is
    (a loss that every rank computes whole from the sum: each rank's
    gradient is then its own rows' share, and the gradient all-reduce
    adds the shares);
  * :func:`gather_replicated`, the global batch assembled in rank order
    for the AUC loss, whose backward keeps this rank's block.

Gloo reduces CUDA tensors (through host copies) but does not gather
them, so the gather is an all-reduce of zero-padded blocks: x + 0 is x,
so the result is the concatenation bit for bit (a -0.0 comes back as
+0.0).

This module imports nothing of the models, which import it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from subgraph_sketching_tpu_torch.parallel import multihost

# collectives issued by the data-parallel layer, counted where each is
# issued (``all_reduce``): calls and bytes reduced
collectives = {"calls": 0, "bytes": 0}


def reset_collectives() -> None:
    for k in collectives:
        collectives[k] = 0


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place (the identity without a
    process group)."""
    if multihost.initialized():
        dist.all_reduce(t)
        collectives["calls"] += 1
        collectives["bytes"] += t.numel() * t.element_size()
    return t


class _SumAcrossRanks(torch.autograd.Function):
    """Forward: the sum over the ranks.  Backward: the gradient summed
    over the ranks, since each rank's downstream work (its own rows)
    contributes to it."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return all_reduce(g.clone())


class _SumReplicated(torch.autograd.Function):
    """Forward: the sum over the ranks.  Backward: the gradient as it
    is: every rank computes the same function of the sum, so each
    rank's gradient already is the whole one, and what flows back is
    this rank's rows' share."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return g


class _GatherReplicated(torch.autograd.Function):
    """Forward: every rank's block of dim 0 in rank order, by an
    all-reduce of zero-padded blocks.  Backward: this rank's block of
    the gradient (every rank computes the same function of the whole)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh) -> torch.Tensor:
        ctx.mesh = mesh
        full = x.new_zeros((x.shape[0] * mesh.world_size, *x.shape[1:]))
        mesh.shard(full).copy_(x)
        return all_reduce(full)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return ctx.mesh.shard(g), None


def sum_across_ranks(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks; the backward sums over the ranks."""
    return _SumAcrossRanks.apply(x)


def sum_replicated(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, for a replicated consumer; the
    backward is the identity."""
    return _SumReplicated.apply(x)


def gather_replicated(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch from every rank's block (dim 0) of ``mesh`` (a
    ``parallel.mesh.Mesh``), for a replicated consumer; the backward
    keeps this rank's block."""
    return _GatherReplicated.apply(x, mesh)
