"""GNN building blocks of the port: batch norm, dropout, SIGN, the SIGN
embedding diffusion and the GCN convolution.

BatchNorm: flax momentum 0.9 (the JAX package's ``BN_MOMENTUM``) is torch
momentum 0.1; eps 1e-5 in both.

Data parallelism (``parallel/mesh.py``): :func:`shard_batch_axis` gives
the BatchNorms and Dropouts that see the link batch the run's mesh.  Each
rank then holds one block of the batch, and they compute what one device
computes over the whole batch: a BatchNorm's statistics are summed over
the ranks, a Dropout draws the whole batch's mask and keeps its block.
Those over a node table, which every rank holds whole (``SIGNEmbedding``'s,
ELPH's GNN's dropout), are left as they are.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from subgraph_sketching_tpu_torch.ops.graph_ops import gcn_norm, spmm
from subgraph_sketching_tpu_torch.parallel.collectives import sum_across_ranks

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


class BatchNorm(nn.BatchNorm1d):
    """``BatchNorm1d`` with flax's running statistics.

    In training mode torch updates ``running_var`` from the unbiased batch
    variance; flax (the JAX package's ``batch_norm``) from the biased one.
    This normalises with the batch statistics as both do and updates the
    running mean and variance from the biased variance, so the running
    statistics follow the JAX package's.  Eval mode and the state_dict
    (parameter and buffer names) are ``BatchNorm1d``'s.

    With ``mask`` ([rows] bool, training mode only) the statistics are
    taken over the rows where it is set, as flax's masked BatchNorm takes
    them (SEALGIN's real nodes): the mean, and the variance as
    max(0, E[x²] − E[x]²), differentiable in both; every row is
    normalised by them.  Against a two-pass variance this costs float32
    cancellation of order eps·E[x²] where the mean is large beside the
    spread.  Eval mode ignores the mask, as flax does.

    With a ``mesh`` (:func:`shard_batch_axis`) ``x`` is this rank's block
    of the batch, and training mode takes the mean and the biased variance
    over the global batch (:meth:`_across_ranks`).  ``nn.SyncBatchNorm``
    is not used: it updates ``running_var`` from the unbiased variance.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # the data-parallel mesh whose ranks each hold a block of the
        # batch (None: the batch is whole here)
        self.mesh = None

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if mask is not None:
            if self.mesh is not None:
                raise NotImplementedError("a masked BatchNorm over a "
                                          "batch split across ranks")
            return self._masked(x, mask.reshape(-1, 1))
        if self.mesh is not None:
            return self._across_ranks(x)
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                           self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=0, correction=0)
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean, alpha=m)
            self.running_var.mul_(1 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return out

    def _masked(self, x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        count = m.sum().to(x.dtype)
        zero = x.new_zeros(())
        mean = torch.where(m, x, zero).sum(0) / count
        mean2 = torch.where(m, x * x, zero).sum(0) / count
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        out = (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias
        self._track(mean, var)
        return out

    def _across_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """Training mode over a batch whose [B/W, C] blocks lie on the W
        ranks: the mean, then the biased variance as the mean of the
        centred squares (two passes, as ``F.batch_norm``), each sum taken
        on the rank and summed over the ranks by a differentiable
        all-reduce whose backward sums the gradient over the ranks."""
        n = x.shape[0] * self.mesh.world_size
        mean = sum_across_ranks(x.sum(0)) / n
        xc = x - mean
        var = sum_across_ranks((xc * xc).sum(0)) / n
        out = xc * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        self._track(mean, var)
        return out

    @torch.no_grad()
    def _track(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """flax's running statistics, from the biased variance."""
        mo = self.momentum
        self.running_mean.mul_(1 - mo).add_(mean.detach(), alpha=mo)
        self.running_var.mul_(1 - mo).add_(var.detach(), alpha=mo)
        self.num_batches_tracked.add_(1)


def batch_norm(num_features: int) -> BatchNorm:
    return BatchNorm(num_features, momentum=BN_MOMENTUM, eps=BN_EPS)


class Dropout(nn.Module):
    """Dropout whose mask comes from the ``generator`` given to forward (a
    ``torch.Generator`` on the input's device), so a training epoch is a
    function of its seed, as the JAX package's is of its key.  Kept units
    are scaled by 1/(1-p), as in flax.

    With a ``mesh`` (:func:`shard_batch_axis`) ``x`` is this rank's block
    of the batch: the mask is drawn for the whole batch, as one device
    draws it, and the rank keeps its block, so every rank's generator
    stays in step and the masks are the single-device ones."""

    def __init__(self, p: float):
        super().__init__()
        # the data-parallel mesh whose ranks each hold a block of the
        # batch (None: the batch is whole here)
        self.mesh = None
        self.p = p

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.p == 0:
            return x
        if self.mesh is None:
            keep = torch.empty_like(x)
        else:
            keep = x.new_empty((x.shape[0] * self.mesh.world_size,
                                *x.shape[1:]))
        keep.bernoulli_(1 - self.p, generator=generator)
        if self.mesh is not None:
            keep = self.mesh.shard(keep)
        return torch.where(keep.bool(), x / (1 - self.p), torch.zeros_like(x))


def shard_batch_axis(module: nn.Module, mesh) -> None:
    """Give every BatchNorm and Dropout under ``module`` the data-parallel
    ``mesh``: ``module`` sees one rank's block of the batch (a BUDDY, an
    ELPH ``LinkPredictor``).  Never a module over a replicated node table
    (``SIGNEmbedding``, ELPH's GNN)."""
    for m in module.modules():
        if isinstance(m, (BatchNorm, Dropout)):
            m.mesh = mesh


class SIGN(nn.Module):
    """SIGN over precomputed per-hop feature blocks.

    Input [B, 2, d*(K+1)] is split into K+1 hop blocks; each gets its own
    Linear+BN+ReLU+Dropout, then blocks are concatenated and mixed
    (reference src/models/gnn.py:169-191).  BatchNorm is applied per link
    endpoint with shared parameters, like the reference's bn(h[:,0])/bn(h[:,1])
    (in training mode each call updates the running statistics, as in flax).
    Submodules ``lin_{k}``, ``bn_{k}``, ``lin_out`` mirror the flax names.
    """

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: int, K: int, dropout: float):
        super().__init__()
        self.K = K
        for k in range(K + 1):
            self.add_module(f"lin_{k}", nn.Linear(in_channels, hidden_channels))
            self.add_module(f"bn_{k}", batch_norm(hidden_channels))
        self.lin_out = nn.Linear(hidden_channels * (K + 1), out_channels)
        self.dropout = Dropout(dropout)

    def forward(self, xs: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        hs = []
        for k, x in enumerate(torch.chunk(xs, self.K + 1, dim=-1)):
            h = getattr(self, f"lin_{k}")(x)
            bn = getattr(self, f"bn_{k}")
            h = torch.stack([bn(h[:, 0, :]), bn(h[:, 1, :])], dim=1)
            hs.append(self.dropout(torch.relu(h), generator))
        return self.lin_out(torch.cat(hs, dim=-1))


class SIGNEmbedding(nn.Module):
    """SIGN over a node table diffused on the fly (the JAX package's
    ``SIGNEmbedding``; reference src/models/gnn.py:149-166, the ogbl-ddi
    embeddings): for k = 0..K, ``lin_k`` -> ``bn_k`` (over the table's
    rows) -> relu -> dropout of x_k, where x_0 is the table and
    x_{k+1} = A x_k over the unweighted gcn_norm'd graph; the K+1 blocks
    are concatenated and mixed by ``lin_out``.

    The propagation is the staged ``PlanSpmm`` when ``plan`` is given,
    else the scatter ``spmm`` over ``norm`` (gcn_norm(edge_index, None,
    N), computed here when absent).  The JAX loop also computes x_{K+1},
    which nothing reads and XLA drops; eager PyTorch would pay for it, so
    only K propagations run.
    """

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: int, K: int, dropout: float):
        super().__init__()
        self.K = K
        for k in range(K + 1):
            self.add_module(f"lin_{k}", nn.Linear(in_channels, hidden_channels))
            self.add_module(f"bn_{k}", batch_norm(hidden_channels))
        self.lin_out = nn.Linear(hidden_channels * (K + 1), out_channels)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, edge_index: Optional[torch.Tensor],
                num_nodes: int, plan=None, norm: Optional[tuple] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if plan is not None:
            prop = plan
        else:
            ei, w = norm if norm is not None else gcn_norm(edge_index, None,
                                                           num_nodes)
            prop = lambda h: spmm(ei, w, h, num_nodes)   # noqa: E731
        hs = []
        for k in range(self.K + 1):
            h = getattr(self, f"bn_{k}")(getattr(self, f"lin_{k}")(x))
            hs.append(self.dropout(torch.relu(h), generator))
            if k < self.K:
                x = prop(x)
        return self.lin_out(torch.cat(hs, dim=-1))


class GCNConv(nn.Module):
    """out = D^-1/2 (A+I) D^-1/2 X W + b, PyG ``GCNConv``'s default
    semantics (the JAX package's ``GCNConv``; reference
    src/models/elph.py:136-146).

    ``lin`` (no bias) runs first, then the propagation: the staged
    ``PlanSpmm`` when one is given (its gcn_norm weights are in its slot
    tables), else ``gcn_norm`` (or the ``norm`` passed in) and the scatter
    ``spmm``; then the separate ``bias``.  In flax ``lin`` is
    ``Dense_0``, initialised glorot-uniform, and the bias zeros.
    """

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.lin = nn.Linear(in_channels, out_channels, bias=False)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor,
                num_nodes: int, edge_weight: Optional[torch.Tensor] = None,
                norm: Optional[tuple] = None, plan=None) -> torch.Tensor:
        x = self.lin(x)
        if plan is not None:
            out = plan(x)
        else:
            ei, w = norm if norm is not None else gcn_norm(
                edge_index, edge_weight, num_nodes)
            out = spmm(ei, w, x, num_nodes)
        return out + self.bias
