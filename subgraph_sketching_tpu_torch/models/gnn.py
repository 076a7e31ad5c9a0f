"""GNN building blocks of the port: the dense layer, batch norm, dropout,
SIGN, the SIGN embedding diffusion, the GCN and SAGE convolutions and
stacks, and the Hadamard MLP scorer.

BatchNorm: flax momentum 0.9 (the JAX package's ``BN_MOMENTUM``) is torch
momentum 0.1; eps 1e-5 in both.

The compute dtype (``--dtype bfloat16``) follows flax's ``dtype`` field
module by module, not autocast: a module with a ``dtype`` (None: its
inputs' and parameters' promoted type, float32 here) computes in it while
its parameters and BatchNorm statistics stay float32.  ``Dense`` casts
its input, weight and bias to the dtype and returns it; ``BatchNorm``
takes its statistics and normalises in at least float32 and returns the
dtype; ``Dropout``, ReLU and tanh keep their input's dtype; a float32
bias added to a bfloat16 product gives float32, as in JAX (``GCNConv``'s
output).

Data parallelism (``parallel/mesh.py``): :func:`shard_batch_axis` gives
the BatchNorms and Dropouts that see the link batch the run's mesh.  Each
rank then holds one block of the batch, and they compute what one device
computes over the whole batch: a BatchNorm's statistics are summed over
the data axis's ranks, a Dropout draws the whole batch's mask and keeps
its block.
Those over a node table, which every rank holds whole (``SIGNEmbedding``'s,
ELPH's GNN's dropout), are left as they are.

ELPH's GCN on the mesh's ``graph`` axis (:class:`EdgeShardSpmm`): each
rank holds one block of the gcn_norm'd edges (the degrees are the whole
graph's) and runs the SpMM over it, then a SUM over the graph axis gives
every rank the whole product; in the backward each block contributes
its A_rᵀ g, so the gradient of the replicated input is summed over the
axis too.  JAX's GSPMD partitioned that SpMM over the sharded edge list
by itself.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from subgraph_sketching_tpu_torch.ops.graph_ops import (
    edge_orders, gcn_norm, spmm,
)
from subgraph_sketching_tpu_torch.ops.segment_scan import ordered_segment_add
from subgraph_sketching_tpu_torch.parallel.collectives import (
    replicate_into, sum_across_ranks, sum_replicated,
)

BN_MOMENTUM = 0.1
BN_EPS = 1e-5

# --dtype values -> the compute dtype (None: float32, the default path)
_COMPUTE_DTYPES = {"float32": None, "f32": None, "bfloat16": torch.bfloat16}


def compute_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """``--dtype`` as the models' compute dtype (the JAX package's
    ``_dtype_from_cfg``): None for float32, ``torch.bfloat16`` for
    bfloat16."""
    if name is None:
        return None
    if name not in _COMPUTE_DTYPES:
        raise ValueError(f"--dtype {name}: one of "
                         f"{', '.join(_COMPUTE_DTYPES)}")
    return _COMPUTE_DTYPES[name]


def at_least_float32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 if it is narrower (a bfloat16 model's logits, as
    flax's ``.astype(jnp.float32)``, and BatchNorm's statistics); a float64
    run keeps float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class Dense(nn.Linear):
    """flax's ``nn.Dense``: with ``dtype`` the input, weight and bias are
    cast to it and the product is returned in it; without, in their
    promoted type.  The parameters stay as they are (float32); the
    state_dict is ``nn.Linear``'s."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


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

    ``dtype`` (flax's compute dtype): the statistics, the normalisation
    and the cross-rank sums are taken in at least float32 from the upcast
    input, the running statistics stay float32, and the output is cast to
    ``dtype`` (None: the promoted type of the input and the parameters).
    """

    def __init__(self, *args, dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype
        # the data-parallel mesh whose ranks each hold a block of the
        # batch (None: the batch is whole here)
        self.mesh = None

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return self._normalise(at_least_float32(x), mask).to(dt)

    def _normalise(self, x: torch.Tensor,
                   mask: Optional[torch.Tensor]) -> torch.Tensor:
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
        ranks of the data axis: the mean, then the biased variance as the mean of the
        centred squares (two passes, as ``F.batch_norm``), each sum taken
        on the rank and summed over the ranks by a differentiable
        all-reduce whose backward sums the gradient over the ranks."""
        n = x.shape[0] * self.mesh.data_size
        group = self.mesh.group("data")
        mean = sum_across_ranks(x.sum(0), group) / n
        xc = x - mean
        var = sum_across_ranks((xc * xc).sum(0), group) / n
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


def batch_norm(num_features: int,
               dtype: Optional[torch.dtype] = None) -> BatchNorm:
    return BatchNorm(num_features, momentum=BN_MOMENTUM, eps=BN_EPS,
                     dtype=dtype)


class Dropout(nn.Module):
    """Dropout whose mask comes from the ``generator`` given to forward (a
    ``torch.Generator`` on the input's device), so a training epoch is a
    function of its seed, as the JAX package's is of its key.  Kept units
    are scaled by 1/(1-p), as in flax.

    With a ``mesh`` (:func:`shard_batch_axis`) ``x`` is this rank's block
    of the batch: the mask is drawn for the whole batch, as one device
    draws it, and the rank keeps its block, so every rank's generator
    stays in step and the masks are the single-device ones (the graph and
    lane peers of a rank, which hold its block, draw its mask).  The mask
    is drawn in at least float32, so a bfloat16 run draws the float32
    run's masks; the output keeps the input's dtype."""

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
        rows = x.shape[0] * (1 if self.mesh is None else self.mesh.data_size)
        keep = torch.empty((rows, *x.shape[1:]), device=x.device,
                           dtype=torch.promote_types(x.dtype, torch.float32))
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
    Submodules ``lin_{k}``, ``bn_{k}``, ``lin_out`` mirror the flax names;
    ``dtype`` is their compute dtype.
    """

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: int, K: int, dropout: float,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.K = K
        for k in range(K + 1):
            self.add_module(f"lin_{k}", Dense(in_channels, hidden_channels,
                                              dtype=dtype))
            self.add_module(f"bn_{k}", batch_norm(hidden_channels, dtype))
        self.lin_out = Dense(hidden_channels * (K + 1), out_channels,
                             dtype=dtype)
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
    only K propagations run.  ``dtype`` is the compute dtype of the dense
    layers and BatchNorms, as in JAX: the diffusion runs on the table in
    its own dtype (float32), and the output is in ``dtype``.
    """

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: int, K: int, dropout: float,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.K = K
        for k in range(K + 1):
            self.add_module(f"lin_{k}", Dense(in_channels, hidden_channels,
                                              dtype=dtype))
            self.add_module(f"bn_{k}", batch_norm(hidden_channels, dtype))
        self.lin_out = Dense(hidden_channels * (K + 1), out_channels,
                             dtype=dtype)
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
    ``Dense_0``, initialised glorot-uniform, and the bias zeros.  With
    ``dtype`` bfloat16 the product and the SpMM run in bfloat16 (K1's
    bfloat16 add), and the float32 bias makes the output float32, as in
    JAX.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.lin = Dense(in_channels, out_channels, bias=False, dtype=dtype)
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


class EdgeShardSpmm:
    """The GCN's SpMM over this rank's block of the edges, summed over the
    graph axis's ``group``: forward Σ_r A_r x on every rank, backward
    Σ_r A_rᵀ g into the replicated ``x``.  ``spmm`` is the block's own
    SpMM (a ``PlanSpmm``, each way one K1 add, or the scatter ``spmm``);
    the wrapper is what ``GCNConv`` takes as its ``plan``.  At bfloat16
    the sums over the axis stay bfloat16, as JAX's psum of the bfloat16
    product does (half the bytes on the wire; each rank's partial is
    rounded before the sum)."""

    def __init__(self, spmm, group):
        self.spmm, self.group = spmm, group

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return sum_replicated(self.spmm(replicate_into(x, self.group)),
                              self.group)


class SAGEConv(nn.Module):
    """GraphSAGE mean aggregation, ``lin(mean over in-neighbours of x) +
    lin_root(x)`` (the JAX package's ``SAGEConv``; reference
    src/models/gnn.py:90-113, PyG ``SAGEConv``).  The in-neighbour sums
    and the in-degrees go through the sorted ``spmm`` and K1's add, so
    the card computes them in a fixed order.  ``mask`` [E] bool drops the
    edges where it is False.  flax's ``Dense_0`` / ``Dense_1`` are
    ``lin`` / ``lin_root``."""

    def __init__(self, in_channels: int, out_channels: int,
                 root_weight: bool = True):
        super().__init__()
        self.lin = Dense(in_channels, out_channels)
        self.root_weight = root_weight
        if root_weight:
            self.lin_root = Dense(in_channels, out_channels, bias=False)

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor,
                num_nodes: int, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        ei = edge_index.long()
        w = (torch.ones(ei.shape[1], dtype=x.dtype, device=x.device)
             if mask is None else mask.to(x.dtype))
        orders = edge_orders(ei, num_nodes)
        perm, ptr = orders[0]
        deg = ordered_segment_add(w[perm, None], ptr, num_nodes)[:, 0]
        agg = spmm(ei, w, x, num_nodes, orders) \
            / torch.clamp(deg, min=1.0)[:, None]
        out = self.lin(agg)
        if self.root_weight:
            out = out + self.lin_root(x)
        return out


class GCN(nn.Module):
    """A plain GCN stack (the JAX package's ``GCN``; reference
    src/models/gnn.py:18-42): ``num_layers`` ``GCNConv`` over the graph's
    gcn_norm (one for the stack; ``mask`` drops edges), ReLU and dropout
    between them.  flax's ``GCNConv_<i>`` are ``convs.<i>``."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: int, num_layers: int, dropout: float):
        super().__init__()
        dims = [in_channels] + [hidden_channels] * (num_layers - 1) \
            + [out_channels]
        self.convs = nn.ModuleList(GCNConv(dims[i], dims[i + 1])
                                   for i in range(num_layers))
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor,
                num_nodes: int, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        w = None if mask is None else mask.to(torch.float32)
        norm = gcn_norm(edge_index.long(), w, num_nodes)
        for conv in self.convs[:-1]:
            x = self.dropout(torch.relu(conv(x, None, num_nodes, norm=norm)),
                             generator)
        return self.convs[-1](x, None, num_nodes, norm=norm)


class SAGE(nn.Module):
    """A GraphSAGE stack (the JAX package's ``SAGE``; reference
    src/models/gnn.py:90-113): ``num_layers`` ``SAGEConv`` (with their
    root weight when ``residual``), ReLU and dropout between them.
    flax's ``SAGEConv_<i>`` are ``convs.<i>``."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: int, num_layers: int, dropout: float,
                 residual: bool = True):
        super().__init__()
        dims = [in_channels] + [hidden_channels] * (num_layers - 1) \
            + [out_channels]
        self.convs = nn.ModuleList(
            SAGEConv(dims[i], dims[i + 1], root_weight=residual)
            for i in range(num_layers))
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor,
                num_nodes: int, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for conv in self.convs[:-1]:
            x = self.dropout(torch.relu(conv(x, edge_index, num_nodes, mask)),
                             generator)
        return self.convs[-1](x, edge_index, num_nodes, mask)


class MLPLinkPredictor(nn.Module):
    """The Hadamard-product MLP scorer (the JAX package's
    ``MLPLinkPredictor``; reference src/models/gnn.py:194-218): x_i * x_j
    through ``num_layers`` dense layers, ReLU and dropout between them,
    then a sigmoid.  flax's ``Dense_<i>`` are ``lins.<i>``."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: int, num_layers: int, dropout: float):
        super().__init__()
        dims = [in_channels] + [hidden_channels] * (num_layers - 1) \
            + [out_channels]
        self.lins = nn.ModuleList(Dense(dims[i], dims[i + 1])
                                  for i in range(num_layers))
        self.dropout = Dropout(dropout)

    def forward(self, x_i: torch.Tensor, x_j: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x_i * x_j
        for lin in self.lins[:-1]:
            x = self.dropout(torch.relu(lin(x)), generator)
        return torch.sigmoid(self.lins[-1](x))
