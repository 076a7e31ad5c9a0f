"""SEAL baseline models over dense padded subgraph batches (the JAX
package's models/seal.py; reference src/models/seal.py: SEALDGCNN,
SEALGCN, SEALSAGE, SEALGIN, SEALMLP).

A batch is the dense [B, N, ...] stack of ``graph.seal`` (nodes 0 and 1
of every subgraph are the link's endpoints), with its edges as one
:class:`UnionGraph`: the B subgraphs as one disjoint graph of B·N nodes
(local ids offset by b·N), the padded edges dropped on the host.  Every
per-subgraph sum (GCN propagation, SAGE mean, GIN sum) is then one
``ops/graph_ops.py`` ``spmm`` over the union, whose forward and backward
sum each node's edges in a fixed order by K1's add; the label, node
embedding and frozen-table lookups go through ``gather_rows`` (K1 in
the backward), and DGCNN's 1-D convolution is a matmul over stacked
windows.  So a training step is the same from run to run on the card.

Module names follow the flax ones (``conv_dense_0``, ``z_embedding``,
``gin_bn_1``, ...), so ``models/convert.py`` ``seal_state_dict_from_flax``
carries JAX weights over by name.

``dtype`` is each model's compute dtype (the JAX models' ``dtype``
field): the dense layers, DGCNN's convolution and GIN's BatchNorms run in
it, the label and node-embedding tables are cast to it before the lookup
(flax's ``nn.Embed(dtype=...)``, so their gradients are summed in it by
K1's add), the union SpMMs run in their input's dtype, and the logits
come back float32.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from subgraph_sketching_tpu_torch.models.gnn import (
    Dense, Dropout, at_least_float32, batch_norm,
)
from subgraph_sketching_tpu_torch.ops.graph_ops import (
    add_self_loops, edge_orders, spmm,
)
from subgraph_sketching_tpu_torch.ops.segment_scan import (
    gather_rows, ordered_segment_add,
)


def upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``; to the card through pinned memory
    without blocking, so the host extracts the next batch while the card
    runs this one's step."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class UnionGraph:
    """The edges of a batch of B padded subgraphs of N nodes as one
    disjoint graph of B·N nodes on the device: ``edge_index`` [2, E]
    (global ids b·N + local id), ``edge_weight`` [E], in the batch's
    order (subgraph by subgraph, edges in extraction order).  The
    normalised forms each model reads are built once per batch."""

    def __init__(self, edge_index: torch.Tensor, edge_weight: torch.Tensor,
                 num_nodes: int):
        self.edge_index = edge_index
        self.edge_weight = edge_weight
        self.num_nodes = num_nodes
        self._cache: Dict[str, tuple] = {}

    @classmethod
    def from_padded(cls, edge_index: np.ndarray, edge_weight: np.ndarray,
                    edge_mask: np.ndarray, nodes_per_graph: int,
                    device) -> "UnionGraph":
        """From the padded [B, E, 2] local edges, [B, E] weights and [B, E]
        mask of a ``SealBatchArrays``: the masked edges dropped on the
        host, the rest offset by their subgraph and uploaded."""
        b, e = np.nonzero(np.asarray(edge_mask))
        off = b.astype(np.int64) * nodes_per_graph
        ei = np.stack([edge_index[b, e, 0] + off, edge_index[b, e, 1] + off])
        w = np.asarray(edge_weight, dtype=np.float32)[b, e]
        return cls(upload(ei, device), upload(w, device),
                   len(edge_mask) * nodes_per_graph)

    def gcn(self) -> tuple:
        """(edge_index, weight, orders) of D^-1/2 (A + I) D^-1/2 over the
        union: PyG ``gcn_norm``, as the JAX package applies it per
        subgraph (self-loops of weight 1 on every node, padded ones too;
        degrees are in-degrees), with the degrees summed in a fixed order
        by K1's add at W = 1; ``orders`` are the edges' ``spmm`` sorts,
        made once for every layer each way."""
        if "gcn" not in self._cache:
            n = self.num_nodes
            ei, w = add_self_loops(self.edge_index, self.edge_weight, n)
            orders = edge_orders(ei, n)
            perm, ptr = orders[0]
            deg = ordered_segment_add(w[perm, None], ptr, n)[:, 0]
            dinv = torch.where(deg > 0, 1.0 / torch.sqrt(
                torch.where(deg > 0, deg, torch.ones_like(deg))),
                torch.zeros_like(deg))
            self._cache["gcn"] = (ei, dinv[ei[0]] * w * dinv[ei[1]], orders)
        return self._cache["gcn"]

    def ones(self) -> tuple:
        """(edge_index, 1 per edge, in-degree [B·N] as float, orders): the
        unweighted sums of SAGE and GIN."""
        if "ones" not in self._cache:
            ei = self.edge_index
            orders = edge_orders(ei, self.num_nodes)
            # the target runs' lengths: integer counts, exact
            deg = orders[0][1].diff().to(torch.float32)
            self._cache["ones"] = (ei, torch.ones_like(self.edge_weight),
                                   deg, orders)
        return self._cache["ones"]


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


def gcn_prop(x: torch.Tensor, graph: UnionGraph,
             node_mask: torch.Tensor) -> torch.Tensor:
    """Per-subgraph normalised propagation of [B, N, d] ``x``."""
    ei, w, orders = graph.gcn()
    out = spmm(ei, w, _flat(x), graph.num_nodes, orders).view(x.shape)
    return out * node_mask[..., None]


def mean_agg(x: torch.Tensor, graph: UnionGraph,
             node_mask: torch.Tensor) -> torch.Tensor:
    """Per-subgraph mean over in-neighbours (SAGE)."""
    ei, ones, deg, orders = graph.ones()
    agg = spmm(ei, ones, _flat(x), graph.num_nodes, orders)
    agg = agg / torch.clamp(deg, min=1.0)[:, None]
    return agg.view(x.shape) * node_mask[..., None]


def sum_agg(x: torch.Tensor, graph: UnionGraph,
            node_mask: torch.Tensor) -> torch.Tensor:
    """Per-subgraph sum over in-neighbours (GIN)."""
    ei, ones, _, orders = graph.ones()
    out = spmm(ei, ones, _flat(x), graph.num_nodes, orders).view(x.shape)
    return out * node_mask[..., None]


def global_sort_pool(x: torch.Tensor, node_mask: torch.Tensor,
                     k: int) -> torch.Tensor:
    """[B, k, D]: each subgraph's nodes sorted by the last channel,
    descending, the first k kept (PyG global_sort_pool, used at reference
    seal.py:245).  The sort is stable, as ``jnp.argsort`` is, so tied
    keys (the rule with label-only inputs) keep node order; padding sorts
    last (key -inf), subgraphs of fewer than k nodes are zero-padded, and
    picks of padding are zeroed."""
    if x.shape[1] < k:
        pad = k - x.shape[1]
        x = F.pad(x, (0, 0, 0, pad))
        node_mask = F.pad(node_mask, (0, pad))
    key = torch.where(node_mask, x[..., -1],
                      torch.full_like(x[..., -1], float("-inf")))
    idx = torch.sort(-key, dim=1, stable=True).indices[:, :k]
    took = torch.take_along_dim(x, idx[..., None], dim=1)
    valid = torch.take_along_dim(node_mask, idx, dim=1)
    return torch.where(valid[..., None], took, torch.zeros_like(took))


def global_add_pool(x: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * node_mask[..., None], dim=1)


def global_mean_pool(x: torch.Tensor,
                     node_mask: torch.Tensor) -> torch.Tensor:
    s = global_add_pool(x, node_mask)
    return s / torch.clamp(node_mask.sum(dim=1), min=1)[:, None].to(s.dtype)


def _center_pool(x: torch.Tensor) -> torch.Tensor:
    """Nodes 0 and 1 of every subgraph are src and dst (reference
    seal.py:88-95)."""
    return x[:, 0, :] * x[:, 1, :]


class SEALMLP(nn.Module):
    """One-hot z, pooled, through a 2-layer MLP (reference seal.py:22-40;
    flax's ``Dense_0`` / ``Dense_1`` are ``lin1`` / ``lin2``)."""

    def __init__(self, emb_dim: int, dropout: float = 0.5,
                 pooling: str = "add", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.emb_dim = emb_dim
        self.pooling = pooling
        self.lin1 = Dense(emb_dim, emb_dim, dtype=dtype)
        self.lin2 = Dense(emb_dim, 1, dtype=dtype)
        self.drop = Dropout(dropout)

    def forward(self, batch: dict,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        mask = batch["node_mask"]
        # clamped as the embedding inputs of the other models are: an
        # out-of-range DRNL label would one-hot to an all-zero row
        z = torch.clamp(batch["z"], max=self.emb_dim - 1)
        x = F.one_hot(z, self.emb_dim).to(torch.float32) * mask[..., None]
        x = (global_add_pool(x, mask) if self.pooling == "add"
             else global_mean_pool(x, mask))
        x = self.drop(F.relu(self.lin1(x)), generator)
        return at_least_float32(self.lin2(x))


class _SealBase(nn.Module):
    """The input embedding of the four GNN models (JAX ``_SealBase``): the
    z label's embedding (two summed for DE's [B, N, 2] labels), with
    ``use_feature`` the node features, and a trainable node embedding
    (``use_node_embedding``) or a frozen pretrained table's rows
    (``batch["node_emb"]``) concatenated."""

    def __init__(self, hidden_channels: int, num_layers: int, max_z: int,
                 use_feature: bool = False, num_features: int = 0,
                 dropout: float = 0.5, use_node_embedding: bool = False,
                 num_nodes: int = 0, node_emb_dim: int = 0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.hidden_channels = hidden_channels
        self.num_layers = num_layers
        self.max_z = max_z
        self.use_feature = use_feature
        self.use_node_embedding = use_node_embedding
        self.z_embedding = nn.Embedding(max_z, hidden_channels)
        if use_node_embedding:
            self.node_embedding = nn.Embedding(num_nodes, hidden_channels)
            node_emb_dim = hidden_channels
        self.in_channels = (hidden_channels
                            + (num_features if use_feature else 0)
                            + node_emb_dim)
        self.dropout = dropout

    def _dense(self, d_in: int, d_out: int, bias: bool = True) -> Dense:
        return Dense(d_in, d_out, bias=bias, dtype=self.dtype)

    def _lookup(self, table: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
        """``table``'s rows ``ids``: the table cast to the compute dtype
        first, then gathered (flax ``nn.Embed``)."""
        w = table.weight if self.dtype is None else table.weight.to(self.dtype)
        return gather_rows(w, ids)

    def embed_inputs(self, batch: dict) -> torch.Tensor:
        # clamp labels into the table: disconnected pairs give DRNL labels
        # >> max_z when max_dist is large (reference run.py:192 hides it
        # with --max_dist 4)
        z = torch.clamp(batch["z"], max=self.max_z - 1)
        x = self._lookup(self.z_embedding, z)
        if x.dim() == 4:   # DE / DE+: sum the two labels' embeddings
            x = x.sum(dim=2)
        if self.use_feature and batch.get("x") is not None:
            x = torch.cat([x, batch["x"]], dim=-1)
        if self.use_node_embedding:
            ids = torch.clamp(batch["node_ids"], min=0)   # -1 pads -> row 0
            x = torch.cat([x, self._lookup(self.node_embedding, ids)],
                          dim=-1)
        elif batch.get("node_emb") is not None:   # frozen pretrained rows
            x = torch.cat([x, batch["node_emb"]], dim=-1)
        return x * batch["node_mask"][..., None]


class SEALGCN(_SealBase):
    """GCN stack and center (``edge``) or sum pooling (reference
    seal.py:43-113)."""

    def __init__(self, *args, pooling: str = "edge", **kwargs):
        super().__init__(*args, **kwargs)
        self.pooling = pooling
        h = self.hidden_channels
        for li in range(self.num_layers):
            setattr(self, f"conv_dense_{li}",
                    self._dense(self.in_channels if li == 0 else h, h))
        self.lin1 = self._dense(h, h)
        self.lin2 = self._dense(h, 1)
        self.drop = Dropout(self.dropout)

    def forward(self, batch: dict,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        mask, graph = batch["node_mask"], batch["graph"]
        x = self.embed_inputs(batch)
        for li in range(self.num_layers):
            x = gcn_prop(getattr(self, f"conv_dense_{li}")(x), graph, mask)
            if li < self.num_layers - 1:
                x = self.drop(F.relu(x), generator)
        h = (_center_pool(x) if self.pooling == "edge"
             else global_add_pool(x, mask))
        h = self.drop(F.relu(self.lin1(h)), generator)
        return at_least_float32(self.lin2(h))


class SEALSAGE(_SealBase):
    """SAGE stack and center pooling (reference seal.py:116-173)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        h = self.hidden_channels
        for li in range(self.num_layers):
            d = self.in_channels if li == 0 else h
            setattr(self, f"sage_n_{li}", self._dense(d, h))
            setattr(self, f"sage_r_{li}", self._dense(d, h, bias=False))
        self.lin1 = self._dense(h, h)
        self.lin2 = self._dense(h, 1)
        self.drop = Dropout(self.dropout)

    def forward(self, batch: dict,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        mask, graph = batch["node_mask"], batch["graph"]
        x = self.embed_inputs(batch)
        for li in range(self.num_layers):
            agg = mean_agg(x, graph, mask)
            x = (getattr(self, f"sage_n_{li}")(agg)
                 + getattr(self, f"sage_r_{li}")(x))
            if li < self.num_layers - 1:
                x = self.drop(F.relu(x), generator)
        h = self.drop(F.relu(self.lin1(_center_pool(x))), generator)
        return at_least_float32(self.lin2(h))


class SEALGIN(_SealBase):
    """GIN stack with jumping-knowledge mean pooling (reference
    seal.py:259-328).  Each layer's BatchNorm takes its statistics over
    the real nodes of the flattened [B·N] rows only (``BatchNorm``'s
    masked mode)."""

    def __init__(self, *args, jk: bool = True, train_eps: bool = False,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.jk = jk
        self.train_eps = train_eps
        h = self.hidden_channels
        for li in range(self.num_layers):
            setattr(self, f"gin_a_{li}",
                    self._dense(self.in_channels if li == 0 else h, h))
            setattr(self, f"gin_b_{li}", self._dense(h, h))
            setattr(self, f"gin_bn_{li}", batch_norm(h, self.dtype))
            if train_eps:
                setattr(self, f"eps_{li}", nn.Parameter(torch.zeros(())))
        self.lin1 = self._dense(h * self.num_layers if jk else h, h)
        self.lin2 = self._dense(h, 1)
        self.drop = Dropout(self.dropout)

    def forward(self, batch: dict,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        mask, graph = batch["node_mask"], batch["graph"]
        x = self.embed_inputs(batch)
        xs = []
        for li in range(self.num_layers):
            agg = sum_agg(x, graph, mask)
            if self.train_eps:
                # a float32 (1 + eps) promotes x, as jnp promotes it
                eps = getattr(self, f"eps_{li}")
                h = (1.0 + eps) * x.to(torch.promote_types(x.dtype,
                                                           eps.dtype))
            else:
                h = x
            h = h + agg
            h = F.relu(getattr(self, f"gin_a_{li}")(h))
            h = F.relu(getattr(self, f"gin_b_{li}")(h))
            h = getattr(self, f"gin_bn_{li}")(
                _flat(h), mask=mask.reshape(-1)).view(h.shape)
            x = h * mask[..., None]
            xs.append(x)
        h = torch.cat(xs, dim=-1) if self.jk else xs[-1]
        h = self.drop(F.relu(self.lin1(global_mean_pool(h, mask))),
                      generator)
        return at_least_float32(self.lin2(h))


class SEALDGCNN(_SealBase):
    """DGCNN (reference seal.py:177-256): a tanh GCN stack ending in one
    channel, sort pooling to k nodes, a per-node ``conv1`` (16), a max
    pool over node pairs, ``conv2`` (flax ``nn.Conv(32, (5,), VALID)`` on
    channels-last rows: a ``Conv1d(16, 32, 5)``'s weights applied as one
    matmul over the five stacked shifts), and an MLP over the
    channels-last flattening."""

    def __init__(self, *args, k: int = 30, **kwargs):
        super().__init__(*args, **kwargs)
        self.k = k
        h = self.hidden_channels
        dims = [h] * self.num_layers + [1]
        for li, dim in enumerate(dims):
            setattr(self, f"conv_dense_{li}",
                    self._dense(self.in_channels if li == 0 else dims[li - 1],
                                dim))
        self.num_convs = len(dims)
        self.conv1 = self._dense(h * self.num_layers + 1, 16)
        self.conv2 = nn.Conv1d(16, 32, 5)
        self.lin1 = self._dense((k // 2 - 4) * 32, 128)
        self.lin2 = self._dense(128, 1)
        self.drop = Dropout(0.5)

    def _conv2(self, h: torch.Tensor) -> torch.Tensor:
        """[B, L, 16] -> [B, L - 4, 32]: the VALID convolution as a matmul
        over the windows (whose backward is slicing and a matmul, the same
        from run to run), in the compute dtype as flax's ``nn.Conv``."""
        dt = self.dtype or torch.promote_types(h.dtype,
                                               self.conv2.weight.dtype)
        out_len = h.shape[1] - 4
        win = torch.stack([h[:, t:t + out_len] for t in range(5)], dim=-1)
        w = self.conv2.weight.reshape(32, -1)          # [32, 16 * 5]
        return F.linear(win.reshape(*win.shape[:2], -1).to(dt), w.to(dt),
                        self.conv2.bias.to(dt))

    def forward(self, batch: dict,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        mask, graph = batch["node_mask"], batch["graph"]
        x = self.embed_inputs(batch)
        xs = []
        for li in range(self.num_convs):
            x = torch.tanh(gcn_prop(getattr(self, f"conv_dense_{li}")(x),
                                    graph, mask))
            xs.append(x)
        pooled = global_sort_pool(torch.cat(xs, dim=-1), mask, self.k)
        h = F.relu(self.conv1(pooled))                  # [B, k, 16]
        b, k, c = h.shape
        h = h[:, :(k // 2) * 2].reshape(b, k // 2, 2, c).amax(dim=2)
        h = F.relu(self._conv2(h)).reshape(b, -1)
        h = self.drop(F.relu(self.lin1(h)), generator)
        return at_least_float32(self.lin2(h))
