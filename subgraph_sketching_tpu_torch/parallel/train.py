"""The full ELPH training step over a mesh, and its single-device oracle
(the JAX package's parallel/train.py).

A step: subgraph features of the batch from sketches built once per graph
(gradient-free, step-constant), the full-graph GCN (``ELPH`` with its
scatter SpMM, on K1 each way), the ``LinkPredictor`` head, the BCE loss,
the backward and Adam.  ``make_distributed_train_step`` runs it over the
mesh's axes:

  * ``data``: every rank takes its block of the global ``links`` and
    ``labels`` (JAX's ``P("data")``), the loss is the global batch's and
    the gradients are summed over the data axis;
  * ``graph``: the sketches are built edge-sharded (the state
    replicated, ``parallel/dist_sketch.py``), and the GCN runs over the
    rank's block of the gcn_norm'd edges, summed over the axis
    (``models/gnn.py`` ``EdgeShardSpmm``); with ``node_partition`` (a
    ``NodePartitionPlan`` over the graph axis) the sketch state is
    instead node-sharded through training, and each batch's features are
    assembled from the shards (``parallel/node_sharded.py``): the
    citation2-scale configuration;
  * ``lane``: the features come from the rank's width slice, summed over
    the axis.

``single_device_reference_step`` runs the same step body without a mesh.
The two share ``_make_step`` and ``_make_init_fn``, so the oracle cannot
drift from the distributed math.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from subgraph_sketching_tpu_torch.device import resolve_device
from subgraph_sketching_tpu_torch.models.elph import ELPHPredictor
from subgraph_sketching_tpu_torch.models.gnn import (
    EdgeShardSpmm, shard_batch_axis,
)
from subgraph_sketching_tpu_torch.ops.graph_ops import gcn_norm, spmm
from subgraph_sketching_tpu_torch.ops.segment_scan import gather_rows
from subgraph_sketching_tpu_torch.parallel.dist_sketch import (
    edge_sharded_build_hash_tables, lane_sharded_subgraph_features,
    pad_edges, weighted_edge_block,
)
from subgraph_sketching_tpu_torch.parallel.mesh import Mesh, flat_grads
from subgraph_sketching_tpu_torch.parallel.node_sharded import (
    node_sharded_build_hash_tables, node_sharded_subgraph_features,
)
from subgraph_sketching_tpu_torch.sketch.elph import (
    build_hash_tables, subgraph_features,
)
from subgraph_sketching_tpu_torch.sketch.params import SketchParams
from subgraph_sketching_tpu_torch.train.losses import bce_loss


class DistTrainState(NamedTuple):
    model: ELPHPredictor
    optimizer: torch.optim.Optimizer


def _make_init_fn(params: SketchParams, hidden_channels: int, lr: float,
                  label_dropout: float, feature_dropout: float,
                  mesh: Optional[Mesh], device):
    """``init_fn(seed, x)``: an ELPH (gcn, features on) with its
    LinkPredictor head for [N, F] features ``x``, initialised as flax
    initialises it from a CPU generator seeded with ``seed``, and its
    Adam at ``lr``."""
    from subgraph_sketching_tpu_torch.train.loops import _init_like_flax

    def init_fn(seed: int, x: torch.Tensor) -> DistTrainState:
        model = ELPHPredictor(params, x.shape[-1], hidden_channels,
                              use_feature=True, feature_prop="gcn",
                              label_dropout=label_dropout,
                              feature_dropout=feature_dropout)
        _init_like_flax(model, torch.Generator().manual_seed(seed))
        if mesh is not None:
            shard_batch_axis(model.predictor, mesh)
        model = model.to(device)
        return DistTrainState(model, torch.optim.Adam(model.parameters(),
                                                      lr=lr))

    return init_fn


def _make_gcn_spmm(num_nodes: int, mesh: Optional[Mesh]):
    """``gcn(edge_index, x)``: the GCN's SpMM for a step, None without a
    graph axis (``ELPH`` then takes gcn_norm and the scatter ``spmm``);
    on a graph axis the scatter ``spmm`` over the rank's block of the
    gcn_norm'd edges, summed over the axis."""
    if mesh is None or "graph" not in mesh.axis_names:
        return lambda edge_index, x: None

    def gcn(edge_index: torch.Tensor, x: torch.Tensor):
        e, w = weighted_edge_block(*gcn_norm(edge_index, None, num_nodes),
                                   mesh)
        return EdgeShardSpmm(lambda h: spmm(e, w, h, num_nodes),
                             mesh.group("graph"))

    return gcn


def _make_step(params: SketchParams, num_nodes: int, mesh: Optional[Mesh],
               feature_fn):
    """The ONE step body of both paths; they differ only in ``mesh`` and
    ``feature_fn`` (how the batch's subgraph features come from the
    sketches)."""
    shard = mesh.shard if mesh is not None else (lambda t: t)
    gcn = _make_gcn_spmm(num_nodes, mesh)

    def step(state: DistTrainState, x: torch.Tensor,
             edge_index: torch.Tensor, mask: Optional[torch.Tensor], sk,
             links: torch.Tensor, labels: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One step on the global batch ``links`` [B, 2] / ``labels``
        [B]; ``mask`` [E] marks the real edges of a padded
        ``edge_index`` (None: all).  Returns the global batch's loss."""
        model, opt = state
        links, labels = shard(links), shard(labels)
        ei = edge_index if mask is None else edge_index[:, mask]
        with torch.no_grad():
            sf = feature_fn(sk, links)
        model.train()
        feats, _ = model.gnn(x, ei, num_nodes, plan=gcn(ei, x),
                             generator=generator)
        logits = model.predictor(sf, gather_rows(feats, links),
                                 generator=generator)
        loss = bce_loss(logits, labels, mesh=mesh)
        if mesh is None:
            opt.zero_grad(set_to_none=True)
            loss.backward()
        else:
            grads = flat_grads(model)
            grads.zero_grad()
            loss.backward()
            grads.all_reduce(mesh.group("data"))
        opt.step()
        return loss.detach()

    return step


def _make_build(params: SketchParams, num_nodes: int, device,
                mesh: Optional[Mesh] = None, node_partition=None):
    def build_sketches(edge_index: torch.Tensor,
                       mask: Optional[torch.Tensor] = None):
        """The graph's sketch stacks, built once (step-constant): this
        rank's node shard with ``node_partition``, edge-sharded and
        replicated on a graph axis, else on one device."""
        if node_partition is not None:
            return node_sharded_build_hash_tables(node_partition, params,
                                                  mesh)
        ei = edge_index if mask is None else edge_index[:, mask]
        if mesh is not None and "graph" in mesh.axis_names:
            padded, m = pad_edges(ei.cpu().numpy(), mesh.axis_size("graph"))
            return edge_sharded_build_hash_tables(padded, num_nodes, params,
                                                  mesh, mask=m)
        return build_hash_tables(np.asarray(ei.cpu()), num_nodes, params,
                                 device=device)

    return build_sketches


def _make_features(params: SketchParams, mesh: Optional[Mesh],
                   node_partition=None):
    """``feature_fn(sk, links)`` of the step."""
    if node_partition is not None:
        return lambda sk, links: node_sharded_subgraph_features(
            links, sk, params, mesh, perm=node_partition.perm)
    if mesh is not None and "lane" in mesh.axis_names:
        return lambda sk, links: lane_sharded_subgraph_features(
            links, sk, params, mesh)
    return lambda sk, links: subgraph_features(links, sk, params)


def make_distributed_train_step(mesh: Mesh, params: SketchParams,
                                hidden_channels: int, num_nodes: int,
                                lr: float = 1e-3,
                                label_dropout: float = 0.5,
                                feature_dropout: float = 0.5,
                                node_partition=None):
    """Full ELPH training over ``mesh``, on its device.

    Returns ``(init_fn, step_fn, build_sketches)``:
      * ``init_fn(seed, x) -> DistTrainState`` (the same weights on every
        rank);
      * ``step_fn(state, x, edge_index, mask, sk, links, labels,
        generator)`` with the GLOBAL ``links`` and ``labels`` (each rank
        takes its block); ``generator`` draws the dropout masks, of the
        global batch on every rank;
      * ``build_sketches(edge_index, mask=None)``: run it once per graph.

    ``node_partition`` (a ``NodePartitionPlan`` over the ``graph`` axis):
    the memory-sharded mode, the sketch state node-sharded through
    training (module docstring).
    """
    if node_partition is not None and "graph" not in mesh.axis_names:
        raise ValueError("node_partition needs a 'graph' mesh axis")
    return (_make_init_fn(params, hidden_channels, lr, label_dropout,
                          feature_dropout, mesh, mesh.device),
            _make_step(params, num_nodes, mesh,
                       _make_features(params, mesh, node_partition)),
            _make_build(params, num_nodes, mesh.device, mesh,
                        node_partition))


def single_device_reference_step(params: SketchParams, hidden_channels: int,
                                 num_nodes: int, lr: float = 1e-3,
                                 label_dropout: float = 0.5,
                                 feature_dropout: float = 0.5,
                                 device="cuda"):
    """The SAME step body without a mesh: the equality oracle of
    ``make_distributed_train_step`` (the same three functions)."""
    dev = resolve_device(device)
    return (_make_init_fn(params, hidden_channels, lr, label_dropout,
                          feature_dropout, None, dev),
            _make_step(params, num_nodes, None,
                       _make_features(params, None)),
            _make_build(params, num_nodes, dev))
