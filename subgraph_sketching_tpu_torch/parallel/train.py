"""The full ELPH training step over a data-parallel mesh, and its
single-device oracle (the JAX package's parallel/train.py, on the data
axis).

A step: subgraph features of the batch from sketches built once per graph
(gradient-free, step-constant), the full-graph GCN (``ELPH`` with its
scatter SpMM, on K1 each way), the ``LinkPredictor`` head, the BCE loss,
the backward and Adam.  ``make_distributed_train_step`` runs it with the
link batch split over the mesh's ranks (every rank takes its block of the
global ``links`` and ``labels``, as JAX's ``P("data")`` in_shardings take
it), the graph and the tables replicated, the loss over the global batch
and the gradients summed over the ranks; ``single_device_reference_step``
runs the same step body without a mesh.  The two share ``_make_step`` and
``_make_init_fn``, so the oracle cannot drift from the distributed math.

The graph and lane axes of the JAX function (edge-sharded sketch build,
lane-sharded features, the memory-sharded mode) are ROADMAP item 9b.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from subgraph_sketching_tpu_torch.device import resolve_device
from subgraph_sketching_tpu_torch.models.elph import ELPHPredictor
from subgraph_sketching_tpu_torch.models.gnn import shard_batch_axis
from subgraph_sketching_tpu_torch.ops.segment_scan import gather_rows
from subgraph_sketching_tpu_torch.parallel.mesh import (
    Mesh, batch_sharding, flat_grads,
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


def _make_step(params: SketchParams, num_nodes: int, mesh: Optional[Mesh]):
    """The ONE step body of both paths; they differ only in ``mesh``."""
    shard = batch_sharding(mesh) if mesh is not None else (lambda t: t)

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
            sf = subgraph_features(links, sk, params)
        model.train()
        feats, _ = model.gnn(x, ei, num_nodes, generator=generator)
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
            grads.all_reduce()
        opt.step()
        return loss.detach()

    return step


def _make_build(params: SketchParams, num_nodes: int, device):
    def build_sketches(edge_index: torch.Tensor,
                       mask: Optional[torch.Tensor] = None):
        """The graph's sketch stacks, built once (step-constant)."""
        ei = edge_index if mask is None else edge_index[:, mask]
        return build_hash_tables(np.asarray(ei.cpu()), num_nodes, params,
                                 device=device)

    return build_sketches


def make_distributed_train_step(mesh: Mesh, params: SketchParams,
                                hidden_channels: int, num_nodes: int,
                                lr: float = 1e-3,
                                label_dropout: float = 0.5,
                                feature_dropout: float = 0.5):
    """Full ELPH training over ``mesh``'s data axis, on its device.

    Returns ``(init_fn, step_fn, build_sketches)``:
      * ``init_fn(seed, x) -> DistTrainState`` (the same weights on every
        rank);
      * ``step_fn(state, x, edge_index, mask, sk, links, labels,
        generator)`` with the GLOBAL ``links`` and ``labels`` (each rank
        takes its block); ``generator`` draws the dropout masks, of the
        global batch on every rank;
      * ``build_sketches(edge_index, mask=None)``: run it once per graph.
    """
    return (_make_init_fn(params, hidden_channels, lr, label_dropout,
                          feature_dropout, mesh, mesh.device),
            _make_step(params, num_nodes, mesh),
            _make_build(params, num_nodes, mesh.device))


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
            _make_step(params, num_nodes, None),
            _make_build(params, num_nodes, dev))
