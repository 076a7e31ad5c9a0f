"""SEAL training and inference loop of the port (the JAX package's
train/seal_loop.py; reference src/runners/train.py:92-157,
src/runners/inference.py:55-95).

Subgraph extraction stays on the host (``graph/seal.py``); each batch
goes to the device as its dense [B, N] labels, masks and features and one
``UnionGraph`` of its edges.  As in the JAX package:

  * an epoch walks a permutation of the train links, cut to
    ``train_samples`` under ``--dynamic_train``; the last batch is padded
    with link 0, masked in the loss only (its subgraphs do enter SEALGIN's
    BatchNorm statistics);
  * the epoch loss is sum(step losses) * batch_size / links used;
  * ``predict`` batches by ``batch_size`` over ``eval_subset``;
  * edge weights reach the models only under ``--use_edge_weight``.

An epoch is a function of (model, optimizer, seed) and of the stdlib
``random`` stream that fringe sampling draws from (``ratio_per_hop < 1``
or ``max_nodes_per_hop``), which the runner's ``set_seed`` seeds: the
permutation comes from ``np.random.default_rng(seed)`` and every dropout
mask from a ``torch.Generator`` on the device seeded with ``seed``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.device import resolve_device
from subgraph_sketching_tpu_torch.graph.seal import (
    SEALDataset, SealBatchArrays,
)
from subgraph_sketching_tpu_torch.models.gnn import compute_dtype
from subgraph_sketching_tpu_torch.models.seal import (
    SEALDGCNN, SEALGCN, SEALGIN, SEALMLP, SEALSAGE, UnionGraph, upload,
)
from subgraph_sketching_tpu_torch.train.losses import get_loss
from subgraph_sketching_tpu_torch.train.loops import (
    _init_like_flax, batched_predict, eval_subset, load_frozen_embedding,
)

SEAL_MODELS = ("SEALDGCNN", "SEALGCN", "SEALSAGE", "SEALGIN", "SEALMLP")


def dgcnn_k(dataset: SEALDataset, sortpool_k: float) -> int:
    """k from the ``sortpool_k`` percentile of the first 1,000 subgraphs'
    sizes (by ``extract_one``), at least 10; a ``sortpool_k`` above 1 is k
    itself (reference src/models/seal.py:186-197)."""
    if sortpool_k > 1:
        return max(10, int(sortpool_k))
    sizes = sorted(min(len(dataset.extract_one(i)[0]), dataset.max_nodes)
                   for i in range(min(1000, len(dataset))))
    k = sizes[max(0, int(math.ceil(sortpool_k * len(sizes))) - 1)]
    return max(10, int(k))


def build_seal_model(cfg: Config, num_nodes: int,
                     num_features: Optional[int], frozen_width: int = 0,
                     k: Optional[int] = None) -> nn.Module:
    """The ``cfg.model`` SEAL model, on the CPU and not initialised
    (``num_features``: the node features' width, None without them;
    ``frozen_width``: the width of a pretrained table's rows, 0 without
    one; ``k``: DGCNN's sort-pool size, from ``dgcnn_k``)."""
    dtype = compute_dtype(cfg.dtype)
    if cfg.model == "SEALMLP":
        # structure-free baseline; --label_pooling picks add/mean pooling
        # (reference seal.py:22-40 defines it but never dispatches it)
        return SEALMLP(cfg.max_z, dropout=cfg.dropout,
                       pooling=cfg.label_pooling, dtype=dtype)
    use_feature = bool(cfg.use_feature and num_features)
    common = dict(hidden_channels=cfg.hidden_channels, dtype=dtype,
                  num_layers=cfg.num_seal_layers, max_z=cfg.max_z,
                  use_feature=use_feature,
                  num_features=num_features if use_feature else 0,
                  dropout=cfg.dropout,
                  use_node_embedding=cfg.train_node_embedding,
                  num_nodes=num_nodes,
                  node_emb_dim=0 if cfg.train_node_embedding
                  else frozen_width)
    if cfg.model == "SEALDGCNN":
        return SEALDGCNN(**common, k=k)
    if cfg.model == "SEALGCN":
        return SEALGCN(**common, pooling=cfg.seal_pooling)
    if cfg.model == "SEALSAGE":
        return SEALSAGE(**common)
    if cfg.model == "SEALGIN":
        return SEALGIN(**common)
    raise NotImplementedError(cfg.model)


class SealTrainer:
    """Host extraction and the SEAL step on the device, in the port's
    trainer protocol (``init_model``, ``train_epoch``, ``predict``,
    ``num_links``, ``train_eval_split``).  DGCNN's k is read from the
    train subgraphs here, as the JAX trainer reads it; ``init_model``
    builds and initialises the model, whose optimizer is the caller's.

    ``features`` maps each split to its graph's [num_nodes, d] node
    features (None without them).  They live on the device, and each
    batch's [B, N, d] rows are gathered there by node id (the same values
    as the host gather, ``x[ids] * node_mask``, which would be most of a
    host extraction's time at 128-dim features); the datasets are built
    without them (``use_feature=False``)."""

    def __init__(self, cfg: Config, datasets: Dict[str, SEALDataset],
                 features: Optional[Dict[str, np.ndarray]] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.datasets = datasets
        train = datasets["train"]
        self.num_nodes = train.A.shape[0]
        features = (features or {}) if cfg.use_feature else {}
        x_train = features.get("train")
        self.num_features = (None if x_train is None
                             else int(x_train.shape[1]))
        tables: Dict[int, torch.Tensor] = {}   # one upload per array
        self.features = {}
        for split, x in features.items():
            if x is not None and self.num_features:
                if id(x) not in tables:
                    tables[id(x)] = upload(x, self.device)
                self.features[split] = tables[id(x)]
        frozen = (None if cfg.train_node_embedding
                  else load_frozen_embedding(cfg, self.num_nodes))
        self.frozen_emb = None if frozen is None else frozen.to(self.device)
        self.frozen_width = 0 if frozen is None else int(frozen.shape[1])
        self.k = (dgcnn_k(train, cfg.sortpool_k)
                  if cfg.model == "SEALDGCNN" else None)
        self.loss_fn = get_loss(cfg.loss)
        self.train_eval_split = "train"

    def num_links(self, split: str) -> int:
        return len(self.datasets[split])

    def init_model(self, seed: int) -> nn.Module:
        """The run's model on the trainer's device, initialised as flax
        initialises it, from a CPU generator seeded with ``seed``.  Like
        the JAX trainer's ``init_state`` it first extracts a batch of two
        train links, so the stdlib ``random`` stream (fringe sampling)
        stays in step with the JAX package's."""
        train = self.datasets["train"]
        train.batch(np.arange(min(2, len(train))))
        model = build_seal_model(self.cfg, self.num_nodes, self.num_features,
                                 self.frozen_width, self.k)
        _init_like_flax(model, torch.Generator().manual_seed(seed))
        return model.to(self.device)

    def to_device(self, raw: SealBatchArrays, split: str = "train"
                  ) -> Tuple[dict, torch.Tensor]:
        """One extracted batch of ``split`` as the models' input dict
        (``z``, ``node_mask``, ``graph``, and ``x``, ``node_ids`` or
        ``node_emb`` where the model reads them) and its labels, on the
        device.  The edge weights are the extracted ones under
        ``--use_edge_weight``, else 1 on every real edge (reference
        train.py:127, inference.py:73)."""
        w = (raw.edge_weight if self.cfg.use_edge_weight
             else raw.edge_mask.astype(np.float32))
        dev = self.device
        mask = upload(raw.node_mask, dev)
        batch = {"z": upload(raw.z.astype(np.int64), dev),
                 "node_mask": mask,
                 "graph": UnionGraph.from_padded(
                     raw.edge_index, w, raw.edge_mask, raw.z.shape[1],
                     dev)}
        table = self.features.get(split)
        if (table is not None or self.cfg.train_node_embedding
                or self.frozen_emb is not None):
            # global node ids; -1 padding reads row 0, masked downstream
            # (reference seal.py:80-81 for the tables)
            ids = upload(raw.node_ids.astype(np.int64), dev)
            safe = ids.clamp(min=0)
        if table is not None:
            batch["x"] = table[safe] * mask[..., None].to(table.dtype)
        if self.cfg.train_node_embedding:
            batch["node_ids"] = ids
        elif self.frozen_emb is not None:
            batch["node_emb"] = self.frozen_emb[safe]
        return batch, upload(raw.y, dev)

    def step(self, model: nn.Module, optimizer: torch.optim.Optimizer,
             raw: SealBatchArrays, mask: np.ndarray,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One training step on an extracted batch (``mask``: the links
        that count in the loss); returns the loss, on the device."""
        batch, y = self.to_device(raw)
        logits = model(batch, generator)
        loss = self.loss_fn(logits, y, upload(mask, self.device))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    def train_epoch(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                    seed: int, order: Optional[np.ndarray] = None) -> float:
        """One epoch over ``order`` (link indices) or a permutation drawn
        from ``seed``; returns sum(step losses) * batch_size / links."""
        cfg = self.cfg
        ds = self.datasets["train"]
        if order is None:
            n = len(ds)
            if cfg.dynamic_train and cfg.train_samples != math.inf:
                n = (int(cfg.train_samples * n) if cfg.train_samples < 1
                     else min(int(cfg.train_samples), n))
            order = np.random.default_rng(seed).permutation(len(ds))[:n]
        n = len(order)
        bs = cfg.batch_size
        g = torch.Generator(device=self.device).manual_seed(seed)
        model.train()
        losses = []
        for s in range(0, n, bs):
            idx = np.asarray(order[s:s + bs], dtype=np.int64)
            pad = bs - len(idx)
            mask = np.arange(bs) < len(idx)
            if pad:
                idx = np.concatenate([idx, np.zeros(pad, np.int64)])
            losses.append(self.step(model, optimizer, ds.batch(idx), mask,
                                    g))
        total = float(torch.stack(losses).sum()) * bs if losses else 0.0
        return total / max(n, 1)

    @torch.inference_mode()
    def predict(self, model: nn.Module, split: str,
                n_samples: Optional[int] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
        """(pred, labels) over ``eval_subset`` of the split's links,
        batched by ``batch_size`` as the JAX trainer batches them."""
        model.eval()
        ds = self.datasets[split]
        sel = eval_subset(len(ds), n_samples, self.cfg.dataset_name,
                          num_pos=int(np.asarray(ds.labels).sum()))

        def score(idx: np.ndarray) -> torch.Tensor:
            batch, _ = self.to_device(ds.batch(idx), split)
            return model(batch).ravel()

        pred = batched_predict(score, sel, self.cfg.batch_size)
        return pred, ds.labels[sel]


def build_seal_trainer(cfg: Config, splits, device="cuda") -> SealTrainer:
    """A ``SealTrainer`` over one ``SEALDataset`` per split, extracted up
    front or per batch by ``--dynamic_train/val/test`` (the JAX runner's
    ``build_seal_trainer``), without node features: the trainer gathers
    those on the device."""
    datasets = {}
    for name, sd in splits.items():
        dynamic = {"train": cfg.dynamic_train, "valid": cfg.dynamic_val,
                   "test": cfg.dynamic_test}[name]
        datasets[name] = SEALDataset(
            sd.graph, sd.pos_edges, sd.neg_edges, num_hops=cfg.num_hops,
            node_label=cfg.node_label, ratio_per_hop=cfg.ratio_per_hop,
            max_nodes_per_hop=cfg.max_nodes_per_hop, max_dist=cfg.max_dist,
            use_feature=False, dynamic=dynamic)
    features = {name: sd.graph.x for name, sd in splits.items()}
    return SealTrainer(cfg, datasets, features, device=device)
