"""What the drivers share: a cell's inputs, and the program built over
them through its own entry points (``graph/preprocess.py``
``build_link_dataset``, the model's trainer of ``train/loops.py`` as
``models/<model>.py`` names it)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import spec
from benchmark.inputs import graphs
from benchmark.inputs.weights import seeded_state_dict


class Inputs:
    """The cell's graph, features and supervision links, made on the
    device from the seed; ``split()`` hands them to the program."""

    def __init__(self, conf: dict, seed: int, device):
        spec = conf["graph"]
        self.n = spec["nodes"]
        g = graphs.make_graph(spec, seed, device)
        self.edges, self.weight, self.x = g["edges"], g["weight"], g["x"]
        # the undirected message graph as the loader leaves it: a simple
        # graph coalesced (sorted), a multigraph as both directions of
        # every edge, which the program coalesces itself (ogbl-collab)
        self.sym, self.sym_w = graphs.symmetric(
            self.edges, self.weight, self.n, sort=spec["kind"] == "simple")
        self.pos, self.neg = graphs.supervision(
            conf["supervision"], self.edges, self.n, seed,
            device)

    @property
    def links(self) -> torch.Tensor:
        return torch.cat([self.pos, self.neg])

    @property
    def labels(self) -> torch.Tensor:
        return torch.cat([torch.ones(len(self.pos), device=self.pos.device),
                          torch.zeros(len(self.neg), device=self.neg.device)])

    def split(self):
        from subgraph_sketching_tpu_torch.graph.container import Graph
        from subgraph_sketching_tpu_torch.graph.splits import SplitData
        w = None if self.sym_w is None else self.sym_w.cpu().numpy()
        g = Graph(self.sym.cpu().numpy().astype(np.int32), self.n,
                  edge_weight=w, x=self.x.cpu().numpy())
        return SplitData(graph=g,
                         pos_edges=self.pos.cpu().numpy().astype(np.int32),
                         neg_edges=self.neg.cpu().numpy().astype(np.int32))


def port_config(conf: dict):
    from subgraph_sketching_tpu_torch.config import Config
    return Config(**conf["config"])


def build_program(conf: dict, inputs: Inputs, seed: int, device):
    """(cfg, dataset, trainer, model, weights): the split's preprocessed
    dataset, the configuration's trainer over it, its model holding the
    seeded weights (``weights``, a copy kept for the reference)."""
    from subgraph_sketching_tpu_torch.graph.preprocess import (
        build_link_dataset,
    )
    cfg = port_config(conf)
    net = spec.load_model(cfg.model)
    ds = build_link_dataset(inputs.split(), cfg, "train", device=device)
    trainer = net.trainer(cfg, ds, device)
    model = trainer.init_model(seed)
    weights = seeded_state_dict(model, seed, device)
    model.load_state_dict(weights)
    return cfg, ds, trainer, model, {k: v.clone()
                                     for k, v in weights.items()}


def model_shape(conf: dict, trainer) -> dict:
    """The widths the FLOP counts need."""
    c = conf["config"]
    shape = {"model": c["model"], "hidden": c["hidden_channels"],
             "sf_dim": c.get("max_hash_hops", 2) * (
                 c.get("max_hash_hops", 2) + 2),
             "features": conf["graph"]["features"],
             "sign_k": c.get("sign_k", 0), "hops": c.get("max_hash_hops", 2),
             "nodes": conf["graph"]["nodes"]}
    shape.update(spec.load_model(c["model"]).shape(conf, trainer))
    return shape


def k1_launches() -> dict:
    from subgraph_sketching_tpu_torch.ops import segscan
    return dict(segscan.launches)
