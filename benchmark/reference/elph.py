"""Plain ELPH (the authors' src/models/elph.py ``ELPH``) with the GCN
``feature_prop``: the full-graph GCN runs for every batch."""

from __future__ import annotations

import torch

from benchmark.reference.models import Params, batch_norm, dense, dropout


def node_state(x: torch.Tensor, adj: torch.Tensor, c: dict) -> dict:
    """The resident node rows and the normalised adjacency."""
    return {"x": x, "adj": adj}


def nodes(P: Params, x: torch.Tensor, adj: torch.Tensor, hops: int,
          drop: dict, gen=None, train: bool = False) -> torch.Tensor:
    """The GCN: per hop A (x W) + b, then dropout."""
    for k in range(hops):
        x = torch.sparse.mm(adj, x @ P[f"gnn.conv_{k}.lin.weight"].t()) \
            + P[f"gnn.conv_{k}.bias"]
        x = dropout(x, drop["feature"], gen, train)
    return x


def logits(P: Params, state: dict, sf: torch.Tensor, pair: torch.Tensor,
           c: dict, drop: dict, gen=None, train: bool = False) -> torch.Tensor:
    """Logits [B] of the links ``pair`` [B, 2]: ``sf`` [B, 8] their
    subgraph features, the endpoints' rows from the GCN."""
    nf = nodes(P, state["x"], state["adj"], c["max_hash_hops"], drop, gen,
               train)[pair]
    x = torch.relu(batch_norm(P, "predictor.bn_labels",
                              dense(P, "predictor.label_lin_layer", sf),
                              train))
    x = dropout(x, drop["label"], gen, train)
    h = dense(P, "predictor.lin_out", nf[:, 0] * nf[:, 1])
    h = torch.relu(batch_norm(P, "predictor.bn_feats", h, train))
    h = dropout(h, drop["feature"], gen, train)
    return dense(P, "predictor.lin", torch.cat([x, h], dim=1)).reshape(-1)
