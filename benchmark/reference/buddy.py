"""Plain BUDDY (the authors' src/models/elph.py ``BUDDY``) with SIGN(k)
node features."""

from __future__ import annotations

import torch

from benchmark.reference.models import (
    Params, batch_norm, dense, dropout, sign_features,
)


def node_state(x: torch.Tensor, adj: torch.Tensor, c: dict) -> dict:
    """The resident node rows: [x, Ax, ..., A^k x]."""
    return {"x": sign_features(x, adj, c["sign_k"])}


def logits(P: Params, state: dict, sf: torch.Tensor, pair: torch.Tensor,
           c: dict, drop: dict, gen=None, train: bool = False) -> torch.Tensor:
    """Logits [B] of the links ``pair`` [B, 2]: ``sf`` [B, 8] their
    subgraph features, the endpoints' SIGN rows taken from ``state``."""
    sign_k = c["sign_k"]
    xs = state["x"][pair]
    x = torch.relu(batch_norm(P, "bn_labels", dense(P, "label_lin_layer", sf),
                              train))
    x = dropout(x, drop["label"], gen, train)
    hs = []
    for k, blk in enumerate(torch.chunk(xs, sign_k + 1, dim=-1)):
        h = dense(P, f"sign.lin_{k}", blk)
        h = torch.stack([batch_norm(P, f"sign.bn_{k}", h[:, 0], train),
                         batch_norm(P, f"sign.bn_{k}", h[:, 1], train)], 1)
        hs.append(dropout(torch.relu(h), drop["sign"], gen, train))
    h = dense(P, "sign.lin_out", torch.cat(hs, dim=-1))
    h = dense(P, "lin_out", h[:, 0] * h[:, 1])
    h = torch.relu(batch_norm(P, "bn_feats", h, train))
    h = dropout(h, drop["feature"], gen, train)
    return dense(P, "lin", torch.cat([x, h], dim=1)).reshape(-1)
