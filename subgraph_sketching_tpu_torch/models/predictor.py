"""ELPH's edgewise scoring head (the JAX package's models/predictor.py).

Structure-feature MLP ⊕ Hadamard-product feature MLP ⊕ optional embedding
MLP -> logit (reference src/models/elph.py:22-95).  Submodule names mirror
the flax names, so ``models/convert.py`` maps flax weights one to one.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from subgraph_sketching_tpu_torch.models.gnn import (
    Dense, Dropout, at_least_float32, batch_norm,
)


class LinkPredictor(nn.Module):
    """Scores one batch of links from structure features and node
    features.

    sf [B, sf_dim]; node_features [B, 2, hidden]; emb [B, 2, emb_dim]
    (reference LinkPredictor.forward, src/models/elph.py:73-86).  Returns
    float32 logits [B, 1]; ``dtype`` is the compute dtype of its dense
    layers and BatchNorms (the JAX package's ``dtype`` field).
    """

    def __init__(self, sf_dim: int, hidden_channels: int,
                 use_feature: bool = True, use_embedding: bool = False,
                 label_dropout: float = 0.5, feature_dropout: float = 0.5,
                 emb_dim: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.use_feature = use_feature
        self.use_embedding = use_embedding
        self.label_lin_layer = Dense(sf_dim, sf_dim, dtype=dtype)
        self.bn_labels = batch_norm(sf_dim, dtype)
        self.label_dropout = Dropout(label_dropout)
        self.feature_dropout = Dropout(feature_dropout)
        out_dim = sf_dim
        if use_feature:
            # the Hadamard product of the two endpoints, then an MLP
            # (reference feature_forward, src/models/elph.py:48-60; the
            # reference defines lin_feat but applies only lin_out)
            self.lin_out = Dense(hidden_channels, hidden_channels,
                                 dtype=dtype)
            self.bn_feats = batch_norm(hidden_channels, dtype)
            out_dim += hidden_channels
        if use_embedding:
            # (reference embedding_forward, src/models/elph.py:62-71)
            self.lin_emb = Dense(emb_dim or hidden_channels, hidden_channels,
                                 dtype=dtype)
            self.lin_emb_out = Dense(hidden_channels, hidden_channels,
                                     dtype=dtype)
            self.bn_embs = batch_norm(hidden_channels, dtype)
            out_dim += hidden_channels
        self.lin = Dense(out_dim, 1, dtype=dtype)

    def forward(self, sf: torch.Tensor,
                node_features: Optional[torch.Tensor] = None,
                emb: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``generator`` draws the dropout masks in training mode."""
        x = self.label_lin_layer(sf)
        x = self.label_dropout(torch.relu(self.bn_labels(x)), generator)
        if self.use_feature and node_features is not None:
            h = self.lin_out(node_features[:, 0, :] * node_features[:, 1, :])
            h = self.feature_dropout(torch.relu(self.bn_feats(h)), generator)
            x = torch.cat([x, h.to(x.dtype)], dim=1)
        if self.use_embedding and emb is not None:
            e = self.lin_emb(emb)
            e = self.lin_emb_out(e[:, 0, :] * e[:, 1, :])
            e = self.feature_dropout(torch.relu(self.bn_embs(e)), generator)
            x = torch.cat([x, e.to(x.dtype)], dim=1)
        return at_least_float32(self.lin(x))
