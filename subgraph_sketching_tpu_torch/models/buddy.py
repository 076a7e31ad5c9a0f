"""BUDDY: pure edgewise MLP over precomputed subgraph + SIGN features.

Counterpart of the JAX package's models/buddy.py (reference
src/models/elph.py:221-352).  All graph-dependent work happens in
preprocessing, so a forward pass touches only per-link tensors.  Submodule
names mirror the flax names, so ``models/convert.py`` maps flax weights
one to one.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from subgraph_sketching_tpu_torch.models.gnn import SIGN, Dropout, batch_norm


class BUDDY(nn.Module):
    """Edgewise link scorer.

    Inputs per batch (reference forward, src/models/elph.py:324-352):
      sf            [B, k(k+2)]   subgraph (structure) features
      node_features [B, 2, d] raw features, or [B, 2, d*(sign_k+1)] if sign_k>0
      src_degree / dst_degree [B] — for the degree-normalised feature copy
      RA            [B] resource-allocation scores (with ``use_RA``)
    Returns logits [B, 1].
    """

    def __init__(self, sf_dim: int, hidden_channels: int,
                 num_features: Optional[int] = None, use_feature: bool = True,
                 sign_k: int = 0, append_normalised: bool = False,
                 use_RA: bool = False, use_embedding: bool = False,
                 label_dropout: float = 0.5, feature_dropout: float = 0.5,
                 sign_dropout: float = 0.5):
        super().__init__()
        if use_embedding:
            raise NotImplementedError(
                "BUDDY's node-embedding inputs are not ported yet")
        self.use_feature = use_feature and num_features is not None
        self.sign_k = sign_k
        self.append_normalised = append_normalised
        dim = sf_dim * 2 if append_normalised else sf_dim
        self.label_lin_layer = nn.Linear(dim, dim)
        self.bn_labels = batch_norm(dim)
        self.label_dropout = Dropout(label_dropout)
        out_dim = dim
        if self.use_feature:
            # (reference feature_forward, src/models/elph.py:295-311)
            if sign_k != 0:
                self.sign = SIGN(num_features, hidden_channels,
                                 hidden_channels, sign_k, sign_dropout)
            else:
                self.lin_feat = nn.Linear(num_features, hidden_channels)
            self.lin_out = nn.Linear(hidden_channels, hidden_channels)
            self.bn_feats = batch_norm(hidden_channels)
            self.feature_dropout = Dropout(feature_dropout)
            out_dim += hidden_channels
        self.use_RA = use_RA
        if use_RA:
            # the RA score, batch-normalised, joins the last layer's input
            self.bn_RA = batch_norm(1)
            out_dim += 1
        self.lin = nn.Linear(out_dim, 1)

    @classmethod
    def from_config(cls, cfg, num_features: Optional[int]) -> "BUDDY":
        """The model a BUDDY run with ``cfg`` trains (as the JAX package's
        BuddyTrainer builds it).  ``num_features`` is the width of the
        split's node features, d*(sign_k+1) when sign_k > 0."""
        if num_features is not None:
            num_features //= cfg.sign_k + 1
        return cls(sf_dim=cfg.sf_dim, hidden_channels=cfg.hidden_channels,
                   num_features=num_features,
                   use_feature=cfg.use_feature and num_features is not None,
                   sign_k=cfg.sign_k,
                   append_normalised=cfg.add_normed_features,
                   use_RA=cfg.use_RA,
                   use_embedding=(cfg.train_node_embedding
                                  or cfg.pretrained_node_embedding is not None),
                   label_dropout=cfg.label_dropout,
                   feature_dropout=cfg.feature_dropout,
                   sign_dropout=cfg.sign_dropout)

    @staticmethod
    def _append_degree_normalised(x, src_degree, dst_degree):
        """x ⊕ x/sqrt(d_src * d_dst) with 0/0 -> 0
        (reference src/models/elph.py:276-293)."""
        normed = x / torch.sqrt(src_degree * dst_degree)[:, None]
        normed = torch.where(torch.isfinite(normed), normed,
                             torch.zeros_like(normed))
        return torch.cat([x, normed], dim=1)

    def forward(self, sf: torch.Tensor,
                node_features: Optional[torch.Tensor] = None,
                src_degree: Optional[torch.Tensor] = None,
                dst_degree: Optional[torch.Tensor] = None,
                RA: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the dropout masks in training mode."""
        if self.append_normalised:
            sf = self._append_degree_normalised(sf, src_degree, dst_degree)
        x = self.label_lin_layer(sf)
        x = self.label_dropout(torch.relu(self.bn_labels(x)), generator)
        if self.use_feature and node_features is not None:
            if self.sign_k != 0:
                h = self.sign(node_features, generator)
            else:
                h = self.lin_feat(node_features)
            h = self.lin_out(h[:, 0, :] * h[:, 1, :])
            h = self.feature_dropout(torch.relu(self.bn_feats(h)), generator)
            x = torch.cat([x, h], dim=1)
        if self.use_RA and RA is not None:
            x = torch.cat([x, self.bn_RA(RA[:, None].to(x.dtype))], dim=1)
        return self.lin(x)
