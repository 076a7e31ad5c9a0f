"""ELPH: a full-graph GNN propagating sketches and node features in
lockstep (the JAX package's models/elph.py; reference
src/models/elph.py:98-218).

Per hop k the sketches advance by the closed-neighbourhood min (MinHash)
/ max (HLL), with no gradient (integer data), while the node features
advance through a ``GCNConv``; the model returns the final features and
every hop's sketches for the predictor.  In training the sketches are
built once at staging (``train/loops.py`` ``ElphTrainer``), and only the
feature side runs in the step; its SpMM is the staged ``PlanSpmm``
(forward and backward on K1) or the scatter ``spmm``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from subgraph_sketching_tpu_torch.models.gnn import (
    Dense, Dropout, GCNConv, compute_dtype,
)
from subgraph_sketching_tpu_torch.models.predictor import LinkPredictor
from subgraph_sketching_tpu_torch.ops.graph_ops import gcn_norm
from subgraph_sketching_tpu_torch.sketch.elph import (
    propagate_hll, propagate_minhash, subgraph_features,
)
from subgraph_sketching_tpu_torch.sketch.hll import hll_count
from subgraph_sketching_tpu_torch.sketch.params import SketchParams, Sketches


class ELPH(nn.Module):
    """Returns (node features, Sketches) for the full graph.

    feature_prop: 'gcn' | 'residual' | 'cat' (reference
    src/models/elph.py:113; 'residual' and 'cat' first encode the raw
    features to hidden_channels with ``feature_encoder``, :131-139, and
    'residual' adds skip connections).  Submodules ``feature_encoder`` and
    ``conv_{k}`` mirror the flax names.  ``dtype`` is their compute dtype;
    each ``GCNConv`` returns float32 (its float32 bias), so the node
    features that leave the model are float32, as in JAX.
    """

    def __init__(self, sketch_params: SketchParams,
                 num_features: Optional[int], hidden_channels: int,
                 use_feature: bool = True, feature_prop: str = "gcn",
                 feature_dropout: float = 0.5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if feature_prop not in ("gcn", "residual", "cat"):
            raise ValueError(f"feature_prop {feature_prop!r}: gcn, residual "
                             f"or cat")
        self.sketch_params = sketch_params
        self.use_feature = use_feature and num_features is not None
        self.feature_prop = feature_prop
        self.dropout = Dropout(feature_dropout)
        if self.use_feature:
            width = num_features
            if feature_prop in ("residual", "cat"):
                self.feature_encoder = Dense(num_features, hidden_channels,
                                             dtype=dtype)
                width = hidden_channels
            for k in range(sketch_params.max_hops):
                self.add_module(f"conv_{k}", GCNConv(width, hidden_channels,
                                                     dtype=dtype))
                width = hidden_channels

    def forward(self, x: Optional[torch.Tensor], edge_index: torch.Tensor,
                num_nodes: int, init_minhash: Optional[torch.Tensor] = None,
                init_hll: Optional[torch.Tensor] = None,
                edge_weight: Optional[torch.Tensor] = None,
                norm: Optional[tuple] = None, plan=None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[Optional[torch.Tensor], Optional[Sketches]]:
        """``edge_index`` [2, E] is the unnormalised message graph; the
        convolutions take ``plan`` (a staged ``PlanSpmm`` over its
        gcn_norm'd edges) or else ``norm`` ((edge_index, weight) from
        ``gcn_norm``, computed here when absent).  With hop-0 sketches
        (biased-int32 MinHash, int8 HLL) the sketch hops run too.
        ``generator`` draws the dropout masks in training mode."""
        p = self.sketch_params
        with_sketches = init_minhash is not None
        if self.use_feature and plan is None and norm is None:
            norm = gcn_norm(edge_index, edge_weight, num_nodes)
        if self.use_feature and self.feature_prop in ("residual", "cat"):
            x = self.dropout(self.feature_encoder(x), generator)
        src, dst = edge_index[0].long(), edge_index[1].long()
        mhs, hlls, cards = [init_minhash], [init_hll], []
        for k in range(p.max_hops):
            if with_sketches:
                # integer min/max message passing, gradient-free
                # (reference hashing.py:32,42)
                with torch.no_grad():
                    mhs.append(propagate_minhash(mhs[-1], src, dst,
                                                 num_nodes))
                    hlls.append(propagate_hll(hlls[-1], src, dst, num_nodes))
                    cards.append(hll_count(hlls[-1], p.hll_p))
            if self.use_feature:
                conv = getattr(self, f"conv_{k}")
                out = self.dropout(conv(x, edge_index, num_nodes, norm=norm,
                                        plan=plan), generator)
                x = x + out if self.feature_prop == "residual" else out
        sketches = None
        if with_sketches:
            sketches = Sketches(minhash=torch.stack(mhs),
                                hll=torch.stack(hlls),
                                cards=torch.stack(cards, dim=1))
        return (x if self.use_feature else None), sketches


class ELPHPredictor(nn.Module):
    """ELPH with its LinkPredictor head in one module (children ``gnn``
    and ``predictor``, and ``embedding`` with node embeddings: the JAX
    trainer's ``{"gnn", "predictor", "embedding"}`` params tree), so
    checkpoints, the determinism check, ``models/convert.py`` and the
    optimizer see one model."""

    def __init__(self, sketch_params: SketchParams,
                 num_features: Optional[int], hidden_channels: int,
                 use_feature: bool = True, use_embedding: bool = False,
                 feature_prop: str = "gcn", label_dropout: float = 0.5,
                 feature_dropout: float = 0.5, emb_dim: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.sketch_params = sketch_params
        self.gnn = ELPH(sketch_params, num_features, hidden_channels,
                        use_feature, feature_prop, feature_dropout, dtype)
        self.predictor = LinkPredictor(
            sketch_params.sf_dim, hidden_channels, self.gnn.use_feature,
            use_embedding, label_dropout, feature_dropout, emb_dim, dtype)

    @classmethod
    def from_config(cls, cfg, sketch_params: SketchParams,
                    num_features: Optional[int],
                    emb_dim: Optional[int] = None) -> "ELPHPredictor":
        """The model an ELPH run with ``cfg`` trains (as the JAX package's
        ElphTrainer builds it, less its node-embedding table, which the
        trainer adds as the child ``embedding``); ``num_features`` None
        without features, ``emb_dim`` the width of the embedding rows
        (default hidden_channels)."""
        return cls(sketch_params, num_features, cfg.hidden_channels,
                   use_feature=cfg.use_feature and num_features is not None,
                   use_embedding=(cfg.train_node_embedding
                                  or cfg.pretrained_node_embedding
                                  is not None),
                   feature_prop=cfg.feature_prop,
                   label_dropout=cfg.label_dropout,
                   feature_dropout=cfg.feature_dropout, emb_dim=emb_dim,
                   dtype=compute_dtype(cfg.dtype))

    def forward(self, x, edge_index, num_nodes, init_minhash, init_hll,
                links, edge_weight=None, emb=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The whole model for ``links`` [B, 2]: the graph pass, the
        subgraph features and node-feature rows, then the head.  Training
        and prediction instead run ``gnn`` once and the head per batch
        (reference inference.py:185-194)."""
        feats, sketches = self.gnn(x, edge_index, num_nodes, init_minhash,
                                   init_hll, edge_weight,
                                   generator=generator)
        sf = subgraph_features(links, sketches, self.sketch_params)
        nf = feats[links] if feats is not None else None
        batch_emb = emb[links] if emb is not None else None
        return self.predictor(sf, nf, batch_emb, generator=generator)
