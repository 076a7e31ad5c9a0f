"""GNN building blocks of the port: batch norm and SIGN.

BatchNorm: flax momentum 0.9 (the JAX package's ``BN_MOMENTUM``) is torch
momentum 0.1; eps 1e-5 in both.
"""

from __future__ import annotations

import torch
from torch import nn

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def batch_norm(num_features: int) -> nn.BatchNorm1d:
    return nn.BatchNorm1d(num_features, momentum=BN_MOMENTUM, eps=BN_EPS)


class SIGN(nn.Module):
    """SIGN over precomputed per-hop feature blocks.

    Input [B, 2, d*(K+1)] is split into K+1 hop blocks; each gets its own
    Linear+BN+ReLU+Dropout, then blocks are concatenated and mixed
    (reference src/models/gnn.py:169-191).  BatchNorm is applied per link
    endpoint with shared parameters, like the reference's bn(h[:,0])/bn(h[:,1]).
    Submodules ``lin_{k}``, ``bn_{k}``, ``lin_out`` mirror the flax names.
    """

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: int, K: int, dropout: float):
        super().__init__()
        self.K = K
        for k in range(K + 1):
            self.add_module(f"lin_{k}", nn.Linear(in_channels, hidden_channels))
            self.add_module(f"bn_{k}", batch_norm(hidden_channels))
        self.lin_out = nn.Linear(hidden_channels * (K + 1), out_channels)
        self.dropout = nn.Dropout(dropout)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        hs = []
        for k, x in enumerate(torch.chunk(xs, self.K + 1, dim=-1)):
            h = getattr(self, f"lin_{k}")(x)
            bn = getattr(self, f"bn_{k}")
            h = torch.stack([bn(h[:, 0, :]), bn(h[:, 1, :])], dim=1)
            hs.append(self.dropout(torch.relu(h)))
        return self.lin_out(torch.cat(hs, dim=-1))
