"""Normalised-adjacency ops: gcn_norm, self-loops, degrees.

Torch counterparts of PyG ``gcn_norm`` as the reference uses it
(src/datasets/elph.py:99-107).  Edge lists are [2, E] int tensors; the
SpMM itself runs through the plan's add path (ops/segment_scan.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def degrees_from_edges(edge_index: torch.Tensor,
                       edge_weight: Optional[torch.Tensor],
                       num_nodes: int) -> torch.Tensor:
    """Weighted in-degree: deg[v] = sum of w over edges (u, v).

    Matches the reference's ``A.sum(axis=0)`` with A[src, dst] = w
    (src/datasets/elph.py:74).
    """
    if edge_weight is None:
        edge_weight = torch.ones(edge_index.shape[1], dtype=torch.float32,
                                 device=edge_index.device)
    deg = torch.zeros(num_nodes, dtype=torch.float32, device=edge_index.device)
    return deg.index_add_(0, edge_index[1].long(),
                          edge_weight.to(torch.float32))


def add_self_loops(edge_index: torch.Tensor,
                   edge_weight: Optional[torch.Tensor], num_nodes: int,
                   fill_value: float = 1.0
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Append (v, v) for every node: the output has E + n edges."""
    loop = torch.arange(num_nodes, dtype=edge_index.dtype,
                        device=edge_index.device)
    ei = torch.cat([edge_index, torch.stack([loop, loop])], dim=1)
    ew = None
    if edge_weight is not None:
        ew = torch.cat([edge_weight,
                        torch.full((num_nodes,), fill_value,
                                   dtype=edge_weight.dtype,
                                   device=edge_weight.device)])
    return ei, ew


def gcn_norm(edge_index: torch.Tensor, edge_weight: Optional[torch.Tensor],
             num_nodes: int, with_self_loops: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric GCN normalisation D^-1/2 (A + I) D^-1/2.

    PyG ``gcn_norm`` with default arguments (reference
    src/datasets/elph.py:99): self-loops are added with weight 1, degree is
    the weighted sum over incoming edges, and isolated nodes get
    deg_inv_sqrt = 0.  Returns (edge_index, norm_weight).
    """
    if edge_weight is None:
        edge_weight = torch.ones(edge_index.shape[1], dtype=torch.float32,
                                 device=edge_index.device)
    edge_weight = edge_weight.to(torch.float32)
    if with_self_loops:
        edge_index, edge_weight = add_self_loops(edge_index, edge_weight,
                                                 num_nodes)
    deg = degrees_from_edges(edge_index, edge_weight, num_nodes)
    deg_inv_sqrt = torch.where(deg > 0, torch.rsqrt(
        torch.where(deg > 0, deg, torch.ones_like(deg))),
        torch.zeros_like(deg))
    row, col = edge_index[0].long(), edge_index[1].long()
    norm_weight = deg_inv_sqrt[row] * edge_weight * deg_inv_sqrt[col]
    return edge_index, norm_weight
