"""Normalised-adjacency ops: gcn_norm, self-loops, degrees, the scatter
SpMM.

Torch counterparts of PyG ``gcn_norm`` as the reference uses it
(src/datasets/elph.py:99-107).  Edge lists are [2, E] int tensors.  The
SpMM runs through the plan's add path (``ops/segment_scan.py``
``PlanSpmm``) where a plan is staged; ``spmm`` is the scatter route,
taken under ``--use_plan false`` or when the plan would exceed
``max_gather_slots``.  Both add in a fixed order, so a step's SpMM and
its gradient are the same from run to run on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from subgraph_sketching_tpu_torch.ops.segment_scan import (
    ordered_segment_add, segment_order,
)


def degrees_from_edges(edge_index: torch.Tensor,
                       edge_weight: Optional[torch.Tensor],
                       num_nodes: int) -> torch.Tensor:
    """Weighted in-degree: deg[v] = sum of w over edges (u, v).

    Matches the reference's ``A.sum(axis=0)`` with A[src, dst] = w
    (src/datasets/elph.py:74).  Each node's weights are summed in edge
    order by K1's add (``segment_order``, ``ordered_segment_add``), so
    the degrees of non-integer weights, and the gcn_norm weights made
    from them, are the same bits in every process (every rank of a
    data-parallel run computes them), where ``index_add_``'s atomics on
    the card are not.
    """
    if edge_weight is None:
        edge_weight = torch.ones(edge_index.shape[1], dtype=torch.float32,
                                 device=edge_index.device)
    perm, ptr = segment_order(edge_index[1].long(), num_nodes)
    w = edge_weight.to(torch.float32)[perm, None]
    return ordered_segment_add(w, ptr, num_nodes)[:, 0]


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
    # 1 / sqrt (both correctly rounded) rather than rsqrt, so that the card
    # and the CPU give the same bits for the same degrees
    deg_inv_sqrt = torch.where(deg > 0, 1.0 / torch.sqrt(
        torch.where(deg > 0, deg, torch.ones_like(deg))),
        torch.zeros_like(deg))
    row, col = edge_index[0].long(), edge_index[1].long()
    norm_weight = deg_inv_sqrt[row] * edge_weight * deg_inv_sqrt[col]
    return edge_index, norm_weight


def edge_orders(edge_index: torch.Tensor, num_nodes: int) -> tuple:
    """The groupings ``spmm`` sums by: ``segment_order`` of the targets
    (the forward) and of the sources (the backward), for a caller that
    runs several ``spmm`` over one graph and sorts its edges once."""
    return (segment_order(edge_index[1].long(), num_nodes),
            segment_order(edge_index[0].long(), num_nodes))


def spmm(edge_index: torch.Tensor, edge_weight: torch.Tensor,
         x: torch.Tensor, num_nodes: int,
         orders: Optional[tuple] = None) -> torch.Tensor:
    """out[v] = sum over edges (u, v) of w_uv * x[u], by the scatter route:
    a row gather, the weight product and a sum at the destinations (the
    JAX package's ``spmm``; the reference's ``torch_sparse.spmm``,
    src/datasets/elph.py:103-107).  Differentiable in ``x``; the weights
    are data and get no gradient.  Each way the edges are grouped by a
    stable sort of their targets and summed by K1's add, so neither the
    result nor the gradient depends on the order atomics land in;
    ``orders`` (from ``edge_orders``) are those sorts made once, else
    each way sorts in the call.  It runs at ``x``'s dtype, the weights
    cast to it (bfloat16 or float16: K1's add of that dtype each way)."""
    return _ScatterSpmm.apply(x, edge_index[0].long(), edge_index[1].long(),
                              edge_weight.to(x.dtype), num_nodes, orders)


def _pull(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
          w: torch.Tensor, n: int,
          order: Optional[tuple] = None) -> torch.Tensor:
    """out[v] = sum over e with dst[e] = v of w[e] x[src[e]], in edge
    order (``order``: ``segment_order(dst, n)``, made here if None)."""
    perm, ptr = order if order is not None else segment_order(dst, n)
    v = x.index_select(0, src[perm]) * w[perm, None]
    return ordered_segment_add(v, ptr, n)


class _ScatterSpmm(torch.autograd.Function):
    """``spmm``: forward pulls along the edges, backward along the reversed
    edges (dL/dx = A^T g)."""

    @staticmethod
    def forward(ctx, x, src, dst, w, n, orders):
        ctx.save_for_backward(src, dst, w)
        ctx.n = n
        ctx.bwd_order = None if orders is None else orders[1]
        return _pull(x, src, dst, w, n,
                     None if orders is None else orders[0])

    @staticmethod
    def backward(ctx, g):
        src, dst, w = ctx.saved_tensors
        grad = _pull(g.contiguous(), dst, src, w, ctx.n, ctx.bwd_order)
        return grad, None, None, None, None, None
