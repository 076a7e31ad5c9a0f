"""ELPH: the program's ``ElphTrainer`` and the FLOPs of its links (the
link head) and, in a training step, of its full-graph GCN."""

from __future__ import annotations

from typing import List

from benchmark.counts import Layer, dense_flops


def trainer(cfg, ds, device):
    from subgraph_sketching_tpu_torch.train.loops import ElphTrainer
    return ElphTrainer(cfg, ds, ds.x.shape[1], device=device)


def shape(conf: dict, trainer) -> dict:
    """The normalised adjacency's entries: gcn_norm adds one self-loop a
    node to the coalesced edges."""
    data = trainer._data["train"]
    return {"nnz": int(data["edge_index"].shape[1])
            + conf["graph"]["nodes"]}


def head_layers(sf_dim: int, hidden: int) -> List[Layer]:
    """ELPH's link predictor per link; its node rows come from the GCN,
    so the Hadamard product's layer needs its input's gradient."""
    return [(1, sf_dim, sf_dim, False), (1, hidden, hidden, True),
            (1, sf_dim + hidden, 1, True)]


def gcn_flops(nodes: int, nnz: int, feat: int, hidden: int, hops: int,
              train: bool) -> int:
    """The full-graph GCN: per hop x W over every node and the SpMM over
    the normalised adjacency's ``nnz`` entries (self-loops included); in
    training each SpMM runs again transposed for the gradient."""
    layers = [(nodes, feat if k == 0 else hidden, hidden, k > 0)
              for k in range(hops)]
    spmm = 2 * nnz * hidden * hops * (2 if train else 1)
    return dense_flops(layers, train) + spmm


def flops(shape: dict, links: int, train: bool) -> int:
    """A training step adds its full-graph GCN once."""
    head = dense_flops(head_layers(shape["sf_dim"], shape["hidden"]),
                       train) * links
    if not train:
        return head
    return head + gcn_flops(shape["nodes"], shape["nnz"], shape["features"],
                            shape["hidden"], shape["hops"], True)
