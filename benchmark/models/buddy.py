"""BUDDY: the program's ``BuddyTrainer`` and the FLOPs of its links (SIGN
blocks on both endpoints, then the link head)."""

from __future__ import annotations

from typing import List

from benchmark.counts import Layer, dense_flops


def trainer(cfg, ds, device):
    from subgraph_sketching_tpu_torch.train.loops import BuddyTrainer
    return BuddyTrainer(cfg, ds, ds.x.shape[1], device=device)


def shape(conf: dict, trainer) -> dict:
    """What the counts need beyond the configuration's widths: nothing."""
    return {}


def head_layers(sf_dim: int, feat: int, hidden: int,
                sign_k: int) -> List[Layer]:
    """BUDDY's dense layers per link (SIGN blocks on both endpoints)."""
    blocks = [(2, feat, hidden, False)] * (sign_k + 1)
    return ([(1, sf_dim, sf_dim, False)] + blocks
            + [(2, hidden * (sign_k + 1), hidden, True),
               (1, hidden, hidden, True), (1, sf_dim + hidden, 1, True)])


def flops(shape: dict, links: int, train: bool) -> int:
    layers = head_layers(shape["sf_dim"], shape["features"],
                         shape["hidden"], shape["sign_k"])
    return dense_flops(layers, train) * links
