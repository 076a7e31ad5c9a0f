"""The graph, its node features and the supervision links of a cell, made
on the device from the seed.

Endpoints follow ``chip_smoke.py``'s ``_power_law_nodes`` recipe, here in
torch: the node of rank r is drawn with probability proportional to
r^-exponent, the ranks a random permutation of the nodes.  Each draw
comes from its own stream (``stream``), so one input's draws never shift
another's.  Every seed makes the same numbers of nodes, edges and links.

Two graph kinds, named by the configuration's ``graph.kind``:

  ``multi``   ogbl-collab's co-authorship multigraph as ``write_collab``
              makes it: power-law endpoints, a self-loop moved to the next
              node, repeated pairs kept, weights geometric(0.7) (mostly 1);
  ``simple``  a citation graph: distinct unordered pairs, no self-loops,
              so the undirected message graph the loader would build has
              every weight 1.
"""

from __future__ import annotations

from typing import Dict

import torch

_MIX = 0x9E3779B97F4A7C15 & ((1 << 63) - 1)


def stream(seed: int, name: str, device) -> torch.Generator:
    """A generator on ``device`` for one named input of one seed."""
    tag = sum((i + 1) * ord(c) for i, c in enumerate(name))
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * _MIX + tag * 1_000_003) % (1 << 63))
    return g


def power_law_nodes(g: torch.Generator, n: int, size: int, exponent: float,
                    device) -> torch.Tensor:
    """[size] int64 node ids, rank r drawn with probability ∝ r^-exponent."""
    cdf = torch.cumsum(torch.arange(1, n + 1, dtype=torch.float64,
                                    device=device) ** -exponent, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(size, generator=g, dtype=torch.float64, device=device)
    ranks = torch.searchsorted(cdf, u).clamp_(max=n - 1)
    perm = torch.randperm(n, generator=g, device=device)
    return perm[ranks]


def _endpoints(g, n: int, size: int, exponent: float, device):
    src = power_law_nodes(g, n, size, exponent, device)
    dst = power_law_nodes(g, n, size, exponent, device)
    dst = torch.where(dst == src, (dst + 1) % n, dst)
    return src, dst


def make_graph(spec: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``edges`` [2, E] int64 (one direction each), ``weight`` [E] float32
    or None, ``x`` [n, d] float32, for the configuration's ``graph``."""
    n, e, d = spec["nodes"], spec["edges"], spec["features"]
    g = stream(seed, "edges", device)
    if spec["kind"] == "multi":
        src, dst = _endpoints(g, n, e, spec["exponent"], device)
        w = torch.empty(e, dtype=torch.float32, device=device)
        w.geometric_(spec["weight_p"], generator=g)
        edges, weight = torch.stack([src, dst]), w
    elif spec["kind"] == "simple":
        keys = torch.empty(0, dtype=torch.int64, device=device)
        while keys.numel() < e:
            src, dst = _endpoints(g, n, e + e // 16 + 16, spec["exponent"],
                                  device)
            lo, hi = torch.minimum(src, dst), torch.maximum(src, dst)
            keys = torch.unique(torch.cat([keys, lo * n + hi]))
        keys = keys[torch.randperm(keys.numel(), generator=g,
                                   device=device)[:e]]
        # orient each pair by a coin, as citations point either way
        flip = torch.rand(e, generator=g, device=device) < 0.5
        a, b = keys // n, keys % n
        edges = torch.stack([torch.where(flip, b, a), torch.where(flip, a, b)])
        weight = None
    else:
        raise ValueError(f"graph kind {spec['kind']!r}: multi or simple")
    gx = stream(seed, "features", device)
    if spec["feature_dist"] == "normal":
        x = torch.randn(n, d, generator=gx, device=device)
    elif spec["feature_dist"] == "uniform":
        x = torch.rand(n, d, generator=gx, device=device) * 2 - 1
    else:
        raise ValueError(f"feature_dist {spec['feature_dist']!r}")
    return {"edges": edges, "weight": weight, "x": x}


def symmetric(edges: torch.Tensor, weight, n: int, sort: bool):
    """Both directions of every edge (weights repeated); with ``sort`` in
    (src, dst) order, as the loader's coalesce leaves a simple graph."""
    sym = torch.cat([edges, edges.flip(0)], dim=1)
    w = None if weight is None else torch.cat([weight, weight])
    if sort:
        order = torch.argsort(sym[0] * n + sym[1])
        sym = sym[:, order]
        w = None if w is None else w[order]
    return sym, w


def supervision(spec: dict, edges: torch.Tensor, n: int, seed: int,
                device):
    """(pos [Np, 2], neg [Nn, 2]) int64 for the configuration's
    ``supervision``: positives all message edges (``count`` "all") or a
    seeded subset of ``count``; negatives ``per_positive`` to each
    positive, ``same_source`` (citation2's rule: the positive's source, a
    uniform destination, blocks laid out after all positives) or
    ``uniform`` (both endpoints uniform, a self-pair moved to the next
    node; not rejected against the graph)."""
    g = stream(seed, "supervision", device)
    e = edges.shape[1]
    if spec["count"] == "all":
        pos = edges.t().contiguous()
    else:
        take = torch.randperm(e, generator=g, device=device)[:spec["count"]]
        pos = edges[:, take].t().contiguous()
    k = spec["per_positive"]
    if spec["negatives"] == "same_source":
        src = pos[:, 0].repeat_interleave(k)
        dst = torch.randint(0, n, (len(src),), generator=g, device=device)
    elif spec["negatives"] == "uniform":
        src = torch.randint(0, n, (len(pos) * k,), generator=g, device=device)
        dst = torch.randint(0, n, (len(pos) * k,), generator=g, device=device)
        dst = torch.where(dst == src, (dst + 1) % n, dst)
    else:
        raise ValueError(f"negatives {spec['negatives']!r}")
    return pos, torch.stack([src, dst], dim=1)
