"""Edge-sharded sketch construction and lane-sharded features (the JAX
package's parallel/dist_sketch.py).

Min/max sketch propagation is idempotent and commutative, so graph
partitioning composes with collectives:

  * edge-sharded propagation (``graph`` axis): each rank reduces its block
    of the edges through a plan over the whole replicated table (its
    own rows folded in, merged by K1), then one MIN (MinHash) and one MAX
    (HLL) all-reduce over the graph axis merges the partials; the
    sketches stay replicated;
  * lane-sharded features (``lane`` axis): the MinHash permutations and
    HLL registers are split over the ranks; the match counts and the
    register statistics are summed over the lane axis into the HLL
    estimator core, and the ladder runs replicated.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from subgraph_sketching_tpu_torch.ops.segment_scan import make_auto_plan
from subgraph_sketching_tpu_torch.parallel.collectives import all_reduce
from subgraph_sketching_tpu_torch.sketch.elph import (
    inclusion_exclusion_ladder, initialise_sketches,
)
from subgraph_sketching_tpu_torch.sketch.hll import (
    hll_count, hll_count_from_stats, pow2_neg,
)
from subgraph_sketching_tpu_torch.sketch.params import SketchParams, Sketches


def pad_edges(edge_index: np.ndarray, d: int) -> tuple:
    """[2, E] edges padded with (0, 0) to a multiple of ``d`` (JAX's
    ``Graph.padded_edges`` for a graph axis of ``d``), and the mask of the
    real ones."""
    ei = np.asarray(edge_index)
    e = ei.shape[1]
    pad = (-e) % d
    ei = np.concatenate([ei, np.zeros((2, pad), ei.dtype)], axis=1)
    return ei, np.arange(e + pad) < e


def weighted_edge_block(edge_index: torch.Tensor, weight: torch.Tensor,
                        mesh, axis: str = "graph") -> tuple:
    """This rank's block of weighted edges (the gcn_norm'd edges of ELPH's
    GCN, whose degrees are the whole graph's) over ``axis``: padded as
    :func:`pad_edges` pads them, cut as :func:`edge_block` cuts them, on
    the edges' device."""
    ei, mask = pad_edges(edge_index.cpu().numpy(), mesh.axis_size(axis))
    w = np.concatenate([weight.cpu().numpy(), np.zeros(
        ei.shape[1] - edge_index.shape[1], np.float32)])
    blk = mesh.block_of(ei.shape[1], axis)
    keep = mask[blk]
    dev = edge_index.device
    return (torch.from_numpy(ei[:, blk][:, keep]).to(dev),
            torch.from_numpy(w[blk][keep]).to(dev))


def edge_block(edge_index: np.ndarray, mask: Optional[np.ndarray], mesh,
               axis: str = "graph") -> np.ndarray:
    """This rank's contiguous block of the [2, E] edges over ``axis`` (E
    a multiple of the axis, as ``Graph.padded_edges`` pads it), less the
    edges ``mask`` marks as padding."""
    D, r = mesh.axis_size(axis), mesh.axis_index(axis)
    ei = np.asarray(edge_index)
    E = ei.shape[1]
    if E % D:
        raise ValueError(f"pad the edges ({E}) to a multiple of the mesh's "
                         f"{axis!r} axis ({D})")
    blk = slice(r * E // D, (r + 1) * E // D)
    ei = ei[:, blk]
    if mask is not None:
        ei = ei[:, np.asarray(mask)[blk]]
    return ei


def edge_sharded_build_hash_tables(
        edge_index: np.ndarray, num_nodes: int, params: SketchParams, mesh,
        init_minhash: Optional[torch.Tensor] = None,
        init_hll: Optional[torch.Tensor] = None,
        mask: Optional[np.ndarray] = None, axis: str = "graph",
        max_gather_slots: Optional[int] = None) -> Sketches:
    """Per-hop sketches with the edges sharded over ``axis`` and the state
    replicated: each rank's plan over its edge block (``edge_block``,
    built once), its reduce merged by K1, then a MIN / MAX all-reduce over
    the axis.  ``init_*`` default to ``initialise_sketches``.  Returns the
    whole [K+1, n, w] stacks on every rank."""
    dev = mesh.device
    if init_minhash is None:
        init_minhash, init_hll = initialise_sketches(num_nodes, params, dev)
    plan = make_auto_plan(edge_block(edge_index, mask, mesh, axis),
                          num_nodes, max_slots=max_gather_slots, device=dev)
    group = mesh.group(axis)
    mhs, hlls, cards = [init_minhash.to(dev)], [init_hll.to(dev)], []
    for _ in range(params.max_hops):
        # the plan folds the (replicated) rows in, so the merge over the
        # ranks is min(x, every shard's in-neighbours)
        mh = plan.reduce(mhs[-1], "min")
        hll = plan.reduce(hlls[-1], "max")
        works = [all_reduce(mh, "min", group, async_op=True),
                 all_reduce(hll, "max", group, async_op=True)]
        for w in works:
            if w is not None:
                w.wait()
        mhs.append(mh)
        hlls.append(hll)
        cards.append(hll_count(hll, params.hll_p))
    return Sketches(minhash=torch.stack(mhs), hll=torch.stack(hlls),
                    cards=torch.stack(cards, dim=1))


def lane_slice(sk: Sketches, params: SketchParams, mesh,
               axis: str = "lane") -> Sketches:
    """This rank's lane block of full-width stacks (JAX's
    ``P(None, None, "lane")`` of a replicated table); stacks already
    narrower than the full width are taken as the rank's block."""
    L, i = mesh.axis_size(axis), mesh.axis_index(axis)
    if L == 1 or sk.minhash.shape[-1] != params.num_perm:
        return sk
    pw, mw = params.num_perm // L, params.m // L
    return Sketches(minhash=sk.minhash[..., i * pw:(i + 1) * pw],
                    hll=sk.hll[..., i * mw:(i + 1) * mw], cards=sk.cards)


def lane_cards(regs: torch.Tensor, p: int, group=None) -> torch.Tensor:
    """[...] cardinalities of [..., m / L] register slices: the register
    statistics summed over ``group`` (the lane axis's; None where the
    rank holds the whole width), then the estimator core."""
    nz = all_reduce((regs == 0).to(torch.float32).sum(dim=-1), group=group)
    ps = all_reduce(pow2_neg(regs).sum(dim=-1), group=group)
    return hll_count_from_stats(nz, ps, p)


def lane_summed_features(mh_u: torch.Tensor, mh_v: torch.Tensor,
                         hll_u: torch.Tensor, hll_v: torch.Tensor,
                         cu: torch.Tensor, cv: torch.Tensor,
                         params: SketchParams, group=None) -> torch.Tensor:
    """The feature math on assembled rows, shared by the lane-sharded and
    the node-sharded features: [K, B, P/L] MinHash and [K, B, m/L] HLL
    rows of each link's two ends, and their [B, K] cardinalities.  The
    match counts and the union registers' statistics are summed over
    ``group`` (the lane axis's, or None) into the estimator core; the
    ladder then runs as on one device."""
    match = (mh_u[:, None] == mh_v[None, :]).to(torch.float32).sum(dim=-1)
    jac = all_reduce(match, group=group) / params.num_perm     # [K, K, B]
    unions = torch.maximum(hll_u[:, None], hll_v[None, :])
    inter = jac * lane_cards(unions, params.hll_p, group)
    return inclusion_exclusion_ladder(inter.permute(2, 0, 1), cu, cv, params)


def lane_sharded_subgraph_features(links: torch.Tensor, sk: Sketches,
                                   params: SketchParams, mesh,
                                   axis: str = "lane") -> torch.Tensor:
    """Subgraph features with the sketch width sharded over ``axis``:
    ``sk`` holds this rank's [K+1, n, P/L] MinHash and [K+1, n, m/L] HLL
    blocks (``lane_slice`` takes them from whole stacks).  Each hop's
    register statistics are summed over the axis for the cardinalities,
    then :func:`lane_summed_features`.  Requires num_perm % L == 0 and
    m % L == 0."""
    L = mesh.axis_size(axis)
    if params.num_perm % L or params.m % L:
        raise ValueError(f"lane axis size {L} must divide num_perm="
                         f"{params.num_perm} and m={params.m}")
    sk = lane_slice(sk, params, mesh, axis)
    group = mesh.group(axis)
    # hops 0..K stacks slice off hop 0; K-row hops-only stacks as they are
    s = sk.minhash.shape[0] - params.max_hops
    links = torch.as_tensor(links, device=sk.minhash.device).long()
    u, v = links[:, 0], links[:, 1]
    hll_u, hll_v = sk.hll[s:, u, :], sk.hll[s:, v, :]
    cu = lane_cards(hll_u, params.hll_p, group).T               # [B, K]
    cv = lane_cards(hll_v, params.hll_p, group).T
    return lane_summed_features(sk.minhash[s:, u, :], sk.minhash[s:, v, :],
                                hll_u, hll_v, cu, cv, params, group)


def lane_sharded_subgraph_features_batched(
        links, sk: Sketches, params: SketchParams, mesh,
        axis: str = "lane", batch_size: int = 1 << 18) -> torch.Tensor:
    """:func:`lane_sharded_subgraph_features` over chunks of ``batch_size``
    links (power-of-two buckets, the tail padded with (0, 0) links, as the
    JAX package's ``lane_sharded_subgraph_features_batched``), so the
    [K, K, B, m/L] union tensor stays bounded."""
    dev = sk.minhash.device
    links = np.asarray(links)
    n = links.shape[0]
    if n == 0:
        return torch.zeros((0, params.sf_dim), dtype=torch.float32,
                           device=dev)
    bucket = 1 << max(8, (max(1, min(n, batch_size)) - 1).bit_length())
    bucket = min(bucket, batch_size)
    out = []
    for i in range(0, n, bucket):
        chunk = links[i:i + bucket]
        pad = bucket - len(chunk)
        if pad:
            chunk = np.concatenate(
                [chunk, np.zeros((pad, 2), dtype=chunk.dtype)])
        sf = lane_sharded_subgraph_features(
            torch.from_numpy(chunk.astype(np.int64)).to(dev), sk, params,
            mesh, axis=axis)
        out.append(sf[:bucket - pad])
    return torch.cat(out)
