"""ELPH sketch engine: hash-table construction and subgraph features.

Counterpart of the JAX package's sketch/elph.py (reference ``ElphHashes``,
src/hashing.py:48-323).  Hop-0 sketches are initialised on the host
(bit-exact 64-bit hashing, see node_hash.py); the hops run on the device
through the padded-tree plan, whose merge is K1, or by the scatter route
when no plan is given (``--use_plan false``):

  * k-hop propagation = segment-min (minhash) / segment-max (HLL) over the
    in-edges with the node's own row folded in (the reference adds explicit
    self-loops, src/hashing.py:148; min/max are idempotent, so the fold-in
    is equivalent).  ``propagate_minhash`` / ``propagate_hll`` compute one
    such hop by the scatter route (a row gather and a scatter_reduce), the
    definition every other route of the hop is held against.
  * subgraph features for a batch of links = lookups of per-hop sketch rows
    + the hop-pair inclusion-exclusion ladder (src/hashing.py:258-323).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from subgraph_sketching_tpu_torch.device import resolve_device
from subgraph_sketching_tpu_torch.ops.segment import segment_max, segment_min
from subgraph_sketching_tpu_torch.sketch.hll import hll_count, hll_init
from subgraph_sketching_tpu_torch.sketch.minhash import (
    jaccard, minhash_init, to_biased,
)
from subgraph_sketching_tpu_torch.sketch.params import SketchParams, Sketches


def propagate_minhash(mh: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                      num_nodes: int, mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """One hop of MinHash propagation by the scatter route:
    out[v] = min(mh[v], min_{(u,v)} mh[u]) on biased int32 lanes (the bias
    preserves uint32 order).  ``src``/``dst`` are [E] index tensors on
    ``mh``'s device, ``mask`` [E] bool selects real edges."""
    agg = segment_min(mh.index_select(0, src), dst, num_nodes, mask=mask)
    return torch.minimum(mh, agg)


def propagate_hll(hll: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  num_nodes: int, mask: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """One hop of HLL propagation by the scatter route:
    out[v] = max(hll[v], max_{(u,v)} hll[u]) on int8 registers."""
    agg = segment_max(hll.index_select(0, src), dst, num_nodes, mask=mask)
    return torch.maximum(hll, agg)


def initialise_sketches(num_nodes: int, params: SketchParams, device="cuda"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hop-0 state on ``device``: (minhash biased int32 [n,P], hll int8
    [n,m])."""
    dev = resolve_device(device)
    mh0 = to_biased(minhash_init(num_nodes, params.num_perm,
                                 params.minhash_seed))
    hll0 = hll_init(num_nodes, params.hll_p)
    return torch.from_numpy(mh0).to(dev), torch.from_numpy(hll0).to(dev)


def build_hash_tables(edge_index: np.ndarray, num_nodes: int,
                      params: SketchParams, plan=None,
                      hops_only: bool = False, device="cuda") -> Sketches:
    """All per-hop sketches + cardinalities (reference src/hashing.py:139-165).

    edge_index: [2, E] int (host).  plan: an ops.segment_scan plan for the
    same edges, whose device the hops run on (the plan route, merged by
    K1); with None the hops run on ``device`` by the scatter route
    (``propagate_minhash`` / ``propagate_hll``), as the JAX package runs
    them without a plan.
    hops_only: return K-row stacks (hops 1..K; hop 0 dropped) — the feature
    extractor accepts both layouts.
    """
    assert params.max_hops in (1, 2, 3), \
        f"hashing is not implemented for {params.max_hops} hops"
    if plan is not None:
        dev = plan.device

        def hop(t: torch.Tensor, op: str) -> torch.Tensor:
            return plan.reduce(t, op)
    else:
        dev = resolve_device(device)
        ei = torch.from_numpy(np.asarray(edge_index, dtype=np.int64)).to(dev)

        def hop(t: torch.Tensor, op: str) -> torch.Tensor:
            step = propagate_minhash if op == "min" else propagate_hll
            return step(t, ei[0], ei[1], num_nodes)
    mh0, hll0 = initialise_sketches(num_nodes, params, dev)
    mhs, hlls, cards = [mh0], [hll0], []
    for _ in range(params.max_hops):
        mhs.append(hop(mhs[-1], "min"))
        hlls.append(hop(hlls[-1], "max"))
        cards.append(hll_count(hlls[-1], params.hll_p))
    if hops_only:
        mhs, hlls = mhs[1:], hlls[1:]
    return Sketches(minhash=torch.stack(mhs), hll=torch.stack(hlls),
                    cards=torch.stack(cards, dim=1))


def _pairwise_intersections(links: torch.Tensor, sk: Sketches,
                            params: SketchParams) -> torch.Tensor:
    """intersections[b, k1-1, k2-1] = |N_k1(u) ∩ N_k2(v)| estimates.

    jaccard(minhash_u^k1, minhash_v^k2) * hll_count(union) for every hop pair
    (reference src/hashing.py:167-189).
    """
    K = params.max_hops
    u, v = links[:, 0], links[:, 1]
    # the stack holds hops 0..K, or hops 1..K only (hops_only)
    s = sk.minhash.shape[0] - K
    mh_u = sk.minhash[s:, u, :]                             # [K, B, P]
    mh_v = sk.minhash[s:, v, :]
    hll_u = sk.hll[s:, u, :]                                # [K, B, m]
    hll_v = sk.hll[s:, v, :]
    jac = jaccard(mh_u[:, None], mh_v[None, :])             # [K, K, B]
    unions = torch.maximum(hll_u[:, None], hll_v[None, :])  # [K, K, B, m]
    inter = jac * hll_count(unions, params.hll_p)
    return inter.permute(2, 0, 1)                           # [B, K, K]


def subgraph_features(links: torch.Tensor, sk: Sketches,
                      params: SketchParams) -> torch.Tensor:
    """Structure features for a batch of links: [B, k(k+2)] float32.

    (Reference src/hashing.py:258-323.)  ``links`` is [B, 2] int64 on the
    sketches' device.
    """
    inter = _pairwise_intersections(links, sk, params)      # [B, K, K]
    cu = sk.cards[links[:, 0]]                              # [B, K] |N_k(u)|
    cv = sk.cards[links[:, 1]]                              # [B, K] |N_k(v)|
    return inclusion_exclusion_ladder(inter, cu, cv, params)


def inclusion_exclusion_ladder(inter: torch.Tensor, cu: torch.Tensor,
                               cv: torch.Tensor,
                               params: SketchParams) -> torch.Tensor:
    """Convert hop-pair intersection estimates + per-hop cardinalities into
    disjoint (d_u, d_v) region counts, in the exact column order of
    LABEL_LOOKUP (reference src/hashing.py:276-320, including its quirk of
    double-subtracting f(1,1) in the (2,0) column).

    inter: [B, K, K]; cu, cv: [B, K].
    """
    K = params.max_hops

    def I(k1, k2):  # noqa: E743 — intersection estimate, 1-indexed hops
        return inter[:, k1 - 1, k2 - 1]

    f = []  # built in LABEL_LOOKUP column order
    f01 = I(1, 1)                                          # (1,1)
    f.append(f01)
    if K == 1:
        f.append(cv[:, 0] - f01)                           # (0,1)
        f.append(cu[:, 0] - f01)                           # (1,0)
    elif K == 2:
        f21 = I(2, 1) - f01
        f12 = I(1, 2) - f01
        f22 = I(2, 2) - f01 - f21 - f12
        f_0_1 = cv[:, 0] - f01 - f21
        f_1_0 = cu[:, 0] - f01 - f12
        f_0_2 = cv[:, 1] - (f01 + f21 + f12 + f22 + f_0_1)
        f_2_0 = cu[:, 1] - f01 - (f01 + f21 + f12 + f22) - f_1_0
        f += [f21, f12, f22, f_0_1, f_1_0, f_0_2, f_2_0]
    else:  # K == 3
        f21 = I(2, 1) - f01
        f12 = I(1, 2) - f01
        f22 = I(2, 2) - f01 - f21 - f12
        f31 = I(3, 1) - f01 - f21
        f13 = I(1, 3) - f01 - f12
        s4 = f01 + f21 + f12 + f22                          # sum of first 4
        f32 = I(3, 2) - s4 - f31
        f23 = I(2, 3) - s4 - f13
        s8 = s4 + f31 + f13 + f32 + f23                     # sum of first 8
        f33 = I(3, 3) - s8
        f_0_1 = cv[:, 0] - f01 - f21 - f31
        f_1_0 = cu[:, 0] - f01 - f12 - f13
        s5 = s4 + f31                                       # sum of first 5
        f_0_2 = cv[:, 1] - s5 - f32 - f_0_1
        f_2_0 = cu[:, 1] - s5 - f23 - f_1_0
        s9 = s8 + f33                                       # sum of first 9
        f_0_3 = cv[:, 2] - s9 - f_0_1 - f_0_2
        f_3_0 = cu[:, 2] - s9 - f_1_0 - f_2_0
        f += [f21, f12, f22, f31, f13, f32, f23, f33,
              f_0_1, f_1_0, f_0_2, f_2_0, f_0_3, f_3_0]

    feats = torch.stack(f, dim=1).to(torch.float32)

    if not params.use_zero_one:
        # positive edges at distance 1 from u must be at distance <= 2 from v,
        # so (0,1)/(1,0) (and (0,2)/(2,0) at 3 hops) carry no signal
        # (src/hashing.py:310-317); knocked out for K >= 2 only.
        knockout = {2: [4, 5], 3: [4, 5, 11, 12]}.get(K)
        if knockout:
            feats[:, knockout] = 0.0
    if params.floor_sf:
        feats = torch.clamp(feats, min=0.0)  # counts can't be negative (:319-320)
    return feats


def pack_sketches(sk: Sketches, params: SketchParams) -> torch.Tensor:
    """[n, K*(P + m/4)] int32: per node, hops 1..K of (biased MinHash
    lanes ‖ HLL registers packed four to an int32 lane, a ``view``),
    concatenated, so that one row gather per endpoint fetches every hop
    (the JAX package's ``pack_sketches``; its MinHash lanes are the uint32
    ones, here biased int32, and its packed HLL lanes the same bits as
    uint32)."""
    K = params.max_hops
    s = sk.minhash.shape[0] - K  # 1 for hops 0..K stacks, 0 for hops-only
    parts = []
    for k in range(K):
        parts.append(sk.minhash[s + k])
        parts.append(sk.hll[s + k].contiguous().view(torch.int32))
    return torch.cat(parts, dim=1)


def _unpack_rows(rows: torch.Tensor, params: SketchParams):
    """Split gathered packed rows back into ([K, B, P] MinHash, [K, B, m]
    HLL)."""
    P = params.num_perm
    stride = P + params.m // 4
    mh, hll = [], []
    for k in range(params.max_hops):
        seg = rows[:, k * stride:(k + 1) * stride]
        mh.append(seg[:, :P])
        hll.append(seg[:, P:].contiguous().view(torch.int8))
    return torch.stack(mh), torch.stack(hll)


def subgraph_features_packed(links: torch.Tensor, packed: torch.Tensor,
                             cards: torch.Tensor,
                             params: SketchParams) -> torch.Tensor:
    """Structure features from a hop-packed table (``pack_sketches``): one
    row gather per endpoint, then the estimator and the
    inclusion-exclusion ladder of :func:`subgraph_features`, whose values
    it gives."""
    u, v = links[:, 0], links[:, 1]
    mh_u, hll_u = _unpack_rows(packed[u], params)
    mh_v, hll_v = _unpack_rows(packed[v], params)
    jac = jaccard(mh_u[:, None], mh_v[None, :])             # [K, K, B]
    unions = torch.maximum(hll_u[:, None], hll_v[None, :])  # [K, K, B, m]
    inter = (jac * hll_count(unions, params.hll_p)).permute(2, 0, 1)
    return inclusion_exclusion_ladder(inter, cards[u], cards[v], params)


def subgraph_features_batched(links, sk: Sketches, params: SketchParams,
                              batch_size: int = 1 << 18) -> torch.Tensor:
    """Subgraph features over link chunks of ``batch_size`` to bound device
    memory (reference src/hashing.py:258-270).  ``links`` is any [N, 2]
    int array; the result is [N, sf_dim] float32 on the sketches' device."""
    dev = sk.minhash.device
    links = torch.as_tensor(np.asarray(links), dtype=torch.int64)
    if len(links) == 0:
        return torch.zeros((0, params.sf_dim), dtype=torch.float32,
                           device=dev)
    return torch.cat([subgraph_features(links[s:s + batch_size].to(dev), sk,
                                        params)
                      for s in range(0, len(links), batch_size)])
