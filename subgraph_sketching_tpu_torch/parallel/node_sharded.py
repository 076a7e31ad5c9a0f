"""Node-partitioned (memory-sharded) sketch state with halo exchange (the
JAX package's parallel/node_sharded.py).

The citation2-scale configuration needs sketch tables that never sit
whole on one device.  The nodes are laid out at row positions
``perm[v]`` (a locality order, :func:`make_node_partition`) and cut into
D contiguous shards over the mesh's ``graph`` axis: each rank holds only
its [S, width] rows of the MinHash, HLL and cardinality stacks, S =
``padded_nodes / D``.

Per hop (reference semantics: src/hashing.py:139-165, the elementwise
min / max over the closed in-neighbourhood), on each rank:

  1. it gathers the boundary ("halo") rows that every other rank needs
     from its own rows and issues the exchange (``parallel/collectives.py``
     ``halo_exchange``: ``all_to_all_single``, or on gloo with CUDA
     tensors one MIN / MAX all-reduce padded with the identity);
  2. while that is in flight it reduces its local-source edges (source
     and destination both its own) through a plan over its [S, w] rows,
     its own rows folded in, ending in K1;
  3. it reduces its halo-source edges through a second plan, over the
     received [D·H, w] buffer, folded into step 2's result by K1.

Min and max are idempotent and commutative, so the sharded reduction is
bit-equal to the single-device one: in node order, the stacks are the
single-device stacks.  Both plans are built once per graph
(:class:`ShardedHop`), under ``max_gather_rows`` chunk-streamed
(``ChunkedSegmentPlan``, JAX's ``_chunked_seg``).  With a ``lane`` axis
the width is sharded too, and each lane shard runs the same hop on its
slice: min and max are elementwise, so the lanes exchange nothing but
the cardinality estimator's register statistics.

The host side (:class:`NodePartitionPlan`, :func:`balanced_partition`,
:func:`make_node_partition`) is this package's own copy of the JAX
package's numpy, and gives the same arrays.  MinHash rows are biased
int32 here (``Sketches``), so the padding identity of min is the int32
maximum (the image of uint32 0xFFFFFFFF); the HLL rows that
``pad_init`` pads are 0, and the HLL send buffer pads with -128, the
int8 minimum.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from subgraph_sketching_tpu_torch.ops.segment_scan import make_auto_plan
from subgraph_sketching_tpu_torch.parallel.collectives import (
    all_reduce, halo_exchange,
)
from subgraph_sketching_tpu_torch.parallel.dist_sketch import (
    lane_cards, lane_summed_features,
)
from subgraph_sketching_tpu_torch.sketch.hll import hll_init_rows
from subgraph_sketching_tpu_torch.sketch.minhash import (
    minhash_init_rows, to_biased,
)
from subgraph_sketching_tpu_torch.sketch.params import SketchParams, Sketches


@dataclass(frozen=True)
class NodePartitionPlan:
    """Host-built static partition of nodes and edges for D ranks.

    ``perm[v]`` is node v's row position in the padded sharded tables; the
    node lives on rank ``perm[v] // shard_size`` of the graph axis.  Edge
    (u, v) is reduced by v's owner; if u is remote it reads u's row from
    the halo buffer.  With ``method='locality'`` the positions follow a
    low-boundary partition (:func:`balanced_partition`).
    """

    num_nodes: int
    n_dev: int
    shard_size: int          # S: nodes per rank (n padded to D*S)
    halo_width: int          # H: max rows any rank sends to any other
    # [D, D, H] local row indices rank s sends to rank d (0-padded)
    send_idx: np.ndarray
    send_mask: np.ndarray    # [D, D, H] bool
    # per-rank edge lists, padded to uniform length with mask=False
    local_src: np.ndarray    # [D, E_loc] local row index of src
    local_dst: np.ndarray    # [D, E_loc] local row index of dst
    local_mask: np.ndarray   # [D, E_loc]
    halo_src: np.ndarray     # [D, E_halo] index into the [D*H] halo buffer
    halo_dst: np.ndarray     # [D, E_halo] local row index of dst
    halo_mask: np.ndarray    # [D, E_halo]
    # [num_nodes] int32: node id -> padded row position (the identity for
    # method='contiguous'); queries translate through it
    perm: np.ndarray = None

    @property
    def padded_nodes(self) -> int:
        return self.n_dev * self.shard_size

    @property
    def is_identity_perm(self) -> bool:
        return self.perm is None or len(self.perm) == 0 or (
            self.perm[0] == 0 and self.perm[-1] == self.num_nodes - 1
            and np.array_equal(
                self.perm, np.arange(self.num_nodes, dtype=self.perm.dtype)))

    @property
    def halo_rows_per_dev(self) -> int:
        """Padded halo rows each rank receives per hop: (D-1)*H rows ride
        the exchange (every sender-receiver pair is padded to the widest
        pair, H)."""
        return (self.n_dev - 1) * self.halo_width

    def pad_init(self, init_mh: np.ndarray, init_hll: np.ndarray):
        """Lay hop-0 sketch rows out in partition order, padded to
        ``padded_nodes`` rows with the reduction identities (MinHash:
        its dtype's maximum, uint32 0xFFFFFFFF or the biased int32
        0x7FFFFFFF; HLL: 0)."""
        if self.is_identity_perm:
            pad = self.padded_nodes - init_mh.shape[0]
            if pad == 0:
                return init_mh, init_hll
            mh = np.concatenate(
                [init_mh, np.full((pad, init_mh.shape[1]),
                                  np.iinfo(init_mh.dtype).max,
                                  init_mh.dtype)])
            hll = np.concatenate(
                [init_hll, np.zeros((pad, init_hll.shape[1]),
                                    init_hll.dtype)])
            return mh, hll
        mh = np.full((self.padded_nodes, init_mh.shape[1]),
                     np.iinfo(init_mh.dtype).max, init_mh.dtype)
        hll = np.zeros((self.padded_nodes, init_hll.shape[1]),
                       init_hll.dtype)
        mh[self.perm] = init_mh
        hll[self.perm] = init_hll
        return mh, hll

    def to_node_order(self, table: np.ndarray) -> np.ndarray:
        """Rows of a padded sharded table in original node-id order
        (axis -2 is the node axis, as in the Sketches layouts)."""
        perm = (np.arange(self.num_nodes) if self.perm is None else self.perm)
        return np.take(np.asarray(table), perm, axis=-2)

    def shard_init(self, params: SketchParams, index: int, lane: int = 0,
                   lanes: int = 1):
        """Hop-0 rows of shard ``index`` alone (biased int32 MinHash, int8
        HLL; [S, num_perm / lanes] and [S, m / lanes], lane block
        ``lane``), padded as ``pad_init`` pads: hop 0 is a function of
        the node id, so no rank builds the whole table."""
        S = self.shard_size
        node = np.full(S, -1, np.int64)
        perm = (np.arange(self.num_nodes) if self.perm is None
                else np.asarray(self.perm, np.int64))
        mine = (perm >= index * S) & (perm < (index + 1) * S)
        node[perm[mine] - index * S] = np.flatnonzero(mine)
        real = node >= 0
        pw, mw = params.num_perm // lanes, params.m // lanes
        mh = np.full((S, pw), np.iinfo(np.int32).max, np.int32)
        hll = np.zeros((S, mw), np.int8)
        ids = node[real]
        mh[real] = to_biased(minhash_init_rows(
            ids, params.num_perm, params.minhash_seed))[:, lane * pw:
                                                        (lane + 1) * pw]
        hll[real] = hll_init_rows(ids, params.hll_p)[:, lane * mw:
                                                     (lane + 1) * mw]
        return mh, hll


def _padded_halo_width(src: np.ndarray, dst: np.ndarray, part: np.ndarray,
                       n_dev: int) -> int:
    """H = max over (sender, receiver) pairs of unique boundary source
    nodes: the exchange pads every pair to this width, so (D-1)*H rows
    ride it per receiver per hop.  The partitioner minimises it."""
    ps, pd = part[src], part[dst]
    remote = ps != pd
    if not remote.any():
        return 0
    n = len(part)
    key = (pd[remote].astype(np.int64) * n_dev + ps[remote]) * (n + 1) \
        + src[remote]
    sd = np.unique(key) // (n + 1)
    return int(np.bincount(sd, minlength=n_dev * n_dev).max())


def _rank_within_groups(groups: np.ndarray) -> np.ndarray:
    """rank[i] = #j<i with groups[j] == groups[i] (order-preserving)."""
    order = np.argsort(groups, kind="stable")
    g = groups[order]
    starts = np.flatnonzero(np.concatenate([[True], g[1:] != g[:-1]]))
    within = np.arange(len(g)) - np.repeat(
        starts, np.diff(np.concatenate([starts, [len(g)]])))
    rank = np.empty(len(g), np.int64)
    rank[order] = within
    return rank


def _refine_partition(src: np.ndarray, dst: np.ndarray, part: np.ndarray,
                      n_dev: int, slack: float = 0.0625,
                      passes: int = 32) -> np.ndarray:
    """Balanced label-propagation refinement: repeatedly move boundary
    nodes to the shard holding most of their neighbours, under per-shard
    size caps (``slack`` headroom over n/D).  Keeps the best-seen
    assignment by padded halo width, so it never returns something worse
    than its input."""
    n = len(part)
    S0 = -(-n // n_dev)
    s_cap = int(S0 * (1 + slack)) + 1
    idx = np.arange(n)
    best = part.copy()
    best_h = _padded_halo_width(src, dst, part, n_dev)
    stale = 0
    key_dtype = np.int32 if n * n_dev < 2**31 else np.int64
    key_dst = (dst * n_dev).astype(key_dtype)
    key_src = (src * n_dev).astype(key_dtype)
    for _ in range(passes):
        counts = np.bincount(
            np.concatenate([key_dst + part[src], key_src + part[dst]]),
            minlength=n * n_dev).reshape(n, n_dev)
        want = counts.argmax(1).astype(np.int32)
        gain = counts[idx, want] - counts[idx, part]
        movers = np.flatnonzero((gain > 0) & (want != part))
        if not len(movers):
            break
        movers = movers[np.argsort(-gain[movers], kind="stable")]
        sizes = np.bincount(part, minlength=n_dev)
        # best-gain movers first, capped per destination and per source
        # (a shard is not drained below S0/2)
        cap = np.maximum(s_cap - sizes, 0)
        keep = _rank_within_groups(want[movers]) < cap[want[movers]]
        movers = movers[keep]
        avail = np.maximum(sizes - S0 // 2, 0)
        keep = _rank_within_groups(part[movers]) < avail[part[movers]]
        movers = movers[keep]
        if not len(movers):
            break
        part[movers] = want[movers]
        h = _padded_halo_width(src, dst, part, n_dev)
        if h < best_h:
            best_h, best, stale = h, part.copy(), 0
        else:
            stale += 1
            if stale >= 5:
                break
    return best


def balanced_partition(edge_index: np.ndarray, num_nodes: int,
                       n_dev: int) -> np.ndarray:
    """part[v] in [0, D): a balanced, low-halo node assignment: the best
    by padded halo width of id-order blocks, strided round-robin and
    reverse-Cuthill-McKee-order blocks (scipy), then refined by
    :func:`_refine_partition`.  Never worse than plain contiguous
    blocks."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    src = np.asarray(edge_index[0], dtype=np.int64)
    dst = np.asarray(edge_index[1], dtype=np.int64)
    S0 = -(-num_nodes // n_dev)
    ids = np.arange(num_nodes)
    candidates = [(ids // S0).astype(np.int32),
                  (ids % n_dev).astype(np.int32)]
    A = csr_matrix((np.ones(len(src), np.float32), (src, dst)),
                   shape=(num_nodes, num_nodes))
    order = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=False),
                       dtype=np.int64)
    pos = np.empty(num_nodes, np.int64)
    pos[order] = ids
    candidates.append((pos // S0).astype(np.int32))
    part = min(candidates,
               key=lambda p: _padded_halo_width(src, dst, p, n_dev))
    return _refine_partition(src, dst, part.copy(), n_dev)


def make_node_partition(edge_index: np.ndarray, num_nodes: int,
                        n_dev: int,
                        method: str = "locality") -> NodePartitionPlan:
    """Build the static halo-exchange plan on the host.

    ``method='locality'`` (default): :func:`balanced_partition` (at
    D = 1 the identity, as in the JAX package).  ``method='contiguous'``:
    id-order blocks.  Vectorised numpy, O(E log E)."""
    if method not in ("locality", "contiguous"):
        raise ValueError(f"unknown partition method {method!r}")
    src = np.asarray(edge_index[0], dtype=np.int64)
    dst = np.asarray(edge_index[1], dtype=np.int64)
    if method == "locality" and n_dev > 1 and num_nodes > 0:
        part = balanced_partition(edge_index, num_nodes, n_dev)
        sizes = np.bincount(part, minlength=n_dev)
        S = max(1, int(sizes.max()))
        # positions: nodes sorted by (part, id); node v sits at
        # part(v)*S + rank-of-v-within-its-part
        order = np.argsort(part, kind="stable")
        cum = np.concatenate([[0], np.cumsum(sizes[:-1])])
        pos = part[order] * S + (np.arange(num_nodes) - cum[part[order]])
        perm = np.empty(num_nodes, np.int32)
        perm[order] = pos.astype(np.int32)
        src = perm[src].astype(np.int64)
        dst = perm[dst].astype(np.int64)
    else:
        perm = np.arange(num_nodes, dtype=np.int32)
        S = -(-num_nodes // n_dev)
    owner_src = src // S
    owner_dst = dst // S

    # halo sets: unique (receiver d, sender s, node u) triples, one int64
    # key each; np.unique yields every (d, s) group's sorted member list
    remote = owner_src != owner_dst
    r_src, r_dst = src[remote], dst[remote]
    r_os, r_od = owner_src[remote], owner_dst[remote]
    M = np.int64(n_dev) * S                      # > any node position
    key = (r_od * n_dev + r_os) * M + r_src
    uniq, inv = np.unique(key, return_inverse=True)
    u_sd = uniq // M                             # d * n_dev + s
    u_src = uniq % M
    if len(uniq):
        grp_change = np.empty(len(uniq), dtype=bool)
        grp_change[0] = True
        np.not_equal(u_sd[1:], u_sd[:-1], out=grp_change[1:])
        grp_starts = np.flatnonzero(grp_change)
        rank = np.arange(len(uniq), dtype=np.int64) - \
            grp_starts[np.cumsum(grp_change) - 1]
        counts_sd = np.bincount(u_sd, minlength=n_dev * n_dev)
        H = max(1, int(counts_sd.max()))
    else:
        rank = np.zeros(0, np.int64)
        H = 1
    send_idx = np.zeros((n_dev, n_dev, H), np.int32)
    send_mask = np.zeros((n_dev, n_dev, H), bool)
    d_of = u_sd // n_dev
    s_of = u_sd % n_dev
    send_idx[s_of, d_of, rank] = u_src - s_of * S
    send_mask[s_of, d_of, rank] = True
    # halo-buffer position of each remote edge's src for its receiver
    halo_pos = s_of[inv] * H + rank[inv]

    def _grouped(cols, owners):
        order = np.argsort(owners, kind="stable")
        counts = np.bincount(owners, minlength=n_dev)
        E = max(1, int(counts.max()) if len(owners) else 1)
        bounds = np.concatenate([[0], np.cumsum(counts)])
        s_arr = np.zeros((n_dev, E), np.int32)
        d_arr = np.zeros((n_dev, E), np.int32)
        m_arr = np.zeros((n_dev, E), bool)
        a, b = (c[order] for c in cols)
        for d in range(n_dev):
            lo, hi = bounds[d], bounds[d + 1]
            s_arr[d, :hi - lo] = a[lo:hi]
            d_arr[d, :hi - lo] = b[lo:hi]
            m_arr[d, :hi - lo] = True
        return s_arr, d_arr, m_arr

    local = ~remote
    ls, ld, lm = _grouped((src[local] - owner_dst[local] * S,
                           dst[local] - owner_dst[local] * S),
                          owner_dst[local])
    hs, hd, hm = _grouped((halo_pos, r_dst - r_od * S), r_od)
    return NodePartitionPlan(num_nodes=num_nodes, n_dev=n_dev, shard_size=S,
                             halo_width=H, send_idx=send_idx,
                             send_mask=send_mask, local_src=ls, local_dst=ld,
                             local_mask=lm, halo_src=hs, halo_dst=hd,
                             halo_mask=hm, perm=perm)


# ------------------------------------------------------------ the hop --

_IDENTITY = {("min", torch.int32): torch.iinfo(torch.int32).max,
             ("max", torch.int8): torch.iinfo(torch.int8).min}


class ShardedHop:
    """One rank's node-sharded hop (JAX ``_sharded_hop``): the plans of its
    local-source and halo-source edges, built once per graph, and the
    rows it sends.  ``__call__(mh, hll)`` runs one hop of both sketches
    on the rank's [S, w] rows; ``group`` is the graph axis's.

    ``max_gather_rows`` bounds each plan's slot table: past it the plan
    is chunk-streamed (``ChunkedSegmentPlan``), each chunk merged by K1.
    """

    def __init__(self, plan: NodePartitionPlan, index: int, group, device,
                 max_gather_rows: Optional[int] = None):
        D, H, S = plan.n_dev, plan.halo_width, plan.shard_size
        self.group = group
        self.send_idx = torch.from_numpy(
            plan.send_idx[index].astype(np.int64)).to(device)     # [D, H]
        self.send_mask = torch.from_numpy(plan.send_mask[index]).to(device)
        lm, hm = plan.local_mask[index], plan.halo_mask[index]
        self.local_edges, self.halo_edges = int(lm.sum()), int(hm.sum())
        self.local = make_auto_plan(
            np.stack([plan.local_src[index][lm], plan.local_dst[index][lm]]),
            S, max_slots=max_gather_rows, device=device)
        # the halo plan's sources are the received [D*H, w] buffer
        self.halo = make_auto_plan(
            np.stack([plan.halo_src[index][hm], plan.halo_dst[index][hm]]),
            S, max_slots=max_gather_rows, device=device, num_sources=D * H)

    def _send(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """The [D, H, w] rows this rank sends, padded with op's identity."""
        ident = torch.full((), _IDENTITY[(op, t.dtype)], dtype=t.dtype,
                           device=t.device)
        return torch.where(self.send_mask[..., None], t[self.send_idx],
                           ident)

    def __call__(self, mh: torch.Tensor, hll: torch.Tensor):
        # 1. both exchanges first, so the local reduces overlap them
        ex_mh = halo_exchange(self._send(mh, "min"), self.group, "min")
        ex_hll = halo_exchange(self._send(hll, "max"), self.group, "max")
        # 2. local-source edges, own rows folded in (K1)
        mh_acc = self.local.reduce(mh, "min")
        hll_acc = self.local.reduce(hll, "max")
        # 3. halo-source edges against the received rows, folded into
        # step 2's result (K1)
        recv_mh = ex_mh.wait().reshape(-1, mh.shape[1])
        recv_hll = ex_hll.wait().reshape(-1, hll.shape[1])
        return (self.halo.reduce(mh_acc, "min", sources=recv_mh),
                self.halo.reduce(hll_acc, "max", sources=recv_hll))


def _lanes(mesh, lane_axis: Optional[str], params: SketchParams) -> tuple:
    """(lane index, lane count, lane group) of this rank."""
    if lane_axis is None:
        return 0, 1, None
    L = mesh.axis_size(lane_axis)
    if params.num_perm % L or params.m % L:
        raise ValueError(f"lane axis size {L} must divide num_perm="
                         f"{params.num_perm} and m={params.m}")
    return mesh.axis_index(lane_axis), L, mesh.group(lane_axis)


def node_sharded_build_hash_tables(
        plan: NodePartitionPlan, params: SketchParams, mesh,
        axis: str = "graph", max_gather_rows: Optional[int] = None,
        lane_axis: Optional[str] = None, hop=None) -> Sketches:
    """All per-hop sketches with the state sharded over ``axis`` by node:
    this rank's shard, [K+1, S, num_perm / L] biased int32 MinHash,
    [K+1, S, m / L] int8 HLL and [S, K] cardinalities, S =
    ``plan.padded_nodes / D``, rows in the partition's order.

    The rank computes its hop-0 rows alone (``plan.shard_init``), so no
    rank builds the whole table.  ``lane_axis``: the width is sharded over
    it too; the cardinalities sum their register statistics over it.
    ``hop``: a :class:`ShardedHop` of this plan and rank, to reuse its
    plans."""
    D, r = mesh.axis_size(axis), mesh.axis_index(axis)
    if D != plan.n_dev:
        raise ValueError(f"the plan is for {plan.n_dev} shards; the mesh's "
                         f"{axis!r} axis has {D}")
    lane, L, lane_group = _lanes(mesh, lane_axis, params)
    dev = mesh.device
    mh, hll = (torch.from_numpy(t).to(dev)
               for t in plan.shard_init(params, r, lane, L))
    if hop is None:
        hop = ShardedHop(plan, r, mesh.group(axis), dev, max_gather_rows)
    mhs, hlls, cards = [mh], [hll], []
    for _ in range(params.max_hops):
        mh, hll = hop(mhs[-1], hlls[-1])
        mhs.append(mh)
        hlls.append(hll)
        cards.append(lane_cards(hll, params.hll_p, lane_group))
    return Sketches(minhash=torch.stack(mhs), hll=torch.stack(hlls),
                    cards=torch.stack(cards, dim=1))


def node_sharded_subgraph_features(
        links, sk: Sketches, params: SketchParams, mesh,
        axis: str = "graph", perm=None,
        lane_axis: Optional[str] = None) -> torch.Tensor:
    """Subgraph features for a link batch from node-sharded sketch state
    (this rank's shard ``sk``, from ``node_sharded_build_hash_tables``).

    Each rank contributes the rows of the batch's nodes that it owns and
    zeros for the rest, and one SUM all-reduce over the graph axis per
    table assembles the [K+1, 2B, w] rows: exact, since each row has one
    owner (the biased MinHash lanes are summed with zeros as they are).
    The feature math then runs as on one device (``sketch/elph.py``); its
    slice start adapts, so hops-only stacks (hop 0 dropped) serve too.
    ``links`` [B, 2] are node ids on every graph peer alike; ``perm`` (the
    partition's node -> row map) translates them.  With ``lane_axis`` the
    assembled rows are the rank's width slice, and the match counts and
    register statistics are summed over the lane axis into the estimator
    core (``hll_count_from_stats``)."""
    dev = sk.minhash.device
    links = torch.as_tensor(links, device=dev).long()
    if perm is not None:
        links = torch.as_tensor(perm, device=dev).long()[links]
    S = sk.minhash.shape[1]
    base = mesh.axis_index(axis) * S
    B = links.shape[0]
    group = mesh.group(axis)
    nodes = torch.cat([links[:, 0], links[:, 1]])
    local = (nodes - base).clamp(0, S - 1)
    owned = (nodes >= base) & (nodes < base + S)
    mh = torch.where(owned[None, :, None], sk.minhash[:, local, :],
                     torch.zeros((), dtype=sk.minhash.dtype, device=dev))
    hl = torch.where(owned[None, :, None], sk.hll[:, local, :],
                     torch.zeros((), dtype=sk.hll.dtype, device=dev))
    cd = torch.where(owned[:, None], sk.cards[local, :],
                     torch.zeros((), dtype=sk.cards.dtype, device=dev))
    for t in (mh, hl, cd):
        all_reduce(t, group=group)
    lane_group = mesh.group(lane_axis) if lane_axis is not None else None
    s0 = mh.shape[0] - params.max_hops
    return lane_summed_features(mh[s0:, :B], mh[s0:, B:], hl[s0:, :B],
                                hl[s0:, B:], cd[:B], cd[B:], params,
                                lane_group)


def node_sharded_subgraph_features_batched(
        links, sk: Sketches, params: SketchParams, mesh, perm=None,
        batch_size: int = 1 << 18, axis: str = "graph",
        lane_axis: Optional[str] = None) -> torch.Tensor:
    """:func:`node_sharded_subgraph_features` over link chunks of
    ``batch_size`` (the JAX package's ``_chunked_node_sharded_features``:
    fixed-size chunks, the tail padded with (0, 0) links past the first
    chunk); [N, sf_dim] float32 on the sketches' device."""
    dev = sk.minhash.device
    links = torch.as_tensor(np.asarray(links), dtype=torch.int64)
    if len(links) == 0:
        return torch.zeros((0, params.sf_dim), dtype=torch.float32,
                           device=dev)
    out = []
    for s in range(0, len(links), batch_size):
        chunk = links[s:s + batch_size]
        pad = 0
        if len(chunk) < batch_size and s > 0:
            pad = batch_size - len(chunk)
            chunk = torch.cat([chunk, chunk.new_zeros((pad, 2))])
        sf = node_sharded_subgraph_features(chunk.to(dev), sk, params, mesh,
                                            axis, perm, lane_axis)
        out.append(sf[:len(sf) - pad] if pad else sf)
    return torch.cat(out)
