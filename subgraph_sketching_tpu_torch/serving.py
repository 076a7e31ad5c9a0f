"""Online link scoring with a trained BUDDY or ELPH model.

Counterpart of the JAX package's serving.py ``LinkScorer``: the per-hop
sketch stacks, the SIGN-propagated node features, the degrees and the
model stay resident on the device, and a query batch computes subgraph
features straight from the sketches (the same math as preprocessing,
including the zero-one knockout / floor) and runs the BUDDY MLP.
``ElphLinkScorer`` runs ELPH's full-graph GCN once at construction and
keeps its node features resident; a query runs the LinkPredictor head.
A model with node embeddings has its table resolved once at
construction, in eval mode (diffused by the scatter ``spmm`` over the
served split's graph with ``--propagate_embeddings``); a query gathers
its rows.

Checkpoints: a directory holding ``config.json`` (the ``Config``) and
either ``step_<N>.pt`` files from a training run (``runners/run.py`` with
``--checkpoint_dir``) or ``buddy.pt`` (a ``BUDDY`` state_dict), written by
:func:`save_buddy_checkpoint`.  Weights trained by the JAX package cross
over through ``models/convert.py``.  A checkpoint of a ``--dtype
bfloat16`` or ``--dtype float16`` run serves in that dtype: the model is
rebuilt from its config, whose compute dtype it keeps (its weights are
float32 either way).

A ``use_RA`` model is served as the JAX package serves it: the message
graph's CSR stays on the host, and each query chunk's RA scores come from
the host ``resource_allocation`` over the same coalesced graph that
preprocessing used, so online RA equals the staged training feature bit
for bit; the column then goes to the device and into ``bn_RA``.  ELPH's
model reads no RA column, so ``ElphLinkScorer`` ignores the flag.

``LinkScorer`` takes exact streaming edge inserts and deletes
(``insert_edges`` / ``delete_edges``), bit-equal to a rebuild on the
changed graph.

Node-sharded state (a dataset built under a ``graph`` mesh, whose
``sketch_perm`` maps node ids to row positions): ``LinkScorer`` keeps the
permutation (``sk_perm``) and translates every sketch lookup, and every
row a streaming update gathers, scatters or resets (``_pos``), from node
ids to positions, while the adjacency walk, the degrees, the features
and the embedding rows stay in node ids: a missed translation would read
another node's row without any error (the train/serve skew the JAX
package's serving.py names).  A checkpoint whose config names a graph
mesh is served at world size 1 (``scorer_from_checkpoint``): the mesh
becomes [1] over ``graph``, the tables are built node-sharded at D = 1.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import scipy.sparse as ssp
import torch

from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.device import resolve_device
from subgraph_sketching_tpu_torch.graph.container import Graph
from subgraph_sketching_tpu_torch.graph.preprocess import (
    LinkDataset, sketch_params_from_config,
)
from subgraph_sketching_tpu_torch.heuristics import resource_allocation
from subgraph_sketching_tpu_torch.ops.segment import identity
from subgraph_sketching_tpu_torch.sketch.elph import subgraph_features
from subgraph_sketching_tpu_torch.sketch.hll import hll_count, hll_init_rows
from subgraph_sketching_tpu_torch.sketch.minhash import (
    minhash_init_rows, to_biased,
)
from subgraph_sketching_tpu_torch.sketch.params import Sketches
from subgraph_sketching_tpu_torch.train.loops import (
    ElphTrainer, build_buddy, load_frozen_embedding,
)

CONFIG_FILE = "config.json"
WEIGHTS_FILE = "buddy.pt"


class _BucketedScorer:
    """The query contract both scorers share: ``score`` checks the ids and
    scores in chunks of ``max_bucket`` links through ``_score_batch``
    (given each chunk on the device and on the host);
    ``warmup`` scores one batch of each given size."""

    num_nodes: int
    min_bucket: int
    max_bucket: int
    device: torch.device

    def score(self, links: np.ndarray) -> np.ndarray:
        """Scores (logits) for [B, 2] int link pairs, any B ≥ 0."""
        links = np.asarray(links, dtype=np.int64).reshape(-1, 2)
        if len(links) and (links.min() < 0 or links.max() >= self.num_nodes):
            raise ValueError(f"link ids must be in [0, {self.num_nodes}); "
                             f"got [{links.min()}, {links.max()}]")
        outs = []
        for s in range(0, len(links), self.max_bucket):
            chunk = links[s:s + self.max_bucket]
            outs.append(self._score_batch(
                torch.from_numpy(chunk).to(self.device), chunk).cpu().numpy())
        return np.concatenate(outs) if outs else np.zeros((0,), np.float32)

    def warmup(self, buckets: Optional[list] = None) -> None:
        """Score one batch of each given size (default: min_bucket), so the
        first query does not pay one-time costs (kernel load, allocator)."""
        for b in (buckets or [self.min_bucket]):
            self.score(np.zeros((b, 2), np.int64))


class LinkScorer(_BucketedScorer):
    """Serve scores for arbitrary (src, dst) pairs.

    Parameters
    ----------
    cfg: the run's Config.
    model: the model a BUDDY run with ``cfg`` trains (``build_buddy``: a
        BUDDY, or a BuddyWithEmbedding), put in eval mode and moved to
        ``device`` here.
    dataset: the served split's LinkDataset — must retain ``sketches`` and
        carry x/degrees (and the edges the table diffuses over).  The
        scorer serves its sketch stacks where they lie, and the streaming
        updates change them in place: never a copy of the stacks.
    min_bucket: the batch size ``warmup`` scores.
    max_bucket: larger queries are scored in chunks of this many links.
    """

    def __init__(self, cfg: Config, model, dataset: LinkDataset,
                 min_bucket: int = 1024, max_bucket: int = 1 << 18,
                 device="cuda"):
        if dataset.sketches is None and cfg.use_struct_feature:
            raise ValueError(
                "serving needs the sketch stacks: build the dataset with "
                "build_link_dataset so LinkDataset.sketches is retained")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model.to(self.device).eval()
        self.buddy = getattr(self.model, "buddy", self.model)
        self.sketch_params = sketch_params_from_config(cfg)
        # under --use_struct_feature 0 the model was trained on zeroed
        # structure features (reference train.py:58) — serve the same zeros
        self.sk = None
        if cfg.use_struct_feature:
            self.sk = Sketches(*(t.to(self.device)
                                 for t in dataset.sketches))
        # node-sharded tables are POSITION-ordered: sketch lookups and the
        # streaming updates' rows translate node id -> row position
        self._perm_np = self.sk_perm = None
        if self.sk is not None and dataset.sketch_perm is not None:
            self._perm_np = np.asarray(dataset.sketch_perm, dtype=np.int64)
            self.sk_perm = torch.from_numpy(self._perm_np).to(self.device)
        self.num_nodes = dataset.num_nodes
        # the message graph with use_RA: its CSR stays on the host, and RA
        # is scored by the host math preprocessing used over the same
        # coalesced graph, so online RA equals the staged feature
        self.ra_csr = (Graph(dataset.edge_index, dataset.num_nodes,
                             dataset.edge_weight).csr()
                       if cfg.use_RA else None)
        self._edge_index = dataset.edge_index   # for the streaming updates
        self.x = (torch.from_numpy(np.asarray(dataset.x)).to(self.device)
                  if self.buddy.use_feature and dataset.x is not None
                  else None)
        # a copy: the streaming updates add to it in place
        self.deg = torch.from_numpy(
            np.array(dataset.degrees, dtype=np.float32)).to(self.device)
        self.emb_table = None
        if self.buddy is not self.model:
            ei = torch.from_numpy(np.asarray(dataset.edge_index,
                                             dtype=np.int64)).to(self.device)
            with torch.inference_mode():
                self.emb_table = self.model.table(edge_index=ei)
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket

    @torch.inference_mode()
    def _score_batch(self, links: torch.Tensor,
                     chunk: np.ndarray) -> torch.Tensor:
        if self.sk is not None:
            # only the sketch lookup rides sk_perm (x, deg and the
            # embedding rows stay in node order)
            sk_links = links if self.sk_perm is None else self.sk_perm[links]
            sf = subgraph_features(sk_links, self.sk, self.sketch_params)
        else:
            sf = torch.zeros((links.shape[0], self.sketch_params.sf_dim),
                             device=self.device)
        ra = None
        if self.ra_csr is not None:
            ra = torch.from_numpy(resource_allocation(self.ra_csr, chunk)).to(
                self.device)
        out = self.buddy(
            sf, node_features=None if self.x is None else self.x[links],
            src_degree=self.deg[links[:, 0]],
            dst_degree=self.deg[links[:, 1]], RA=ra,
            emb=None if self.emb_table is None else self.emb_table[links])
        return out.ravel()

    # -- streaming updates ----------------------------------------------------
    def _pos(self, ids: np.ndarray) -> np.ndarray:
        """Node ids -> sketch-table row positions: the identity without a
        partition permutation, else ``sk_perm`` (the updates scatter into
        row positions while the adjacency walk stays in node ids)."""
        ids = np.asarray(ids, dtype=np.int64)
        return ids if self._perm_np is None else self._perm_np[ids]

    def _stack_index(self, k: int) -> int:
        """Hop k's index in the stacks: k in hop-0..K stacks, k - 1 in
        K-row hops-only stacks (hop 0 dropped to save device memory at
        citation2 scale)."""
        full = int(self.sk.minhash.shape[0]) == self.sketch_params.max_hops + 1
        return k if full else k - 1

    def _sources(self, k: int, pairs: np.ndarray):
        """The hop-(k-1) rows of the sources of ``pairs`` when the stack
        does not hold them (hop 0 of a hops-only stack), else None."""
        return (self._hop0_rows(pairs[:, 0]) if self._stack_index(k) == 0
                else None)

    def _hop0_rows(self, ids: np.ndarray):
        """Hop-0 sketch rows of the given node ids, on the device (MinHash
        in the biased int32 lanes).  Hop 0 is a pure per-id function
        (sketch/node_hash.py), so hops-only stacks stream updates without
        ever holding the O(n) hop-0 table."""
        params = self.sketch_params
        mh = to_biased(minhash_init_rows(ids, params.num_perm,
                                         params.minhash_seed))
        hll = hll_init_rows(ids, params.hll_p)
        return (torch.from_numpy(mh).to(self.device),
                torch.from_numpy(hll).to(self.device))

    def _edge_key(self, s, d):
        return np.asarray(s, np.int64) * np.int64(self.num_nodes) \
            + np.asarray(d, np.int64)

    def _ensure_adj(self) -> None:
        """Build the serving adjacency at first use: the original message
        graph (src, dst)-key-sorted (src-contiguous and binary-searchable
        by directed key), plus the mutation state — appended extra edges
        and the delete tombstones (sorted directed keys of CSR rows deleted
        but not yet compacted, so a delete batch does not pay an O(E)
        rebuild)."""
        if hasattr(self, "_out_sorted"):
            return
        ei = np.asarray(self._edge_index, dtype=np.int64)
        order = np.argsort(self._edge_key(ei[0], ei[1]), kind="stable")
        self._set_out(ei[:, order])
        self._extra_edges = np.zeros((2, 0), np.int64)
        self._del_keys = np.zeros(0, np.int64)
        self._symmetric: Optional[bool] = None  # unknown until first needed

    def _set_out(self, out_sorted: np.ndarray) -> None:
        self._out_sorted = out_sorted
        self._out_starts = np.searchsorted(out_sorted[0],
                                           np.arange(self.num_nodes + 1))
        self._out_keys = self._edge_key(out_sorted[0], out_sorted[1])

    def _keys_in_del(self, keys: np.ndarray) -> np.ndarray:
        """Boolean mask: which directed keys are tombstoned (binary search
        over the sorted tombstone set)."""
        if not len(self._del_keys):
            return np.zeros(len(keys), bool)
        idx = np.searchsorted(self._del_keys, keys)
        idx = np.minimum(idx, len(self._del_keys) - 1)
        return self._del_keys[idx] == keys

    def _compact(self) -> None:
        """Fold the tombstones into the CSR: one O(E) pass, amortised over
        many delete batches."""
        if not len(self._del_keys):
            return
        self._set_out(self._out_sorted[:, ~self._keys_in_del(self._out_keys)])
        self._del_keys = np.zeros(0, np.int64)
        self._drop_in_csr()

    def _drop_in_csr(self) -> None:
        for attr in ("_in_sorted", "_in_starts"):
            if hasattr(self, attr):
                delattr(self, attr)

    @staticmethod
    def _ranges(starts: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """The positions of the CSR rows ``ids``, row after row."""
        lo = starts[ids]
        counts = starts[ids + 1] - lo
        return (np.repeat(lo, counts) + np.arange(int(counts.sum()))
                - np.repeat(np.cumsum(counts) - counts, counts))

    def _out_pairs(self, srcs: np.ndarray) -> np.ndarray:
        """All current (src, dst) edges whose src is in ``srcs``: the
        original message graph less its tombstoned rows, and every edge
        inserted since."""
        idx = self._ranges(self._out_starts, srcs)
        pairs = self._out_sorted[:, idx].T
        if len(self._del_keys):
            pairs = pairs[~self._keys_in_del(self._out_keys[idx])]
        if self._extra_edges.shape[1]:
            m = np.isin(self._extra_edges[0], srcs)
            pairs = np.concatenate([pairs, self._extra_edges[:, m].T])
        return pairs

    def _is_symmetric(self) -> bool:
        """Whether every stored directed edge has its reverse stored too.
        Resolved once, from the initial CSR (O(E log E)); an update with
        ``undirected=False`` sets it False for the scorer's lifetime, even
        when a later update restores the symmetry."""
        if self._symmetric is None:
            rev = np.sort(self._edge_key(self._out_sorted[1],
                                         self._out_sorted[0]))
            self._symmetric = bool(np.array_equal(rev, self._out_keys))
        return self._symmetric

    def _in_pairs(self, dsts: np.ndarray) -> np.ndarray:
        """All current (src, dst) edges whose dst is in ``dsts``.

        On a symmetric graph (the production case) in(v) is out(v) with
        the columns swapped: no dst-sorted CSR, and no O(E log E) sort
        after a delete batch.  Otherwise a dst-sorted CSR over the
        compacted edge set, built at first use after each compaction."""
        if self._is_symmetric():
            return self._out_pairs(dsts)[:, ::-1]
        if not hasattr(self, "_in_sorted"):
            self._compact()  # tombstones would be invisible to a dst sort
            order = np.argsort(self._out_sorted[1], kind="stable")
            self._in_sorted = self._out_sorted[:, order]
            self._in_starts = np.searchsorted(
                self._in_sorted[1], np.arange(self.num_nodes + 1))
        pairs = self._in_sorted[:, self._ranges(self._in_starts, dsts)].T
        if len(self._del_keys):
            pairs = pairs[~self._keys_in_del(
                self._edge_key(pairs[:, 0], pairs[:, 1]))]
        if self._extra_edges.shape[1]:
            m = np.isin(self._extra_edges[1], dsts)
            pairs = np.concatenate([pairs, self._extra_edges[:, m].T])
        return pairs

    def _checked_edges(self, edges, weights, undirected: bool):
        """[M, 2] int64 directed edges (both directions when
        ``undirected``) and their float32 weights, or a ValueError."""
        edges = np.asarray(edges, dtype=np.int64)
        if edges.ndim != 2 or edges.shape[1] != 2:
            raise ValueError(f"edges must be [M, 2], got {edges.shape}")
        if len(edges) and (edges.min() < 0 or edges.max() >= self.num_nodes):
            raise ValueError("edge endpoint out of range "
                             f"[0, {self.num_nodes})")
        w = (np.ones(len(edges), np.float32) if weights is None
             else np.asarray(weights, np.float32).reshape(-1))
        if len(w) != len(edges):
            raise ValueError(f"{len(w)} weights for {len(edges)} edges")
        if undirected:
            edges = np.concatenate([edges, edges[:, ::-1]])
            w = np.concatenate([w, w])
        return edges, w

    def _update_degrees_and_ra(self, edges: np.ndarray, w: np.ndarray,
                               sign: float) -> None:
        """Weighted in-degree by dst (``Graph.degrees`` is A.sum(axis=0))
        and the RA CSR, in the (src, dst) orientation of the staged CSR."""
        self.deg.index_add_(0, torch.from_numpy(edges[:, 1]).to(self.device),
                            torch.from_numpy(sign * w).to(self.device))
        if self.ra_csr is not None:
            delta = ssp.csr_matrix((sign * w, (edges[:, 0], edges[:, 1])),
                                   shape=(self.num_nodes, self.num_nodes))
            self.ra_csr = (self.ra_csr + delta).tocsr()
            if sign < 0:
                self.ra_csr.eliminate_zeros()

    def _merge(self, k: int, rows: np.ndarray, pairs: np.ndarray,
               reset: bool, sources=None) -> None:
        """One hop of a streaming update, in place on the resident stacks.

        Hop k's rows at the destinations of ``pairs`` absorb the hop-(k-1)
        rows of their sources (MinHash min, HLL max, by ``scatter_reduce_``
        into the stack's hop view); with ``reset`` the rows ``rows`` are
        first set to the merge identities (int32 max in the biased MinHash
        lanes, the order image of uint32 0xFFFFFFFF; 0 for HLL, whose ranks
        are >= 0), and ``pairs`` then hold their whole surviving
        in-neighbourhood.  The cardinalities of ``rows`` are recomputed.
        Min and max do not depend on the order of the merges, so the
        card's atomics leave the result bit-exact.  ``sources``: the
        sources' hop-(k-1) rows where the stack does not hold them
        (``_sources``).  ``rows`` and ``pairs`` are node ids; the stacks
        are indexed at their row positions (``_pos``)."""
        mh, hll, cards = self.sk
        kst = self._stack_index(k)
        dev = self.device
        if sources is None:
            src = torch.from_numpy(self._pos(pairs[:, 0])).to(dev)
            s_mh = mh[kst - 1].index_select(0, src)
            s_hll = hll[kst - 1].index_select(0, src)
        else:
            s_mh, s_hll = sources
        rows_t = torch.from_numpy(self._pos(rows)).to(dev)
        dst = torch.from_numpy(self._pos(pairs[:, 1])).to(dev)[:, None]
        mh_k, hll_k = mh[kst], hll[kst]
        if reset:
            mh_k.index_fill_(0, rows_t, identity("min", mh.dtype))
            hll_k.index_fill_(0, rows_t, 0)
        mh_k.scatter_reduce_(0, dst.expand_as(s_mh), s_mh, "amin",
                             include_self=True)
        hll_k.scatter_reduce_(0, dst.expand_as(s_hll), s_hll, "amax",
                              include_self=True)
        cards[rows_t, k - 1] = hll_count(hll_k.index_select(0, rows_t),
                                         self.sketch_params.hll_p)

    @torch.inference_mode()
    def insert_edges(self, edges: np.ndarray, weights=None,
                     undirected: bool = True) -> None:
        """Exact streaming edge insertion (the JAX package's
        ``LinkScorer.insert_edges``; no reference equivalent).

        Min/max sketches are monotone and idempotent under edge
        insertions, so the updated hop tables equal a from-scratch rebuild
        on the augmented graph bit for bit, at O(Σ deg(touched)) cost
        instead of O(E·K): hop-k rows of the new edges' endpoints (and of
        their out-neighbours, transitively per hop, plus the self fold-in)
        merge the updated hop-(k-1) rows of their sources; the touched
        rows' cardinalities are recomputed.  Degrees (and the RA CSR with
        use_RA) update too; SIGN node features stay as precomputed
        offline, the staleness the reference's cached features have.
        Full hop-0..K stacks and hops-only stacks both stream.

        edges: [M, 2] int node pairs; ``undirected=True`` (the message
        graphs here are undirected) inserts both directions.  One update
        with ``undirected=False`` takes every later delete off the
        symmetric fast path for the scorer's lifetime (``_is_symmetric``).
        weights: [M] (default 1.0 each).  Degrees add them with
        ``index_add_``, which on the card sums in atomic order: integer
        weights are exact, others may differ from a rebuild in the last
        bits.

        ``last_update_stats``: ``host_ms`` (the whole call's host time, the
        walk, adjacency and the extras fold included, less the dispatch),
        ``dispatch_ms`` (enqueuing the per-hop merges, which the card runs
        asynchronously) and ``rows`` (the rows rebuilt per hop).
        """
        t_host0 = time.perf_counter()
        edges, w = self._checked_edges(edges, weights, undirected)
        if len(edges) == 0:
            return
        self._update_degrees_and_ra(edges, w, 1.0)
        self._ensure_adj()
        if not undirected:
            self._symmetric = False  # a one-direction insert breaks it
        t_disp, touched = 0.0, []
        if self.sk is not None:
            pairs, changed = edges, None
            for k in range(1, self.sketch_params.max_hops + 1):
                if changed is not None:
                    pairs = np.concatenate([
                        edges, self._out_pairs(changed),
                        np.stack([changed, changed], axis=1)])  # self fold-in
                changed = np.unique(pairs[:, 1])
                touched.append(len(changed))
                sources = self._sources(k, pairs)
                td = time.perf_counter()
                self._merge(k, changed, pairs, reset=False, sources=sources)
                t_disp += time.perf_counter() - td
        self._extra_edges = np.concatenate([self._extra_edges, edges.T],
                                           axis=1)
        # fold accumulated extras into the sorted adjacency once they get
        # big: keeps _out_pairs' isin scan bounded on long-running servers.
        # Tombstones are compacted first: they only refer to CSR rows, and
        # folding extras under live tombstones would wrongly filter
        # re-inserted copies of a deleted key
        if self._extra_edges.shape[1] > max(
                100_000, self._out_sorted.shape[1] // 4):
            self._compact()
            ei = np.concatenate([self._out_sorted, self._extra_edges],
                                axis=1)
            order = np.argsort(self._edge_key(ei[0], ei[1]), kind="stable")
            self._set_out(ei[:, order])
            self._extra_edges = np.zeros((2, 0), np.int64)
            self._drop_in_csr()  # _in_sorted no longer mirrors _out_sorted
        self.last_update_stats = {
            "op": "insert",
            "host_ms": (time.perf_counter() - t_host0 - t_disp) * 1e3,
            "dispatch_ms": t_disp * 1e3, "rows": touched}

    @torch.inference_mode()
    def delete_edges(self, edges: np.ndarray, weights=None,
                     undirected: bool = True) -> None:
        """Exact streaming edge deletion (the JAX package's
        ``LinkScorer.delete_edges``; no reference equivalent).

        Min/max sketches are not invertible (a deleted neighbour's hash
        may be the row minimum), so deletion cannot be an incremental
        merge.  It is still exact and local: hop-k rows depend only on the
        hop-(k-1) rows of {v} ∪ in(v), so the affected set grows one hop
        per level — A_1 = dst(removed), A_k = A_1 ∪ A_{k-1} ∪ out(A_{k-1})
        — and each affected row is rebuilt per hop: reset to the merge
        identity, then re-merged from its surviving in-edges plus the self
        fold-in.  Bit-equal to a rebuild on the reduced graph, at
        O(Σ_k vol(A_k)) cost.  Degrees and the RA CSR update too; SIGN
        node features stay as precomputed offline.  Full and hops-only
        stacks both stream.

        edges: [M, 2] int node pairs; every given directed pair (both
        directions with ``undirected=True``) must currently be present,
        which is checked before any state changes.  All stored copies of
        a pair are removed; ``weights`` (default 1.0 each) must match the
        total stored weight per pair or degrees and RA drift, and take the
        card's atomic order as in ``insert_edges``.  One update with
        ``undirected=False`` takes every later delete off the symmetric
        fast path for the scorer's lifetime.  ``last_update_stats`` as in
        ``insert_edges``, the presence check, the tombstones and any
        amortised compaction inside ``host_ms``.
        """
        t_host0 = time.perf_counter()
        edges, w = self._checked_edges(edges, weights, undirected)
        if len(edges) == 0:
            return
        # presence before any mutation, O(B log E + B log |del| + |extra|):
        # the CSR is key-sorted, and deletion tombstones instead of
        # compacting per batch
        self._ensure_adj()
        delkeys = np.unique(self._edge_key(edges[:, 0], edges[:, 1]))
        if len(self._out_keys):
            pos = np.searchsorted(self._out_keys, delkeys)
            posc = np.minimum(pos, len(self._out_keys) - 1)
            in_csr = (self._out_keys[posc] == delkeys) \
                & ~self._keys_in_del(delkeys)
        else:
            # numpy & does not short-circuit: an empty key table must be
            # guarded, not indexed (a scorer grown from a zero-edge graph)
            in_csr = np.zeros(len(delkeys), bool)
        extra_keys = self._edge_key(self._extra_edges[0],
                                    self._extra_edges[1])
        mask_extra = np.isin(extra_keys, delkeys)
        in_extra = np.isin(delkeys, extra_keys[mask_extra])
        missing = delkeys[~(in_csr | in_extra)]
        if len(missing):
            s, d = missing // self.num_nodes, missing % self.num_nodes
            raise ValueError(
                "delete_edges: not present in the graph: "
                f"{list(zip(s[:5].tolist(), d[:5].tolist()))}"
                f"{' …' if len(missing) > 5 else ''}")
        # adjacency: tombstone the CSR keys, drop the extra copies
        if not undirected:
            self._symmetric = False  # a one-direction delete breaks it
        self._del_keys = np.union1d(self._del_keys, delkeys[in_csr])
        self._extra_edges = self._extra_edges[:, ~mask_extra]
        # amortised compaction keeps the tombstone set (and every walk's
        # filter) bounded on long-running servers
        if len(self._del_keys) > max(100_000,
                                     self._out_sorted.shape[1] // 4):
            self._compact()
        self._update_degrees_and_ra(edges, w, -1.0)
        t_disp, touched = 0.0, []
        if self.sk is not None:
            dst_removed = np.unique(edges[:, 1])
            rows = dst_removed
            for k in range(1, self.sketch_params.max_hops + 1):
                if k > 1:
                    out = self._out_pairs(rows)
                    rows = np.unique(np.concatenate(
                        [dst_removed, rows, out[:, 1]]))
                pairs = np.concatenate([self._in_pairs(rows),
                                        np.stack([rows, rows], axis=1)])
                touched.append(len(rows))
                sources = self._sources(k, pairs)
                td = time.perf_counter()
                self._merge(k, rows, pairs, reset=True, sources=sources)
                t_disp += time.perf_counter() - td
        self.last_update_stats = {
            "op": "delete",
            "host_ms": (time.perf_counter() - t_host0 - t_disp) * 1e3,
            "dispatch_ms": t_disp * 1e3, "rows": touched}


class ElphLinkScorer(_BucketedScorer):
    """Serve scores from a trained ELPH (the JAX package's
    ``ElphLinkScorer``): the full-graph GCN runs once at construction, in
    eval mode (reference get_elph_preds, inference.py:167-205), and its
    node features stay resident; a query batch computes subgraph features
    from the sketch state of the split's message graph, resolved once at
    construction (``ElphTrainer.link_feature_fn``: the node-sharded
    tables under ``--memory_sharded``, else the graph's stacks), and runs
    the LinkPredictor head; the node-embedding table, when the model has
    one, is resolved once as well.  Same bucketing contract as
    ``LinkScorer``.  ELPH's model reads no RA column, so a ``use_RA``
    config serves as without it, as in the JAX package.  No streaming
    updates, as in the JAX package.
    """

    def __init__(self, trainer, model, split: str = "train",
                 min_bucket: int = 1024, max_bucket: int = 1 << 18):
        cfg = trainer.cfg
        self.cfg = cfg
        self.device = trainer.device
        self.sketch_params = trainer.sketch_params
        data = trainer._data[split]
        self.num_nodes = data["num_nodes"]
        self._link_features = trainer.link_feature_fn(data)
        self.model = model.to(self.device).eval()
        with torch.inference_mode():
            self.feats = trainer.node_features(self.model, data)
            self.emb_table = (trainer.embedding_table(self.model, data)
                              if trainer.use_embedding else None)
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket

    @torch.inference_mode()
    def _score_batch(self, links: torch.Tensor,
                     chunk: np.ndarray) -> torch.Tensor:
        sf = self._link_features(links)
        nf = self.feats[links] if self.feats is not None else None
        emb = self.emb_table[links] if self.emb_table is not None else None
        return self.model.predictor(sf, nf, emb).ravel()


def save_buddy_checkpoint(checkpoint_dir: str, cfg: Config,
                          model) -> None:
    """Write ``config.json`` and ``buddy.pt`` (the model's state_dict)."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    with open(os.path.join(checkpoint_dir, CONFIG_FILE), "w") as f:
        f.write(cfg.to_json())
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(checkpoint_dir, WEIGHTS_FILE))


def serving_config(cfg: Config) -> Config:
    """The config a checkpoint is served with, at world size 1: a mesh
    with a ``graph`` axis becomes [1] over ``graph`` (node-sharded tables
    at D = 1, position-ordered), any other mesh none."""
    if not cfg.mesh_shape:
        return cfg
    if "graph" in (cfg.mesh_axes or []):
        return dataclasses.replace(cfg, mesh_shape=[1], mesh_axes=["graph"])
    return dataclasses.replace(cfg, mesh_shape=None, mesh_axes=["data"],
                               memory_sharded=False)


def scorer_from_checkpoint(checkpoint_dir: str, cfg: Optional[Config] = None,
                           split: str = "train", min_bucket: int = 1024,
                           max_bucket: int = 1 << 18,
                           device="cuda") -> _BucketedScorer:
    """Rebuild the serving stack from a checkpoint directory: re-run the
    deterministic preprocessing on ``device``, load the weights, and return
    a ready LinkScorer (BUDDY) or ElphLinkScorer (ELPH, over an
    ``ElphTrainer`` holding the train split and the served one).
    ``split`` picks the message graph served against; only it and the
    train split (whose SIGN features and sketches it may reuse) are
    preprocessed.

    The weights are the newest ``step_<N>.pt`` that a training run with
    ``--checkpoint_dir D`` (``--save_model`` or ``--checkpoint_every``)
    wrote, with ``restored_step`` set to N; without one, ``buddy.pt``
    from :func:`save_buddy_checkpoint` (``restored_step`` None)."""
    from subgraph_sketching_tpu_torch.graph.datasets import get_data
    from subgraph_sketching_tpu_torch.graph.preprocess import build_all_splits
    from subgraph_sketching_tpu_torch.train.checkpoint import (
        latest_step, load_checkpoint,
    )

    dev = resolve_device(device)
    if cfg is None:
        path = os.path.join(checkpoint_dir, CONFIG_FILE)
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path} not found — pass cfg= "
                                    f"explicitly")
        with open(path) as f:
            cfg = Config.from_json(f.read())
    if cfg.model not in ("BUDDY", "ELPH"):
        # as the JAX package's scorer_from_checkpoint, whose build_trainer
        # takes BUDDY and ELPH only
        raise NotImplementedError(f"serving {cfg.model}: only BUDDY and "
                                  f"ELPH checkpoints are served")
    cfg = serving_config(cfg)
    splits, directed, _ = get_data(cfg)
    # the scorer needs the sketch stacks, which a split whose subgraph
    # features come from the run's cache would not build
    datasets = build_all_splits({k: splits[k] for k in dict.fromkeys(
        ("train", split))}, dataclasses.replace(
            cfg, cache_subgraph_features=False), directed=directed,
        device=dev)
    x = datasets["train"].x
    num_features = None if x is None else x.shape[-1]
    step = latest_step(checkpoint_dir)
    if step is not None:
        saved, step = load_checkpoint(checkpoint_dir, step)
        state = saved["model"]
    else:
        state = torch.load(os.path.join(checkpoint_dir, WEIGHTS_FILE),
                           map_location="cpu", weights_only=True)
    if cfg.model == "ELPH":
        trainer = ElphTrainer(cfg, datasets["train"], num_features,
                              device=dev)
        if split != "train":
            trainer.stage(split, datasets[split])
        model = trainer.init_model(0)
        model.load_state_dict(state)
        scorer = ElphLinkScorer(trainer, model, split=split,
                                min_bucket=min_bucket, max_bucket=max_bucket)
    else:
        n = datasets["train"].num_nodes
        model = build_buddy(cfg, num_features, n,
                            load_frozen_embedding(cfg, n))
        model.load_state_dict(state)
        scorer = LinkScorer(cfg, model, datasets[split],
                            min_bucket=min_bucket, max_bucket=max_bucket,
                            device=dev)
    scorer.restored_step = step
    return scorer
