"""Per-split preprocessing for BUDDY and ELPH: the HashDataset equivalent.

Produces what BUDDY training and serving need — links+labels, SIGN-propagated
node features, degrees, optional RA scores, the sketch stacks and per-link
subgraph features — with npz disk caching keyed like the reference (split,
hops, year, num_negs; src/datasets/elph.py:154-173), as the JAX package's
graph/preprocess.py does (reference src/datasets/elph.py:21-242).  The
graph work runs on ``device``: through the padded-tree plan and K1, or,
with ``use_plan`` false, by the scatter route.

The caches are the JAX package's files: a cache written by either package
loads in the other.  MinHash is stored as uint32, as the JAX package holds
it; the port's biased int32 lanes are converted at that boundary only.

An ELPH split carries the raw features, the graph, its weights and
degrees (and RA when asked): ELPH propagates its features in the model
and its trainer builds the sketches and subgraph features at staging.

Under a mesh with a ``graph`` axis (``--mesh_axes ...,graph``) the BUDDY
sketches are built memory-sharded, as the JAX package builds them: a
locality partition of the nodes over the graph axis, each rank's rows
built by halo exchange with K1 ending every reduce
(``parallel/node_sharded.py``), and the per-link subgraph features
assembled from the ranks that own the rows.  ``LinkDataset.sketches``
then holds this rank's shard, in partition order, and ``sketch_perm``
the node -> row map.  A split on the train graph reuses both; the hash
cache is written on the unsharded branch only, as in the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from subgraph_sketching_tpu_torch import spans
from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.device import resolve_device
from subgraph_sketching_tpu_torch.graph.splits import SplitData
from subgraph_sketching_tpu_torch.heuristics import resource_allocation
from subgraph_sketching_tpu_torch.ops.graph_ops import gcn_norm
from subgraph_sketching_tpu_torch.ops.segment import segment_sum
from subgraph_sketching_tpu_torch.ops.segment_scan import make_auto_plan
from subgraph_sketching_tpu_torch.parallel.node_sharded import (
    make_node_partition, node_sharded_build_hash_tables,
    node_sharded_subgraph_features_batched,
)
from subgraph_sketching_tpu_torch.sketch.elph import (
    build_hash_tables, subgraph_features_batched,
)
from subgraph_sketching_tpu_torch.sketch.minhash import from_biased, to_biased
from subgraph_sketching_tpu_torch.sketch.params import SketchParams, Sketches


def sketch_params_from_config(cfg: Config) -> SketchParams:
    return SketchParams(max_hops=cfg.max_hash_hops,
                        num_perm=cfg.minhash_num_perm,
                        hll_p=cfg.hll_p,
                        use_zero_one=cfg.use_zero_one,
                        floor_sf=cfg.floor_sf)


@dataclass
class LinkDataset:
    """Fully hydrated split: host arrays plus the device sketch stacks."""

    links: np.ndarray                 # [N, 2] int32 (pos ‖ neg)
    labels: np.ndarray                # [N] float32
    edge_index: np.ndarray            # [2, E] message-passing graph (undirected)
    edge_weight: np.ndarray           # [E]
    num_nodes: int
    x: Optional[np.ndarray]           # node features (SIGN-propagated)
    degrees: np.ndarray               # [n] weighted degrees
    subgraph_features: Optional[np.ndarray] = None  # [N, sf_dim]
    RA: Optional[np.ndarray] = None   # [N] resource-allocation scores
    sketches: Optional[Sketches] = None  # retained for serving
    # node id -> row position when ``sketches`` is node-sharded
    # (locality-partitioned) state; None for node-ordered sketches
    sketch_perm: Optional[np.ndarray] = None

    @property
    def num_links(self) -> int:
        return len(self.links)


def sign_features(x: np.ndarray, edge_index: np.ndarray,
                  edge_weight: Optional[np.ndarray], num_nodes: int,
                  sign_k: int, use_plan: bool = True,
                  max_gather_slots: Optional[int] = None,
                  device="cuda") -> np.ndarray:
    """SIGN precompute (reference _generate_sign_features,
    src/datasets/elph.py:87-110): gcn_norm then sign_k=0 -> one propagation
    replacing x; sign_k>0 -> concat [x, Ax, ..., A^k x].  The SpMM is the
    plan's add path (K1 merges it) when ``use_plan``, else a scatter
    ``segment_sum`` over the edges.  The plan's tables and staged weights
    are the stage ``setup.plans``."""
    dev = resolve_device(device)
    ei = torch.from_numpy(np.asarray(edge_index, dtype=np.int64)).to(dev)
    ew = (None if edge_weight is None
          else torch.from_numpy(np.asarray(edge_weight)).to(dev))
    nei, nw = gcn_norm(ei, ew, num_nodes)
    if use_plan:
        with spans.stage("setup.plans", dev):
            plan = make_auto_plan(nei.cpu().numpy(), num_nodes,
                                  max_slots=max_gather_slots, device=dev)
            wslots = plan.stage_edge_data(nw)

        def prop(v: torch.Tensor) -> torch.Tensor:
            return plan.reduce(v, "add", edge_data_slots=wslots)
    else:
        src, dst = nei[0].long(), nei[1].long()

        def prop(v: torch.Tensor) -> torch.Tensor:
            return segment_sum(v.index_select(0, src) * nw[:, None], dst,
                               num_nodes)
    cur = torch.from_numpy(np.asarray(x, dtype=np.float32)).to(dev)
    if sign_k == 0:
        return prop(cur).cpu().numpy()
    xs = [cur]
    for _ in range(sign_k):
        cur = prop(cur)
        xs.append(cur)
    return torch.cat(xs, dim=-1).cpu().numpy()


def _cache_name(cfg: Config, split: str, kind: str) -> Optional[str]:
    """The npz file of one cached array kind of one split, named as the
    JAX package names it, or None without ``cache_dir``."""
    if not cfg.cache_dir:
        return None
    hop_str = "" if cfg.max_hash_hops == 2 else f"{cfg.max_hash_hops}hop_"
    year_str = f"year_{cfg.year}" if (cfg.dataset_name == "ogbl-collab"
                                      and cfg.year > 0) else ""
    neg_str = ("" if cfg.num_negs == 1 or split != "train"
               else f"negs{cfg.num_negs}_")
    os.makedirs(cfg.cache_dir, exist_ok=True)
    return os.path.join(
        cfg.cache_dir,
        f"{cfg.dataset_name}_{split}_{neg_str}{year_str}{hop_str}{kind}.npz")


def save_sketches(path: str, sketches: Sketches) -> None:
    """The hash cache: MinHash as uint32 (the JAX package's layout), HLL
    registers and cardinalities as they are."""
    np.savez(path, minhash=from_biased(sketches.minhash),
             hll=sketches.hll.cpu().numpy(),
             cards=sketches.cards.cpu().numpy())


def load_sketches(path: str, device) -> Sketches:
    """A hash cache written by either package, on ``device``."""
    z = np.load(path)
    return Sketches(
        minhash=torch.from_numpy(to_biased(z["minhash"])).to(device),
        hll=torch.from_numpy(z["hll"]).to(device),
        cards=torch.from_numpy(z["cards"]).to(device))


def _knockout(sf: np.ndarray, cfg: Config) -> np.ndarray:
    """The floor / zero-one knockout, applied again after the cache as the
    reference does (src/datasets/elph.py:214-222): a cached file may come
    from a run with other flags."""
    sf = np.array(sf)
    if cfg.floor_sf:
        sf = np.maximum(sf, 0)
    if not cfg.use_zero_one:
        if cfg.max_hash_hops == 2:
            sf[:, [4, 5]] = 0
        elif cfg.max_hash_hops == 3:
            sf[:, [4, 5, 11, 12]] = 0
    return sf


def build_link_dataset(split_data: SplitData, cfg: Config, split: str,
                       model: Optional[str] = None,
                       directed: bool = False,
                       reuse_from: Optional[LinkDataset] = None,
                       device="cuda") -> LinkDataset:
    """Hydrate one split (reference HashDataset.__init__,
    src/datasets/elph.py:27-85).

    ``reuse_from``: a previously built split (usually train).  When this
    split's message graph is identical (valid shares the train edges), the
    SIGN features and the sketch tables are reused; per-link subgraph
    features and RA still run.

    Caches under ``cfg.cache_dir``, as in the JAX package: the SIGN
    features with ``load_features``, the sketch tables with
    ``load_hashes``, the subgraph features with
    ``cache_subgraph_features`` (a split whose subgraph features come from
    the cache builds no sketches; unlike the JAX package, the port also
    writes them for a split that reuses the train split's sketches).

    ``model`` (default ``cfg.model``) ELPH returns the split before any
    SIGN, sketch or subgraph-feature work, as the JAX package does.

    Stages (``spans.py``): ``setup.graph`` (coalesce, undirected, degrees,
    RA), ``setup.sign``, ``setup.plans``, ``setup.sketches`` and
    ``setup.features`` (with the features' copy to the host)."""
    model = model or cfg.model
    if model not in ("BUDDY", "ELPH"):
        raise NotImplementedError(f"preprocessing for {model} is not ported "
                                  f"yet (BUDDY and ELPH only)")
    dev = resolve_device(device)
    with spans.stage("setup.graph", dev):
        g = split_data.graph
        if cfg.dataset_name == "ogbl-collab":
            # compress multi-edges (src/datasets/elph.py:54-57)
            g = g.coalesce()
        if directed:
            # directed graphs become undirected for propagation and
            # subgraph features (src/datasets/elph.py:63-66)
            g = g.to_undirected()
        same_graph = (
            reuse_from is not None
            and reuse_from.num_nodes == g.num_nodes
            and reuse_from.edge_index.shape == g.edge_index.shape
            and np.array_equal(reuse_from.edge_index, g.edge_index)
            and np.array_equal(np.asarray(reuse_from.edge_weight),
                               np.asarray(g.weights)))
        links = split_data.links.astype(np.int32)
        labels = split_data.labels
        degrees = reuse_from.degrees if same_graph else g.degrees()

        RA = None
        if cfg.use_RA:
            RA = resource_allocation(g.csr(), links, batch_size=2000000)

    if model == "ELPH":
        # ELPH propagates the features in the model (JAX preprocess.py:179)
        return LinkDataset(links, labels, g.edge_index, g.weights,
                           g.num_nodes, g.x, degrees, RA=RA)

    feat_cache = _cache_name(cfg, split, f"k{cfg.sign_k}_features")
    if same_graph:
        x = reuse_from.x  # SIGN features depend only on the message graph
    elif feat_cache and cfg.load_features and os.path.exists(feat_cache):
        x = np.load(feat_cache)["x"]
    elif g.x is not None:
        with spans.stage("setup.sign", dev):
            x = sign_features(g.x, g.edge_index, g.edge_weight, g.num_nodes,
                              cfg.sign_k, use_plan=cfg.use_plan,
                              max_gather_slots=cfg.max_gather_slots,
                              device=dev)
        if feat_cache and cfg.load_features:
            np.savez(feat_cache, x=x)
    else:
        x = None

    params = sketch_params_from_config(cfg)
    sf_cache = _cache_name(cfg, split, "subgraph_features")
    sketches = reuse_from.sketches if same_graph else None
    sketch_perm = reuse_from.sketch_perm if same_graph else None
    batch = min(cfg.subgraph_feature_batch_size, 1 << 18)
    mesh = graph_mesh(cfg, dev)

    def features(sk, perm):
        with spans.stage("setup.features", dev):
            if mesh is not None and perm is not None:
                return node_sharded_subgraph_features_batched(
                    links, sk, params, mesh, perm=perm,
                    batch_size=batch).cpu().numpy()
            return subgraph_features_batched(links, sk, params,
                                             batch_size=batch).cpu().numpy()

    if sketches is not None:
        sf = features(sketches, sketch_perm)
        if sf_cache and cfg.cache_subgraph_features:
            # the JAX package writes no file here, so its next run builds
            # the sketches again for a split that shares the train graph
            np.savez(sf_cache, sf=sf)
    elif sf_cache and cfg.cache_subgraph_features \
            and os.path.exists(sf_cache):
        sf = np.load(sf_cache)["sf"]
        if sf.shape[0] != len(links):
            raise ValueError(
                f"cached subgraph features {sf_cache} hold {sf.shape[0]} "
                f"rows for {len(links)} links; delete the cache file and "
                f"regenerate")
    else:
        hash_cache = _cache_name(cfg, split, "hashes")
        if hash_cache and cfg.load_hashes and os.path.exists(hash_cache):
            sketches = load_sketches(hash_cache, dev)
        elif mesh is not None:
            # memory-sharded (the citation2-scale path): the tables never
            # sit whole on one device
            with spans.stage("setup.sketches", dev):
                part = make_node_partition(g.edge_index, g.num_nodes,
                                           mesh.axis_size("graph"))
                sketches = node_sharded_build_hash_tables(
                    part, params, mesh, max_gather_rows=cfg.max_gather_slots)
            sketch_perm = part.perm
        else:
            plan = None
            if cfg.use_plan:
                with spans.stage("setup.plans", dev):
                    plan = make_auto_plan(g.edge_index, g.num_nodes,
                                          max_slots=cfg.max_gather_slots,
                                          device=dev)
            with spans.stage("setup.sketches", dev):
                sketches = build_hash_tables(
                    g.edge_index, g.num_nodes, params, plan=plan,
                    hops_only=cfg.hops_only_sketches, device=dev)
            if hash_cache and cfg.load_hashes:
                save_sketches(hash_cache, sketches)
        sf = features(sketches, sketch_perm)
        if sf_cache and cfg.cache_subgraph_features:
            np.savez(sf_cache, sf=sf)
    return LinkDataset(links, labels, g.edge_index, g.weights, g.num_nodes,
                       x, degrees, subgraph_features=_knockout(sf, cfg),
                       RA=RA, sketches=sketches, sketch_perm=sketch_perm)


def graph_mesh(cfg: Config, device):
    """The run's mesh when it has a ``graph`` axis (the memory-sharded
    build), else None."""
    if not (cfg.mesh_shape and "graph" in (cfg.mesh_axes or [])):
        return None
    from subgraph_sketching_tpu_torch.parallel.mesh import mesh_from_config
    return mesh_from_config(cfg, device)


def build_all_splits(splits, cfg: Config, directed: bool = False,
                     device="cuda") -> Dict[str, LinkDataset]:
    """train/valid/test LinkDatasets (reference
    get_hashed_train_val_test_datasets, src/datasets/elph.py:245-265).
    Splits whose message graph equals the train split's reuse its SIGN
    features and sketch tables."""
    out: Dict[str, LinkDataset] = {}
    for name, sd in splits.items():
        out[name] = build_link_dataset(sd, cfg, name, directed=directed,
                                       reuse_from=out.get("train"),
                                       device=device)
    return out


def make_train_eval_dataset(train_ds: LinkDataset,
                            n_pos_samples: int = 5000) -> LinkDataset:
    """Small train subset for train-metric estimates on large datasets
    (citation2) — reference make_train_eval_data,
    src/datasets/elph.py:292-325, as in the JAX package.

    The negatives-per-positive count is derived from the dataset (the
    train split holds cfg.num_negs same-source negatives per positive,
    laid out in per-positive blocks after all positives), which keeps the
    k selected positives aligned with exactly their own negative blocks;
    the alignment is checked as the reference checks it."""
    n_pos_total = int(train_ds.labels.sum())
    n_neg_total = len(train_ds.links) - n_pos_total
    if n_pos_total == 0 or n_neg_total % n_pos_total:
        raise ValueError(
            f"train split is not per-positive-block aligned "
            f"({n_pos_total} positives, {n_neg_total} negatives); "
            f"regenerate the cached negatives")
    negs_per_pos = n_neg_total // n_pos_total
    n_pos = min(n_pos_samples, n_pos_total)
    n_neg = n_pos * negs_per_pos
    pos = train_ds.links[:n_pos]
    neg = train_ds.links[n_pos_total:n_pos_total + n_neg]
    if not (pos[:, 0].repeat(negs_per_pos) == neg[:, 0]).all():
        raise ValueError("negatives have different source nodes to "
                         "positives; delete cached negatives and regenerate")
    sf = train_ds.subgraph_features
    RA = None
    if train_ds.RA is not None:
        RA = np.concatenate([train_ds.RA[:n_pos],
                             train_ds.RA[n_pos_total:n_pos_total + n_neg]])
    return LinkDataset(
        links=np.concatenate([pos, neg]),
        labels=np.concatenate([np.ones(n_pos, np.float32),
                               np.zeros(n_neg, np.float32)]),
        edge_index=train_ds.edge_index, edge_weight=train_ds.edge_weight,
        num_nodes=train_ds.num_nodes, x=train_ds.x,
        degrees=train_ds.degrees,
        subgraph_features=np.concatenate(
            [sf[:n_pos], sf[n_pos_total:n_pos_total + n_neg]]),
        RA=RA, sketches=train_ds.sketches,
        sketch_perm=train_ds.sketch_perm)
