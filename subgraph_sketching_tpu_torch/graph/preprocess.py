"""Per-split preprocessing for BUDDY: the HashDataset equivalent.

Produces what BUDDY training and serving need — links+labels, SIGN-propagated
node features, degrees, the sketch stacks and per-link subgraph features —
as the JAX package's graph/preprocess.py does (reference
src/datasets/elph.py:21-242).  The graph work runs on ``device`` through
the padded-tree plan and K1.

Not ported yet (queued): the RA feature, the node-sharded mesh build and
the ELPH dataset.  The npz caches are not read or written: rebuilding gives
the same arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.device import resolve_device
from subgraph_sketching_tpu_torch.graph.splits import SplitData
from subgraph_sketching_tpu_torch.ops.graph_ops import gcn_norm
from subgraph_sketching_tpu_torch.ops.segment_scan import make_auto_plan
from subgraph_sketching_tpu_torch.sketch.elph import (
    build_hash_tables, subgraph_features_batched,
)
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
    sketches: Optional[Sketches] = None  # retained for serving

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
    plan's add path (K1 merges it)."""
    if not use_plan:
        raise NotImplementedError(
            "only the plan SpMM is ported (use_plan=True)")
    dev = resolve_device(device)
    ei = torch.from_numpy(np.asarray(edge_index, dtype=np.int64)).to(dev)
    ew = (None if edge_weight is None
          else torch.from_numpy(np.asarray(edge_weight)).to(dev))
    nei, nw = gcn_norm(ei, ew, num_nodes)
    plan = make_auto_plan(nei.cpu().numpy(), num_nodes,
                          max_slots=max_gather_slots, device=dev)
    wslots = plan.stage_edge_data(nw)
    cur = torch.from_numpy(np.asarray(x, dtype=np.float32)).to(dev)
    if sign_k == 0:
        return plan.reduce(cur, "add", edge_data_slots=wslots).cpu().numpy()
    xs = [cur]
    for _ in range(sign_k):
        cur = plan.reduce(cur, "add", edge_data_slots=wslots)
        xs.append(cur)
    return torch.cat(xs, dim=-1).cpu().numpy()


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
    features still run."""
    model = model or cfg.model
    if model != "BUDDY":
        raise NotImplementedError(f"preprocessing for {model} is not ported "
                                  f"yet (BUDDY only)")
    if cfg.use_RA:
        raise NotImplementedError("--use_RA is not ported yet")
    if cfg.mesh_shape and "graph" in (cfg.mesh_axes or []):
        raise NotImplementedError("the node-sharded (graph mesh) build is "
                                  "not ported yet")
    dev = resolve_device(device)
    g = split_data.graph
    if cfg.dataset_name == "ogbl-collab":
        g = g.coalesce()  # compress multi-edges (src/datasets/elph.py:54-57)
    if directed:
        # directed graphs become undirected for propagation and subgraph
        # features (src/datasets/elph.py:63-66)
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

    if same_graph:
        x = reuse_from.x  # SIGN features depend only on the message graph
    elif g.x is not None:
        x = sign_features(g.x, g.edge_index, g.edge_weight, g.num_nodes,
                          cfg.sign_k, use_plan=cfg.use_plan,
                          max_gather_slots=cfg.max_gather_slots, device=dev)
    else:
        x = None

    params = sketch_params_from_config(cfg)
    if same_graph:
        sketches = reuse_from.sketches
    else:
        plan = make_auto_plan(g.edge_index, g.num_nodes,
                              max_slots=cfg.max_gather_slots, device=dev)
        sketches = build_hash_tables(g.edge_index, g.num_nodes, params,
                                     plan=plan,
                                     hops_only=cfg.hops_only_sketches)
    sf = subgraph_features_batched(
        links, sketches, params,
        batch_size=min(cfg.subgraph_feature_batch_size, 1 << 18))
    # subgraph_features already applies the floor / zero-one knockout from
    # the same params (the JAX package re-applies them after its cache)
    sf = sf.cpu().numpy()
    return LinkDataset(links, labels, g.edge_index, g.weights, g.num_nodes,
                       x, degrees, subgraph_features=sf, sketches=sketches)


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
