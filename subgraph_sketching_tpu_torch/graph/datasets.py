"""Dataset registry of the port: synthetic graphs, Planetoid and OGB from
disk.

A copy of the JAX package's graph/datasets.py.  ``get_data`` keeps its
contract (returns ``(splits, directed, eval_metric)``, reference
src/data.py:67-119) and gives splits equal to the JAX package's for every
dataset name it accepts:

  * ``synth-*`` — bundled synthetic graphs with random features
  * Cora/Citeseer/Pubmed — parsed from the standard Planetoid raw files
    under the data root, restricted to their largest connected component
  * ogbl-* — parsed from the raw OGB layout under the data root

Nothing is downloaded.  The port reads the OGB layout itself with numpy
and gzip (``np.loadtxt``, numpy's C parser), where the JAX package uses
pandas and, when installed, the ``ogb`` package: the port needs neither.
"""

from __future__ import annotations

import gzip
import os
import pickle
from typing import Dict, Tuple

import numpy as np
import scipy.sparse as ssp

from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.graph.container import Graph
from subgraph_sketching_tpu_torch.graph.lcc import use_lcc
from subgraph_sketching_tpu_torch.graph.splits import (
    SplitData, negative_sampling, random_link_split, same_source_negatives,
)
from subgraph_sketching_tpu_torch.graph.synthetic import (
    barabasi_albert_graph, erdos_renyi_graph, watts_strogatz_graph,
    watts_strogatz_graph_fast,
)

PLANETOID_NAMES = {"Cora": "cora", "Citeseer": "citeseer", "Pubmed": "pubmed"}


def default_data_root() -> str:
    """``SKETCH_DATA_ROOT``, else ``dataset/`` at the root of the checkout
    that holds this package."""
    return os.environ.get(
        "SKETCH_DATA_ROOT",
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "dataset"))


# --------------------------------------------------------------- synthetic --

def synthetic_graph(name: str, seed: int = 0) -> Graph:
    """Deterministic synthetic dataset with random node features."""
    rng = np.random.default_rng(seed + 17)
    if name == "synth-ba":
        ei = barabasi_albert_graph(1000, 5, seed=seed)
        n = 1000
    elif name == "synth-ba-large":
        ei = barabasi_albert_graph(20000, 10, seed=seed)
        n = 20000
    elif name == "synth-er":
        ei = erdos_renyi_graph(1000, 0.01, seed=seed)
        n = 1000
    elif name == "synth-ws":
        # small-world: high clustering -> informative structure features
        ei = watts_strogatz_graph(2000, 10, 0.1, seed=seed)
        n = 2000
    elif name.startswith("synth-ws-"):
        # parameterised scale testbed: synth-ws-<num_nodes> (vectorised
        # generator)
        n = int(name[len("synth-ws-"):])
        ei = watts_strogatz_graph_fast(n, 10, 0.1, seed=seed)
    else:
        raise ValueError(f"unknown synthetic dataset {name}")
    x = (rng.random((n, 128)) < 0.05).astype(np.float32)  # sparse bag-of-words-like
    return Graph(ei, n, x=x)


# --------------------------------------------------------------- planetoid --

def _parse_planetoid_index(path: str) -> np.ndarray:
    with open(path) as f:
        return np.array([int(line.strip()) for line in f], dtype=np.int64)


def load_planetoid(name: str, root: str) -> Graph:
    """Parse the standard Planetoid raw files (ind.<name>.{x,tx,allx,graph,
    test.index}) under ``<root>/<name>/raw`` (or ``<root>/<name lower>/raw``,
    torch_geometric's layout): the data the reference loads through
    torch_geometric's Planetoid class (src/data.py:95)."""
    key = PLANETOID_NAMES[name]
    raw = os.path.join(root, name, "raw")
    if not os.path.isdir(raw):
        alt = os.path.join(root, name.lower(), "raw")
        if os.path.isdir(alt):
            raw = alt
        else:
            raise FileNotFoundError(
                f"Planetoid raw files not found under {raw}: nothing is "
                f"downloaded — place ind.{key}.* there, or use a synth-* "
                f"dataset")

    def load(obj):
        # the files are pickles written by python 2 (latin1 strings)
        with open(os.path.join(raw, f"ind.{key}.{obj}"), "rb") as f:
            return pickle.load(f, encoding="latin1")

    x, tx, allx = load("x"), load("tx"), load("allx")
    graph = load("graph")
    test_idx = _parse_planetoid_index(
        os.path.join(raw, f"ind.{key}.test.index"))
    test_idx_range = np.sort(test_idx)

    if name == "Citeseer":
        # citeseer has isolated test nodes; fill the gap rows with zeros
        full_range = np.arange(test_idx_range[0], test_idx_range[-1] + 1)
        tx_ext = ssp.lil_matrix((len(full_range), x.shape[1]))
        tx_ext[test_idx_range - test_idx_range[0], :] = tx
        tx = tx_ext

    features = ssp.vstack((allx, tx)).tolil()
    features[test_idx, :] = features[test_idx_range, :]
    features = np.asarray(features.todense(), dtype=np.float32)

    rows, cols = [], []
    for v, nbrs in graph.items():
        rows.extend([v] * len(nbrs))
        cols.extend(nbrs)
    ei = np.stack([np.array(rows), np.array(cols)]).astype(np.int32)
    # symmetrise + dedup + drop self loops (PyG's Planetoid does to_undirected)
    keep = ei[0] != ei[1]
    ei = ei[:, keep]
    g = Graph(ei, features.shape[0], x=features).to_undirected()
    g.edge_weight = None  # unweighted
    return g


# --------------------------------------------------------------------- ogb --

# dataset metadata the ogb package reads from its bundled master.csv
# (ogb/linkproppred/master.csv): the split directory name, and whether the
# raw edge list is undirected (stored one direction, the loader adds the
# inverse)
_OGB_META = {
    "ogbl-collab": {"split": "time", "add_inverse_edge": True},
    "ogbl-ppa": {"split": "throughput", "add_inverse_edge": True},
    "ogbl-ddi": {"split": "target", "add_inverse_edge": True},
    "ogbl-citation2": {"split": "time", "add_inverse_edge": False},
}


def _read_csv_gz(path: str, dtype) -> np.ndarray:
    """A headerless comma-separated ``.csv.gz`` as a 2-d array.  Floats are
    parsed as float64 (correctly rounded) and then cast, as the JAX
    package's pandas reader casts its float64 column."""
    parse = np.int64 if np.issubdtype(dtype, np.integer) else np.float64
    with gzip.open(path, "rt") as f:
        return np.loadtxt(f, dtype=parse, delimiter=",", ndmin=2).astype(
            dtype, copy=False)


def _numpyify(obj):
    """torch tensors -> numpy, recursively (split .pt files store tensors)."""
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.numpy()
    if isinstance(obj, dict):
        return {k: _numpyify(v) for k, v in obj.items()}
    return obj


def ogb_raw_dir(name: str, root: str) -> str:
    return os.path.join(root, name.replace("-", "_"))


def load_ogb_raw(name: str, root: str):
    """Parse the standard OGB on-disk layout, which the ogb package
    extracts (ogb/io/read_graph_raw.py + ogb/linkproppred/dataset.py):

      <root>/<name with - as _>/
        raw/edge.csv.gz            [E, 2] int, one direction for
                                   undirected datasets (the inverse is
                                   added here, per add_inverse_edge)
        raw/num-node-list.csv.gz   [1] int
        raw/node-feat.csv.gz       [N, F] float (absent for ddi)
        raw/edge_weight.csv.gz     [E, 1] (collab)
        raw/edge_year.csv.gz       [E, 1] (collab)
        split/<split-name>/{train,valid,test}.pt   torch.save'd dicts

    Returns ``(data, split_edge)`` shaped like ``(LinkPropPredDataset[0],
    .get_edge_split())``.
    """
    if name not in _OGB_META:
        raise ValueError(f"unknown ogb dataset {name}")
    meta = _OGB_META[name]
    base = ogb_raw_dir(name, root)
    raw = os.path.join(base, "raw")
    edge_path = os.path.join(raw, "edge.csv.gz")
    if not os.path.exists(edge_path):
        raise FileNotFoundError(edge_path)
    edges = _read_csv_gz(edge_path, np.int64)            # [E, 2]
    num_nodes = int(_read_csv_gz(
        os.path.join(raw, "num-node-list.csv.gz"), np.int64)[0, 0])
    data = {"num_nodes": num_nodes, "node_feat": None, "edge_feat": None}
    feat_path = os.path.join(raw, "node-feat.csv.gz")
    if os.path.exists(feat_path):
        data["node_feat"] = _read_csv_gz(feat_path, np.float32)
    # additional per-edge files (collab: edge_weight, edge_year)
    extra = {}
    for fn in sorted(os.listdir(raw)):
        if fn.startswith("edge_") and fn.endswith(".csv.gz"):
            extra[fn[:-len(".csv.gz")]] = _read_csv_gz(
                os.path.join(raw, fn), np.int64)
    ei = edges.T                                          # [2, E]
    if meta["add_inverse_edge"]:
        ei = np.concatenate([ei, ei[::-1]], axis=1)
        extra = {k: np.concatenate([v, v]) for k, v in extra.items()}
    data["edge_index"] = ei
    data.update(extra)
    import torch
    split_edge = {}
    for split in ("train", "valid", "test"):
        pt = os.path.join(base, "split", meta["split"], f"{split}.pt")
        split_edge[split] = _numpyify(
            torch.load(pt, map_location="cpu", weights_only=False))
    return data, split_edge


def load_ogb(name: str, cfg: Config, root: str
             ) -> Tuple[Dict[str, SplitData], bool, str]:
    """OGB linkprop datasets from the raw layout (``load_ogb_raw``).

    Mirrors reference get_ogb_data (src/data.py:144-238): per-split
    supervision edges from the official split, train negatives sampled
    (same-source for citation2), collab's year filter and its
    val-edges-in-test-graph rule.
    """
    try:
        data, split_edge = load_ogb_raw(name, root)
    except FileNotFoundError as e:
        raise FileNotFoundError(
            f"the raw {name} layout was not found ({e}).  Place the "
            f"extracted OGB dataset at {ogb_raw_dir(name, root)}/ "
            f"(raw/*.csv.gz + split/), e.g. by downloading it with the ogb "
            f"package on a machine with network access and copying the "
            f"directory.") from e
    num_nodes = int(data["num_nodes"])
    x = None if data.get("node_feat") is None else np.asarray(
        data["node_feat"], dtype=np.float32)
    if name == "ogbl-ddi":
        x = np.ones((num_nodes, 1), dtype=np.float32)
    edge_index = np.asarray(data["edge_index"], dtype=np.int32)
    # collab's multigraph weights live in the 'edge_weight' additional edge
    # file (edge_feat is None there); the reference reads the PyG attribute
    # fed from the same file (data.py:176-182)
    edge_weight = None
    if data.get("edge_weight") is not None:
        edge_weight = np.asarray(data["edge_weight"], dtype=np.float32).ravel()
    elif data.get("edge_feat") is not None and data["edge_feat"].shape[1] == 1:
        edge_weight = np.asarray(data["edge_feat"], dtype=np.float32).ravel()

    directed = name.startswith("ogbl-citation")
    eval_metric = "mrr" if directed else "hits"
    rng = np.random.default_rng(cfg.seed)

    def pos_of(split):
        se = split_edge[split]
        if "edge" in se:
            return np.asarray(se["edge"], dtype=np.int32)
        return np.stack([se["source_node"], se["target_node"]],
                        axis=1).astype(np.int32)

    def neg_of(split):
        se = split_edge[split]
        if "edge_neg" in se:
            return np.asarray(se["edge_neg"], dtype=np.int32)
        if "target_node_neg" in se:
            src = np.asarray(se["source_node"])
            tneg = np.asarray(se["target_node_neg"])
            return np.stack([np.repeat(src, tneg.shape[1]),
                             tneg.ravel()], axis=1).astype(np.int32)
        raise ValueError(f"{name} {split}: the split holds no negatives "
                         f"(edge_neg or target_node_neg)")

    # collab year filter (reference src/data.py:110-111,122-141)
    if name == "ogbl-collab" and cfg.year > 0:
        years = np.asarray(split_edge["train"]["year"]).ravel()
        keep = years >= cfg.year
        split_edge["train"]["edge"] = np.asarray(
            split_edge["train"]["edge"])[keep]
        w = np.asarray(split_edge["train"]["weight"])[keep]
        tr = np.asarray(split_edge["train"]["edge"]).T.astype(np.int32)
        g = Graph(tr, num_nodes, w.astype(np.float32), x).to_undirected()
        edge_index, edge_weight = g.edge_index, g.edge_weight

    # train-negative disk cache (reference data.py:152-163), keyed by
    # dataset, negatives per positive, year and seed, as in the JAX package
    negs_dir = (cfg.cache_dir if cfg.cache_dir
                else ogb_raw_dir(name, root)
                if os.path.isdir(ogb_raw_dir(name, root)) else None)
    negs_path = None
    if negs_dir:
        k_str = "" if cfg.num_negs == 1 else f"_{cfg.num_negs}"
        year_str = (f"_year{cfg.year}"
                    if name == "ogbl-collab" and cfg.year > 0 else "")
        negs_path = os.path.join(
            negs_dir,
            f"{name}_negative_samples{k_str}{year_str}_seed{cfg.seed}.npz")
    if negs_path and os.path.exists(negs_path):
        train_negs = np.load(negs_path)["negs"]
    else:
        if directed:
            train_negs = same_source_negatives(num_nodes, cfg.num_negs,
                                               pos_of("train"), rng)
        else:
            loops = np.arange(num_nodes, dtype=np.int32)
            forbidden = np.concatenate(
                [edge_index, np.stack([loops, loops])], axis=1)
            train_negs = negative_sampling(
                forbidden, num_nodes, len(pos_of("train")) * cfg.num_negs,
                rng, forbid_self_loops=False)
        if negs_path:
            os.makedirs(negs_dir, exist_ok=True)
            np.savez(negs_path, negs=train_negs)

    splits: Dict[str, SplitData] = {}
    for split in ("train", "valid", "test"):
        neg = train_negs if split == "train" else neg_of(split)
        ei, w = edge_index, edge_weight
        if split == "test" and name == "ogbl-collab":
            # only collab may use val edges at test time (src/data.py:171-176)
            ve = np.asarray(split_edge["valid"]["edge"]).T.astype(np.int32)
            vw = np.asarray(split_edge["valid"]["weight"]).astype(
                np.float32).ravel()
            both = np.concatenate([ve, ve[::-1]], axis=1)
            bw = np.concatenate([vw, vw])
            ei = np.concatenate([edge_index, both], axis=1)
            w = np.concatenate(
                [edge_weight if edge_weight is not None
                 else np.ones(edge_index.shape[1], np.float32), bw])
        splits[split] = SplitData(graph=Graph(ei, num_nodes, w, x),
                                  pos_edges=pos_of(split), neg_edges=neg)
    return splits, directed, eval_metric


# -------------------------------------------------------------------- main --

def get_data(cfg: Config) -> Tuple[Dict[str, SplitData], bool, str]:
    """Load + split a dataset (reference get_data, src/data.py:67-119)."""
    name = cfg.dataset_name
    root = cfg.data_root or default_data_root()
    if name.startswith("ogbl"):
        return load_ogb(name, cfg, root)
    if name.startswith("synth"):
        g = synthetic_graph(name, seed=cfg.seed)
    elif name in PLANETOID_NAMES:
        g = use_lcc(load_planetoid(name, root))
    else:
        raise ValueError(f"unknown dataset {name}")
    splits = random_link_split(g, cfg.val_pct, cfg.test_pct, seed=cfg.seed,
                               neg_ratio=cfg.num_negs)
    return splits, False, "hits"
