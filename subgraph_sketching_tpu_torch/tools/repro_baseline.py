"""The real-data quality gate: the reference README's reproduction
commands through the port's runner, recorded in a QUALITY artifact.

Counterpart of the JAX repository's ``tools/repro_baseline.py``, with its
``CONFIGS`` table as it is.  For each config the tool:

  1. detects whether its dataset is on disk: the Planetoid raw files
     under ``<data_root>/<name>/raw/``, or an extracted OGB tree with
     ``raw/edge.csv.gz`` under ``<data_root>/ogbl_*/`` (the port reads the
     raw layout itself, ``graph/datasets.py``; it never downloads and
     needs no ``ogb`` package, so a tree holding only ``processed/`` does
     not count);
  2. where it is: runs the command through ``runners.run`` (the
     leaderboard protocol: ``--reps`` repetitions, best-val selection)
     and merges the mean and std row into the artifact, written after
     every config;
  3. where it is not: prints what to place where.

The artifact is ``QUALITY_torch_r<NN>.json`` in the working directory
(``--out`` names another): the JAX package's ``QUALITY_r<NN>.json`` files
are its own record.  Runs on the card unless ``--device cpu`` (or
``--platform cpu``) is given, and raises where there is none.

    python -m subgraph_sketching_tpu_torch.tools.repro_baseline --all [--reps 10]
    python -m subgraph_sketching_tpu_torch.tools.repro_baseline --only cora-buddy,collab-buddy
    python -m subgraph_sketching_tpu_torch.tools.repro_baseline --check
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from subgraph_sketching_tpu_torch.device import (
    device_from_flags, resolve_device,
)
from subgraph_sketching_tpu_torch.graph.datasets import (
    PLANETOID_NAMES, default_data_root, ogb_raw_dir,
)
from subgraph_sketching_tpu_torch.runners.run import (
    config_from_parsed, make_parser, run,
)

# (name, metric, reference README command args — verbatim README.md:69-80,
# minus the `python runners/run.py` prefix; paper-reported BUDDY numbers
# from BASELINE.md recorded as provisional targets)
CONFIGS = {
    "cora-buddy": {
        "metric": "Hits@100", "target": 88.0,
        "args": ["--dataset_name", "Cora", "--model", "BUDDY"],
    },
    "citeseer-buddy": {
        "metric": "Hits@100", "target": 92.9,
        "args": ["--dataset_name", "Citeseer", "--model", "BUDDY"],
    },
    "pubmed-buddy": {
        "metric": "Hits@100", "target": 74.1,
        "args": ["--dataset_name", "Pubmed", "--max_hash_hops", "3",
                 "--feature_dropout", "0.2", "--model", "BUDDY"],
    },
    "collab-buddy": {
        "metric": "Hits@50", "target": 65.9,
        "args": ["--dataset_name", "ogbl-collab", "--K", "50", "--lr",
                 "0.02", "--feature_dropout", "0.05",
                 "--add_normed_features", "1", "--cache_subgraph_features",
                 "--label_dropout", "0.1", "--year", "2007", "--model",
                 "BUDDY"],
    },
    "citation2-buddy": {
        "metric": "MRR", "target": 87.6,
        "args": ["--dataset_name", "ogbl-citation2", "--hidden_channels",
                 "128", "--num_negs", "5", "--lr", "0.0005",
                 "--sign_dropout", "0.2", "--feature_dropout", "0.7",
                 "--label_dropout", "0.8", "--sign_k", "3", "--batch_size",
                 "261424", "--eval_batch_size", "522848",
                 "--cache_subgraph_features", "--model", "BUDDY"],
    },
    # the remaining two reference README commands (README.md:77-79; not in
    # BASELINE.md's five-config target set, included for full coverage).
    # The ppa line fixes the README's literal typos
    # ("----use_zero_one 1 model BUDDY") to their evident intent.
    "ppa-buddy": {
        "metric": "Hits@100", "target": 49.9,
        "args": ["--dataset_name", "ogbl-ppa", "--label_dropout", "0.1",
                 "--use_feature", "0", "--use_RA", "1", "--lr", "0.03",
                 "--epochs", "100", "--hidden_channels", "256",
                 "--cache_subgraph_features", "--add_normed_features", "1",
                 "--use_zero_one", "1", "--model", "BUDDY"],
    },
    "ddi-buddy": {
        "metric": "Hits@20", "target": 78.5,
        "args": ["--dataset_name", "ogbl-ddi", "--K", "20",
                 "--train_node_embedding", "--propagate_embeddings",
                 "--label_dropout", "0.25", "--epochs", "150",
                 "--hidden_channels", "256", "--lr", "0.0015",
                 "--num_negs", "6", "--use_feature", "0", "--sign_k", "2",
                 "--cache_subgraph_features", "--batch_size", "131072",
                 "--model", "BUDDY"],
    },
}

PLANETOID_FILES = "ind.{key}.{{x,tx,allx,graph,test.index,...}}"
RUNNER = "python -m subgraph_sketching_tpu_torch.runners.run"


def artifact_path(round_: int) -> str:
    """The default artifact: ``QUALITY_torch_r<NN>.json`` in the working
    directory."""
    return f"QUALITY_torch_r{round_:02d}.json"


def dataset_status(dataset_name: str, data_root: str):
    """(available: bool, what to place where when it is not)."""
    if dataset_name in PLANETOID_NAMES:
        key = PLANETOID_NAMES[dataset_name]
        for cand in (os.path.join(data_root, dataset_name, "raw"),
                     os.path.join(data_root, dataset_name.lower(), "raw")):
            if os.path.exists(os.path.join(cand, f"ind.{key}.x")):
                return True, ""
        return False, (
            f"place the standard Planetoid raw files "
            f"({PLANETOID_FILES.format(key=key)}) under "
            f"{os.path.join(data_root, dataset_name, 'raw')}/ - e.g. from "
            f"github.com/kimiyoung/planetoid (data/) or any "
            f"torch_geometric Planetoid download")
    base = ogb_raw_dir(dataset_name, data_root)
    if os.path.exists(os.path.join(base, "raw", "edge.csv.gz")):
        return True, ""
    return False, (
        f"place the extracted OGB dataset at {base}/ "
        f"(raw/edge.csv.gz, raw/num-node-list.csv.gz, raw/node-feat.csv.gz "
        f"when present, raw/edge_*.csv.gz extras, split/<type>/"
        f"{{train,valid,test}}.pt) - download once with the ogb package on "
        f"a machine with network access and copy the directory")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--all", action="store_true",
                    help="run every config whose dataset is available")
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of config names")
    ap.add_argument("--check", action="store_true",
                    help="report dataset availability and exit")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--round", type=int, default=3)
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: --platform's, else cuda)")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override the command's epoch count (smoke runs)")
    ap.add_argument("--out", default=None,
                    help="artifact path (default QUALITY_torch_r{N}.json in "
                         "the working directory)")
    args = ap.parse_args(argv)
    device = resolve_device(device_from_flags(args.device, args.platform))
    data_root = args.data_root or default_data_root()

    if args.only:
        names = [n for n in args.only.split(",") if n]
        unknown = [n for n in names if n not in CONFIGS]
        if unknown:
            ap.error(f"unknown config(s) {unknown}; "
                     f"choose from {sorted(CONFIGS)}")
    else:
        names = list(CONFIGS)

    path = args.out or artifact_path(args.round)
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            out = json.load(f)

    any_run = False
    for name in names:
        spec = CONFIGS[name]
        ds = spec["args"][spec["args"].index("--dataset_name") + 1]
        ok, instruction = dataset_status(ds, data_root)
        if not ok:
            print(f"[{name}] {ds}: NOT AVAILABLE - {instruction}")
            continue
        print(f"[{name}] {ds}: available")
        if args.check:
            continue
        cfg = config_from_parsed(make_parser().parse_args(
            spec["args"] + ["--reps", str(args.reps)]))
        cfg.data_root = data_root
        if args.epochs is not None:
            cfg.epochs = args.epochs
        t0 = time.time()
        results = run(cfg, device=device)
        test = np.asarray([r[0] for r in results]) * 100
        val = np.asarray([r[1] for r in results]) * 100
        out[name] = {
            "metric": spec["metric"],
            "test_mean": round(float(test.mean()), 2),
            "test_std": round(float(test.std()), 2),
            "val_mean": round(float(val.mean()), 2),
            "val_std": round(float(val.std()), 2),
            "reps": args.reps,
            "reference_paper_target": spec["target"],
            "wall_s": round(time.time() - t0, 1),
            "command": (f"{RUNNER} " + " ".join(spec["args"])
                        + f" --reps {args.reps}"),
        }
        any_run = True
        print(name, out[name], flush=True)
        with open(path, "w") as f:  # persist after every config
            json.dump(out, f, indent=2)
    if any_run:
        print("wrote", os.path.abspath(path))
    elif not args.check:
        print("no datasets available; nothing run (see instructions above)")


if __name__ == "__main__":
    main()
