"""Heuristic link-prediction baselines: RA, CN, AA, PPR.

    python -m subgraph_sketching_tpu_torch.runners.run_heuristics \
        --dataset_name synth-ba --heuristics RA,CN,AA,PPR

The JAX package's runners/run_heuristics.py (reference
src/runners/run_heuristics.py:23-108).  Scores are computed on the train
message-passing graph for the train and valid splits and on the test graph
for the test split, then evaluated with Hits@K or MRR, and AUC, on the
chosen device.  ``--device`` (default cuda; bare ``--device`` means cuda,
as the JAX package's flag means the accelerator) scores CN/AA/RA by
``DeviceHeuristics`` on that device; ``--device cpu`` runs the host
functions, the plain versions.  The JAX package's ``--platform`` (cpu or
gpu) picks the device when ``--device`` is not given and must agree with
it when it is.  PPR runs on the host either way, as in the
JAX package: one power iteration per unique source.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.device import (
    device_from_flags, resolve_device,
)
from subgraph_sketching_tpu_torch.graph.datasets import get_data
from subgraph_sketching_tpu_torch.heuristics import (
    DeviceHeuristics, adamic_adar, common_neighbours, personalized_pagerank,
    resource_allocation,
)
from subgraph_sketching_tpu_torch.train.evaluation import (
    evaluate_auc, evaluate_hits, evaluate_mrr,
)

HEURISTICS = {
    "RA": resource_allocation,
    "CN": common_neighbours,
    "AA": adamic_adar,
    "PPR": None,  # special-cased: returns its links too
}


def run(cfg: Config, heuristics=("RA", "CN", "AA", "PPR"), device=None,
        logger=None):
    """``device`` None: ``cfg.platform``'s, else cuda."""
    dev = resolve_device(device_from_flags(device, cfg.platform))
    # dataset-specific K (reference run_heuristics.py:27-31)
    k = 100
    if cfg.dataset_name == "ogbl-collab":
        k = 50
    elif cfg.dataset_name == "ogbl-ppi":
        k = 20
    # also evaluate at the config's --K when it differs, so heuristic rows
    # compare with model rows scored at cfg.K
    extra_ks = [cfg.K] if cfg.K and cfg.K != k else []
    if cfg.dataset_name == "ogbl-citation2":
        extra_ks = []  # MRR protocol: no Hits@K rides along

    # the dataset, its splits and CSRs (and the device scorers) are built
    # once per rep and shared by every heuristic
    results_by_name = {name: [] for name in heuristics}
    times = {name: 0.0 for name in heuristics}
    for rep in range(cfg.reps):
        cfg.seed = rep
        splits, directed, eval_metric = get_data(cfg)
        A_train = splits["train"].graph.csr()
        A_test = splits["test"].graph.csr()
        dev_scorers = {}
        if dev.type != "cpu" and any(n != "PPR" for n in heuristics):
            dev_scorers = {id(A_train): DeviceHeuristics(A_train, device=dev),
                           id(A_test): DeviceHeuristics(A_test, device=dev)}

        for name in heuristics:
            t0 = time.time()

            def score(A, links):
                if name == "PPR":
                    s, _ = personalized_pagerank(A, links)
                    return s
                if dev_scorers:
                    return dev_scorers[id(A)].scores(links, name)
                return HEURISTICS[name](A, links)

            preds = {}
            for split, A in (("train", A_train), ("valid", A_train),
                             ("test", A_test)):
                sd = splits[split]
                preds[split] = tuple(
                    torch.from_numpy(score(A, e)).to(dev)
                    for e in (sd.pos_edges, sd.neg_edges))

            (ptr, ntr), (pv, nv), (pt, nt) = (preds["train"], preds["valid"],
                                              preds["test"])
            extras = ()
            if cfg.dataset_name == "ogbl-citation2":
                res = evaluate_mrr(ptr, ntr, pv, nv, pt, nt)
                key = "MRR"
            else:
                res = evaluate_hits(ptr, ntr, pv, nv, pt, nt,
                                    Ks=[k] + extra_ks)
                key = f"Hits@{k}"
                extras = tuple(res[f"Hits@{ek}"][2] for ek in extra_ks)
            print(f"{name} rep {rep}: {key} {res[key]}")
            pv, nv, pt, nt = (t.cpu().numpy() for t in (pv, nv, pt, nt))
            auc = evaluate_auc(np.concatenate([pv, nv]),
                               np.concatenate([np.ones(len(pv)),
                                               np.zeros(len(nv))]),
                               np.concatenate([pt, nt]),
                               np.concatenate([np.ones(len(pt)),
                                               np.zeros(len(nt))]))
            print(f"{name} rep {rep}: AUC {auc['AUC']}")
            # AUC rides along with the hits/mrr triple: Hits@K saturates on
            # dense synthetic graphs while AUC still separates the
            # weightings
            results_by_name[name].append(tuple(res[key]) + tuple(auc["AUC"])
                                         + extras)
            times[name] += time.time() - t0

    all_results = {}
    for name in heuristics:
        arr = np.array(results_by_name[name]) * 100
        summary = {f"{name}_train_mean": arr[:, 0].mean(),
                   f"{name}_val_mean": arr[:, 1].mean(),
                   f"{name}_test_mean": arr[:, 2].mean(),
                   f"{name}_test_std": arr[:, 2].std(),
                   f"{name}_val_auc_mean": arr[:, 3].mean(),
                   f"{name}_test_auc_mean": arr[:, 4].mean()}
        for j, ek in enumerate(extra_ks):
            summary[f"{name}_hits{ek}_test_mean"] = arr[:, 5 + j].mean()
        print(summary)
        print(f"{name} scored in {times[name]:.1f}s over {cfg.reps} reps")
        all_results[name] = summary
        if logger is not None:
            logger.log(summary)
    return all_results


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_name", type=str, default="Cora")
    parser.add_argument("--reps", type=int, default=1)
    parser.add_argument("--heuristics", type=str, default="RA,CN,AA,PPR")
    parser.add_argument("--device", nargs="?", const="cuda", default=None,
                        help="torch device that scores CN/AA/RA (bucketed "
                             "neighbour intersection) and runs the metric "
                             "math; bare --device means cuda, --device cpu "
                             "runs the host functions (default: "
                             "--platform's device, else cuda)")
    parser.add_argument("--platform", type=str, default=None,
                        help="the JAX package's flag: cpu or gpu picks the "
                             "device when --device is not given; a value "
                             "that conflicts with --device raises")
    parser.add_argument("--data_root", type=str, default=None,
                        help="root of the raw dataset trees")
    # reference CLI compatibility (run_heuristics.py:116-120): wandb flags
    # route to the structured sink; sample_size is parse-only there too
    # ("Currently only implemented for producer data").
    parser.add_argument("--wandb_entity", type=str, default="link-prediction")
    parser.add_argument("--wandb_project", type=str, default="link-prediction")
    parser.add_argument("--wandb", action="store_true",
                        help="also mirror summaries to wandb if installed")
    parser.add_argument("--run_dir", type=str, default=None,
                        help="write summaries to <run_dir>/metrics.jsonl")
    parser.add_argument("--sample_size", type=int, default=None,
                        help="parse-only, as in the reference (producer data "
                             "is not a public dataset)")
    return parser


def main(argv=None):
    args = make_parser().parse_args(argv)
    if args.sample_size is not None:
        print("--sample_size is parse-only (reference implements it only "
              "for the private 'producer' dataset)")
    cfg = Config(dataset_name=args.dataset_name, reps=args.reps,
                 platform=args.platform, data_root=args.data_root)
    logger = None
    if args.run_dir or args.wandb:
        from subgraph_sketching_tpu_torch.metrics_logging import MetricsLogger
        logger = MetricsLogger(
            run_dir=args.run_dir, use_wandb=args.wandb,
            config=vars(args),
            wandb_kwargs={"entity": args.wandb_entity,
                          "project": args.wandb_project})
    try:
        return run(cfg, tuple(args.heuristics.split(",")), device=args.device,
                   logger=logger)
    finally:
        if logger is not None:
            logger.finish()  # the reference calls wandb.finish()


if __name__ == "__main__":
    main()
