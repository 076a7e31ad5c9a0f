"""Evaluation orchestration (reference src/runners/inference.py:27-51), as
the JAX package's train/inference.py."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.train.evaluation import (
    evaluate_auc, evaluate_hits, evaluate_mrr,
)


def get_split_samples(split: str, cfg: Config, dataset_len: int) -> int:
    """(reference inference.py:143-163.)"""
    samples = dataset_len

    def num(sample_arg):
        if sample_arg < 1:
            return int(sample_arg * dataset_len)
        return int(min(sample_arg, dataset_len))

    if split == "train" and cfg.dynamic_train:
        samples = num(cfg.train_samples)
    elif split in ("val", "valid") and cfg.dynamic_val:
        samples = num(cfg.val_samples)
    elif split == "test" and cfg.dynamic_test:
        samples = num(cfg.test_samples)
    return samples


def _split_pos_neg(pred: np.ndarray, labels: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    return pred[labels == 1], pred[labels == 0]


def test(trainer, model, cfg: Config, eval_metric: str = "hits",
         train_split: str = "train") -> Dict[str, tuple]:
    """Predict on train/valid/test with ``model`` and compute the configured
    metric.

    ``train_split`` may point at a dedicated train-eval subset (citation2,
    reference data.py:55-59).
    """
    preds = {}
    for split, name in ((train_split, "train"), ("valid", "valid"),
                        ("test", "test")):
        n = get_split_samples(name if name != "valid" else "val", cfg,
                              trainer.num_links(split))
        pred, labels = trainer.predict(model, split, n_samples=n)
        preds[name] = _split_pos_neg(pred, labels)

    (ptr, ntr), (pv, nv), (pt, nt) = (preds["train"], preds["valid"],
                                      preds["test"])
    if eval_metric == "hits":
        return evaluate_hits(ptr, ntr, pv, nv, pt, nt, Ks=[cfg.K])
    if eval_metric == "mrr":
        return evaluate_mrr(ptr, ntr, pv, nv, pt, nt)
    if eval_metric == "auc":
        return evaluate_auc(np.concatenate([pv, nv]),
                            np.concatenate([np.ones(len(pv)), np.zeros(len(nv))]),
                            np.concatenate([pt, nt]),
                            np.concatenate([np.ones(len(pt)), np.zeros(len(nt))]),
                            np.concatenate([ptr, ntr]),
                            np.concatenate([np.ones(len(ptr)),
                                            np.zeros(len(ntr))]))
    raise ValueError(eval_metric)
