"""Evaluation metrics: Hits@K, MRR, ROC-AUC.

The ogb Evaluator math the reference wraps (src/evaluation.py), computed
as the JAX package's train/evaluation.py computes it (float32 means as XLA
forms them, the numpy average-rank AUC), so identical predictions give
identical Hits@K and AUC; MRR's float32 sum of reciprocal ranks may add
in another order than XLA's:
  * hits@K = mean(pos_pred > K-th best negative)  (ogb's formula)
  * mrr: per positive, rank among its own negatives,
    rank = (optimistic + pessimistic) / 2 + 1, mrr = mean(1/rank)
  * auc: rank-based Mann-Whitney formulation (sklearn-compatible with tie
    handling via average ranks)
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def _mean(t: torch.Tensor) -> float:
    """float32 mean as XLA computes jnp.mean: the sum times the float32
    reciprocal of the count (not the sum over the count, which differs in
    the last bit)."""
    inv = torch.tensor(1.0, dtype=torch.float32) / t.numel()
    return float(torch.sum(t.to(torch.float32)) * inv)


def hits_at_k(pos_pred, neg_pred, k: int) -> float:
    """ogb: kth_score = K-th largest negative; hits = mean(pos > kth)."""
    neg_pred = _t(neg_pred).ravel()
    if neg_pred.shape[0] < k:
        return 1.0
    kth = torch.sort(neg_pred).values[-k]
    return _mean(_t(pos_pred).ravel() > kth)


def mrr(pos_pred, neg_pred) -> float:
    """neg_pred [Np, num_negs] (reference reshapes to per-positive rows,
    src/evaluation.py:57-59)."""
    pos = _t(pos_pred).reshape(-1, 1)
    neg = _t(neg_pred)
    opt = torch.sum((neg > pos).to(torch.float32), dim=1)
    pess = torch.sum((neg >= pos).to(torch.float32), dim=1)
    ranking = 0.5 * (opt + pess) + 1.0
    return _mean(1.0 / ranking)


def roc_auc(pred, labels) -> float:
    """Mann-Whitney AUC with average ranks for ties."""
    pred = np.asarray(pred).ravel()
    labels = np.asarray(labels).ravel()
    order = np.argsort(pred, kind="mergesort")
    ranks = np.empty(len(pred))
    sorted_pred = pred[order]
    # average ranks over tied groups
    i = 0
    r = np.arange(1, len(pred) + 1, dtype=np.float64)
    while i < len(pred):
        j = i
        while j + 1 < len(pred) and sorted_pred[j + 1] == sorted_pred[i]:
            j += 1
        r[i:j + 1] = 0.5 * (i + 1 + j + 1)
        i = j + 1
    ranks[order] = r
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[labels > 0.5].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def evaluate_hits(pos_train, neg_train, pos_val, neg_val, pos_test, neg_test,
                  Ks=(100,), use_val_negs_for_train: bool = True
                  ) -> Dict[str, Tuple[float, float, float]]:
    """(reference src/evaluation.py:7-43: train hits are measured against the
    val negatives by default, to make train/val comparable)."""
    results = {}
    neg_for_train = neg_val if use_val_negs_for_train else neg_train
    for k in Ks:
        results[f"Hits@{k}"] = (hits_at_k(pos_train, neg_for_train, k),
                                hits_at_k(pos_val, neg_val, k),
                                hits_at_k(pos_test, neg_test, k))
    return results


def evaluate_mrr(pos_train, neg_train, pos_val, neg_val, pos_test, neg_test
                 ) -> Dict[str, Tuple[float, float, float]]:
    """(reference src/evaluation.py:46-81; train negatives are same-source so
    val negatives cannot be substituted)."""
    def shape(neg, pos):
        return _t(neg).reshape(len(pos), -1)
    return {"MRR": (mrr(pos_train, shape(neg_train, pos_train)),
                    mrr(pos_val, shape(neg_val, pos_val)),
                    mrr(pos_test, shape(neg_test, pos_test)))}


def evaluate_auc(val_pred, val_true, test_pred, test_true,
                 train_pred=None, train_true=None
                 ) -> Dict[str, Tuple[float, ...]]:
    """(reference src/evaluation.py:84-98.)  The full (train, val, test)
    triple when train predictions are given, as in the JAX package (the
    reference returns (val, test) only and its runner cannot unpack it)."""
    val_auc = roc_auc(val_pred, val_true)
    test_auc = roc_auc(test_pred, test_true)
    if train_pred is None:
        return {"AUC": (val_auc, test_auc)}
    return {"AUC": (roc_auc(train_pred, train_true), val_auc, test_auc)}
