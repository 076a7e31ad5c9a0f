"""Training losses (reference src/runners/train.py:231-255), as the JAX
package's train/losses.py computes them.

With a data-parallel ``mesh`` (``parallel/mesh.py``) each rank passes its
block of the batch and gets the global batch's loss, the same value on
every rank; its backward reaches this rank's rows only, so the sum of the
ranks' gradients (the step's gradient all-reduce) is the global
gradient.  The padded tail lies at the end of the global batch, so a
rank may hold no real link: the BCE divides by the global count."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from subgraph_sketching_tpu_torch.parallel.collectives import (
    gather_replicated, sum_replicated,
)
from subgraph_sketching_tpu_torch.parallel.mesh import Mesh


def bce_loss(logits: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None,
             mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Mean sigmoid BCE over valid entries (reference bce_loss,
    train.py:244-245 = BCEWithLogitsLoss), in optax's form
    -y log σ(x) - (1-y) log σ(-x); over the global batch with ``mesh``."""
    x, y = logits.ravel(), labels.ravel()
    per = -y * F.logsigmoid(x) - (1 - y) * F.logsigmoid(-x)
    if mask is None and mesh is None:
        return per.mean()
    m = torch.ones_like(per) if mask is None else mask.ravel().to(per.dtype)
    total, count = torch.sum(per * m), torch.sum(m)
    if mesh is not None:
        total, count = sum_replicated(torch.stack([total, count]))
    return total / torch.clamp(count, min=1.0)


def auc_loss(logits: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None,
             mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Square pairwise ranking loss sum((1 - (pos - neg))^2).

    The reference pairs the i-th positive with the i-th negative after
    truncating to equal counts (train.py:231-241).  As in the JAX package,
    a stable sort puts positives (by label) first and negatives last, and
    pairs beyond min(n_pos, n_neg) are masked.  With ``mesh`` the pairs
    are those of the global batch, gathered on every rank.
    """
    if mesh is not None:
        labels = gather_replicated(labels.ravel(), mesh)
        if mask is not None:
            mask = gather_replicated(mask.ravel().to(labels.dtype), mesh)
        logits = gather_replicated(logits.ravel(), mesh)
    logits = logits.ravel()
    labels = labels.ravel()
    valid = (torch.ones_like(labels) if mask is None
             else mask.ravel().to(labels.dtype))
    n_pos = torch.sum((labels > 0.5) * valid)
    n_neg = torch.sum((labels <= 0.5) * valid)
    k = torch.minimum(n_pos, n_neg)
    pos_order = torch.argsort(-(labels * valid) - valid * 0.1, stable=True)
    neg_order = torch.argsort(labels * valid + (1 - valid) * 2.0, stable=True)
    idx = torch.arange(logits.shape[0], device=logits.device)
    pair_mask = (idx < k).to(logits.dtype)
    diff = 1.0 - (logits[pos_order] - logits[neg_order])
    return torch.sum(diff * diff * pair_mask)


def get_loss(name: str):
    if name == "bce":
        return bce_loss
    if name == "auc":
        return auc_loss
    raise NotImplementedError(name)
