"""Run-to-run determinism check of a training epoch.

An epoch of the port is a function of (model, optimizer, seed): the
shuffle and every dropout mask come from a generator seeded with the
epoch's seed.  So nondeterminism (an atomic reduction in a backward, a
library algorithm chosen per call, a racy kernel) shows as a difference
between two runs of the same epoch from the same state.  Enable with
``--check_determinism`` (runs once, before training starts).
"""

from __future__ import annotations

import copy
from typing import Tuple

import torch


def _state_tensors(model: torch.nn.Module,
                   optimizer: torch.optim.Optimizer) -> list:
    """(name, tensor) for every model state_dict entry and every optimizer
    state tensor, in a fixed order."""
    out = list(model.state_dict().items())
    for i, st in sorted(optimizer.state_dict()["state"].items()):
        out += [(f"optimizer.{i}.{k}", v) for k, v in sorted(st.items())
                if isinstance(v, torch.Tensor)]
    return out


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality (NaN-safe: compares the bytes)."""
    a, b = (t.detach().cpu().reshape(-1).view(torch.uint8) for t in (a, b))
    return torch.equal(a, b)


def check_epoch_determinism(trainer, model: torch.nn.Module,
                            optimizer: torch.optim.Optimizer,
                            seed: int) -> Tuple[int, float]:
    """Run one training epoch twice, each from a deep copy of ``model`` and
    ``optimizer`` (copied together, so each copy's optimizer steps its own
    copy's parameters) with the same ``seed``, and assert that every state
    tensor and the loss are bit-identical.

    Returns (number of tensors compared, loss).  Raises AssertionError
    naming the tensors that differ.  The caller's model and optimizer are
    left untouched.
    """
    runs = []
    for _ in range(2):
        m, opt = copy.deepcopy((model, optimizer))
        loss = trainer.train_epoch(m, opt, seed)
        runs.append((_state_tensors(m, opt), loss))
    (s1, l1), (s2, l2) = runs
    bad = [n for (n, a), (_, b) in zip(s1, s2) if not _bits_equal(a, b)]
    if bad or l1 != l2:
        raise AssertionError(
            f"nondeterministic epoch: loss {l1!r} vs {l2!r}, {len(bad)}/"
            f"{len(s1)} state tensors differ bitwise ({bad[:8]}"
            f"{'...' if len(bad) > 8 else ''}). This indicates an unstable "
            f"reduction or a racy kernel — file it before trusting any run.")
    return len(s1), float(l1)
