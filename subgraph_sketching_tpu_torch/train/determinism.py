"""Run-to-run determinism check of a training epoch.

An epoch of the port is a function of (model, optimizer, seed): the
shuffle and every dropout mask come from a generator seeded with the
epoch's seed.  SEAL's fringe sampling draws from the stdlib ``random``
stream, which the check sets to the same state before each run and
leaves as it found it.  So nondeterminism (an atomic reduction in a
backward, a library algorithm chosen per call, a racy kernel) shows as
a difference between two runs of the same epoch from the same state.
Enable with ``--check_determinism`` (runs once, before training
starts).

Data parallelism: every rank runs the check (its collectives are part of
the epoch), and the two runs must also leave every rank with the same
state bits (:func:`assert_ranks_agree`), the property that makes a
data-parallel step one step on the global batch.
"""

from __future__ import annotations

import copy
import hashlib
import random
from typing import Tuple

import torch
import torch.distributed as dist

from subgraph_sketching_tpu_torch.parallel import multihost


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


def assert_ranks_agree(model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer) -> int:
    """Raise unless every rank of the process group holds the same model
    and optimizer state, bit for bit: each rank hashes its state tensors
    (in ``_state_tensors``' order) and the digests are gathered.  Returns
    the number of tensors hashed; a no-op at world size 1."""
    if multihost.world_size() == 1:
        return 0
    digest = hashlib.sha256()
    tensors = _state_tensors(model, optimizer)
    for _, t in tensors:
        digest.update(t.detach().cpu().reshape(-1).view(torch.uint8)
                      .numpy().tobytes())
    digests = [None] * multihost.world_size()
    dist.all_gather_object(digests, digest.hexdigest())
    if len(set(digests)) != 1:
        raise AssertionError(
            f"the ranks' model and optimizer states differ (sha256 by rank: "
            f"{[d[:12] for d in digests]}): a data-parallel step left the "
            f"replicas apart")
    return len(tensors)


def check_epoch_determinism(trainer, model: torch.nn.Module,
                            optimizer: torch.optim.Optimizer,
                            seed: int) -> Tuple[int, float]:
    """Run one training epoch twice, each from a deep copy of ``model`` and
    ``optimizer`` (copied together, so each copy's optimizer steps its own
    copy's parameters) with the same ``seed``, and assert that every state
    tensor and the loss are bit-identical.

    Returns (number of tensors compared, loss).  Raises AssertionError
    naming the tensors that differ.  The caller's model, optimizer and
    ``random`` stream are left untouched.
    """
    runs = []
    stream = random.getstate()
    for _ in range(2):
        random.setstate(stream)
        m, opt = copy.deepcopy((model, optimizer))
        loss = trainer.train_epoch(m, opt, seed)
        runs.append((_state_tensors(m, opt), loss))
    random.setstate(stream)
    (s1, l1), (s2, l2) = runs
    bad = [n for (n, a), (_, b) in zip(s1, s2) if not _bits_equal(a, b)]
    if bad or l1 != l2:
        raise AssertionError(
            f"nondeterministic epoch: loss {l1!r} vs {l2!r}, {len(bad)}/"
            f"{len(s1)} state tensors differ bitwise ({bad[:8]}"
            f"{'...' if len(bad) > 8 else ''}). This indicates an unstable "
            f"reduction or a racy kernel — file it before trusting any run.")
    assert_ranks_agree(m, opt)
    return len(s1), float(l1)
