"""Checkpoints of a training run: model, optimizer and step.

``step_<N>.pt`` under the run's directory holds ``torch.save`` of
``{"model": state_dict, "optimizer": state_dict, "step": N}``, written to a
temporary file first and moved into place with ``os.replace``, so a crash
mid-save never leaves a partial ``step_<N>.pt``.  The sidecar
``meta_step_<N>.json`` carries the run's best-val tracking, as in the JAX
package's train/checkpoint.py.  A trainable node-embedding table is a
parameter and is saved with the rest; a pretrained (frozen) one is not
in the state_dict, and the model re-reads it from the config's path.

In a process group of several ranks (data parallelism: every rank holds
the same state) rank 0 writes and every rank then waits at a barrier, so
that no rank reads the directory before the file is in place;
``save_run_meta`` is rank 0's alone (the runner calls it there).
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import torch

from subgraph_sketching_tpu_torch.parallel import multihost

_STEP_FILE = re.compile(r"step_(\d+)\.pt")


def _path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}.pt")


def save_checkpoint(directory: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, step: int = 0) -> str:
    """Write ``step_<step>.pt`` (rank 0; the other ranks wait for it)."""
    path = _path(directory, step)
    if multihost.rank() == 0:
        os.makedirs(directory, exist_ok=True)
        tmp = path + ".tmp"
        torch.save({"model": model.state_dict(),
                    "optimizer": optimizer.state_dict(), "step": step}, tmp)
        os.replace(tmp, path)
    multihost.barrier()
    return path


def latest_step(directory: str) -> Optional[int]:
    """The newest complete checkpoint's step, or None.  Only names of the
    form ``step_<digits>.pt`` count: a crash mid-save leaves
    ``step_<N>.pt.tmp``, which --resume must skip."""
    base = os.path.abspath(directory)
    if not os.path.isdir(base):
        return None
    steps = sorted(int(m.group(1)) for m in map(_STEP_FILE.fullmatch,
                                                os.listdir(base)) if m)
    return steps[-1] if steps else None


def save_run_meta(directory: str, step: int, meta: dict) -> None:
    """Sidecar JSON next to ``step_<N>.pt`` holding host-side run state that
    is not part of the model or optimizer (best-val tracking: val/test/
    train_res, best_epoch).  Without it a resumed run restarts best-val
    selection at 0.0.  Written atomically."""
    base = os.path.abspath(directory)
    os.makedirs(base, exist_ok=True)
    tmp = os.path.join(base, f"meta_step_{step}.json.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(base, f"meta_step_{step}.json"))


def load_run_meta(directory: str, step: int) -> Optional[dict]:
    path = os.path.join(os.path.abspath(directory), f"meta_step_{step}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def load_checkpoint(directory: str, step: Optional[int] = None
                    ) -> tuple:
    """(the saved dict, its step); the newest checkpoint when ``step`` is
    None.  Tensors load on the CPU."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under "
                                    f"{os.path.abspath(directory)}")
    saved = torch.load(_path(directory, step), map_location="cpu",
                       weights_only=True)
    return saved, step


# the JAX package's name: the raw saved state and its step
restore_checkpoint = load_checkpoint


def restore_into(directory: str, model: torch.nn.Module,
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 step: Optional[int] = None) -> int:
    """Load a checkpoint into ``model`` (and ``optimizer``) in place;
    returns its step."""
    saved, step = load_checkpoint(directory, step)
    model.load_state_dict(saved["model"])
    if optimizer is not None:
        optimizer.load_state_dict(saved["optimizer"])
    return step
