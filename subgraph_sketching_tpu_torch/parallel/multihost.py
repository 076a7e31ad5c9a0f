"""The multi-process runtime of the port (the JAX package's
parallel/multihost.py): the process group, this process's rank and the
world size, and the host-side shard helpers.

One process per device.  ``initialize`` is
``torch.distributed.init_process_group``: from torchrun's environment
(``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``)
or from explicit arguments (an ``init_method`` such as
``file:///shared/path`` or ``tcp://host:port``, ``num_processes`` and
``process_id``, as the JAX function names them).  The backend is NCCL
for CUDA and gloo for the CPU.  NCCL takes one rank per GPU, so where
the local ranks outnumber the cards (two ranks on one card) the default
is gloo, which reduces CUDA tensors through host copies
(``default_backend``).

Unlike GSPMD, torch inserts no collective by itself: the data-parallel
layer's collectives are in ``parallel/collectives.py``.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    """The world size (1 without a process group)."""
    return dist.get_world_size() if initialized() else 1


def default_backend(device=None) -> str:
    """NCCL when this rank runs on a card of its own, else gloo: on the
    CPU, and where the local ranks (torchrun's ``LOCAL_WORLD_SIZE``)
    outnumber the visible cards, so that some share one, which NCCL
    refuses.  ``device`` None: CUDA where there is a card."""
    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == "cuda")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return "nccl" if cuda and local <= torch.cuda.device_count() else "gloo"


def initialize(init_method: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device=None,
               timeout: Optional[float] = None) -> Tuple[int, int]:
    """Join the process group; returns (rank, world size).

    With no ``init_method`` the group comes from torchrun's environment;
    where there is none (no ``WORLD_SIZE``), the process stays
    single-process and says so loudly, so that a launcher that failed to
    set it shows instead of W processes running independently.  A CUDA
    ``device`` becomes this process's current device before NCCL binds
    to it.  ``timeout``: seconds a collective of the world group may wait
    before it fails (torch's default, 30 minutes for gloo, when None);
    subgroups made later keep torch's default.  Calling it again in a
    joined process returns the group's rank and size."""
    if initialized():
        return rank(), world_size()
    if init_method is None and "WORLD_SIZE" not in os.environ:
        print("multihost.initialize: no distributed context detected (no "
              "init_method and no WORLD_SIZE in the environment); "
              "continuing single-process", flush=True)
        return 0, 1
    backend = backend or default_backend(device)
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    kw = {} if init_method is None else dict(
        init_method=init_method, world_size=num_processes, rank=process_id)
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend=backend, **kw)
    return rank(), world_size()


def shutdown() -> None:
    """Leave the process group, where there is one."""
    if initialized():
        dist.destroy_process_group()


def barrier() -> None:
    """Wait for every rank (nothing to wait for at world size 1)."""
    if world_size() > 1:
        dist.barrier()


def process_shard(n: int, process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> slice:
    """This process's contiguous shard of n items (links, edges, ...).

    Shards are ceil(n / process_count) long except the tail, which may be
    short or empty when n is not a multiple; for staging that needs
    shards of one shape use ``host_local_batch``."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    per = (n + pc - 1) // pc
    return slice(pi * per, min(n, (pi + 1) * per))


def host_local_batch(global_array: np.ndarray, pad_value=None,
                     process_index: Optional[int] = None,
                     process_count: Optional[int] = None) -> np.ndarray:
    """This process's slice of a globally ordered array, every slice of
    one shape.  When len(global_array) is not a multiple of the world
    size, ``pad_value`` pads the short tail shards up to the uniform
    length (callers mask the pads); without it that raises."""
    n = len(global_array)
    pc = world_size() if process_count is None else process_count
    per = (n + pc - 1) // pc
    out = global_array[process_shard(n, process_index, pc)]
    if len(out) == per:
        return out
    if pad_value is None:
        raise ValueError(
            f"{n} items do not shard uniformly over {pc} processes "
            f"(shards of {per}); pad the array to a multiple or pass "
            f"pad_value to pad the tail shards")
    pad = np.full((per - len(out),) + out.shape[1:], pad_value,
                  dtype=out.dtype)
    return np.concatenate([out, pad])
