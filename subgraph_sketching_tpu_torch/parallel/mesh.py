"""The device mesh of the port (the JAX package's parallel/mesh.py), on
the data axis.

In torch a mesh is the process group, one device per rank.  ``make_mesh``
returns a :class:`Mesh` record (shape, axis names, rank, world size,
device).  Only the ``data`` axis is ported: the link batch is split over
the ranks, every table (node features, sketches, embeddings, the GCN's
graph) is replicated.  The ``graph`` and ``lane`` axes, the
memory-sharded sketch state, are ROADMAP item 9b and refused here.

GSPMD inserted the collectives of a data-parallel step for the JAX
package; here they are written out.  This module holds the two that a
step's shape asks for: the rank's contiguous block of a batch axis
(``Mesh.shard``, JAX's ``P("data")``), and one SUM ``all_reduce`` of
every gradient a step (:class:`FlatGrads`: the gradients live in one
flat buffer, in the parameters' order, so the all-reduce copies
nothing).  The differentiable sums of the BatchNorms and the losses are
in ``parallel/collectives.py``.
"""

from __future__ import annotations

import functools
import math
import weakref
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Sequence, Tuple

import torch

from subgraph_sketching_tpu_torch.device import (
    device_from_flags, resolve_device,
)
from subgraph_sketching_tpu_torch.parallel import multihost
from subgraph_sketching_tpu_torch.parallel.collectives import all_reduce

# the axes of ROADMAP item 9b (graph- and lane-sharded sketch state)
UNPORTED_AXES = ("graph", "lane")


def refuse_unported_axes(axes: Sequence[str]) -> None:
    bad = [a for a in axes if a in UNPORTED_AXES]
    if bad:
        raise NotImplementedError(
            f"mesh axes {bad}: the graph- and lane-sharded sketch state "
            f"(--memory_sharded among it) is ROADMAP item 9b, not ported "
            f"yet; the port's mesh has the data axis only")
    if list(axes) != ["data"]:
        raise ValueError(f"mesh axes {list(axes)}: the port's mesh is the "
                         f"one axis ['data']")


@dataclass(frozen=True)
class Mesh:
    """The process group as a data-parallel mesh: ``world_size`` ranks,
    this one ``rank``, on ``device``."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    world_size: int
    device: torch.device

    def block(self, n: int) -> slice:
        """This rank's contiguous block of a batch axis of length ``n``
        (JAX's ``P("data")``).  ``n`` must divide by the world size, as
        JAX's sharding requires."""
        if n % self.world_size:
            raise ValueError(f"a batch axis of {n} does not split evenly "
                             f"over {self.world_size} ranks")
        per = n // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)

    def shard(self, a: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block of ``a`` along ``dim`` (a view)."""
        b = self.block(a.shape[dim])
        return a.narrow(dim, b.start, b.stop - b.start)


class FlatGrads:
    """The gradients of ``params`` as views into one flat buffer per
    dtype and device, laid out once in the parameters' order, so that a
    step's gradient all-reduce is one call a buffer and copies nothing.

    ``zero_grad`` takes the optimizer's place before the backward: it
    zeroes the buffers and binds the views as the gradients, which
    autograd accumulates into in place.  ``all_reduce`` sums the buffers
    over the ranks (each rank's gradient is its rows' share of the
    global loss's, so the sum is the global gradient), then sets to None
    the gradient of every parameter the backward did not reach, as
    ``zero_grad(set_to_none=True)`` leaves it without a mesh (Adam skips
    it).  Frozen parameters are left out, on every rank alike."""

    def __init__(self, params: Iterable[torch.nn.Parameter]):
        self.params = [p for p in params if p.requires_grad]
        groups = {}
        for i, p in enumerate(self.params):
            groups.setdefault((p.dtype, p.device), []).append(i)
        self.buffers, self.views = [], [None] * len(self.params)
        for (dtype, device), idx in groups.items():
            buf = torch.zeros(sum(self.params[i].numel() for i in idx),
                              dtype=dtype, device=device)
            offset = 0
            for i in idx:
                n = self.params[i].numel()
                self.views[i] = buf[offset:offset + n].view_as(
                    self.params[i])
                offset += n
            self.buffers.append(buf)
        self._reached = set()
        for i, p in enumerate(self.params):
            p.register_post_accumulate_grad_hook(
                functools.partial(self._reach, i))

    def _reach(self, i: int, _param) -> None:
        self._reached.add(i)

    def zero_grad(self) -> None:
        for buf in self.buffers:
            buf.zero_()
        for p, v in zip(self.params, self.views):
            p.grad = v
        self._reached.clear()

    def all_reduce(self) -> None:
        for buf in self.buffers:
            all_reduce(buf)
        for i, p in enumerate(self.params):
            if i not in self._reached:
                p.grad = None


# one FlatGrads a model, made at its first step
_flat_grads = weakref.WeakKeyDictionary()


def flat_grads(model: torch.nn.Module) -> FlatGrads:
    """``model``'s :class:`FlatGrads` (made on first use)."""
    grads = _flat_grads.get(model)
    if grads is None:
        grads = _flat_grads[model] = FlatGrads(model.parameters())
    return grads


def make_mesh(shape: Optional[Sequence[int]] = None,
              axes: Sequence[str] = ("data",), device=None) -> Mesh:
    """The data-parallel mesh over the process group (world size 1
    without one).  ``shape`` defaults to [world size]; its product must
    be the world size.  ``device`` defaults to this rank's card
    (``cuda:LOCAL_RANK`` under torchrun, else ``cuda``; raises without
    one).  The ``graph`` and ``lane`` axes raise NotImplementedError
    (ROADMAP item 9b)."""
    axes = tuple(axes)
    refuse_unported_axes(axes)
    world = multihost.world_size()
    shape = (world,) if shape is None else tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {list(shape)} does not match axes "
                         f"{list(axes)}")
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {list(shape)} needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world} (launch one process per rank, e.g. "
                         f"torchrun --nproc_per_node {math.prod(shape)})")
    return Mesh(shape, axes, multihost.rank(), world,
                resolve_device(device_from_flags(device)))


def mesh_from_config(cfg, device) -> Optional[Mesh]:
    """The run's mesh (``--mesh_shape`` / ``--mesh_axes``), or None.
    (``--memory_sharded`` comes with a graph axis, which ``make_mesh``
    refuses.)"""
    if not cfg.mesh_shape:
        return None
    return make_mesh(cfg.mesh_shape, cfg.mesh_axes, device)


def batch_sharding(mesh: Mesh, axis: str = "data"
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """This rank's part of a tensor whose dim 0 is the batch axis
    (JAX's ``NamedSharding(mesh, P(axis))``)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"no {axis!r} axis in mesh {mesh.axis_names}")
    return mesh.shard


def replicated(mesh: Mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """The whole tensor on every rank's device (JAX's ``P()``)."""
    return lambda t: t.to(mesh.device)
