"""The device mesh of the port (the JAX package's parallel/mesh.py).

In torch a mesh is the process group, one device per rank, laid out
row-major over ``shape`` as JAX's ``make_mesh`` lays out its devices:
rank r sits at ``np.unravel_index(r, shape)``.  The axes:

  * ``data``: the link batch is split over it (``Mesh.block`` /
    ``Mesh.shard``, JAX's ``P("data")``);
  * ``graph``: the sketch state is sharded by node
    (``parallel/node_sharded.py``) or its build by edge
    (``parallel/dist_sketch.py``), and ELPH's GCN runs over an edge shard;
  * ``lane``: the sketch width (MinHash permutations, HLL registers) is
    sharded.

Each rank belongs to one line of every axis: the ranks that differ from
it on that axis alone.  ``make_mesh`` makes one process subgroup per
line (``Mesh.group``); every rank calls ``torch.distributed.new_group``
for every line of every axis in the same order, as the call requires,
and a line that spans the whole world is the world group itself.  The
peers of a rank on the graph and lane axes hold the same block of the
batch, so every sum over the batch (the BatchNorm statistics, the
losses, the gradients) runs over the data axis's group alone.  Without
a process group every group is None and every collective the identity.

GSPMD inserted the collectives of a step for the JAX package; here they
are written out.  This module holds the two that a data-parallel step's
shape asks for: the rank's contiguous block of a batch axis, and one SUM
``all_reduce`` over the data axis of every gradient a step
(:class:`FlatGrads`: the gradients live in one flat buffer, in the
parameters' order, so the all-reduce copies nothing).  The
differentiable sums of the BatchNorms, the losses and the GCN's edge
shards are in ``parallel/collectives.py``.
"""

from __future__ import annotations

import functools
import math
import weakref
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from subgraph_sketching_tpu_torch.device import (
    device_from_flags, resolve_device,
)
from subgraph_sketching_tpu_torch.parallel import multihost
from subgraph_sketching_tpu_torch.parallel.collectives import all_reduce

# the axes the JAX package's mesh names
AXES = ("data", "graph", "lane")


def check_axes(shape: Sequence[int], axes: Sequence[str]) -> None:
    """Refuse an axis the JAX package does not name, an axis named twice,
    a shape of another length than the axes and an empty axis
    (ValueError)."""
    bad = [a for a in axes if a not in AXES]
    if bad:
        raise ValueError(f"mesh axes {bad}: the axes are {list(AXES)}")
    if len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes {list(axes)} name an axis twice")
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {list(shape)} does not match axes "
                         f"{list(axes)}")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {list(shape)}: every axis needs a "
                         f"size of 1 or more")


@dataclass(frozen=True)
class Mesh:
    """The process group as a mesh: ``world_size`` ranks laid out
    row-major over ``shape``, this one ``rank`` at ``coords``, on
    ``device``; ``groups`` holds this rank's process subgroup of each
    axis (empty without a process group)."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    world_size: int
    device: torch.device
    coords: Tuple[int, ...] = ()
    groups: Tuple = field(default=(), compare=False, repr=False)

    def __deepcopy__(self, memo) -> "Mesh":
        # a record of the process group's layout, which a copy of a model
        # (the determinism check's) shares: the groups cannot be copied
        return self

    def axis_size(self, axis: str) -> int:
        """The size of ``axis`` (1 where the mesh has no such axis)."""
        if axis not in self.axis_names:
            return 1
        return self.shape[self.axis_names.index(axis)]

    def axis_index(self, axis: str) -> int:
        """This rank's index on ``axis`` (0 where the mesh has none)."""
        if axis not in self.axis_names:
            return 0
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        """This rank's process subgroup of ``axis``: the ranks that differ
        from it on that axis alone (None without a process group or
        without the axis: a collective over None is the identity)."""
        if axis not in self.axis_names or not self.groups:
            return None
        return self.groups[self.axis_names.index(axis)]

    @property
    def data_size(self) -> int:
        """How many blocks the batch is split into (the data axis)."""
        return self.axis_size("data")

    def block_of(self, n: int, axis: str) -> slice:
        """This rank's contiguous block of a dimension of length ``n``
        split over ``axis`` (JAX's ``P(axis)``); ``n`` must divide by the
        axis, as JAX's sharding requires."""
        d = self.axis_size(axis)
        if n % d:
            raise ValueError(f"a batch axis of {n} does not split evenly "
                             f"over {d} ranks")
        per, i = n // d, self.axis_index(axis)
        return slice(i * per, (i + 1) * per)

    def block(self, n: int) -> slice:
        """This rank's contiguous block of a batch axis of length ``n``
        (JAX's ``P("data")``): the data axis splits it, the other axes
        do not."""
        return self.block_of(n, "data")

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
    over the data axis's ranks (each rank's gradient is its rows' share
    of the global loss's, so the sum is the global gradient; the graph
    and lane peers hold the same gradient already), then sets to None
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

    def all_reduce(self, group=None) -> None:
        """Sum the buffers over ``group`` (the mesh's data axis)."""
        for buf in self.buffers:
            all_reduce(buf, group=group)
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


# (shape, axes) -> (the world group they were made under, the groups of
# this rank): a mesh made twice in one process group reuses its groups
_GROUPS: dict = {}


def _axis_groups(shape: Tuple[int, ...], axes: Tuple[str, ...],
                 rank: int) -> tuple:
    """This rank's process subgroup of every axis.  Every rank makes every
    line of every axis, axis by axis and line by line in the order of the
    lines' first rank, since ``new_group`` must be called by all ranks
    in the same order; a line that spans the world is the world group."""
    world = dist.group.WORLD
    held = _GROUPS.get((shape, axes))
    if held is not None and held[0] is world:
        return held[1]
    ranks = np.arange(math.prod(shape)).reshape(shape)
    mine = []
    for a in range(len(axes)):
        lines = np.moveaxis(ranks, a, -1).reshape(-1, shape[a])
        if shape[a] == len(ranks.reshape(-1)):
            mine.append(world)
            continue
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                mine.append(g)
    _GROUPS[(shape, axes)] = (world, tuple(mine))
    return tuple(mine)


def make_mesh(shape: Optional[Sequence[int]] = None,
              axes: Sequence[str] = ("data",), device=None) -> Mesh:
    """The mesh over the process group (world size 1 without one), in any
    order of the axes ``data``, ``graph`` and ``lane`` that JAX's
    ``make_mesh`` takes.  ``shape`` defaults to [world size]; its product
    must be the world size.  ``device`` defaults to this rank's card
    (``cuda:LOCAL_RANK`` under torchrun, else ``cuda``; raises without
    one).  Unknown axes, an axis named twice and a shape whose product is
    not the world size raise ValueError."""
    axes = tuple(axes)
    world = multihost.world_size()
    shape = (world,) if shape is None else tuple(int(s) for s in shape)
    check_axes(shape, axes)
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {list(shape)} needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world} (launch one process per rank, e.g. "
                         f"torchrun --nproc_per_node {math.prod(shape)})")
    rank = multihost.rank()
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    groups = (_axis_groups(shape, axes, rank) if multihost.initialized()
              else ())
    return Mesh(shape, axes, rank, world,
                resolve_device(device_from_flags(device)), coords, groups)


def mesh_from_config(cfg, device) -> Optional[Mesh]:
    """The run's mesh (``--mesh_shape`` / ``--mesh_axes``), or None."""
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
