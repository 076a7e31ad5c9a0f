"""Multi-rank dry run of the full ELPH step: the port's
``__graft_entry__.dryrun_multichip``.

Run it on every rank of a process group of ``n_devices`` ranks (one
process each, ``multihost.initialize``), or with ``n_devices`` 1 in a
single process:

    python -c "from subgraph_sketching_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(1, device='cpu')"

The mesh is the JAX function's: [n/4, 2, 2] over (data, graph, lane)
where 4 divides n, [n/2, 2] over (data, graph) where 2 does, else [n]
over data.  It runs TWO steps of the full ELPH step (GCN feature side and
LinkPredictor head) over the ranks, and asserts that each loss equals the
single-device step's on the whole batch: the mesh program must be the
same math, not just a finite one.  With a graph axis of D > 1 it then
builds the node-sharded sketches (halo exchange) and asserts them
bit-equal in node order to the single-device build with 1/D of the rows
on each rank, and runs one memory-sharded step against the single-device
step.
"""

from __future__ import annotations

import numpy as np
import torch

from subgraph_sketching_tpu_torch.device import resolve_device
from subgraph_sketching_tpu_torch.graph.synthetic import (
    barabasi_albert_graph,
)
from subgraph_sketching_tpu_torch.parallel import multihost
from subgraph_sketching_tpu_torch.parallel.collectives import all_reduce
from subgraph_sketching_tpu_torch.parallel.mesh import make_mesh
from subgraph_sketching_tpu_torch.parallel.node_sharded import (
    make_node_partition,
)
from subgraph_sketching_tpu_torch.parallel.train import (
    make_distributed_train_step, single_device_reference_step,
)
from subgraph_sketching_tpu_torch.sketch.params import SketchParams

# |loss - single-device loss| <= LOSS_RTOL * max(1, |single-device loss|)
LOSS_RTOL = 1e-4


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Two data-parallel ELPH steps over the process group's
    ``n_devices`` ranks against the single-device step on every rank;
    returns {"losses": [...], "reference_losses": [...]}."""
    world = multihost.world_size()
    if world != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) runs on a process "
                         f"group of {n_devices} ranks; this one has {world}")
    dev = resolve_device(device)
    if n_devices % 4 == 0:
        mesh = make_mesh([n_devices // 4, 2, 2], ("data", "graph", "lane"),
                         dev)
    elif n_devices % 2 == 0:
        mesh = make_mesh([n_devices // 2, 2], ("data", "graph"), dev)
    else:
        mesh = make_mesh([n_devices], ("data",), dev)
    num_nodes = 64
    params = SketchParams(max_hops=2)
    ei = torch.from_numpy(barabasi_albert_graph(num_nodes, 4, seed=0)
                          .astype(np.int64)).to(dev)
    B = max(16, 2 * n_devices)
    links = torch.from_numpy(np.stack(
        [np.arange(B) % num_nodes, (np.arange(B) * 7 + 3) % num_nodes],
        axis=1)).to(dev)
    labels = torch.from_numpy((np.arange(B) % 2).astype(np.float32)).to(dev)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (num_nodes, 16), dtype=np.float32)).to(dev)

    kw = dict(hidden_channels=16, num_nodes=num_nodes, label_dropout=0.0,
              feature_dropout=0.0)
    init_fn, step_fn, build = make_distributed_train_step(mesh, params, **kw)
    ref_init, ref_step, ref_build = single_device_reference_step(
        params, device=dev, **kw)
    # sketches built ONCE per graph (step-constant), passed into every step
    sk, sk_ref = build(ei), ref_build(ei)
    if not (torch.equal(sk.minhash, sk_ref.minhash)
            and torch.equal(sk.hll, sk_ref.hll)):
        raise AssertionError("the mesh's sketches differ from the "
                             "single-device build")
    state, ref_state = init_fn(0, x), ref_init(0, x)
    losses, ref_losses = [], []
    for i in range(2):
        loss = float(step_fn(state, x, ei, None, sk, links, labels,
                             torch.Generator(dev).manual_seed(7 + i)))
        ref = float(ref_step(ref_state, x, ei, None, sk_ref, links, labels,
                             torch.Generator(dev).manual_seed(7 + i)))
        if not np.isfinite(loss):
            raise AssertionError(f"non-finite loss {loss}")
        if abs(loss - ref) > LOSS_RTOL * max(1.0, abs(ref)):
            raise AssertionError(f"mesh step diverges from single-device: "
                                 f"{loss} vs {ref}")
        losses.append(loss)
        ref_losses.append(ref)
    out = {"losses": losses, "reference_losses": ref_losses}
    D = mesh.axis_size("graph")
    if D > 1:
        out.update(_memory_sharded(mesh, params, ei, x, links, labels, kw,
                                   sk_ref))
    return out


def _memory_sharded(mesh, params, ei, x, links, labels, kw, sk_ref) -> dict:
    """The graph half: the node-sharded build bit-equal in node order to
    the single-device one, 1/D of the rows on each rank, and one
    memory-sharded step against the single-device step."""
    D, n = mesh.axis_size("graph"), kw["num_nodes"]
    plan = make_node_partition(ei.cpu().numpy(), n, D)
    init_fn, step_fn, build = make_distributed_train_step(
        mesh, params, node_partition=plan, **kw)
    ref_init, ref_step, _ = single_device_reference_step(
        params, device=mesh.device, **kw)
    sk = build(ei)
    if sk.minhash.shape[1] * D != plan.padded_nodes:
        raise AssertionError(f"a rank holds {sk.minhash.shape[1]} rows of "
                             f"{plan.padded_nodes}")
    # the shards in graph order, assembled by an all-reduce of zero-padded
    # blocks (every rank checks the whole table)
    full = sk.minhash.new_zeros((sk.minhash.shape[0], plan.padded_nodes,
                                 sk.minhash.shape[2]))
    b = mesh.block_of(plan.padded_nodes, "graph")
    full[:, b] = sk.minhash
    all_reduce(full, group=mesh.group("graph"))
    if not np.array_equal(plan.to_node_order(full.cpu().numpy()),
                          sk_ref.minhash.cpu().numpy()):
        raise AssertionError("node-sharded sketches differ from the "
                             "single-device build")
    state, ref_state = init_fn(0, x), ref_init(0, x)
    loss = float(step_fn(state, x, ei, None, sk, links, labels,
                         torch.Generator(mesh.device).manual_seed(42)))
    ref = float(ref_step(ref_state, x, ei, None, sk_ref, links, labels,
                         torch.Generator(mesh.device).manual_seed(42)))
    if abs(loss - ref) > LOSS_RTOL * max(1.0, abs(ref)):
        raise AssertionError(f"memory-sharded step diverges: {loss} vs "
                             f"{ref}")
    return {"memory_sharded_loss": loss, "memory_sharded_reference": ref,
            "rows_per_rank": int(sk.minhash.shape[1]),
            "padded_nodes": plan.padded_nodes}
