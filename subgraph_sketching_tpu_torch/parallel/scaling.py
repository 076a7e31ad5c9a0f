"""Scaling harness: sketch-build edges/s at 1 -> D ranks (the measuring
half of the JAX package's parallel/scaling.py).

:func:`measure_scaling` times the edge-sharded build
(``parallel/dist_sketch.py``) and :func:`measure_node_sharded_scaling`
the node-sharded one (``parallel/node_sharded.py``, per-rank state 1/D
of the table) on a seeded random graph, for each D over the first D
ranks of the process group (a subgroup; the other ranks wait), every
rank of the process group calling it alike.  A build is timed by CUDA
events on the card and by the host clock on the CPU, the best of
``iters`` after one untimed build (which also starts the group's
communicators).  The results are rank 0's.

Run as a module under torchrun, one rank per card, it measures the
graph axis across cards (:func:`main`)::

    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        -m subgraph_sketching_tpu_torch.parallel.scaling --out DIR

The JAX module's ``ici_scaling_model`` (a model of the TPU's
inter-chip links) and ``bench_artifact_rate`` (a TPU bench artifact's
rate) are not ported: no TPU number applies to the port.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from subgraph_sketching_tpu_torch.device import resolve_device
from subgraph_sketching_tpu_torch.parallel import multihost
from subgraph_sketching_tpu_torch.parallel.dist_sketch import (
    edge_sharded_build_hash_tables,
)
from subgraph_sketching_tpu_torch.parallel.mesh import Mesh, make_mesh
from subgraph_sketching_tpu_torch.sketch.elph import initialise_sketches
from subgraph_sketching_tpu_torch.sketch.params import SketchParams


def _graph_mesh(d: int, device) -> Optional[Mesh]:
    """A [d] mesh over ``graph`` on the first ``d`` ranks (None on the
    others); every rank calls it, since the subgroup's ``new_group``
    must be called by all."""
    world = multihost.world_size()
    if d == world:
        return make_mesh([d], ["graph"], device)
    group = (dist.new_group(list(range(d))) if multihost.initialized()
             else None)
    rank = multihost.rank()
    if rank >= d:
        return None
    return Mesh((d,), ("graph",), rank, d, resolve_device(device), (rank,),
                (group,) if group is not None else ())


def _best_seconds(run, device, iters: int) -> float:
    run()   # untimed: starts the group's communicators
    times = []
    for _ in range(iters):
        if torch.device(device).type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
    return min(times)


def _random_graph(num_nodes: int, avg_deg: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    e = num_nodes * avg_deg
    return np.stack([rng.integers(0, num_nodes, e, dtype=np.int32),
                     rng.integers(0, num_nodes, e, dtype=np.int32)])


def _counts(device_counts: Optional[List[int]], low: tuple) -> list:
    world = multihost.world_size()
    if device_counts is None:
        device_counts = [d for d in low if d <= world]
    if device_counts and max(device_counts) > world:
        raise ValueError(f"device counts {device_counts} need more than the "
                         f"{world} ranks of the process group")
    return device_counts


def measure_scaling(num_nodes: int = 20000, avg_deg: int = 16,
                    device_counts: List[int] = None, iters: int = 3,
                    device="cuda") -> Dict[int, float]:
    """edges/s of one edge-sharded build (``max_hops`` 2) per rank count
    (default 1, 2, 4, 8, 16 up to the world size)."""
    ei = _random_graph(num_nodes, avg_deg)
    e = ei.shape[1]
    params = SketchParams(max_hops=2)
    results = {}
    for d in _counts(device_counts, (1, 2, 4, 8, 16)):
        mesh = _graph_mesh(d, device)
        if mesh is not None:
            pad = (-e) % d
            eip = np.concatenate([ei, np.zeros((2, pad), np.int32)], axis=1)
            mask = np.arange(e + pad) < e
            mh0, hll0 = initialise_sketches(num_nodes, params, mesh.device)
            secs = _best_seconds(lambda: edge_sharded_build_hash_tables(
                eip, num_nodes, params, mesh, mh0, hll0, mask=mask),
                mesh.device, iters)
            results[d] = params.max_hops * e / secs
        multihost.barrier()
    return results


def measure_node_sharded_scaling(num_nodes: int = 20000, avg_deg: int = 16,
                                 device_counts: List[int] = None,
                                 iters: int = 3, device="cuda",
                                 stats: Optional[dict] = None
                                 ) -> Dict[int, float]:
    """edges/s of the memory-sharded (node-partitioned, halo-exchange)
    build per rank count (default 2, 4, 8, 16 up to the world size);
    per-rank state is ~1/D of the table.  ``stats`` (a dict) receives per
    rank count the partition's halo rows per rank per hop, rows per rank
    and seconds per build."""
    from subgraph_sketching_tpu_torch.parallel.node_sharded import (
        ShardedHop, make_node_partition, node_sharded_build_hash_tables,
    )
    ei = _random_graph(num_nodes, avg_deg)
    params = SketchParams(max_hops=2)
    results = {}
    for d in _counts(device_counts, (2, 4, 8, 16)):
        plan = make_node_partition(ei, num_nodes, d)
        mesh = _graph_mesh(d, device)
        if mesh is not None:
            r = mesh.axis_index("graph")
            hop = ShardedHop(plan, r, mesh.group("graph"), mesh.device)
            secs = _best_seconds(lambda: node_sharded_build_hash_tables(
                plan, params, mesh, hop=hop), mesh.device, iters)
            results[d] = params.max_hops * ei.shape[1] / secs
            if stats is not None:
                stats[d] = {"halo_rows_per_hop": plan.halo_rows_per_dev,
                            "rows_per_rank": plan.shard_size,
                            "build_s": secs}
        multihost.barrier()
    return results


def scaling_efficiency(results: Dict[int, float]) -> Dict[int, float]:
    base = results[min(results)]
    return {d: eps / (base * d / min(results)) for d, eps in results.items()}


def lane_row_bytes(params: SketchParams, lane_shards: int) -> int:
    """Per-(node, lane-shard) sketch row bytes in the TPU's tiled layout,
    the JAX package's function kept for its callers: a slice narrower
    than 128 lanes pads back to a full tile there.  On the card a row is
    its bytes: ``(num_perm * 4 + m) / lane_shards``."""
    mh_lanes = max(params.num_perm // lane_shards, 128)
    hll_lanes = max((1 << params.hll_p) // lane_shards, 128)
    return mh_lanes * 4 + hll_lanes


def main(argv=None) -> dict:
    """One rank of the graph axis measured across the process group's W
    ranks: on a [W] graph mesh over the dataset's train graph, the
    partition, one node-sharded build (bytes this rank holds, its peak
    memory) and the sharded hop's best of 10 (ms, halo rows a hop, local
    and halo edges); one memory-sharded ELPH epoch through runners.run
    (epoch seconds, step ms, loss on rank 0, peak memory); then
    :func:`measure_node_sharded_scaling` (2, 4, ... ranks) and
    :func:`measure_scaling` (1, 2, 4, ...) on a seeded random graph.
    Joins the process group from the environment unless its caller has.
    Writes OUT/rank<r>.json and returns the record."""
    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.device import device_from_flags
    from subgraph_sketching_tpu_torch.graph.datasets import get_data
    from subgraph_sketching_tpu_torch.graph.preprocess import (
        sketch_params_from_config,
    )
    from subgraph_sketching_tpu_torch.parallel.node_sharded import (
        ShardedHop, make_node_partition, node_sharded_build_hash_tables,
    )
    from subgraph_sketching_tpu_torch.runners import run as runner

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--dataset_name", default="synth-ws-200000")
    p.add_argument("--device", default=None,
                   help="default cuda:LOCAL_RANK")
    p.add_argument("--train_samples", type=int, default=131072,
                   help="links of the ELPH epoch (at most the train links)")
    p.add_argument("--runner_args", default="",
                   help="more runners.run flags for the ELPH epoch")
    p.add_argument("--scaling_nodes", type=int, default=20000)
    p.add_argument("--scaling_avg_deg", type=int, default=16)
    p.add_argument("--iters", type=int, default=3)
    args = p.parse_args(argv)
    dev = device_from_flags(args.device)
    joined = not multihost.initialized()
    if joined:
        multihost.initialize(device=dev)
    try:
        world, r = multihost.world_size(), multihost.rank()
        cuda = torch.device(dev).type == "cuda"
        rec = {"rank": r, "world": world,
               "device": torch.cuda.get_device_name(dev) if cuda else "cpu"}
        cfg = Config(dataset_name=args.dataset_name)
        g = get_data(cfg)[0]["train"].graph
        mesh = make_mesh([world], ["graph"], dev)
        t0 = time.perf_counter()
        plan = make_node_partition(g.edge_index, g.num_nodes, world)
        rec["partition_s"] = time.perf_counter() - t0
        hop = ShardedHop(plan, mesh.axis_index("graph"), mesh.group("graph"),
                         mesh.device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        sk = node_sharded_build_hash_tables(
            plan, sketch_params_from_config(cfg), mesh, hop=hop)
        rec.update(bytes_held=sum(t.numel() * t.element_size() for t in sk),
                   build_peak_bytes=(torch.cuda.max_memory_allocated(dev)
                                     if cuda else None))
        mh, hll = sk.minhash[0], sk.hll[0]
        multihost.barrier()
        rec.update(
            hop_ms=_best_seconds(lambda: hop(mh, hll), mesh.device, 10) * 1e3,
            halo_rows_per_hop=plan.halo_rows_per_dev,
            halo_width=plan.halo_width, rows_per_rank=plan.shard_size,
            local_edges=hop.local_edges, halo_edges=hop.halo_edges)
        del sk, hop, mh, hll
        ck = os.path.join(args.out, "elph")
        run_cfg = runner.config_from_parsed(runner.make_parser().parse_args([
            "--dataset_name", args.dataset_name, "--model", "ELPH",
            "--epochs", "1", "--eval_steps", "1",
            "--train_samples", str(args.train_samples),
            "--mesh_shape", str(world), "--mesh_axes", "graph",
            "--memory_sharded", "1", "--checkpoint_dir", ck,
            *args.runner_args.split()]))
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        runner.run(run_cfg, device=dev)
        rec["elph_run_s"] = time.perf_counter() - t0
        rec["elph_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                  if cuda else None)
        if r == 0:   # rank 0 writes the run's metrics
            with open(os.path.join(ck, "metrics.jsonl")) as f:
                row = json.loads(f.readline())
            steps = math.ceil(args.train_samples / run_cfg.batch_size)
            rec.update(elph_loss=row["rep0_loss"],
                       elph_epoch_s=row["rep0_train_time"],
                       elph_step_ms=row["rep0_train_time"] * 1e3 / steps)
        stats = {}
        rec["node_sharded_edges_per_s"] = measure_node_sharded_scaling(
            args.scaling_nodes, args.scaling_avg_deg, iters=args.iters,
            device=dev, stats=stats)
        rec["node_sharded_stats"] = stats
        rec["edge_sharded_edges_per_s"] = measure_scaling(
            args.scaling_nodes, args.scaling_avg_deg, iters=args.iters,
            device=dev)
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"rank{r}.json"), "w") as f:
            json.dump(rec, f)
        print(json.dumps(rec), flush=True)
        return rec
    finally:
        if joined:
            multihost.shutdown()


if __name__ == "__main__":
    main()
