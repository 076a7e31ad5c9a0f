"""Production-scale equality of the memory-sharded paths.

Counterpart of the JAX repository's ``tools/scale_equality.py``.  At
synth-ws-<N> (default 500,000 nodes and 5M directed edges, citation2-class
scale without real data), through the port's own entry points, with the
ranks of each sharded phase launched by ``torch.distributed.run`` and
sharing one device (two or more ranks on one card take gloo, which moves
CUDA tensors through host memory; the halo exchange then takes its
identity-padded MIN / MAX all-reduce, ``collectives.halo_route``):

  1. ``buddy``: BUDDY's node-sharded preprocessing on ``--graph_ranks``
     ranks (default 8): the locality partition, the node-sharded build
     with ``max_gather_rows`` 1 << 22 (each rank draws its own hop-0 rows,
     ``NodePartitionPlan.shard_init``: the rows ``pad_init`` would lay
     out), and the subgraph features of 4,096 probe links; against one
     process's ``make_auto_plan`` + ``build_hash_tables`` +
     ``subgraph_features``: MinHash and HLL tables in node order, and the
     features;
  2. ``elph_sharded``: ``runners.run`` with ELPH ``--memory_sharded 1``
     on ``--mesh_shape 1,D --mesh_axes data,graph`` (``elph_mesh``,
     default 1,4), one rank per graph shard; it also reads each rank's
     bytes of the staged sketch tables (``elph_shard_bytes``: exactly
     1/D of the total);
  3. ``elph_single``: the same run in one process; the per-epoch losses
     and the returned metrics against the sharded run's.

Each phase runs in a process (or a launch) of its own, so each one's
peak memory is its own, and the JSON report, with the JAX report's keys,
is printed (and written to ``out.json`` when given) after every phase.
Every launch has a time limit and is killed at it, and every failure
raises: a rank's collectives fail after ``COLLECTIVE_TIMEOUT_S`` instead
of gloo's 30 minutes.

    python -m subgraph_sketching_tpu_torch.tools.scale_equality \\
        [N] [out.json] [elph_mesh] [--graph_ranks D] [--device cuda]

runs on the card (``--device cpu`` on the CPU, for small N) and raises
where there is none.  ``--epochs``, ``--train_samples`` and
``--eval_samples`` cut the ELPH runs' depth (default the JAX tool's: 2
epochs of 131,072 links, every link evaluated).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import resource
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from subgraph_sketching_tpu_torch.device import (
    device_from_flags, resolve_device,
)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODULE = "subgraph_sketching_tpu_torch.tools.scale_equality"
MAX_GATHER_ROWS = 1 << 22
PROBE_LINKS = 4096
COLLECTIVE_TIMEOUT_S = 300
ELPH_HIDDEN = 16
NOTE = ("equality artifact: loss/metric equality, bit-equal tables and "
        "1/D per-rank sketch state are the claims; the ranks of a sharded "
        "phase share one device (gloo through host memory), so their "
        "timings are no scaling figures; each phase runs in its own "
        "process or launch, so rss_gb and the card's peaks are that "
        "phase's own")


def elph_args(n: int, epochs: int, train_samples: int,
              eval_samples: Optional[int] = None) -> list:
    """The JAX tool's ELPH command line (its ``run_elph``).
    ``eval_samples``: evaluate ``train_samples`` train links and this
    many val and test links (the runner's ``--dynamic_*`` sample counts)
    instead of every link of the three splits."""
    args = ["--dataset_name", f"synth-ws-{n}", "--model", "ELPH",
            "--hidden_channels", str(ELPH_HIDDEN), "--batch_size", "4096",
            "--eval_batch_size", "65536", "--K", "50",
            "--epochs", str(epochs), "--train_samples", str(train_samples),
            "--label_dropout", "0", "--feature_dropout", "0"]
    if eval_samples is not None:
        args += ["--dynamic_train", "1", "--dynamic_val", "1",
                 "--dynamic_test", "1", "--val_samples", str(eval_samples),
                 "--test_samples", str(eval_samples)]
    return args


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def _peak_card_gb(dev: torch.device) -> Optional[float]:
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 1e9


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _write_json(path: str, record: dict) -> None:
    with open(path, "w") as f:
        json.dump(record, f)


# ------------------------------------------------- the phases' processes --

def probe_links(n: int) -> np.ndarray:
    """The 4,096 probe links, [B, 2] int32 (the JAX tool's draw)."""
    rng = np.random.default_rng(0)
    return np.stack([rng.integers(0, n, PROBE_LINKS),
                     rng.integers(0, n, PROBE_LINKS)], 1).astype(np.int32)


def save_partition(part, path: str) -> None:
    np.savez(path, **{f.name: getattr(part, f.name)
                      for f in dataclasses.fields(part)
                      if getattr(part, f.name) is not None})


def load_partition(path: str):
    """The ``NodePartitionPlan`` that :func:`save_partition` wrote."""
    from subgraph_sketching_tpu_torch.parallel.node_sharded import (
        NodePartitionPlan,
    )
    with np.load(path) as z:
        return NodePartitionPlan(**{k: z[k].item() if z[k].ndim == 0
                                    else z[k] for k in z.files})


def buddy_rank(n: int, device: str, work: str) -> None:
    """One rank of the ``buddy`` phase (D = the world size).  Every rank
    writes its shard (``shard<r>.npz``) and its record
    (``buddy_rank<r>.json``); rank 0 also the partition and the probe
    features, then, alone, builds the one-process reference and compares
    (its record's ``reference``)."""
    from subgraph_sketching_tpu_torch.graph.datasets import synthetic_graph
    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.parallel import multihost
    from subgraph_sketching_tpu_torch.parallel.collectives import (
        all_reduce, halo_exchange, halo_route,
    )
    from subgraph_sketching_tpu_torch.parallel.mesh import make_mesh
    from subgraph_sketching_tpu_torch.parallel.node_sharded import (
        ShardedHop, make_node_partition, node_sharded_build_hash_tables,
        node_sharded_subgraph_features,
    )
    from subgraph_sketching_tpu_torch.sketch.params import SketchParams

    start = time.perf_counter()
    dev = resolve_device(device)
    multihost.initialize(device=device, timeout=COLLECTIVE_TIMEOUT_S)
    try:
        D, r = multihost.world_size(), multihost.rank()
        t0 = time.perf_counter()
        g = synthetic_graph(f"synth-ws-{n}")
        graph_s = time.perf_counter() - t0
        params = SketchParams(max_hops=2)
        mesh = make_mesh([D], ["graph"], device)
        group = mesh.group("graph")
        t0 = time.perf_counter()
        part = make_node_partition(g.edge_index, n, D)
        partition_s = time.perf_counter() - t0
        for k in segscan.launches:
            segscan.launches[k] = 0
        multihost.barrier()
        t0 = time.perf_counter()
        hop = ShardedHop(part, r, group, dev, MAX_GATHER_ROWS)
        plans_s = time.perf_counter() - t0
        sk = node_sharded_build_hash_tables(
            part, params, mesh, max_gather_rows=MAX_GATHER_ROWS, hop=hop)
        _sync(dev)
        multihost.barrier()
        build_s = time.perf_counter() - t0
        launches = dict(segscan.launches)
        # one hop's exchange alone, of the hop-0 rows (the same size every
        # hop), timed on every rank
        halo_s = {}
        for name, t, op in (("minhash", sk.minhash[0], "min"),
                            ("hll", sk.hll[0], "max")):
            multihost.barrier()
            t1 = time.perf_counter()
            halo_exchange(hop._send(t, op), group, op).wait()
            _sync(dev)
            halo_s[name] = time.perf_counter() - t1
        own = sum(t.numel() * t.element_size()
                  for t in (sk.minhash, sk.hll, sk.cards))
        total = int(all_reduce(torch.tensor([own], dtype=torch.int64,
                                            device=dev), group=group).item())
        links = probe_links(n)
        sf = node_sharded_subgraph_features(links, sk, params, mesh,
                                            perm=part.perm)
        t0 = time.perf_counter()
        np.savez(os.path.join(work, f"shard{r}.npz"),
                 minhash=sk.minhash.cpu().numpy(), hll=sk.hll.cpu().numpy(),
                 cards=sk.cards.cpu().numpy())
        if r == 0:
            save_partition(part, os.path.join(work, "partition.npz"))
            np.save(os.path.join(work, "features.npy"), sf.cpu().numpy())
        save_s = time.perf_counter() - t0
        record = {"rank": r, "edges": int(g.edge_index.shape[1]),
                  "graph_s": graph_s, "partition_s": partition_s,
                  "plans_s": plans_s, "build_s": build_s,
                  "halo_route": halo_route(group, dev),
                  "halo_exchange_s": halo_s,
                  "bytes": own, "bytes_all_ranks": total,
                  "local_edges": hop.local_edges,
                  "halo_edges": hop.halo_edges,
                  "k1_launches_build": launches, "save_s": save_s,
                  "rss_gb": rss_gb(), "peak_card_gb": _peak_card_gb(dev)}
        print(f"buddy rank {r} of {D}: halo exchange a hop, "
              f"{halo_route(group, dev)} route: MinHash "
              f"{halo_s['minhash']:.3f} s, HLL {halo_s['hll']:.3f} s",
              flush=True)
        del sk, hop
        multihost.barrier()
    finally:
        multihost.shutdown()
    if r == 0:
        record["reference"] = buddy_reference(g.edge_index, n, D, params,
                                              dev, work)
    record["rank_s"] = time.perf_counter() - start
    _write_json(os.path.join(work, f"buddy_rank{r}.json"), record)


def buddy_reference(edge_index: np.ndarray, n: int, D: int, params,
                    dev: torch.device, work: str) -> dict:
    """One process's build of the same tables and probe features,
    against the D shards in node order and the sharded features."""
    from subgraph_sketching_tpu_torch.ops.segment_scan import make_auto_plan
    from subgraph_sketching_tpu_torch.sketch.elph import (
        build_hash_tables, subgraph_features,
    )

    t0 = time.perf_counter()
    plan = make_auto_plan(edge_index, n, max_slots=MAX_GATHER_ROWS,
                          device=dev)
    ref = build_hash_tables(edge_index, n, params, plan=plan)
    links = torch.from_numpy(probe_links(n)).long().to(dev)
    sf_ref = subgraph_features(links, ref, params).cpu().numpy()
    reference_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    part = load_partition(os.path.join(work, "partition.npz"))
    shards = [np.load(os.path.join(work, f"shard{r}.npz")) for r in range(D)]
    equal = {}
    for key in ("minhash", "hll"):
        full = np.concatenate([s[key] for s in shards], axis=1)
        equal[key] = bool(np.array_equal(
            part.to_node_order(full), getattr(ref, key).cpu().numpy()))
    sf = np.load(os.path.join(work, "features.npy"))
    return {"minhash_tables_bit_equal": equal["minhash"],
            "hll_tables_bit_equal": equal["hll"],
            "max_feature_delta": float(np.max(np.abs(sf - sf_ref))),
            "halo_rows_per_dev": int(part.halo_rows_per_dev),
            "reference_s": reference_s,
            "compare_s": time.perf_counter() - t0,
            "reference_peak_card_gb": _peak_card_gb(dev)}


def elph_run(n: int, mesh: Optional[str], device: str, epochs: int,
             train_samples: int, eval_samples: Optional[int],
             work: str) -> None:
    """One ELPH run through ``runners.run`` (one rank of the sharded run
    under ``mesh``, or the single-process run with ``mesh`` None); writes
    ``elph_<kind>_rank<r>.json``: the per-epoch losses (the metric rows'
    ``rep0_loss``, rank 0), the returned metrics, wall seconds, peak
    memory, and in the sharded run the rank's bytes of the staged sketch
    tables and one edge-shard sum of [N, hidden] timed."""
    from subgraph_sketching_tpu_torch.parallel import collectives, multihost
    from subgraph_sketching_tpu_torch.runners import run as runner

    dev = resolve_device(device)
    kind = "single" if mesh is None else "sharded"
    ck = os.path.join(work, f"elph_{kind}")
    args = elph_args(n, epochs, train_samples, eval_samples) + [
        "--device", device, "--checkpoint_dir", ck]
    if mesh is not None:
        args += ["--mesh_shape", mesh, "--mesh_axes", "data,graph",
                 "--memory_sharded", "1"]
        multihost.initialize(device=device, timeout=COLLECTIVE_TIMEOUT_S)
    kept = []
    build = runner.build_trainer

    def keep(*a, **k):
        kept.append(build(*a, **k))
        return kept[-1]

    try:
        collectives.reset_collectives()
        runner.build_trainer = keep
        t0 = time.perf_counter()
        try:
            results = runner.main(args)
        finally:
            runner.build_trainer = build
        _sync(dev)
        record = {"rank": multihost.rank(), "results": results[0],
                  "wall_s": time.perf_counter() - t0,
                  "collectives": dict(collectives.collectives)}
        if mesh is not None:
            record.update(_elph_shard_record(kept[-1], n, dev))
    finally:
        multihost.shutdown()
    if record["rank"] == 0:
        with open(os.path.join(ck, "metrics.jsonl")) as f:
            rows = {}
            for line in f:
                row = json.loads(line)
                rows[row["step"]] = row
        record["losses"] = [rows[s]["rep0_loss"] for s in sorted(rows)]
        # the runner's own stage clocks (train and eval: each epoch's)
        record["stages_s"] = {k: [rows[s][f"rep0_{k}_time"]
                                  for s in sorted(rows)]
                              for k in ("get_data", "preprocess", "train",
                                        "eval")}
    record.update(rss_gb=rss_gb(), peak_card_gb=_peak_card_gb(dev))
    _write_json(os.path.join(work, f"elph_{kind}_rank{record['rank']}.json"),
                record)


def _elph_shard_record(trainer, n: int, dev: torch.device) -> dict:
    """A memory-sharded trainer's bytes of the train split's staged
    MinHash and HLL tables on this rank and on all ranks, and one sum of
    an [N, hidden] float32 edge-shard product over the graph axis, timed
    (each GCN layer sums one a step each way)."""
    from subgraph_sketching_tpu_torch.parallel import multihost
    from subgraph_sketching_tpu_torch.parallel.collectives import all_reduce

    group = trainer.mesh.group("graph")
    sk = trainer._data["train"]["sk_shard"]
    shard = {}
    for name, t in (("sk_minhash", sk.minhash), ("sk_hll", sk.hll)):
        own = t.numel() * t.element_size()
        total = int(all_reduce(torch.tensor([own], dtype=torch.int64,
                                            device=dev), group=group).item())
        shard[name] = {"total_bytes": total, "per_device_bytes": own}
    x = torch.ones((n, ELPH_HIDDEN), dtype=torch.float32, device=dev)
    all_reduce(x, group=group)
    times = []
    for _ in range(3):
        multihost.barrier()
        _sync(dev)
        t0 = time.perf_counter()
        all_reduce(x, group=group)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    if multihost.rank() == 0:
        print(f"edge-shard sum [{n}, {ELPH_HIDDEN}] float32 over "
              f"{trainer.mesh.axis_size('graph')} graph ranks: "
              f"{min(times):.4f} s", flush=True)
    return {"shard_bytes": shard, "edge_shard_sum": {
        "shape": [n, ELPH_HIDDEN], "bytes": x.numel() * 4, "s": times}}


# ------------------------------------------------------------ the driver --

def _launch(name: str, program: list, ranks: Optional[int],
            timeout: float) -> float:
    """``program`` (arguments of this module) as one process, or as
    ``ranks`` ranks by ``torch.distributed.run --standalone`` (which picks
    its rendezvous port itself), from the checkout's root; the output of
    every process goes to stderr.  Killed, its whole process group, at
    ``timeout``; raises unless it exits 0.  Returns its seconds."""
    cmd = [sys.executable, "-m"]
    if ranks is not None:
        cmd += ["torch.distributed.run", "--standalone", "--nproc_per_node",
                str(ranks), "-m"]
    cmd += [MODULE, *program]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise RuntimeError(f"phase {name}: no end within {timeout} s:\n"
                           f"{out[-4000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    sys.stderr.write(out[-8000:])
    if proc.returncode != 0:
        raise RuntimeError(f"phase {name} exited {proc.returncode}:\n"
                           f"{out[-4000:]}")
    return time.perf_counter() - t0


def _rank_records(work: str, prefix: str, ranks: int) -> list:
    out = []
    for r in range(ranks):
        with open(os.path.join(work, f"{prefix}_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _buddy_report(n: int, ranks: list) -> dict:
    lead = ranks[0]
    ref = lead["reference"]
    return {"nodes": n, "edges": lead["edges"],
            "partition_s": lead["partition_s"], "build_s": lead["build_s"],
            "per_device_fraction": lead["bytes"] / lead["bytes_all_ranks"],
            "halo_rows_per_dev": ref["halo_rows_per_dev"],
            "minhash_tables_bit_equal": ref["minhash_tables_bit_equal"],
            "probe_links": PROBE_LINKS,
            "max_feature_delta": ref["max_feature_delta"],
            # the port's additions
            "graph_ranks": len(ranks),
            "hll_tables_bit_equal": ref["hll_tables_bit_equal"],
            "plans_s": lead["plans_s"], "halo_route": lead["halo_route"],
            "halo_exchange_s": [r["halo_exchange_s"] for r in ranks],
            "edges_by_rank": [[r["local_edges"], r["halo_edges"]]
                              for r in ranks],
            "k1_launches_build": [r["k1_launches_build"] for r in ranks],
            "graph_s": lead["graph_s"], "save_s": lead["save_s"],
            "rank_s": lead["rank_s"], "reference_s": ref["reference_s"],
            "compare_s": ref["compare_s"],
            "rss_gb": [r["rss_gb"] for r in ranks],
            "peak_card_gb": [r["peak_card_gb"] for r in ranks],
            "reference_peak_card_gb": ref["reference_peak_card_gb"]}


def _shard_bytes_report(ranks: list) -> dict:
    out = {}
    for name in ("sk_minhash", "sk_hll"):
        per = [r["shard_bytes"][name] for r in ranks]
        total = per[0]["total_bytes"]
        for p in per:
            if p["per_device_bytes"] * len(ranks) != total:
                raise AssertionError(f"{name}: a rank holds "
                                     f"{p['per_device_bytes']} of {total} "
                                     f"bytes over {len(ranks)} ranks")
        out[name] = {"total_gb": total / 1e9,
                     "per_device_gb": per[0]["per_device_bytes"] / 1e9,
                     "fraction": per[0]["per_device_bytes"] / total}
    return out


def _elph_report(ranks: list) -> dict:
    lead = ranks[0]
    out = {"losses": lead["losses"], "results": lead["results"],
           "wall_s": lead["wall_s"], "rss_gb": max(r["rss_gb"] for r in ranks),
           "stages_s": lead["stages_s"]}
    if "edge_shard_sum" in lead:   # the sharded run
        out.update(rss_gb_by_rank=[r["rss_gb"] for r in ranks],
                   peak_card_gb_by_rank=[r["peak_card_gb"] for r in ranks],
                   collectives=lead["collectives"],
                   edge_shard_sum=lead["edge_shard_sum"])
    else:
        out["peak_card_gb"] = lead["peak_card_gb"]
    return out


def run(n: int = 500_000, out_path: Optional[str] = None,
        elph_mesh: str = "1,4", device: str = "cuda", graph_ranks: int = 8,
        epochs: int = 2, train_samples: int = 131072,
        eval_samples: Optional[int] = None, timeout: float = 1800.0,
        work: Optional[str] = None,
        log: Callable[[str], None] = print) -> dict:
    """The three phases in turn; returns the report (module docstring),
    which is also passed to ``log`` as JSON after every phase.  ``work``:
    the directory the phases write to (kept: the shards, the partition,
    the probe features, each rank's record); a temporary one, removed at
    the end, when None."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        # the ranks' kernels, built once before they start
        from subgraph_sketching_tpu_torch.ops import cuda_build
        cuda_build.load_all(("segscan", "plan_build"))
        device = f"cuda:{dev.index or 0}"
    else:
        device = "cpu"
    elph_ranks = int(np.prod([int(s) for s in elph_mesh.split(",")]))
    keep = work is not None
    work = os.path.abspath(work) if keep else tempfile.mkdtemp(
        prefix="scale_equality_")
    os.makedirs(work, exist_ok=True)
    common = [str(n), "--device", device, "--work", work, "--epochs",
              str(epochs), "--train_samples", str(train_samples)]
    if eval_samples is not None:
        common += ["--eval_samples", str(eval_samples)]
    report = {"backend": f"{device}, {graph_ranks} (buddy) and {elph_ranks} "
                         f"(ELPH) torch.distributed ranks sharing it",
              "nodes": n, "elph_training_mesh": elph_mesh, "note": NOTE,
              "device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
              "graph_ranks": graph_ranks,
              "launch_s": {}}   # each phase's launch, start to exit
    launch_s = report["launch_s"]

    def write():
        blob = json.dumps(report, indent=1)
        log(blob)
        if out_path:
            with open(out_path, "w") as f:
                f.write(blob)

    try:
        launch_s["buddy"] = _launch("buddy", ["--phase", "buddy", *common],
                                    graph_ranks, timeout)
        report["buddy_preprocessing"] = _buddy_report(
            n, _rank_records(work, "buddy", graph_ranks))
        write()
        launch_s["elph_sharded"] = _launch(
            "elph_sharded", ["--phase", "elph_sharded", *common, "--mesh",
                             elph_mesh], elph_ranks, timeout)
        ranks = _rank_records(work, "elph_sharded", elph_ranks)
        report["elph_shard_bytes"] = _shard_bytes_report(ranks)
        sharded = _elph_report(ranks)
        report["elph_memory_sharded"] = {"sharded": sharded}
        write()
        launch_s["elph_single"] = _launch(
            "elph_single", ["--phase", "elph_single", *common], None,
            timeout)
        single = _elph_report(_rank_records(work, "elph_single", 1))
        losses_s, losses_1 = sharded["losses"], single["losses"]
        report["elph_memory_sharded"] = {
            "sharded": sharded, "single_device": single,
            "max_loss_delta": (max(abs(a - b) for a, b in
                                   zip(losses_s, losses_1))
                               if losses_s and len(losses_s) == len(losses_1)
                               else None),
            "max_metric_delta": float(np.max(np.abs(
                np.asarray(sharded["results"])
                - np.asarray(single["results"]))))}
        write()
    finally:
        if not keep:
            shutil.rmtree(work, ignore_errors=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=500_000,
                    help="nodes of synth-ws-N (default 500000)")
    ap.add_argument("out", nargs="?", default=None,
                    help="write the report here too")
    ap.add_argument("elph_mesh", nargs="?", default="1,4",
                    help="the ELPH runs' data,graph mesh (default 1,4)")
    ap.add_argument("--graph_ranks", type=int, default=8,
                    help="ranks of the buddy phase (default 8)")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--train_samples", type=int, default=131072)
    ap.add_argument("--eval_samples", type=int, default=None,
                    help="evaluate train_samples train links and this "
                         "many val and test links (default: every link)")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds a phase may take before it is killed")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without one)")
    ap.add_argument("--phase", default=None,
                    help="internal: run one phase's process")
    ap.add_argument("--mesh", default=None,
                    help="internal: the elph_sharded phase's mesh")
    ap.add_argument("--work", default=None,
                    help="the phases' directory (kept; default a "
                         "temporary one)")
    args = ap.parse_intermixed_args(argv)
    device = device_from_flags(args.device)
    if args.phase == "buddy":
        return buddy_rank(args.n, device, args.work)
    if args.phase in ("elph_sharded", "elph_single"):
        return elph_run(args.n, args.mesh, device, args.epochs,
                        args.train_samples, args.eval_samples, args.work)
    if args.phase is not None:
        raise ValueError(f"unknown phase {args.phase}")
    return run(args.n, args.out, args.elph_mesh, device, args.graph_ranks,
               args.epochs, args.train_samples, args.eval_samples,
               args.timeout, args.work)


if __name__ == "__main__":
    main()
