#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  device     the card's name and power limit (nvidia-smi)
  build      nvcc of every kernel source (csrc/segscan.cu, gather_reduce.cu,
             block_prop.cu, dma_gather.cu), one nvcc each, all at once;
             each one's seconds
  kernels    each K1 instance (ops/segscan.py), held against its plain
             torch version on the card and against itself across two
             calls, then timed beside it, beside one scatter_reduce call
             (a yardstick the port never calls) and beside its bound (HBM
             bytes or combines, whichever takes longer on the data
             sheet); at three shapes: ``main_path`` (the plans the serve
             phase runs K1 on), ``ba_large`` (the same plans on the
             synth-ba-large train graph: 20k nodes, BA m=10, a power-law
             degree profile) and ``bench_hub`` (200k nodes, 3.2M random
             edges and one 50k-in-edge hub)
  reference  a small BUDDY scorer on the card against the same scorer on
             the CPU (plain versions): sketches bit-equal, scores allclose
  serve      the main path at full width: a seeded BUDDY checkpoint
             (Config defaults, synth-ws-200000) is rebuilt with
             scorer_from_checkpoint on the card and answers four requests,
             each sent twice (the size's first call, then a repeat);
             the K1 launch counts are read around that run.  Then the
             served state of the train and test splits (the two message
             graphs the rebuild runs K1 on) is recomputed with the plain
             merge: sketches bit-equal, SIGN features within the add bound
  hop_routes the sketch hop by its four routes at full width (MinHash
             biased int32 W=128, HLL int8 W=256, 2 hops from
             initialise_sketches): the plan (K1), the plain scatter route
             (sketch/elph.py), K3 (studies/gather_reduce.py) and K2
             (studies/sketch_prop.py).  ``served``: the train message
             graph the serve phase rebuilt, every hop of every route
             bit-equal to the served scorer's sketch stack, with the K2
             and K3 launch counts read around that run; ``bench_hub``:
             the kernels phase's hub graph, every hop bit-equal to the
             scatter route.  One line per hop, sketch and route (ms,
             bound, gathered bytes), then one per K2/K3 instance (kernel
             against its plain version and against itself across two
             calls, its time beside the plain version, the scatter route
             and its bound)
  k4         the gather-rate study (studies/dma_gather_rate.py) at its
             shape, 200000 rows of 128 int32 and 2^20 indices: every
             block's min bit-equal to the plain version, then the study's
             own measure() with the launch count read around it; rows/s
             of the kernel and of rows[idx].min(0), and the bound (the
             distinct rows touched, read once, plus the indices)
  profile    the same rebuild and one 262144-link request again under
             torch.profiler: host stage times, device busy time and share,
             the top kernels

then the per-kernel summary line (each K1 and K3 entry also carries its
``bench_hub`` time, bound and yardstick: ``hub_ms``, ``hub_bound_ms``,
``hub_library_ms``), the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``.  Any failure raises: the run exits
non-zero and prints no last line.  Without a CUDA device it exits 2 at once.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
VECTOR_OPS_PER_S = 67e12       # float32 outside the tensor cores, same sheet
CSRC = "subgraph_sketching_tpu_torch/csrc"
KERNEL_LIBS = ("segscan", "gather_reduce", "block_prop", "dma_gather")
# library name -> the TPU kernel it replaces (file:line of the pallas_call's
# function)
REPLACES = {"segscan": "subgraph_sketching_tpu/ops/pallas_segscan.py:103",
            "gather_reduce": "studies/pallas_gather_reduce.py:95",
            "block_prop": "studies/pallas_sketch_prop.py:134",
            "dma_gather": "studies/pallas_dma_gather_rate.py:72"}
REQUEST_SIZES = (1024, 8192, 65536, 262144)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` over warmed CUDA-event timing."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build() -> dict:
    from subgraph_sketching_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    seconds = cuda_build.load_all(KERNEL_LIBS)
    wall = time.perf_counter() - t0
    for name in KERNEL_LIBS:
        log = cuda_build.library_path(name)[:-3] + ".log"
        if os.path.exists(log):   # absent when the build was reused
            with open(log) as f:
                sys.stderr.write(f.read())
    return {"phase": "build", "seconds": seconds, "wall_s": wall,
            "libraries": {name: os.path.relpath(cuda_build.library_path(name))
                          for name in KERNEL_LIBS}}


# (instance name, op, dtype name, width) for every K1 instance
INSTANCES = [("segscan_min_i32", "min", "int32", 128),
             ("segscan_max_i8", "max", "int8", 256),
             ("segscan_max_i32", "max", "int32", 128),
             ("segscan_add_f32", "add", "float32", 128)]


def graph_plans(g, cfg) -> dict:
    """The plans the serve phase's K1 launches run on for one message graph
    ``g``, built the way the port builds them: the sketch plan (min/max)
    and the gcn-normalised SIGN plan with self-loops and staged weights
    (add)."""
    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.ops.graph_ops import gcn_norm
    from subgraph_sketching_tpu_torch.ops.segment_scan import make_auto_plan

    n = g.num_nodes
    sketch_plan = make_auto_plan(g.edge_index, n,
                                 max_slots=cfg.max_gather_slots,
                                 device="cuda")
    ei = torch.from_numpy(g.edge_index.astype(np.int64)).to("cuda")
    ew = (None if g.edge_weight is None
          else torch.from_numpy(np.asarray(g.edge_weight)).to("cuda"))
    nei, nw = gcn_norm(ei, ew, n)
    sign_plan = make_auto_plan(nei.cpu().numpy(), n,
                               max_slots=cfg.max_gather_slots, device="cuda")
    return {"graph": g, "min": (sketch_plan, None), "max": (sketch_plan, None),
            "add": (sign_plan, sign_plan.stage_edge_data(nw))}


def bench_hub_plans(seed: int = 0) -> dict:
    """The JAX bench.py plan shape (200k nodes, 3.2M uniform random edges)
    plus one hub of 50k in-edges (node 7)."""
    import numpy as np

    from subgraph_sketching_tpu_torch.ops.segment_scan import SortedSegmentPlan

    n, e, hub_in = 200_000, 3_200_000, 50_000
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e + hub_in, dtype=np.int32)
    dst = np.concatenate([rng.integers(0, n, e, dtype=np.int32),
                          np.full(hub_in, 7, np.int32)])
    edge_index = np.stack([src, dst])
    plan = SortedSegmentPlan(edge_index, n, device="cuda")
    w = plan.stage_edge_data(rng.random(e + hub_in, dtype=np.float32))
    return {"edge_index": edge_index, "min": (plan, None),
            "max": (plan, None), "add": (plan, w)}


ADD_TOLERANCE = "|err| <= 1e-4 * sum|v| + 1e-6"


def check_add(got, want, v, x, ptr, what: str) -> None:
    """float32 sums in another order (the kernel in sequence, the plain
    version with atomics): |err| <= 1e-4 * sum |v| + 1e-6 per element."""
    from subgraph_sketching_tpu_torch.ops import segscan
    scale = segscan.segment_combine_plain(v.abs(), x, "add", ptr)
    err = (got - want).abs()
    if bool((err > 1e-4 * scale + 1e-6).any()):
        raise AssertionError(f"{what}: kernel and plain version disagree, "
                             f"max |err| {float(err.max())}")


def phase_kernels(shape: str, plans: dict, seed: int = 0) -> list:
    """Every K1 instance on ``plans``: checked against the plain version on
    the card, then timed beside it, one scatter_reduce call and its
    bound."""
    import torch

    from subgraph_sketching_tpu_torch.ops import segscan

    g = torch.Generator(device="cuda").manual_seed(seed)
    records = []
    for name, op, dtype_name, width in INSTANCES:
        plan, w_slots = plans[op]
        n, S = plan.num_segments, plan.num_subruns
        dtype = getattr(torch, dtype_name)
        if dtype == torch.float32:
            x = torch.randn((n, width), generator=g, device="cuda")
        else:
            lo, hi = ((0, 56) if dtype == torch.int8
                      else (torch.iinfo(dtype).min, torch.iinfo(dtype).max))
            x = torch.randint(lo, hi, (n, width), generator=g, device="cuda",
                              dtype=dtype)
        v = plan.reduce_subruns(x, op, w_slots).contiguous()
        got = segscan.segment_combine(v, x, op, plan.sub_ptr)
        again = segscan.segment_combine(v, x, op, plan.sub_ptr)
        want = segscan.segment_combine_plain(v, x, op, plan.sub_ptr)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{name} ({shape}): two calls differ")
        max_err = float((got.double() - want.double()).abs().max())
        if op == "add":
            check_add(got, want, v, x, plan.sub_ptr, f"{name} ({shape})")
            tolerance = ADD_TOLERANCE
        else:
            if not torch.equal(got, want):
                raise AssertionError(f"{name} ({shape}): kernel is not "
                                     f"bit-equal to the plain version")
            tolerance = "bit-equal"
        kernel_ms = cuda_ms(lambda: segscan.segment_combine(
            v, x, op, plan.sub_ptr))
        plain_ms = cuda_ms(lambda: segscan.segment_combine_plain(
            v, x, op, plan.sub_ptr))
        # yardstick: one scatter_reduce computing the same function (x as
        # the initial value folds the node's own row in for min/max)
        red = {"min": "amin", "max": "amax", "add": "sum"}[op]
        base = x if op != "add" else torch.zeros_like(x)
        idx = segscan.segment_ids(plan.sub_ptr)[:, None].expand(-1, width)
        lib_v, lib_base, widened = v, base, False
        try:
            base.scatter_reduce(0, idx, v, red, include_self=True)
        except RuntimeError:   # type not supported there: int32 copy
            lib_v, lib_base, widened = v.int(), base.int(), True
        library_ms = cuda_ms(lambda: lib_base.scatter_reduce(
            0, idx, lib_v, red, include_self=True))
        b = v.element_size()
        bytes_moved = (S * width * b + (n * width * b if op != "add" else 0)
                       + n * width * b + (n + 1) * 8)
        # one combine per element of v, and one per element of x (min/max)
        combines = S * width + (n * width if op != "add" else 0)
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = combines / VECTOR_OPS_PER_S * 1e3
        records.append({
            "phase": "kernels", "shape": shape, "name": name, "op": op,
            "dtype": dtype_name, "W": width, "N": n, "S": S,
            "max_subruns_per_row": int(plan.sub_ptr.diff().max()),
            "max_abs_err": max_err, "tolerance": tolerance,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_widened_to_int32": widened,
            "bytes": bytes_moved, "combines": combines,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"})
        del x, v, got, want
    return records


def seeded_buddy(cfg, num_features: int, seed: int):
    """A BUDDY for ``cfg`` with every weight and BN statistic drawn from a
    torch.Generator (fan-in-scaled uniform weights, non-trivial BN)."""
    import torch

    from subgraph_sketching_tpu_torch.models import BUDDY
    model = BUDDY.from_config(cfg, num_features)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for key, t in model.state_dict().items():
            if not t.is_floating_point():
                continue
            u = torch.rand(t.shape, generator=g)
            if t.dim() == 2:
                t.copy_((2 * u - 1) / t.shape[1] ** 0.5)
            elif key.endswith("running_var") or (
                    key.endswith("weight") and "bn" in key):
                t.copy_(0.5 + u)
            else:
                t.copy_(0.2 * u - 0.1)
    return model


def phase_reference(seed: int = 1) -> dict:
    """Small input: the scorer on the card (K1) against the same scorer on
    the CPU (plain merge)."""
    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.ops.cuda_build import BUILD_DIR
    from subgraph_sketching_tpu_torch.serving import (
        save_buddy_checkpoint, scorer_from_checkpoint,
    )
    cfg = Config(dataset_name="synth-ws", hidden_channels=32)
    ckpt = os.path.join(BUILD_DIR, "smoke_reference_checkpoint")
    save_buddy_checkpoint(ckpt, cfg, seeded_buddy(cfg, 128, seed))
    on_card = scorer_from_checkpoint(ckpt, device="cuda")
    on_cpu = scorer_from_checkpoint(ckpt, device="cpu")
    shutil.rmtree(ckpt)
    for a, b in zip(on_card.sk, on_cpu.sk):
        if a.dtype == torch.float32:
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
        elif not torch.equal(a.cpu(), b):
            raise AssertionError("sketches on the card differ from the CPU")
    links = np.random.default_rng(seed).integers(0, on_cpu.num_nodes,
                                                 (4096, 2))
    got, want = on_card.score(links), on_cpu.score(links)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    return {"phase": "reference", "dataset": cfg.dataset_name,
            "links": len(links),
            "max_abs_score_diff": float(np.abs(got - want).max()),
            "tolerance": "sketches bit-equal, cards 1e-5, scores 1e-4"}


def check_against_plain(cfg, scorer, plans: dict, what: str) -> None:
    """The served state of one message graph again, with the plain merge on
    the card: every propagated sketch hop bit-equal, and the SIGN features
    (one propagation at sign_k=0) within the add bound."""
    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.sketch.elph import initialise_sketches

    plan = plans["min"][0]
    rows = initialise_sketches(plan.num_segments, scorer.sketch_params,
                               "cuda")
    first = 0 if cfg.hops_only_sketches else 1   # stack row of hop 1
    for hop in range(1, cfg.max_hash_hops + 1):
        rows = tuple(
            segscan.segment_combine_plain(plan.reduce_subruns(r, op), r, op,
                                          plan.sub_ptr)
            for r, op in zip(rows, ("min", "max")))
        i = hop - 1 + first
        if not (torch.equal(rows[0], scorer.sk.minhash[i])
                and torch.equal(rows[1], scorer.sk.hll[i])):
            raise AssertionError(f"{what}, hop {hop}: kernel-path sketches "
                                 f"differ from the plain merge")
    if cfg.sign_k != 0:
        raise NotImplementedError("the SIGN check covers sign_k=0 only")
    sign_plan, w = plans["add"]
    x0 = torch.from_numpy(np.asarray(plans["graph"].x,
                                     dtype=np.float32)).to("cuda")
    v = sign_plan.reduce_subruns(x0, "add", w).contiguous()
    want = segscan.segment_combine_plain(v, x0, "add", sign_plan.sub_ptr)
    check_add(scorer.x, want, v, x0, sign_plan.sub_ptr,
              f"{what}, SIGN features")


def phase_serve(cfg, splits, train_plans: dict, seed: int = 2) -> dict:
    """The main path at full width: rebuild a seeded checkpoint on the card
    with scorer_from_checkpoint, answer four requests, and read the K1
    launch counts around that run.  Then hold the served state of both
    message graphs K1 ran on (train, and test, which adds the validation
    edges) against the plain merge.  Returns the train scorer's (sketch
    stack, sketch params) and the record."""
    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.ops.cuda_build import BUILD_DIR
    from subgraph_sketching_tpu_torch.serving import (
        save_buddy_checkpoint, scorer_from_checkpoint,
    )

    ckpt = os.path.join(BUILD_DIR, "smoke_serve_checkpoint")
    save_buddy_checkpoint(ckpt, cfg, seeded_buddy(cfg, 128, seed))

    for k in segscan.launches:
        segscan.launches[k] = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scorer = scorer_from_checkpoint(ckpt, device="cuda")
    torch.cuda.synchronize()
    preprocess_s = time.perf_counter() - t0

    rng = np.random.default_rng(seed)
    scorer.warmup()
    requests = []
    for size in REQUEST_SIZES:
        links = rng.integers(0, scorer.num_nodes, (size, 2))
        ms = []   # the size's first request, then the same request again
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores = scorer.score(links)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if scores.shape != (size,) or not np.isfinite(scores).all():
                raise AssertionError(f"request of {size} links: bad scores")
        requests.append({"links": size, "ms": ms[0],
                         "links_per_s": size / ms[0] * 1e3,
                         "repeat_ms": ms[1]})
    launches = dict(segscan.launches)
    peak_memory = torch.cuda.max_memory_allocated()

    need = {"segscan_min_i32": cfg.max_hash_hops,
            "segscan_max_i8": cfg.max_hash_hops, "segscan_add_f32": 1}
    if any(launches[k] < v for k, v in need.items()) \
            or sum(launches.values()) < 5:
        raise AssertionError(f"the main path did not run through K1: "
                             f"{launches}")

    # the test split's message graph is the other one the rebuild ran K1
    # on; the scorer for it comes from the same entry point
    test_scorer = scorer_from_checkpoint(ckpt, split="test", device="cuda")
    shutil.rmtree(ckpt)
    check_against_plain(cfg, scorer, train_plans, "train")
    served = (scorer.sk, scorer.sketch_params)   # for the hop_routes phase
    del scorer
    check_against_plain(cfg, test_scorer,
                        graph_plans(splits["test"].graph, cfg), "test")
    return served, {"phase": "serve", "dataset": cfg.dataset_name,
            "nodes": test_scorer.num_nodes,
            "train_message_edges": int(train_plans["graph"].num_edges),
            "test_message_edges": int(splits["test"].graph.num_edges),
            "hidden_channels": cfg.hidden_channels,
            "minhash_num_perm": cfg.minhash_num_perm, "hll_p": cfg.hll_p,
            "max_hash_hops": cfg.max_hash_hops, "sign_k": cfg.sign_k,
            "preprocess_s": preprocess_s, "k1_launches": launches,
            "state_equals_plain_merge": ["train", "test"],
            "requests": requests, "peak_memory_bytes": peak_memory}


def _bound(nbytes: int, combines: int) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the combines over the float32 vector rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = combines / VECTOR_OPS_PER_S * 1e3
    return {"bytes": nbytes, "combines": combines,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class HopRoutes:
    """The four routes of one sketch hop over one graph on the card, each
    a function of the [n, W] rows for min (biased int32 MinHash) and max
    (int8 HLL), with the bytes of the edge tables it reads."""

    def __init__(self, edge_index, n: int, plan):
        import numpy as np
        import torch

        from subgraph_sketching_tpu_torch.sketch import elph
        from subgraph_sketching_tpu_torch.studies import gather_reduce as gr
        from subgraph_sketching_tpu_torch.studies import sketch_prop as sp

        t0 = time.perf_counter()
        self.n, self.e = n, edge_index.shape[1]
        src = torch.from_numpy(edge_index[0].astype(np.int32)).to("cuda")
        dst = torch.from_numpy(edge_index[1].astype(np.int64)).to("cuda")
        self.csr = tuple(torch.from_numpy(a).to("cuda")
                         for a in gr.prepare_csr_edges(edge_index, n))
        self.block = sp.BlockPropPlan(edge_index, n, device="cuda")
        torch.cuda.synchronize()
        self.layout_s = time.perf_counter() - t0
        csr, block = self.csr, self.block
        self.fns = {
            "plan": {op: (lambda x, op=op: plan.reduce(x, op))
                     for op in ("min", "max")},
            "scatter": {"min": lambda x: elph.propagate_minhash(x, src, dst, n),
                        "max": lambda x: elph.propagate_hll(x, src, dst, n)},
            "K3": {"min": lambda x: gr.propagate_min(x, *csr),
                   "max": lambda x: gr.propagate_max(x, *csr)},
            "K2": {"min": block.propagate_minhash,
                   "max": block.propagate_hll},
        }
        # K3's kernel reads the real edges' src and the pointer only
        self.edge_bytes = {
            "plan": _nbytes(plan.gather_idx, plan.sub_ptr),
            "scatter": _nbytes(src, dst),
            "K3": 4 * self.e + _nbytes(csr[2]),
            "K2": _nbytes(block.src, block.dstl, block.blk_ptr),
        }

    def bound(self, route: str, x) -> dict:
        """Rows read once, the route's edge tables read once, out written
        once; one combine per element for each edge and self-loop."""
        w, b = x.shape[1], x.element_size()
        rec = _bound(2 * self.n * w * b + self.edge_bytes[route],
                     (self.e + self.n) * w)
        rec["gathered_bytes"] = self.e * w * b   # what no reuse would read
        return rec


SKETCHES = (("minhash", "min"), ("hll", "max"))


def phase_hop_routes(shape: str, edge_index, n: int, plan, params,
                     served=None, hops: int = 2) -> list:
    """Every route of the sketch hop, ``hops`` hops from
    initialise_sketches.  With ``served`` (the serve phase's sketch stack
    and whether it holds hop 0) every hop is held bit-equal to it, else to
    the scatter route.  The K2 and K3 launch counts are set to 0 just
    before that drive and read just after.  Returns the records."""
    import torch

    from subgraph_sketching_tpu_torch.sketch.elph import initialise_sketches
    from subgraph_sketching_tpu_torch.studies import gather_reduce as gr
    from subgraph_sketching_tpu_torch.studies import sketch_prop as sp

    r = HopRoutes(edge_index, n, plan)
    hop0 = initialise_sketches(n, params, "cuda")
    if served is not None:
        sk, first = served
        want = [hop0] + [(sk.minhash[h - 1 + first], sk.hll[h - 1 + first])
                         for h in range(1, hops + 1)]
        against = "served sketches"
    else:
        want = [hop0]
        for _ in range(hops):
            want.append(tuple(r.fns["scatter"][op](x)
                              for x, (_, op) in zip(want[-1], SKETCHES)))
        against = "scatter route"

    # the path: every route runs every hop from hop 0, each hop checked
    for counts in (gr.launches, sp.launches):
        for k in counts:
            counts[k] = 0
    for route, fns in r.fns.items():
        rows = hop0
        for hop in range(1, hops + 1):
            rows = tuple(fns[op](x) for x, (_, op) in zip(rows, SKETCHES))
            for got, ref, (sketch, _) in zip(rows, want[hop], SKETCHES):
                if not torch.equal(got, ref):
                    raise AssertionError(f"{shape}: {route} route, hop {hop},"
                                         f" {sketch} differs from the "
                                         f"{against}")
    torch.cuda.synchronize()
    launches = {**gr.launches, **sp.launches}
    if any(v != hops for v in launches.values()):
        raise AssertionError(f"{shape}: the K2/K3 routes did not launch "
                             f"their kernels once a hop: {launches}")

    records = [{"phase": "hop_routes", "shape": shape, "nodes": n,
                "edges": r.e, "layout_s": r.layout_s, "equal_to": against,
                "launches": launches}]
    route_ms = {}
    for hop in range(1, hops + 1):
        for i, (sketch, op) in enumerate(SKETCHES):
            x = want[hop - 1][i]
            for route, fns in r.fns.items():
                ms = cuda_ms(lambda: fns[op](x))
                route_ms[(hop, sketch, route)] = ms
                records.append({"phase": "hop_routes", "shape": shape,
                                "hop": hop, "sketch": sketch, "route": route,
                                "W": x.shape[1], "dtype": str(x.dtype),
                                "cuda_ms": ms, **r.bound(route, x)})

    # each K2/K3 instance on hop 1's input: against its plain version, then
    # timed beside it, the scatter route (its library yardstick) and its
    # bound
    s, d, ptr = r.csr
    b = r.block
    for i, (sketch, op) in enumerate(SKETCHES):
        x = want[0][i]
        is_min = op == "min"
        rows = gr.append_identity_row(x, is_min=is_min)
        instances = {
            gr._ENTRY[(op, x.dtype)][0]: (
                lambda: gr.gather_reduce(rows, s, d, ptr, is_min=is_min),
                lambda: gr.gather_reduce_plain(rows, s, d, is_min=is_min),
                "K3"),
            sp._ENTRY[(op, x.dtype)][0]: (
                lambda: sp.block_prop(x, b.src, b.dstl, b.blk_ptr,
                                      is_min=is_min),
                lambda: sp.block_prop_plain(x, b.src, b.dstl, b.blk_ptr,
                                            is_min=is_min),
                "K2"),
        }
        for name, (kernel, plain, route) in instances.items():
            got, again, ref = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"{shape}: {name} is not bit-equal to "
                                     f"its plain version")
            if not torch.equal(got, again):
                raise AssertionError(f"{shape}: {name}: two calls differ")
            records.append({
                "phase": "hop_routes", "shape": shape, "name": name,
                "route": route, "max_abs_err":
                    float((got.double() - ref.double()).abs().max()),
                "tolerance": "bit-equal", "kernel_ms": cuda_ms(kernel),
                "plain_ms": cuda_ms(plain),
                "library_ms": route_ms[(1, sketch, "scatter")],
                "launches": launches[name], **r.bound(route, x)})
            del got, ref
    return records


def phase_k4(seed: int = 0) -> dict:
    """K4 at its study shape: every block's min against the plain version;
    the study's own measure() with the launch count read around it; the
    plain version's time; the bound from the distinct rows touched."""
    import torch

    from subgraph_sketching_tpu_torch.studies import dma_gather_rate as dg

    num_rows, num_indices = 200_000, 1 << 20
    rows, idx = dg.study_inputs(num_rows, num_indices, seed, "cuda")
    nb = num_indices // dg.BLOCK
    got = dg.block_mins(rows, idx, nb)
    want = dg.block_mins_plain(rows, idx, nb)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("dma_gather: block mins are not bit-equal to "
                             "the plain version")
    dg.launches["dma_gather"] = 0
    study = dg.measure(num_rows, num_indices, seed, device="cuda")
    launches = dg.launches["dma_gather"]
    if launches < 1:
        raise AssertionError("the gather-rate study did not launch K4")
    # the plain version of the study's function gathers the last block
    # only; the plain version of every block's min is timed beside it
    plain_ms = cuda_ms(lambda: dg.dma_gather_plain(rows, idx, nb))
    plain_all_ms = cuda_ms(lambda: dg.block_mins_plain(rows, idx, nb))
    distinct = int(torch.unique(idx[:nb * dg.BLOCK]).numel())
    w = rows.shape[1]
    return {"phase": "k4", "name": "dma_gather", **study,
            "launches": launches, "plain_ms": plain_ms,
            "plain_all_blocks_ms": plain_all_ms,
            "max_abs_err": float((got.double() - want.double()).abs().max()),
            "tolerance": "bit-equal", "distinct_rows": distinct,
            **_bound(distinct * w * 4 + nb * dg.BLOCK * 4 + w * 4,
                     nb * dg.BLOCK * w)}


def _device_time(prof) -> tuple:
    """(busy ms, {kernel name: [ms, count]}) from the CUDA events of a
    torch.profiler run."""
    from torch.autograd import DeviceType
    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            slot = per.setdefault(e.name[:96], [0.0, 0])
            slot[0] += e.time_range.elapsed_us() / 1e3
            slot[1] += 1
    return sum(v[0] for v in per.values()), per


def phase_profile(cfg, seed: int = 3) -> dict:
    """Where the serving time goes: the rebuild's host stages by clock, and
    the device's busy time under torch.profiler, for the rebuild and for
    one 262144-link request.  A second run of the same work as the serve
    phase, so the profiler's cost stays out of the serve numbers."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from subgraph_sketching_tpu_torch.graph.datasets import get_data
    from subgraph_sketching_tpu_torch.graph.preprocess import build_all_splits
    from subgraph_sketching_tpu_torch.serving import LinkScorer

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        splits, directed, _ = get_data(cfg)
        t1 = time.perf_counter()
        datasets = build_all_splits(splits, cfg, directed=directed,
                                    device="cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    busy_ms, per = _device_time(prof)
    rebuild = {"get_data_s": t1 - t0, "build_all_splits_s": t2 - t1,
               "device_busy_ms": busy_ms,
               "device_idle_share": 1 - busy_ms / ((t2 - t0) * 1e3),
               "top_kernels": sorted(([k, v[0], v[1]] for k, v in per.items()),
                                     key=lambda r: -r[1])[:12]}
    scorer = LinkScorer(cfg, seeded_buddy(cfg, 128, seed), datasets["train"],
                        device="cuda")
    links = np.random.default_rng(seed).integers(0, scorer.num_nodes,
                                                 (REQUEST_SIZES[-1], 2))
    scorer.score(links)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        scorer.score(links)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    busy_ms, per = _device_time(prof)
    request = {"links": REQUEST_SIZES[-1], "ms": dt * 1e3,
               "device_busy_ms": busy_ms,
               "device_idle_share": 1 - busy_ms / (dt * 1e3),
               "top_kernels": sorted(([k, v[0], v[1]] for k, v in per.items()),
                                     key=lambda r: -r[1])[:12]}
    return {"phase": "profile", "rebuild": rebuild, "request": request}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the port itself: fails here when run outside a checkout of the repo
    import subgraph_sketching_tpu_torch  # noqa: F401
    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.graph.datasets import get_data

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    emit(phase_build())
    cfg = Config(dataset_name="synth-ws-200000")   # full-width defaults
    splits, _, _ = get_data(cfg)
    plans = graph_plans(splits["train"].graph, cfg)
    hub = bench_hub_plans()
    main_records = phase_kernels("main_path", plans)
    ba_splits, _, _ = get_data(Config(dataset_name="synth-ba-large"))
    ba_records = phase_kernels("ba_large",
                               graph_plans(ba_splits["train"].graph, cfg))
    del ba_splits
    hub_records = phase_kernels("bench_hub", hub)
    for r in main_records + ba_records + hub_records:
        emit(r)
    emit(phase_reference())
    (sk, params), serve = phase_serve(cfg, splits, plans)
    emit(serve)
    g = splits["train"].graph
    served = phase_hop_routes(
        "served", g.edge_index, g.num_nodes, plans["min"][0], params,
        served=(sk, 0 if cfg.hops_only_sketches else 1),
        hops=cfg.max_hash_hops)
    del sk
    hub_routes = phase_hop_routes(
        "bench_hub", hub["edge_index"], hub["min"][0].num_segments,
        hub["min"][0], params, hops=cfg.max_hash_hops)
    for r in served + hub_routes:
        emit(r)
    k4 = phase_k4()
    emit(k4)
    emit(phase_profile(cfg))

    # each K1 and K3 instance's bench_hub record, by name
    at_hub = {r["name"]: r for r in hub_records + hub_routes if "name" in r}

    def line(r, lib, ms_key="kernel_ms"):
        rec = {"name": r["name"], "route": "cuda",
               "source": f"{CSRC}/{lib}.cu", "replaces": REPLACES[lib],
               "launches": r["launches"], "max_abs_err": r["max_abs_err"],
               "ms": r[ms_key], "plain_ms": r["plain_ms"],
               "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               "library_ms": r["library_ms"]}
        if lib in ("segscan", "gather_reduce"):
            h = at_hub[r["name"]]
            rec.update(hub_ms=h["kernel_ms"], hub_bound_ms=h["bound_ms"],
                       hub_library_ms=h["library_ms"])
        return rec

    # K1: the instances the main path launched (int32 max is checked and
    # timed above, but serving does not run it); K2 and K3 on the served
    # graph, launched by the hop_routes drive; K4 by its study
    k1 = serve["k1_launches"]
    emit({"kernels": [
        line({**r, "launches": k1[r["name"]]}, "segscan")
        for r in main_records if k1[r["name"]] > 0] + [
        line(r, {"K3": "gather_reduce", "K2": "block_prop"}[r["route"]])
        for r in served if "name" in r] + [
        line({**k4, "library_ms": k4["torch_gather_min_ms"]}, "dma_gather")]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
