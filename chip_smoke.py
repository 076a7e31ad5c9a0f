#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  device     the card's name and power limit (nvidia-smi)
  build      nvcc of every kernel source (csrc/segscan.cu, gather_reduce.cu,
             block_prop.cu, dma_gather.cu) and g++ of the plan builder
             (csrc/plan_build.cpp) and the SEAL extractor
             (csrc/seal_extract.cpp), one compiler each, all at once; each
             one's seconds
  kernels    each K1 instance (ops/segscan.py), held against its plain
             torch version on the card and against itself across two
             calls, then timed beside it, beside one scatter_reduce call
             (a yardstick the port never calls) and beside its bound (HBM
             bytes or combines, whichever takes longer on the data
             sheet); timed twice, by events around 20 wrapper calls
             (``kernel_ms``, the host's work included) and by replaying a
             CUDA graph of 20 wrapper calls (``graph_ms``, the device's
             time alone); at three shapes: ``main_path`` (the plans the serve
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
             (studies/sketch_prop.py, its fold launch counted apart).
             ``served``: the train message graph the serve phase
             rebuilt, every hop of every route bit-equal to the served
             scorer's sketch stack, with the K2 and K3 launch counts read
             around that run; ``bench_hub``:
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
  train      BUDDY training at full width through runners.run.run
             (synth-ws-200000, Config defaults, 2 epochs of 262,144 links,
             BUDDY_TRAIN_SAMPLES, eval every epoch,
             --check_determinism, --save_model), the K1 launch counts read
             around it (at least 2 min, 2 max and 1 add per message graph);
             per epoch: loss (finite, falling), train and eval seconds,
             trained links/s, Hits@100; peak memory.  Then the device idle
             share over 200 steps under torch.profiler, and the saved
             checkpoint served by scorer_from_checkpoint: its scores for
             65536 random links equal to the trainer's predict within 1e-4
  train_reference  a small BUDDY (synth-ws, hidden 32, dropout 0) trained 2
             epochs from the same weights on the same orders on the card
             and on the CPU, in float32 and float64: step losses and
             parameters allclose (see phase_train_reference)
  datasets   the reference's datasets, in three parts:
             ``collab``: an ogbl_collab raw-layout tree at the published
             shape (235,868 nodes, 128-dim features, 1,179,052 train edges
             with weights and years, 60,084 valid and 46,329 test edges
             with 100,000 negatives each), written from a seed (its
             seconds apart), then the reference's collab BUDDY command cut
             to one epoch of 131,072 links through runners.run, twice
             with one --cache_dir:
             the second run reads the caches and equals the first
             (subgraph and SIGN features, epoch-0 loss); per run get_data,
             preprocessing, epoch and eval seconds, Hits@50, peak memory.
             ``chunked_synth_ws``: the chunk-streamed plan against the
             one-shot plan on the synth-ws-200000 train graph at
             max_slots 2^18 (2 hops of MinHash and HLL bit-equal, one SIGN
             add within the add bound, K1 once per chunk of every reduce).
             ``citation2_scale``: a graph with ogbl-citation2's published
             counts (2,927,963 nodes, 30,387,995 edges, power-law
             in-degrees, 128-dim features) through the citation2
             preprocessing (to_undirected, SIGN sign_k 3, 2-hop sketches)
             on the chunked plan at the default max_gather_slots: the C++
             plan tables against numpy (equal, both timed), each hop's
             device ms, the K1 launch counts, peak memory; then every
             chunk merge of every reduce, K1 against its plain version,
             and each K1 instance timed over one reduce's chunks
  citation2_train  BUDDY end to end at citation2 scale through the port's
             tools/citation2_train.py at the JAX tool's full sizes (a
             2,927,963-node Watts-Strogatz ring, 29,279,630 directed
             edges, 28M train and 2M val links and 10,000 MRR positives
             with 100 same-source negatives each, the chunked plan at
             max_slots 4 << 20, 2-hop sketches, features for every link,
             SIGN(k=0), hidden 256, 3 epochs at batch 262,144, eval), one
             line per stage as it ends (seconds, links/s, peak memory),
             the K1 launch counts read around the run (exactly 2 min and
             2 max a chunk, 1 add a chunk); then every chunk merge of hop
             1's min and max on K1 bit-equal to its plain version and of
             the SIGN add within the add bound, the epoch losses finite
             and falling, val AUC >= 0.90 and MRR >= 0.50, the shifted
             last prediction chunk equal to whole chunks on the MRR set,
             20 training steps under torch.profiler (idle share, top
             kernels), and each K1 instance timed over one reduce's chunks

  plan_spmm  ELPH's differentiable SpMM at full width: PlanSpmm over the
             gcn_norm'd synth-ws-200000 train graph at W=1024 float32,
             forward and x-gradient against the plain merge on the card
             and against autograd through the scatter spmm, one K1 add
             launch each way; K1 on each direction's sub-run results timed
             as in the kernels phase (one line each); the whole SpMM timed
             by each route
  train_elph ELPH training at full width through runners.run.run
             (--model ELPH, synth-ws-200000, Config defaults: hidden 1024,
             batch 1024, gcn, 2 hops, dropouts 0.5; 2 epochs of 65536
             links, eval every epoch, --check_determinism, --save_model),
             the K1 launch counts read around it (at least 5 add launches
             a step: PlanSpmm each way per convolution, gather_rows'
             backward), the rebuilt trainer's staged plan; per epoch loss
             (finite, falling), seconds, trained links/s, Hits@100; peak
             memory; gather_rows' backward at the run's shape against the
             plain merge and indexing's backward, timed; the device idle
             share and top kernels over 20 steps under torch.profiler
             (exactly 5 K1 add launches a step, by the counter and in the
             trace); a step by the scatter SpMM (two runs from one init
             bit-identical) beside a step by the plan; the checkpoint
             served by scorer_from_checkpoint, equal to the trainer's
             predict on 65536 links within 1e-4
  elph_reference  a small ELPH (synth-ws, hidden 32, dropout 0) trained 2
             epochs from the same weights on the same orders on the card
             and on the CPU, in float32 and float64 (K1's float64 add)
  ddi        node embeddings at ogbl-ddi's published shape: an ogbl_ddi raw
             tree (4,267 nodes, 1,067,911 train edges with skewed degrees,
             133,489 valid and test positives, 101,882 / 95,599 negatives)
             written from a seed (its seconds apart), then the reference's
             ddi BUDDY command twice with one --cache_dir (the second run
             reads the caches and equals the first) and its ddi ELPH
             command, each at its published widths (hidden 256, batch
             131072, 6 negatives, sign_k 2, a trainable table diffused in
             every step) cut to 2 epochs, eval every epoch,
             --check_determinism, --save_model; per run get_data,
             preprocessing, epoch seconds, links/s, loss (finite,
             falling), Hits@20, peak memory and K1 add launches (at least 5
             a step); for the first BUDDY run and the ELPH run 20 profiled
             steps (idle share, top kernels, exactly 5 K1 add launches a
             step by counter and trace) and the checkpoint served, equal
             to predict on 65536 links within 1e-4; then K1 on the
             diffusion plan's forward and backward sub-run results at
             W = 256, as the kernels phase holds and times it
  emb_reference  a small BUDDY and a small ELPH with a trainable,
             propagated table (synth-ws, hidden 32, sign_k 2, dropouts 0)
             trained 2 epochs on the card and on the CPU, float32 and
             float64
  streaming  exact streaming edge updates at full width: 1,000 undirected
             train edges of synth-ws-200000 held out of the message graph,
             a LinkScorer at Config defaults on the rest, the pairs
             inserted in batches of 1, 100 and 899 and deleted again in
             the same batches; after each pass the MinHash and HLL stacks
             bit-equal (cards rtol 1e-6) to build_hash_tables on that
             graph by the plan route (K1) and the scores within 1e-5 of a
             rebuilt scorer's; on full and on hops-only stacks; per batch
             wall, host, dispatch and device ms and the rows rebuilt per
             hop, the rebuild's seconds beside them; K1's launches read
             around the phase
  serve_ra   a use_RA BUDDY at Config defaults on synth-ws-200000: served
             scores equal predict on the valid split (max |err| <= 1e-5),
             request ms at 1024, 65536 and 262144 links with the host RA
             share, one weighted insert + delete round with the RA CSR
             equal to a rebuilt one after each; K1's launches read around
             the rebuild
  heuristics runners.run_heuristics.run with RA, CN and AA on the card over
             the collab tree of the datasets phase (one rep): seconds,
             links per bucket width, Hits@50 and AUC per heuristic; a
             seeded sample of 100,000 valid/test links held to the host
             functions (rtol 1e-4, atol 1e-5); the four heuristics, PPR
             among them, through the runner on synth-ba; one call over
             16,384 hub pairs of the ddi tree (bucket 4096), timed
  seal       the SEAL tier at full width on the collab tree: SEALDGCNN at
             Config defaults (hidden 1024, 3 layers, sortpool_k 0.6, DRNL,
             batch 1024) through runners.run with --dynamic_train/val/test,
             65,536 train and 16,384 valid and test links, 1 epoch,
             --check_determinism, --save_model: k, loss (finite), the
             host's extraction seconds, epoch and eval seconds, trained
             links/s, Hits@50, peak memory, K1's launches; 50 steps of the
             trained model under torch.profiler (step ms on the host and
             the device, extraction ms a batch, idle share, top kernels,
             exactly 10 K1 add launches a step by counter and trace); then
             K1 on the label embedding's backward (one step's real ids
             and gradient, held against indexing's backward too) and on
             one batch's disjoint union at W = 1024 and at DGCNN's W = 1
             (one line each, held and timed as in the kernels phase);
             SEALGCN, SEALSAGE, SEALGIN and SEALMLP through the
             runner at 8,192 train links, 1 epoch each
  seal_reference  small SEALGCN, SEALGIN and SEALDGCNN (synth-ba, hidden
             32, dropout 0) trained 3 steps on the card and on the CPU,
             float32 and float64
  kge        transE, distmult, complEx and rotatE at Config defaults
             (hidden 1024) on the collab tree, 1 epoch each through the
             runner (--check_determinism on transE): epoch seconds,
             steps/s, loss, Hits@50, peak memory, K1 add launches (2 a
             step); one step of transE and of rotatE on the card against
             the CPU's from one init (loss, gradients, tables); K1 on
             that step's real gather_rows backward inputs: the entity
             rows at W = 1024 (transE) and 2048 (rotatE), the relation
             row (transE), one line each

  bf16       the bfloat16 compute dtype (--dtype bfloat16): ELPH at full
             width through runners.run.run (the train_elph run at
             bfloat16, with --profile_dir: its epoch-1 trace names K1's
             bfloat16 kernel), K1 launches a step by instance, the state
             float32 after training, 20 steps profiled (idle share, top
             kernels), a step at bfloat16 beside one at float32 on the same
             staged data in turns, the checkpoint served within 1e-2 of
             predict; BUDDY at full width, one epoch of
             BUDDY_TRAIN_SAMPLES links, served in bfloat16;
             SEALDGCNN at Config defaults on the collab tree cut to 16
             train batches (K1 launches a step by instance, the step at
             both dtypes in turns); a small ELPH with a diffused node
             table and a small SEALDGCNN on the card against the CPU at
             bfloat16 (logits, one step's gradients), GCN, SAGE and
             MLPLinkPredictor in float32; K1's bfloat16 add at PlanSpmm's
             shape (W = 1024) and SEAL's union (W = 1024, W = 1): dyadic
             inputs bit-equal to the plain version, random ones within the
             bound of the float64 sum, two calls bit-equal, timed as in
             the kernels phase
  f16        the float16 compute dtype (--dtype float16): ELPH at full
             width through runners.run.run (synth-ws-200000, Config
             defaults, one epoch of F16_ELPH_SAMPLES links): K1 launches a
             step by instance, the state float32, 5 steps profiled, a step
             at float16 beside one at float32 on the same staged data in
             turns; SEALDGCNN at Config defaults on the collab tree cut to
             4 train batches; a small ELPH with a diffused node table and a
             small SEALDGCNN on the card against the CPU at float16; a
             small float16 ELPH checkpoint served on the card and on the
             CPU; SEALGCN and transE runs with and without --mesh_shape 1,
             equal bit for bit; K1's float16 add at PlanSpmm's shape each
             way (W = 1024), on SEAL's label table backward (W = 1024) and
             on its union (W = 1024, W = 1), held and timed as in the bf16
             phase; the phase's seconds
  dp         data parallelism (parallel/, the trainers' data axis): (a)
             world size 1 on NCCL at full width: BUDDY at Config defaults
             on synth-ws-200000 through runners.run with --mesh_shape 1 (1
             epoch of BUDDY_TRAIN_SAMPLES links, --check_determinism),
             its epoch loss within rtol 1e-4 of the train phase's first
             epoch without a mesh, and ELPH at
             Config defaults with --mesh_shape 1 (one epoch of 65536
             links) against the train_elph run's first epoch; per model
             the epoch seconds, step ms, 50 / 20 steps on the mesh and
             unsharded under torch.profiler (parallel/breakdown.py: idle
             share, collectives a step: calls, bytes, NCCL device ms;
             host self ms by operator and the mesh's excess by operator;
             K1 adds a step) and the step ms on the mesh and unsharded
             in turns; K1 on one meshed ELPH step's real
             inputs (PlanSpmm each way, gather_rows' backward), one line
             each, held and timed as in the kernels phase.  (b) BUDDY and
             ELPH on two gloo ranks sharing cuda:0 (torch.distributed.run
             --standalone, two ranks each, hidden 64, synth-ba, 2 epochs,
             --heartbeat_dir; the runner holds the ranks' states bit-equal
             after every epoch), each against the same run at world size
             1 on the card (epoch losses rtol 1e-4), and BUDDY's ranks
             resumed from the epoch-1 checkpoint, bit-equal to the
             uninterrupted run.  (c) parallel.dryrun.dryrun_multichip(1)
             on NCCL.  Then gcn_norm's degrees of the synth-ws-200000
             train graph with non-integer weights: one K1 add a call,
             bit-equal across two calls, within the add bound of
             index_add_
  mesh_graph the graph and lane axes (parallel/node_sharded.py,
             dist_sketch.py, the trainers' graph branches): (a) world size
             1 on NCCL on a [1] graph mesh at Config defaults on
             synth-ws-200000: the locality partition at D = 1, the
             node-sharded build bit-equal in node order to the plan
             route's (ms per sharded hop beside the plan route's hop, K1
             launches per hop by op, halo rows, bytes the rank holds), the
             edge-sharded build bit-equal too; ELPH with --memory_sharded
             through runners.run (one epoch of 64 steps) within rtol 1e-4
             of train_elph's first epoch, 20 steps profiled (idle share,
             K1 adds a step); BUDDY preprocessing on the graph mesh against
             the unsharded one (rtol 1e-5, atol 1e-4); a seeded BUDDY served
             by runners/serve.py under the graph-mesh config and without
             it, scores equal; 100 undirected edges deleted and inserted on
             the position-ordered state, bit-equal to node-sharded
             rebuilds; K1 on the hop's local merges, the edge-sharded
             build's and the edge shard's PlanSpmm each way, held and
             timed.  (b) two gloo ranks on cuda:0 on a [2] graph mesh
             (synth-ba, hidden 64, 2 epochs, ELPH --memory_sharded and
             BUDDY; launched beside the dp phase's two-rank launches, an
             untimed window, and read here): the shards bit-equal to world size 1's in node order,
             epoch losses within rtol 1e-5 of world size 1's, the halo
             route printed (the all-reduce route: gloo exchanges no CUDA
             tensor), K1 on rank 0's halo merges held and timed
  scale_equality  the port's tools/scale_equality.py on the card at
             synth-ws-200000 (SE_NODES; the JAX artifact's 500,000 took
             153-231 s of the phase's 120), launched beside the dp
             phase's two-rank launches (an untimed window) and read here,
             every sharded phase on two gloo ranks sharing cuda:0: BUDDY's node-sharded preprocessing
             against one process (MinHash and HLL tables bit-equal in node
             order, 4,096 probe links' features within 1e-4, each rank
             holding exactly half), memory-sharded ELPH on a 1,2
             data,graph mesh against one process (one epoch of 16,384
             links, 16,384 links a split evaluated; epoch losses within
             1e-4, metrics within 0.01); K1 on rank 0's halo merges at that
             scale, rebuilt from the tool's partition (the merged rows
             bit-equal to rank 0's hop-1 shard), held and timed, with rank
             0's launches in the build; then tools/gen_hll_tables.py on the
             card for p = 4..10, every raw and bias array bit-equal to the
             committed sketch/_hll_tables.npz

then the per-kernel summary line (each K1, K2 and K3 entry also carries
its ``bench_hub`` time, bound and yardstick: ``hub_ms``, ``hub_bound_ms``,
``hub_library_ms``; each K1 entry its launches in the train phase,
``train_launches``; and the three K1 instances of the citation2-scale
chunk merges, their ``ms`` summed over one reduce's chunks, and the three
of the citation2_train phase's chunk merges, timed so, with that run's
launches; and the three K1 add instances of the ELPH step at W=1024,
PlanSpmm forward and backward and gather_rows' backward, each with the
add launches of the
train_elph run, which the three share, and the launches a step counted in
the profiled window; and the two K1 add instances of the ddi diffusion at
W=256, forward and backward, with the add launches of the ddi runs; each
K1 entry of the main path also its launches in the streaming and serve_ra
phases, ``streaming_launches`` and ``serve_ra_launches``, and in the
seal and kge phases, ``seal_launches`` and ``kge_launches``; and the two
K1 add instances of the SEAL step's union, at W = 1024 and W = 1, with
the add launches of the SEALDGCNN run but the label embedding's; and the
four gather_rows backward instances, SEAL's label embedding and KGE's
three, each with its own launches in its run; and the three K1 add
instances of the dp phase's meshed ELPH step, with the add launches of
its world-size-1 ELPH run; and the mesh_graph phase's K1 instances, each
with the launches of the run it came from, and the scale_equality
phase's two, with rank 0's launches in its build; and the bf16 phase's three K1
bfloat16 add instances, with the bfloat16 add launches of its ELPH and
SEALDGCNN runs; and the f16 phase's five K1 float16 add instances, with
the float16 add launches of its ELPH and SEALDGCNN runs), the
nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``.  Any failure raises: the run exits
non-zero and prints no last line.  Without a CUDA device it exits 2 at once.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
VECTOR_OPS_PER_S = 67e12       # float32 outside the tensor cores, same sheet
CSRC = "subgraph_sketching_tpu_torch/csrc"
KERNEL_LIBS = ("segscan", "gather_reduce", "block_prop", "dma_gather")
PLAN_BUILDER = "plan_build"    # csrc/plan_build.cpp: host code, built by g++
SEAL_EXTRACTOR = "seal_extract"   # csrc/seal_extract.cpp: host code, g++
# library name -> the TPU kernel it replaces (file:line of the pallas_call's
# function)
REPLACES = {"segscan": "subgraph_sketching_tpu/ops/pallas_segscan.py:103",
            "gather_reduce": "studies/pallas_gather_reduce.py:95",
            "block_prop": "studies/pallas_sketch_prop.py:134",
            "dma_gather": "studies/pallas_dma_gather_rate.py:72"}
REQUEST_SIZES = (1024, 8192, 65536, 262144)
# The BUDDY runs of the train, dp and bf16 phases train this many links an
# epoch (256 steps of the default batch 1024; the full width, cut in
# depth only, to keep the whole script inside its time limit), and the
# collab runs COLLAB_TRAIN_SAMPLES
BUDDY_TRAIN_SAMPLES = 262144
COLLAB_TRAIN_SAMPLES = 131072


START = time.perf_counter()


def emit(record: dict) -> None:
    """One JSON line; a phase's record carries the script's seconds so
    far (``elapsed_s``), the kernels line and the last line do not."""
    if "phase" in record:
        record = {**record, "elapsed_s": time.perf_counter() - START}
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


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Mean milliseconds per call of ``fn`` replayed from one CUDA graph of
    ``calls`` calls: the device's time, without the host's work per call."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm-up off the capture, as required
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (calls * replays)
    del graph
    return ms


def phase_build() -> dict:
    from subgraph_sketching_tpu_torch.ops import cuda_build
    libs = KERNEL_LIBS + (PLAN_BUILDER, SEAL_EXTRACTOR)
    t0 = time.perf_counter()
    seconds = cuda_build.load_all(libs)
    wall = time.perf_counter() - t0
    for name in libs:
        log = cuda_build.library_path(name)[:-3] + ".log"
        if os.path.exists(log):   # absent when the build was reused
            with open(log) as f:
                sys.stderr.write(f.read())
    return {"phase": "build", "seconds": seconds, "wall_s": wall,
            "libraries": {name: os.path.relpath(cuda_build.library_path(name))
                          for name in libs}}


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


def k1_record(what: str, op: str, v, x, ptr) -> dict:
    """K1 on one instance's inputs: held against its plain version on the
    card (min/max bit-equal, float32 add within ADD_TOLERANCE, bfloat16
    and float16 add, both, within ``half_add``'s bound of the float64 sum)
    and against itself
    across two calls, then timed beside it, beside one scatter_reduce call
    (a yardstick the port never calls) and beside its bound."""
    import torch

    from subgraph_sketching_tpu_torch.ops import segscan

    n, width = x.shape
    S = v.shape[0]
    got = segscan.segment_combine(v, x, op, ptr)
    again = segscan.segment_combine(v, x, op, ptr)
    want = segscan.segment_combine_plain(v, x, op, ptr)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: two calls differ")
    max_err = float((got.double() - want.double()).abs().max())
    if op == "add" and half_add(v.dtype) is not None:
        check_half_add(got, v, ptr, what)
        check_half_add(want, v, ptr, f"{what} (plain version)")
        tolerance = half_add(v.dtype)[1]
    elif op == "add":
        check_add(got, want, v, x, ptr, what)
        tolerance = ADD_TOLERANCE
    else:
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: kernel is not bit-equal to the "
                                 f"plain version")
        tolerance = "bit-equal"
    del got, again, want
    kernel_ms = cuda_ms(lambda: segscan.segment_combine(v, x, op, ptr))
    kernel_graph_ms = graph_ms(lambda: segscan.segment_combine(v, x, op,
                                                               ptr))
    plain_ms = cuda_ms(lambda: segscan.segment_combine_plain(v, x, op, ptr))
    # yardstick: one scatter_reduce computing the same function (x as the
    # initial value folds the node's own row in for min/max)
    red = {"min": "amin", "max": "amax", "add": "sum"}[op]
    base = x if op != "add" else torch.zeros_like(x)
    idx = segscan.segment_ids(ptr)[:, None].expand(-1, width)
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
    return {"op": op, "dtype": str(v.dtype).replace("torch.", ""),
            "W": width, "N": n, "S": S,
            "max_subruns_per_row": int(ptr.diff().max()),
            "max_abs_err": max_err, "tolerance": tolerance,
            "kernel_ms": kernel_ms, "graph_ms": kernel_graph_ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "library_widened_to_int32": widened,
            "bytes": bytes_moved, "combines": combines,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_kernels(shape: str, plans: dict, seed: int = 0) -> list:
    """Every K1 instance on ``plans``: checked against the plain version on
    the card, then timed beside it, one scatter_reduce call and its
    bound."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    records = []
    for name, op, dtype_name, width in INSTANCES:
        plan, w_slots = plans[op]
        n = plan.num_segments
        dtype = getattr(torch, dtype_name)
        if dtype == torch.float32:
            x = torch.randn((n, width), generator=g, device="cuda")
        else:
            lo, hi = ((0, 56) if dtype == torch.int8
                      else (torch.iinfo(dtype).min, torch.iinfo(dtype).max))
            x = torch.randint(lo, hi, (n, width), generator=g, device="cuda",
                              dtype=dtype)
        v = plan.reduce_subruns(x, op, w_slots).contiguous()
        records.append({"phase": "kernels", "shape": shape, "name": name,
                        **k1_record(f"{name} ({shape})", op, v, x,
                                    plan.sub_ptr)})
        del x, v
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
        # K3's kernel reads the real edges' src and the pointer only; K2's
        # its src, dstl and piece table
        self.edge_bytes = {
            "plan": _nbytes(plan.gather_idx, plan.sub_ptr),
            "scatter": _nbytes(src, dst),
            "K3": 4 * self.e + _nbytes(csr[2]),
            "K2": _nbytes(block.src, block.dstl, *block.pieces.tensors()),
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
    # K2 folds once a hop where a block has more than one piece
    folds = hops if r.block.pieces.num_folds else 0
    if launches != {k: folds if "_fold_" in k else hops for k in launches}:
        raise AssertionError(f"{shape}: the K2/K3 routes did not launch "
                             f"their kernels once a hop: {launches}")

    records = [{"phase": "hop_routes", "shape": shape, "nodes": n,
                "edges": r.e, "layout_s": r.layout_s, "equal_to": against,
                "launches": launches,
                "k2_pieces": r.block.pieces.num_pieces,
                "k2_folds": r.block.pieces.num_folds}]
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
                                      is_min=is_min, pieces=b.pieces),
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
            if route == "K2":
                records[-1]["fold_launches"] = launches[
                    sp._ENTRY[(op, x.dtype)][1]]
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
    torch.profiler run.  User annotations that the profiler puts on the
    device's timeline (``Optimizer.step#Adam.step``, spanning the step's
    own kernels) are left out, so no time is counted twice."""
    from torch.autograd import DeviceType
    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            slot = per.setdefault(e.name[:96], [0.0, 0])
            slot[0] += e.time_range.elapsed_us() / 1e3
            slot[1] += 1
    return sum(v[0] for v in per.values()), per


def profile_window(warm, window) -> tuple:
    """(host seconds, device busy ms, {kernel: [ms, count]}) of
    ``window()`` under torch.profiler, with K1's counts set to 0 just
    before it.  ``warm()`` runs first under the profiler's warm-up step
    (tracing on, results dropped), so CUPTI's start-up falls there and the
    window's trace holds every kernel the window launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        warm()
        torch.cuda.synchronize()
        prof.step()
        _reset_k1()
        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        prof.step()
    return (seconds, *_device_time(prof))


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


def message_graphs(splits) -> int:
    """The number of message graphs build_all_splits builds for
    ``splits``: the train graph, and each other split's unless it equals
    the train graph's (valid shares it; test adds the valid edges)."""
    import numpy as np
    g = splits["train"].graph
    return 1 + sum(
        not (s.graph.num_nodes == g.num_nodes
             and np.array_equal(s.graph.edge_index, g.edge_index)
             and np.array_equal(np.asarray(s.graph.weights),
                                np.asarray(g.weights)))
        for name, s in splits.items() if name != "train")


def phase_train(splits, seed: int = 4) -> dict:
    """BUDDY training at full width through the runner's entry point:
    ``runners.run.run`` on synth-ws-200000 at Config defaults, 2 epochs of
    BUDDY_TRAIN_SAMPLES links, eval every epoch, --check_determinism and
    --save_model, with the K1
    launch counts read around it.  Then, apart from that run: the device
    idle share over 200 steps under torch.profiler, and the saved
    checkpoint served by ``scorer_from_checkpoint``, whose scores for 65536
    random links must equal the trainer's ``predict`` within 1e-4."""
    import math

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.graph.preprocess import (
        build_all_splits, build_link_dataset,
    )
    from subgraph_sketching_tpu_torch.graph.splits import SplitData
    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.ops.cuda_build import BUILD_DIR
    from subgraph_sketching_tpu_torch.runners.run import build_trainer, run
    from subgraph_sketching_tpu_torch.serving import scorer_from_checkpoint
    from subgraph_sketching_tpu_torch.train import checkpoint
    from subgraph_sketching_tpu_torch.train.loops import make_optimizer

    ckpt = os.path.join(BUILD_DIR, "smoke_train_checkpoint")
    shutil.rmtree(ckpt, ignore_errors=True)
    cfg = Config(dataset_name="synth-ws-200000", epochs=2, eval_steps=1,
                 train_samples=BUDDY_TRAIN_SAMPLES, check_determinism=True,
                 save_model=True, checkpoint_dir=ckpt)
    for k in segscan.launches:
        segscan.launches[k] = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run(cfg, device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(segscan.launches)
    peak_memory = torch.cuda.max_memory_allocated()

    graphs = message_graphs(splits)
    need = {"segscan_min_i32": cfg.max_hash_hops * graphs,
            "segscan_max_i8": cfg.max_hash_hops * graphs,
            "segscan_add_f32": graphs}
    if any(launches[k] < v for k, v in need.items()):
        raise AssertionError(f"the training run's preprocessing did not run "
                             f"through K1 for its {graphs} message graphs: "
                             f"{launches}")
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["rep0_loss"] for r in rows]
    if len(rows) != cfg.epochs or not all(map(math.isfinite, losses)) \
            or not losses[1] < losses[0]:
        raise AssertionError(f"training losses not finite and falling: "
                             f"{losses}")
    n_links = len(splits["train"].links)
    n_used = min(BUDDY_TRAIN_SAMPLES, n_links)   # each epoch's links
    steps = math.ceil(n_used / cfg.batch_size)
    epochs = [{"epoch": i, "loss": r["rep0_loss"],
               "train_s": r["rep0_train_time"], "eval_s": r["rep0_eval_time"],
               "trained_links_per_s": n_used / r["rep0_train_time"],
               "steps_per_s": steps / r["rep0_train_time"],
               "hits@100": {"train": r["rep0_TrainHits@100"] / 100,
                            "valid": r["rep0_tmp_valHits@100"] / 100,
                            "test": r["rep0_tmp_testHits@100"] / 100}}
              for i, r in enumerate(rows)]

    # the same staged data again, the trained model and optimizer restored
    datasets = build_all_splits(splits, cfg, device="cuda")
    trainer = build_trainer(cfg, datasets, datasets["train"].x.shape[-1],
                            "cuda")
    model = trainer.init_model(0)
    opt = make_optimizer(cfg, model.parameters())
    step = checkpoint.restore_into(ckpt, model, opt)

    # device idle share over 200 steps of an epoch (after 10 warm steps)
    g = torch.Generator(device="cuda").manual_seed(seed)
    order = torch.randperm(n_links, generator=g, device="cuda")
    bs, window = cfg.batch_size, order[:200 * cfg.batch_size]
    trainer.run_epoch(model, opt, seed, order=order[:10 * bs])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        trainer.run_epoch(model, opt, seed, order=window)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t1
    busy_ms, per = _device_time(prof)
    idle = {"steps": math.ceil(len(window) / bs), "window_ms": window_s * 1e3,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / (window_s * 1e3),
            "top_kernels": sorted(([k, v[0], v[1]] for k, v in per.items()),
                                  key=lambda r: -r[1])[:8]}

    # serve what was trained: the scorer rebuilt from the run's directory
    # against the trainer's predict on 65536 random links (staged as a
    # split of the train message graph, so its features come from the
    # trainer's preprocessing path)
    model = trainer.init_model(0)
    checkpoint.restore_into(ckpt, model, step=cfg.epochs)
    rng = np.random.default_rng(seed)
    links = rng.integers(0, datasets["train"].num_nodes, (65536, 2))
    query = SplitData(splits["train"].graph, links,
                      np.zeros((0, 2), np.int64))
    trainer.stage("query", build_link_dataset(
        query, cfg, "query", reuse_from=datasets["train"], device="cuda"))
    want, _ = trainer.predict(model, "query")
    del datasets, trainer
    scorer = scorer_from_checkpoint(ckpt, device="cuda")
    got = scorer.score(links)
    shutil.rmtree(ckpt)
    if scorer.restored_step != cfg.epochs:
        raise AssertionError(f"served step {scorer.restored_step}, trained "
                             f"{cfg.epochs}")
    serve_err = float(np.abs(got - want).max())
    if not np.isfinite(got).all() or serve_err > 1e-4:
        raise AssertionError(f"served scores differ from the trainer's "
                             f"predict: max |err| {serve_err}")
    return {"phase": "train", "dataset": cfg.dataset_name,
            "hidden_channels": cfg.hidden_channels,
            "batch_size": cfg.batch_size,
            "minhash_num_perm": cfg.minhash_num_perm, "hll_p": cfg.hll_p,
            "max_hash_hops": cfg.max_hash_hops, "sign_k": cfg.sign_k,
            "lr": cfg.lr, "train_links": n_links,
            "train_samples": n_used, "steps_per_epoch": steps,
            "run_s": run_s, "preprocess_s": rows[0]["rep0_preprocess_time"],
            "epochs": epochs, "results": results,
            "determinism": "epoch 0 bit-identical on two runs",
            "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
            "peak_memory_bytes": peak_memory, "k1_launches": launches,
            "message_graphs": graphs, "restored_step": step,
            "profile": idle, "served_links": len(links),
            "served_max_abs_err": serve_err}


# biases of the Linear layers that feed a BatchNorm: their true gradient is
# zero, and Adam scales each device's rounding noise in it to steps of up
# to lr, so train_reference freezes them on both devices
PRE_BN_BIAS = r"(label_lin_layer|lin_out|sign\.lin_\d+)\.bias"


def phase_train_reference(seed: int = 5) -> dict:
    """A small BUDDY (synth-ws, hidden 32, dropout 0) trained 2 epochs from
    the same weights, on the same explicit orders, on the card and on the
    CPU, in float32 (the port's precision) and in float64, held as
    ``hold_card_to_cpu`` holds them."""
    import re

    import torch

    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.graph.datasets import get_data
    from subgraph_sketching_tpu_torch.graph.preprocess import build_all_splits
    from subgraph_sketching_tpu_torch.train.loops import (
        BuddyTrainer, epoch_seed, make_optimizer,
    )

    cfg = Config(dataset_name="synth-ws", hidden_channels=32,
                 label_dropout=0.0, feature_dropout=0.0, sign_dropout=0.0)
    splits, directed, _ = get_data(cfg)
    ds = build_all_splits(splits, cfg, directed=directed, device="cpu")
    n = ds["train"].num_links
    g = torch.Generator().manual_seed(seed)
    orders = [torch.randperm(n, generator=g) for _ in range(2)]
    runs = {}
    for dev in ("cpu", "cuda"):
        for dtype in (torch.float32, torch.float64):
            tr = BuddyTrainer(cfg, ds["train"], ds["train"].x.shape[-1],
                              device=dev)
            for data in tr._data.values():   # the staged float tensors
                data["rows"], data["x"] = (data["rows"].to(dtype),
                                           data["x"].to(dtype))
            model = tr.init_model(seed).to(dtype)
            for name, p in model.named_parameters():
                p.requires_grad_(not re.fullmatch(PRE_BN_BIAS, name))
            opt = make_optimizer(cfg, model.parameters())
            losses = torch.cat([tr.run_epoch(model, opt, epoch_seed(0, e),
                                             order=orders[e])
                                for e in range(2)])
            runs[dev, dtype] = (
                losses.double().cpu().numpy(),
                {k: v.double().cpu() for k, v in model.state_dict().items()
                 if v.is_floating_point()})
    return {"phase": "train_reference", "dataset": cfg.dataset_name,
            "hidden_channels": cfg.hidden_channels,
            **hold_card_to_cpu(runs, "train_reference"),
            "tolerance": "float64: 1e-9; float32: losses rtol 1e-4, "
                         "parameters rtol 1e-4 / atol 1e-5 or within 4x "
                         "the CPU float32 run's distance from float64; "
                         "pre-BN biases frozen"}


def hold_card_to_cpu(runs: dict, what: str) -> dict:
    """The comparison of the ``*_reference`` phases, over ``runs[device,
    dtype] = (step losses, {state entry: tensor})``, both in float64 on
    the CPU.  float64: step losses and every entry within 1e-9 (the same
    function on both devices).  float32: step losses within rtol 1e-4;
    each entry within rtol 1e-4 / atol 1e-5 of the CPU one, or, where
    float32 rounding alone moves it further (Adam scales the rounding of a
    near-zero gradient to up to lr a step), no further from the float64
    result than 4x the CPU float32 run is."""
    import numpy as np
    import torch

    f32, f64 = torch.float32, torch.float64
    np.testing.assert_allclose(runs["cuda", f64][0], runs["cpu", f64][0],
                               rtol=1e-9)
    for k, v in runs["cpu", f64][1].items():
        torch.testing.assert_close(runs["cuda", f64][1][k], v, rtol=1e-9,
                                   atol=1e-12)
    want, got = runs["cpu", f32][0], runs["cuda", f32][0]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    max_rel, beyond = 0.0, {}
    for k, exact in runs["cpu", f64][1].items():
        cpu, card = runs["cpu", f32][1][k], runs["cuda", f32][1][k]
        max_rel = max(max_rel, float(((card - cpu).abs()
                                      / (cpu.abs() + 1e-5)).max()))
        if bool(((card - cpu).abs() <= 1e-5 + 1e-4 * cpu.abs()).all()):
            continue
        card_err = float((card - exact).abs().max())
        cpu_err = float((cpu - exact).abs().max())
        beyond[k] = {"card_vs_cpu": float((card - cpu).abs().max()),
                     "card_vs_float64": card_err,
                     "cpu_vs_float64": cpu_err}
        if card_err > 4 * cpu_err:
            raise AssertionError(f"{what}: {k} on the card is {card_err} "
                                 f"from the float64 result, the CPU "
                                 f"float32 run {cpu_err}")
    return {"steps": len(want),
            "max_loss_rel_diff": float(np.abs(got / want - 1).max()),
            "max_param_rel_diff": max_rel,
            "beyond_rtol_1e-4_atol_1e-5": beyond,
            "float64_max_param_diff": max(
                float((runs["cuda", f64][1][k] - v).abs().max())
                for k, v in runs["cpu", f64][1].items())}


# ----------------------------------------------------------------- ELPH --

SPMM_WIDTH = 1024   # Config's hidden_channels: the GCN's SpMM width


def _abs_spmm(edge_index, weight, x, n: int):
    """sum over edges of |w| |x[src]| at the destinations: the scale of an
    SpMM's float32 rounding, as ADD_TOLERANCE takes it."""
    from subgraph_sketching_tpu_torch.ops.graph_ops import spmm
    return spmm(edge_index, weight.abs(), x.abs(), n)


def phase_plan_spmm(g, cfg, seed: int = 8) -> tuple:
    """ELPH's differentiable SpMM at full width: ``PlanSpmm`` over the
    gcn_norm'd synth-ws-200000 train graph at W = 1024 float32.  Forward
    and x-gradient each against the plain merge of the same sub-run
    results on the card and against autograd through the scatter
    ``spmm`` (within ADD_TOLERANCE), with exactly one K1 add launch each
    way; then K1 on each direction's sub-run results timed as the kernels
    phase times it, and the whole SpMM timed by each route (forward, and
    forward with backward).  Returns ({direction: K1 record}, record)."""
    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.ops.graph_ops import gcn_norm, spmm
    from subgraph_sketching_tpu_torch.ops.segment_scan import PlanSpmm

    n = g.num_nodes
    ei = torch.from_numpy(g.edge_index.astype(np.int64)).to("cuda")
    ew = torch.from_numpy(np.asarray(g.weights, np.float32)).to("cuda")
    nei, nw = gcn_norm(ei, ew, n)
    t0 = time.perf_counter()
    ps = PlanSpmm.try_build(nei.cpu().numpy(), nw.cpu().numpy(), n,
                            max_slots=cfg.max_gather_slots, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if ps is None:
        raise AssertionError("PlanSpmm.try_build refused the train graph")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, SPMM_WIDTH), generator=gen, device="cuda",
                    requires_grad=True)
    cot = torch.randn((n, SPMM_WIDTH), generator=gen, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    _reset_k1()
    out = ps(x)
    torch.cuda.synchronize()
    fwd_launches = segscan.launches["segscan_add_f32"]
    (grad,) = torch.autograd.grad(out, x, grad_outputs=cot)
    torch.cuda.synchronize()
    bwd_launches = segscan.launches["segscan_add_f32"] - fwd_launches
    peak = torch.cuda.max_memory_allocated()
    if (fwd_launches, bwd_launches) != (1, 1) \
            or sum(segscan.launches.values()) != 2:
        raise AssertionError(f"PlanSpmm: K1 launches {segscan.launches}, "
                             f"expected one add each way")
    x = x.detach()
    # against autograd through the scatter route
    xs = x.clone().requires_grad_()
    ref = spmm(nei, nw, xs, n)
    (ref_grad,) = torch.autograd.grad(ref, xs, grad_outputs=cot)
    ref = ref.detach()
    with torch.no_grad():
        errs = {}
        for what, got, want, scale in (
                ("forward", out, ref, _abs_spmm(nei, nw, x, n)),
                ("backward", grad, ref_grad,
                 _abs_spmm(nei.flip(0), nw, cot, n))):
            err = (got - want).abs()
            errs[what] = float(err.max())
            if bool((err > 1e-4 * scale + 1e-6).any()):
                raise AssertionError(f"PlanSpmm {what} disagrees with the "
                                     f"scatter spmm: max |err| {errs[what]}")
        del ref, ref_grad, xs
        # K1 of each direction against its plain version, then timed
        k1 = {}
        for what, plan, w, inp, got in (("forward", ps.fwd, ps._w_fwd, x, out),
                                        ("backward", ps.bwd, ps._w_bwd, cot,
                                         grad)):
            v = plan.reduce_subruns(inp, "add", w).contiguous()
            want = segscan.segment_combine_plain(v, inp, "add", plan.sub_ptr)
            check_add(got, want, v, inp, plan.sub_ptr,
                      f"PlanSpmm {what} against the plain merge")
            del want
            k1[what] = {
                "phase": "plan_spmm", "direction": what,
                "name": f"segscan_add_f32 (PlanSpmm {what}, "
                        f"W={SPMM_WIDTH})",
                **k1_record(f"PlanSpmm {what}", "add", v, inp, plan.sub_ptr)}
            del v
        del out, grad

    def plan_step():
        xr = x.requires_grad_()
        torch.autograd.grad(ps(xr), xr, grad_outputs=cot)

    def scatter_step():
        xr = x.requires_grad_()
        torch.autograd.grad(spmm(nei, nw, xr, n), xr, grad_outputs=cot)

    with torch.no_grad():
        plan_fwd_ms = cuda_ms(lambda: ps(x), iters=5, warmup=1)
        scatter_fwd_ms = cuda_ms(lambda: spmm(nei, nw, x, n), iters=5,
                                 warmup=1)
    plan_step_ms = cuda_ms(plan_step, iters=5, warmup=1)
    scatter_step_ms = cuda_ms(scatter_step, iters=5, warmup=1)
    x.requires_grad_(False)
    return k1, {
        "phase": "plan_spmm", "dataset": cfg.dataset_name, "nodes": n,
        "normed_edges": int(nei.shape[1]), "W": SPMM_WIDTH,
        "subruns": {"forward": ps.fwd.num_subruns,
                    "backward": ps.bwd.num_subruns},
        "try_build_s": build_s, "k1_launches": {"forward": fwd_launches,
                                                "backward": bwd_launches},
        "max_abs_err_vs_scatter": errs,
        "tolerance": ADD_TOLERANCE + " (sum |w| |x| for the routes)",
        "peak_memory_bytes_forward_backward": peak,
        "plan_forward_ms": plan_fwd_ms, "scatter_forward_ms": scatter_fwd_ms,
        "plan_forward_backward_ms": plan_step_ms,
        "scatter_forward_backward_ms": scatter_step_ms,
        "k1": {k: {f: r[f] for f in ("kernel_ms", "graph_ms", "bound_ms",
                                     "plain_ms", "library_ms")}
               for k, r in k1.items()}}


# 64 steps of the default batch 1024 (131,072 until the scale_equality
# phase came: depth cut for the script's time limit)
ELPH_TRAIN_SAMPLES = 65536
ELPH_PROFILE_STEPS = 20


def phase_train_elph(splits, seed: int = 9) -> dict:
    """ELPH training at full width through the runner's entry point:
    ``runners.run.run`` with --model ELPH on synth-ws-200000 at Config
    defaults (the reference's Cora ELPH command: hidden 1024, batch 1024,
    feature_prop gcn, 2 hops, dropouts 0.5), 2 epochs of
    ELPH_TRAIN_SAMPLES links, eval every epoch, --check_determinism and
    --save_model, with the K1 launch counts read around it: at least
    2 * convolutions + 1 add launches a step (each convolution's PlanSpmm
    forward and backward, and gather_rows' backward), besides the
    staging's min/max; the same trainer rebuilt must stage a plan.  Then,
    apart from that run: gather_rows' backward at the run's shape (the
    trained [N, hidden] features, one batch of links), one K1 add launch,
    against the plain merge and indexing's backward, and timed; the device
    idle share and top kernels over ELPH_PROFILE_STEPS steps under
    torch.profiler, where K1's add runs exactly 2 * convolutions + 1 times
    a step by the counter and by the trace; a step by the scatter SpMM (a
    --use_plan false trainer, run twice from one init: bit-identical)
    beside a step by the plan; and the saved checkpoint served by
    ``scorer_from_checkpoint``, whose scores for 65536 random links must
    equal the trainer's ``predict`` within 1e-4.  Returns (the gather_rows
    K1 record, the phase record)."""
    import dataclasses
    import math

    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.graph.preprocess import (
        build_all_splits, build_link_dataset,
    )
    from subgraph_sketching_tpu_torch.graph.splits import SplitData
    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.ops.cuda_build import BUILD_DIR
    from subgraph_sketching_tpu_torch.ops.segment_scan import (
        gather_rows, segment_order,
    )
    from subgraph_sketching_tpu_torch.runners.run import build_trainer, run
    from subgraph_sketching_tpu_torch.serving import scorer_from_checkpoint
    from subgraph_sketching_tpu_torch.train import checkpoint
    from subgraph_sketching_tpu_torch.train.loops import (
        ElphTrainer, make_optimizer,
    )

    ckpt = os.path.join(BUILD_DIR, "smoke_elph_checkpoint")
    shutil.rmtree(ckpt, ignore_errors=True)
    cfg = Config(dataset_name="synth-ws-200000", model="ELPH", epochs=2,
                 eval_steps=1, train_samples=ELPH_TRAIN_SAMPLES,
                 check_determinism=True, save_model=True,
                 checkpoint_dir=ckpt)
    _reset_k1()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run(cfg, device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(segscan.launches)
    peak_memory = torch.cuda.max_memory_allocated()

    steps = math.ceil(ELPH_TRAIN_SAMPLES / cfg.batch_size)
    trained_steps = steps * (cfg.epochs + 2)   # + the determinism check's 2
    graphs = message_graphs(splits)
    convs = cfg.max_hash_hops
    adds_per_step = 2 * convs + 1   # PlanSpmm each way, gather_rows' backward
    if launches["segscan_add_f32"] < adds_per_step * trained_steps \
            or launches["segscan_min_i32"] < convs * graphs \
            or launches["segscan_max_i8"] < convs * graphs:
        raise AssertionError(f"the ELPH run's K1 launches fall short: "
                             f"{launches}, {trained_steps} steps, {graphs} "
                             f"graphs")
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["rep0_loss"] for r in rows]
    if len(rows) != cfg.epochs or not all(map(math.isfinite, losses)) \
            or not losses[1] < losses[0]:
        raise AssertionError(f"ELPH losses not finite and falling: {losses}")
    epochs = [{"epoch": i, "loss": r["rep0_loss"],
               "train_s": r["rep0_train_time"], "eval_s": r["rep0_eval_time"],
               "trained_links_per_s": ELPH_TRAIN_SAMPLES
               / r["rep0_train_time"],
               "steps_per_s": steps / r["rep0_train_time"],
               "hits@100": {"train": r["rep0_TrainHits@100"] / 100,
                            "valid": r["rep0_tmp_valHits@100"] / 100,
                            "test": r["rep0_tmp_testHits@100"] / 100}}
              for i, r in enumerate(rows)]

    # the same staged data again, the trained model and optimizer restored
    datasets = build_all_splits(splits, cfg, device="cuda")
    width = datasets["train"].x.shape[-1]
    trainer = build_trainer(cfg, datasets, width, "cuda")
    if "plan" not in trainer._data["train"]:
        raise AssertionError("the run's trainer staged no PlanSpmm")
    model = trainer.init_model(0)
    opt = make_optimizer(cfg, model.parameters())
    checkpoint.restore_into(ckpt, model, opt)
    n_links = trainer.num_links("train")
    g = torch.Generator(device="cuda").manual_seed(seed)
    order = torch.randperm(n_links, generator=g, device="cuda")
    bs = cfg.batch_size

    # gather_rows' backward at the run's shape: one batch's [bs, 2] rows of
    # the trained [N, hidden] features; one K1 add launch, the same on two
    # runs, against the plain merge of the same rows and indexing's
    # backward, then K1 timed as the kernels phase times it
    model.eval()
    with torch.no_grad():
        table = trainer.node_features(model, trainer._data["train"])
    table.requires_grad_()
    idx = trainer._data["train"]["links"][order[:bs]]
    cot = torch.randn((bs, 2, table.shape[1]), generator=g, device="cuda")

    def gather_backward():
        return torch.autograd.grad(gather_rows(table, idx), table,
                                   grad_outputs=cot)[0]

    _reset_k1()
    got = gather_backward()
    torch.cuda.synchronize()
    if segscan.launches["segscan_add_f32"] != 1 \
            or sum(segscan.launches.values()) != 1:
        raise AssertionError(f"gather_rows backward: K1 launches "
                             f"{segscan.launches}, expected one add")
    if not torch.equal(got, gather_backward()):
        raise AssertionError("gather_rows backward: two runs differ")
    (want,) = torch.autograd.grad(table[idx], table, grad_outputs=cot)
    with torch.no_grad():
        perm, ptr = segment_order(idx.reshape(-1), table.shape[0])
        v = cot.reshape(-1, table.shape[1]).index_select(0, perm)
        x = table.detach()
        check_add(got, segscan.segment_combine_plain(v, x, "add", ptr), v,
                  x, ptr, "gather_rows backward against the plain merge")
        check_add(got, want, v, x, ptr,
                  "gather_rows backward against indexing's backward")
        gather_err = float((got - want).abs().max())
        del got, want
        gather_k1 = {
            "phase": "train_elph",
            "name": f"segscan_add_f32 (gather_rows backward, "
                    f"W={table.shape[1]})",
            "links": [bs, 2],
            **k1_record("gather_rows backward", "add", v, x, ptr)}
        del v, x
    gather_k1.update(
        backward_ms=cuda_ms(gather_backward, iters=5, warmup=1),
        index_backward_ms=cuda_ms(lambda: torch.autograd.grad(
            table[idx], table, grad_outputs=cot)[0], iters=5, warmup=1),
        max_abs_err_vs_index_backward=gather_err)
    del table, cot
    model.train()

    # device idle share over ELPH_PROFILE_STEPS steps (after 3 warm
    # steps), with K1's add launches counted by the wrapper and in the trace
    window_s, busy_ms, per = profile_window(
        lambda: trainer.run_epoch(model, opt, seed, order=order[:3 * bs]),
        lambda: trainer.run_epoch(model, opt, seed,
                                  order=order[:ELPH_PROFILE_STEPS * bs]))
    window_adds = segscan.launches["segscan_add_f32"]
    traced_adds = sum(c for k, (_, c) in per.items()
                      if "segscan_kernel" in k)
    if window_adds != adds_per_step * ELPH_PROFILE_STEPS \
            or traced_adds != window_adds:
        raise AssertionError(
            f"{ELPH_PROFILE_STEPS} ELPH steps: {window_adds} K1 add launches "
            f"counted, {traced_adds} traced, expected {adds_per_step} a step")
    idle = {"steps": ELPH_PROFILE_STEPS, "window_ms": window_s * 1e3,
            "k1_add_launches": window_adds,
            "k1_add_kernels_traced": traced_adds,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / (window_s * 1e3),
            "top_kernels": sorted(([k, v[0], v[1]] for k, v in per.items()),
                                  key=lambda r: -r[1])[:10]}

    # a step by the plan and by the scatter SpMM (--use_plan false), each
    # timed over 5 steps after 2 warm ones on the same links; the scatter
    # trainer skips the sketches (zero structure features: the same work a
    # step) and runs twice from one init, bit for bit
    def step_ms(tr, m) -> float:
        o = torch.optim.Adam(m.parameters(), lr=cfg.lr)
        tr.run_epoch(m, o, seed, order=order[:2 * bs])
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.run_epoch(m, o, seed, order=order[2 * bs:7 * bs])
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / 5

    plan_step_ms = step_ms(trainer, trainer.init_model(1))
    scatter_cfg = dataclasses.replace(cfg, use_plan=False,
                                      use_struct_feature=False)
    scatter = ElphTrainer(scatter_cfg, datasets["train"], width,
                          device="cuda")
    if "plan" in scatter._data["train"]:
        raise AssertionError("the --use_plan false trainer staged a plan")
    runs = [scatter.init_model(1) for _ in range(2)]
    scatter_step_ms = step_ms(scatter, runs[0])
    step_ms(scatter, runs[1])
    if not all(torch.equal(a, b) for a, b in zip(
            runs[0].state_dict().values(), runs[1].state_dict().values())):
        raise AssertionError("the scatter SpMM route trained two runs from "
                             "one init apart")
    del scatter, runs

    # serve what was trained: the scorer rebuilt from the run's directory
    # against the trainer's predict on 65536 random links (staged as a
    # split of the train message graph)
    model = trainer.init_model(0)
    checkpoint.restore_into(ckpt, model, step=cfg.epochs)
    links = np.random.default_rng(seed).integers(
        0, datasets["train"].num_nodes, (65536, 2))
    query = SplitData(splits["train"].graph, links,
                      np.zeros((0, 2), np.int64))
    trainer.stage("query", build_link_dataset(
        query, cfg, "query", reuse_from=datasets["train"], device="cuda"))
    want, _ = trainer.predict(model, "query")
    del datasets, trainer, model, opt
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    scorer = scorer_from_checkpoint(ckpt, device="cuda")
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t1
    got = scorer.score(links)
    shutil.rmtree(ckpt)
    if scorer.restored_step != cfg.epochs:
        raise AssertionError(f"served step {scorer.restored_step}, trained "
                             f"{cfg.epochs}")
    serve_err = float(np.abs(got - want).max())
    if not np.isfinite(got).all() or serve_err > 1e-4:
        raise AssertionError(f"served ELPH scores differ from the trainer's "
                             f"predict: max |err| {serve_err}")
    del scorer
    return gather_k1, {"phase": "train_elph", "dataset": cfg.dataset_name,
            "model": cfg.model, "hidden_channels": cfg.hidden_channels,
            "batch_size": cfg.batch_size, "feature_prop": cfg.feature_prop,
            "max_hash_hops": cfg.max_hash_hops, "lr": cfg.lr,
            "dropouts": [cfg.label_dropout, cfg.feature_dropout],
            "train_links": n_links, "train_samples": ELPH_TRAIN_SAMPLES,
            "steps_per_epoch": steps, "trained_steps": trained_steps,
            "run_s": run_s, "preprocess_s": rows[0]["rep0_preprocess_time"],
            "get_data_s": rows[0]["rep0_get_data_time"],
            "epochs": epochs, "results": results,
            "determinism": "epoch 0 bit-identical on two runs",
            "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
            "peak_memory_bytes": peak_memory, "k1_launches": launches,
            "k1_add_launches_per_step": launches["segscan_add_f32"]
            / trained_steps,
            "k1_add_launches_per_step_expected": adds_per_step,
            "message_graphs": graphs,
            "profile": idle, "plan_step_ms": plan_step_ms,
            "scatter_step_ms": scatter_step_ms,
            "scatter_route_deterministic": "7 steps twice from one init, "
                                           "parameters bit-identical", "serve_rebuild_s": rebuild_s,
            "served_links": len(links), "served_max_abs_err": serve_err}


# biases of the Linear layers that feed a BatchNorm in ELPH's head
ELPH_PRE_BN_BIAS = r"predictor\.(label_lin_layer|lin_out)\.bias"


def phase_elph_reference(seed: int = 10) -> dict:
    """A small ELPH (synth-ws, hidden 32, dropout 0, the pre-BN biases
    frozen) trained 2 epochs from the same weights, on the same explicit
    orders, on the card (PlanSpmm and gather_rows on K1) and on the CPU
    (their plain versions), in float32 and in float64 (K1's float64 add).
    Each trainer builds its own sketches and subgraph features; the
    integer sketches must be bit-equal and the features within rtol 1e-5
    / atol 1e-4, and the runs then train on the CPU's features.  float64:
    step losses and parameters within 1e-9; float32: as train_reference
    holds it."""
    import re

    import torch

    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.graph.datasets import get_data
    from subgraph_sketching_tpu_torch.graph.preprocess import build_all_splits
    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.train.loops import (
        ElphTrainer, epoch_seed, make_optimizer,
    )

    cfg = Config(dataset_name="synth-ws", model="ELPH", hidden_channels=32,
                 label_dropout=0.0, feature_dropout=0.0)
    splits, directed, _ = get_data(cfg)
    ds = build_all_splits(splits, cfg, directed=directed, device="cpu")
    width = ds["train"].x.shape[-1]
    n = ds["train"].num_links
    g = torch.Generator().manual_seed(seed)
    orders = [torch.randperm(n, generator=g) for _ in range(2)]
    trainers = {dev: ElphTrainer(cfg, ds["train"], width, device=dev)
                for dev in ("cpu", "cuda")}
    sk_cpu, sk_card = (trainers[d]._sk_graph[2] for d in ("cpu", "cuda"))
    for a, b in zip(sk_card[:2], sk_cpu[:2]):
        if not torch.equal(a.cpu(), b):
            raise AssertionError("ELPH sketches on the card differ from the "
                                 "CPU's")
    sf_cpu = trainers["cpu"]._data["train"]["sf"]
    sf_card = trainers["cuda"]._data["train"]["sf"]
    torch.testing.assert_close(sf_card.cpu(), sf_cpu, rtol=1e-5, atol=1e-4)
    trainers["cuda"]._data["train"]["sf"] = sf_cpu.to("cuda")
    runs = {}
    _reset_k1()
    for dev, tr in trainers.items():
        base = dict(tr._data["train"])
        for dtype in (torch.float32, torch.float64):
            tr._data["train"] = {k: (v.to(dtype) if k in ("x", "sf",
                                                           "labels") else v)
                                 for k, v in base.items()}
            model = tr.init_model(seed).to(dtype)
            for name, p in model.named_parameters():
                p.requires_grad_(not re.fullmatch(ELPH_PRE_BN_BIAS, name))
            opt = make_optimizer(cfg, model.parameters())
            losses = torch.cat([tr.run_epoch(model, opt, epoch_seed(0, e),
                                             order=orders[e])
                                for e in range(2)])
            runs[dev, dtype] = (
                losses.double().cpu().numpy(),
                {k: v.double().cpu() for k, v in model.state_dict().items()
                 if v.is_floating_point()})
        tr._data["train"] = base
    launches = dict(segscan.launches)
    steps = sum(-(-len(o) // cfg.batch_size) for o in orders)
    if launches["segscan_add_f32"] < 4 * steps \
            or launches["segscan_add_f64"] < 4 * steps:
        raise AssertionError(f"elph_reference: the card's runs did not go "
                             f"through K1: {launches}")
    return {"phase": "elph_reference", "dataset": cfg.dataset_name,
            "hidden_channels": cfg.hidden_channels,
            "k1_launches": launches,
            "max_sf_abs_diff": float((sf_card.cpu() - sf_cpu).abs().max()),
            **hold_card_to_cpu(runs, "elph_reference"),
            "tolerance": "sketches bit-equal, sf rtol 1e-5 / atol 1e-4; "
                         "float64: 1e-9; float32: losses rtol 1e-4, "
                         "parameters rtol 1e-4 / atol 1e-5 or within 4x "
                         "the CPU float32 run's distance from float64; "
                         "pre-BN biases frozen"}


# ------------------------------------------------------------- datasets --

# ogbl-collab at its published shape (ogb/linkproppred/master.csv and the
# OGB paper's dataset table): nodes, feature width, train edges stored one
# direction, valid and test edges, each with 100,000 negatives
COLLAB = {"nodes": 235_868, "features": 128, "train": 1_179_052,
          "valid": 60_084, "test": 46_329, "negatives": 100_000}
# the reference README's collab BUDDY command (tests/test_cli.py), cut to
# one epoch below
COLLAB_COMMAND = ("--dataset_name ogbl-collab --K 50 --lr 0.02 "
                  "--feature_dropout 0.05 --add_normed_features 1 "
                  "--cache_subgraph_features --label_dropout 0.1 "
                  "--year 2007 --model BUDDY")
# ogbl-citation2's published counts: nodes and (directed) edges
CITATION2 = {"nodes": 2_927_963, "edges": 30_387_995, "features": 128}


def _write_csv_gz(path: str, arr, fmt: str) -> None:
    """A headerless comma-separated ``.csv.gz``, as the ogb package stores
    its raw files: gzip level 1, each block of rows formatted by one ``%``
    over the block's values."""
    import gzip

    import numpy as np
    arr = np.asarray(arr)
    if arr.ndim == 1:
        arr = arr[:, None]
    line = ",".join([fmt] * arr.shape[1]) + "\n"
    with gzip.open(path, "wt", compresslevel=1) as f:
        for s in range(0, len(arr), 1 << 14):
            block = arr[s:s + (1 << 14)]
            f.write((line * len(block)) % tuple(block.ravel().tolist()))


def _power_law_nodes(rng, n: int, size: int, exponent: float):
    """``size`` node ids, the node of rank r drawn with probability
    proportional to r^-exponent (ranks a random permutation of the
    nodes)."""
    import numpy as np
    cdf = np.cumsum(np.arange(1, n + 1, dtype=np.float64) ** -exponent)
    cdf /= cdf[-1]
    ranks = np.minimum(np.searchsorted(cdf, rng.random(size)), n - 1)
    return rng.permutation(n).astype(np.int32)[ranks]


def write_collab(root: str, seed: int = 6) -> None:
    """An ``ogbl_collab`` raw-layout tree at the published shape, from a
    seed, in the layout of tests/ogb_fixture.py: co-authorship edges with
    power-law endpoints, weights (mostly 1) and years 1963-2017 (skewed
    recent), float node features, and the time split's .pt files."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n = COLLAB["nodes"]
    base = os.path.join(root, "ogbl_collab")
    raw, split = os.path.join(base, "raw"), os.path.join(base, "split", "time")
    os.makedirs(raw)
    os.makedirs(split)

    def edges(k):
        src = _power_law_nodes(rng, n, k, 0.5)
        dst = _power_law_nodes(rng, n, k, 0.5)
        dst = np.where(dst == src, (dst + 1) % n, dst)
        return np.stack([src, dst], axis=1).astype(np.int64)

    train = edges(COLLAB["train"])
    weight = rng.geometric(0.7, len(train)).astype(np.int64)
    year = 2017 - np.minimum(54, rng.exponential(8.0, len(train))).astype(
        np.int64)
    feat = (2 * rng.random((n, COLLAB["features"]), dtype=np.float32) - 1)
    _write_csv_gz(os.path.join(raw, "edge.csv.gz"), train, "%d")
    _write_csv_gz(os.path.join(raw, "num-node-list.csv.gz"), [n], "%d")
    _write_csv_gz(os.path.join(raw, "edge_weight.csv.gz"), weight, "%d")
    _write_csv_gz(os.path.join(raw, "edge_year.csv.gz"), year, "%d")
    _write_csv_gz(os.path.join(raw, "node-feat.csv.gz"), feat, "%.7g")
    torch.save({"edge": torch.from_numpy(train),
                "weight": torch.from_numpy(weight),
                "year": torch.from_numpy(year)},
               os.path.join(split, "train.pt"))
    for name, y in (("valid", 2018), ("test", 2019)):
        e = edges(COLLAB[name])
        torch.save({"edge": torch.from_numpy(e),
                    "weight": torch.from_numpy(
                        rng.geometric(0.7, len(e)).astype(np.int64)),
                    "year": torch.full((len(e),), y, dtype=torch.int64),
                    "edge_neg": torch.from_numpy(edges(COLLAB["negatives"]))},
                   os.path.join(split, f"{name}.pt"))


def phase_datasets_collab(root: str) -> dict:
    """(a) ogbl-collab at its published shape through the runner: the tree
    written under ``root`` (which the caller removes), then the
    reference's collab BUDDY command, cut to one epoch of
    COLLAB_TRAIN_SAMPLES links, run twice with one
    --cache_dir.  The second run reads the caches (the train negatives and
    every split's subgraph features: no sketch is built, so no min/max K1
    launch), and its subgraph features, SIGN features and epoch-0 loss
    equal the first run's."""
    import shlex

    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.runners import run as runner

    t0 = time.perf_counter()
    write_collab(root)
    write_s = time.perf_counter() - t0
    built = []   # each run's datasets, seen through the runner's call
    build_all_splits = runner.build_all_splits

    def keep(*args, **kwargs):
        built.append(build_all_splits(*args, **kwargs))
        return built[-1]

    runs = []
    runner.build_all_splits = keep
    try:
        for i in range(2):
            ckpt = os.path.join(root, f"run{i}")
            for k in segscan.launches:
                segscan.launches[k] = 0
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = runner.main(shlex.split(COLLAB_COMMAND) + [
                "--epochs", "1", "--train_samples",
                str(COLLAB_TRAIN_SAMPLES), "--device", "cuda",
                "--data_root", root,
                "--cache_dir", os.path.join(root, "cache"),
                "--checkpoint_dir", ckpt])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            with open(os.path.join(ckpt, "metrics.jsonl")) as f:
                (row,) = [json.loads(line) for line in f]
            runs.append({
                "run_s": run_s, "get_data_s": row["rep0_get_data_time"],
                "preprocess_s": row["rep0_preprocess_time"],
                "epoch_s": row["rep0_train_time"],
                "eval_s": row["rep0_eval_time"], "loss": row["rep0_loss"],
                "hits@50": {"train": row["rep0_TrainHits@50"] / 100,
                            "valid": row["rep0_tmp_valHits@50"] / 100,
                            "test": row["rep0_tmp_testHits@50"] / 100},
                "results": results,
                "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                "k1_launches": dict(segscan.launches)})
    finally:
        runner.build_all_splits = build_all_splits
    first, second = built
    for split in first:
        for what in ("subgraph_features", "x"):
            if not np.array_equal(getattr(first[split], what),
                                  getattr(second[split], what)):
                raise AssertionError(f"collab: the second run's {what} "
                                     f"({split}) differ from the first's")
    if runs[1]["loss"] != runs[0]["loss"]:
        raise AssertionError(f"collab: epoch-0 loss {runs[1]['loss']} "
                             f"on the cached run, {runs[0]['loss']} "
                             f"before")
    l0, l1 = runs[0]["k1_launches"], runs[1]["k1_launches"]
    if l0["segscan_min_i32"] < 4 or l0["segscan_max_i8"] < 4 \
            or l0["segscan_add_f32"] < 2:
        raise AssertionError(f"collab: the first run did not build its "
                             f"two message graphs through K1: {l0}")
    if l1["segscan_min_i32"] or l1["segscan_max_i8"]:
        raise AssertionError(f"collab: the second run built sketches "
                             f"despite the caches: {l1}")
    cached = sorted(os.listdir(os.path.join(root, "cache")))
    if sum(f.endswith("subgraph_features.npz") for f in cached) != 3 \
            or not any("negative_samples" in f for f in cached):
        raise AssertionError(f"collab: caches missing: {cached}")
    train = first["train"]
    return {"phase": "datasets", "part": "collab",
            "dataset": "ogbl-collab", "shape": COLLAB,
            "command": COLLAB_COMMAND + " --epochs 1 --train_samples "
                       + str(COLLAB_TRAIN_SAMPLES),
            "write_s": write_s, "nodes": train.num_nodes,
            "train_message_edges": int(train.edge_index.shape[1]),
            "train_links": int(train.num_links),
            "links": {k: int(d.num_links) for k, d in first.items()},
            "runs": runs, "cached_files": cached,
            "second_run_equal": ["subgraph_features", "x",
                                 "epoch-0 loss"]}


def _reset_k1() -> None:
    from subgraph_sketching_tpu_torch.ops import segscan
    for k in segscan.launches:
        segscan.launches[k] = 0


def phase_datasets_chunked(plans: dict, max_slots: int = 1 << 18) -> dict:
    """(b) The chunk-streamed plan against the one-shot plan on the
    synth-ws-200000 train message graph, at a ``max_slots`` that forces
    several chunks: 2 hops of MinHash and HLL bit-equal, one SIGN add
    within the add bound, and K1 launched once per chunk of every
    reduce."""
    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.graph.preprocess import (
        sketch_params_from_config,
    )
    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.ops.graph_ops import gcn_norm
    from subgraph_sketching_tpu_torch.ops.segment_scan import (
        ChunkedSegmentPlan, make_auto_plan,
    )
    from subgraph_sketching_tpu_torch.sketch.elph import initialise_sketches

    g = plans["graph"]
    n = g.num_nodes
    one = plans["min"][0]
    chunked = make_auto_plan(g.edge_index, n, max_slots=max_slots,
                             device="cuda")
    ei = torch.from_numpy(g.edge_index.astype(np.int64)).to("cuda")
    nei, nw = gcn_norm(ei, None, n)
    sign_chunked = make_auto_plan(nei.cpu().numpy(), n, max_slots=max_slots,
                                  device="cuda")
    if not (isinstance(chunked, ChunkedSegmentPlan)
            and isinstance(sign_chunked, ChunkedSegmentPlan)):
        raise AssertionError("synth-ws-200000 at max_slots 2^18 did not "
                             "take the chunked plan")
    params = sketch_params_from_config(Config(dataset_name="synth-ws-200000"))
    rows = initialise_sketches(n, params, "cuda")
    reduces = []

    def counted(plan, x, op, w=None):
        _reset_k1()
        out = plan.reduce(x, op, edge_data_slots=w)
        torch.cuda.synchronize()
        launches = sum(segscan.launches.values())
        if launches < plan.num_chunks:
            raise AssertionError(f"chunked {op}: {launches} K1 launches for "
                                 f"{plan.num_chunks} chunks")
        reduces.append({"op": op, "chunks": plan.num_chunks,
                        "k1_launches": launches})
        return out

    for hop in range(1, 3):
        nxt = tuple(counted(chunked, x, op)
                    for x, op in zip(rows, ("min", "max")))
        for got, x, (what, op) in zip(nxt, rows, SKETCHES):
            if not torch.equal(got, one.reduce(x, op)):
                raise AssertionError(f"chunked {what} hop {hop} differs from "
                                     f"the one-shot plan")
        rows = nxt
    sign_one, w_one = plans["add"]
    x0 = torch.from_numpy(np.asarray(g.x, dtype=np.float32)).to("cuda")
    got = counted(sign_chunked, x0, "add", sign_chunked.stage_edge_data(nw))
    v = sign_one.reduce_subruns(x0, "add", w_one).contiguous()
    want = segscan.segment_combine_plain(v, x0, "add", sign_one.sub_ptr)
    check_add(got, want, v, x0, sign_one.sub_ptr, "chunked SIGN add")
    return {"phase": "datasets", "part": "chunked_synth_ws",
            "dataset": "synth-ws-200000", "nodes": n,
            "edges": int(g.num_edges), "max_slots": max_slots,
            "sub_len": chunked.sub_len, "chunks": chunked.num_chunks,
            "sign_chunks": sign_chunked.num_chunks,
            "window_rows": chunked.window, "reduces": reduces,
            "add_max_abs_err": float((got - want).abs().max()),
            "tolerance": f"min/max bit-equal to the one-shot plan; add "
                         f"{ADD_TOLERANCE}"}


def citation2_graph(seed: int = 7):
    """A directed graph with ogbl-citation2's published counts, from a
    seed: power-law in-degrees (hubs of thousands of citations), uniform
    citing nodes, no self-loops."""
    import numpy as np

    from subgraph_sketching_tpu_torch.graph.container import Graph
    rng = np.random.default_rng(seed)
    n, e = CITATION2["nodes"], CITATION2["edges"]
    dst = _power_law_nodes(rng, n, e, 0.5)
    src = rng.integers(0, n - 1, e, dtype=np.int32)
    src += (src >= dst).astype(np.int32)
    return Graph(np.stack([src, dst]), n), int(np.bincount(dst).max())


def _chunk_instance(plan, x, op: str, w=None) -> dict:
    """One K1 instance over every chunk of one reduce: each chunk's merge
    (its sub-runs into its window of ``x``) timed by K1, by its plain
    version and by one scatter_reduce over the window, summed over the
    chunks, with the bound of the bytes the merges move."""
    import torch

    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.ops.segment_scan import (
        with_identity_row,
    )
    red = {"min": "amin", "max": "amax", "add": "sum"}[op]
    rows = with_identity_row(x, op)
    width, b = x.shape[1], x.element_size()
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    nbytes = combines = 0
    for c, ((s0, s1, lo, hi), ptr) in enumerate(zip(plan.bounds, plan.ptrs)):
        v = plan.chunk_subruns(rows, c, op, w)
        win = x[lo:hi]
        total["ms"] += cuda_ms(lambda: segscan.segment_combine(v, win, op,
                                                               ptr),
                               iters=5, warmup=1)
        total["plain_ms"] += cuda_ms(
            lambda: segscan.segment_combine_plain(v, win, op, ptr),
            iters=5, warmup=1)
        base = win if op != "add" else torch.zeros_like(win)
        idx = segscan.segment_ids(ptr)[:, None].expand(-1, width)
        lib_v, lib_base = v, base
        if v.dtype == torch.int8:   # scatter_reduce takes no int8 amax
            lib_v, lib_base = v.int(), base.int()
        total["library_ms"] += cuda_ms(lambda: lib_base.scatter_reduce(
            0, idx, lib_v, red, include_self=True), iters=5, warmup=1)
        r = hi - lo
        nbytes += ((s1 - s0) * width * b + (r * width * b if op != "add"
                                            else 0)
                   + r * width * b + (r + 1) * 8)
        combines += (s1 - s0) * width + (r * width if op != "add" else 0)
        del v
    return {**total, **_bound(nbytes, combines)}


def phase_datasets_citation2(seed: int = 7) -> tuple:
    """(c) Citation2 scale: a graph with ogbl-citation2's published counts,
    128-dim features, and the citation2 preprocessing (to_undirected,
    SIGN with sign_k 3, 2-hop sketches at Config defaults) through
    make_auto_plan at the default max_gather_slots, which takes the
    chunked form.  The K1 launch counts are set to 0 just before that
    drive and read just after.  Then every chunk's merge of every reduce
    again, K1 against segment_combine_plain on the same chunk (min/max
    bit-equal, add within the add bound), and each K1 instance timed over
    one reduce's chunks.  Returns (the record, the instances)."""
    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.graph.preprocess import (
        sketch_params_from_config,
    )
    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.ops.graph_ops import gcn_norm
    from subgraph_sketching_tpu_torch.ops.segment_scan import (
        ChunkedSegmentPlan, make_auto_plan, plan_tables_native,
        plan_tables_plain,
    )
    from subgraph_sketching_tpu_torch.sketch.elph import initialise_sketches

    cfg = Config(dataset_name="ogbl-citation2", sign_k=3)
    max_slots = cfg.max_gather_slots
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    directed, max_in_degree = citation2_graph(seed)
    g = directed.to_undirected()
    del directed
    graph_s = time.perf_counter() - t0
    n = g.num_nodes
    x = torch.randn((n, CITATION2["features"]), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(seed))

    # the host plan tables: the C++ builder against numpy on the sketch
    # graph (equal tables), then the two plans as preprocessing builds them
    src, dst = g.edge_index
    t0 = time.perf_counter()
    native = plan_tables_native(src, dst, n, 16)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = plan_tables_plain(src, dst, n, 16)
    numpy_s = time.perf_counter() - t0
    if not all(np.array_equal(a, b) for a, b in zip(native, plain)):
        raise AssertionError("citation2: C++ plan tables differ from numpy")
    del native, plain
    ei = torch.from_numpy(g.edge_index.astype(np.int64)).to("cuda")
    nei, nw = gcn_norm(ei, torch.from_numpy(g.edge_weight).to("cuda"), n)
    del ei
    t0 = time.perf_counter()
    sign_plan = make_auto_plan(nei.cpu().numpy(), n, max_slots=max_slots,
                               device="cuda")
    sign_plan_s = time.perf_counter() - t0
    wslots = sign_plan.stage_edge_data(nw)
    del nei, nw
    t0 = time.perf_counter()
    plan = make_auto_plan(g.edge_index, n, max_slots=max_slots,
                          device="cuda")
    plan_s = time.perf_counter() - t0
    if not (isinstance(plan, ChunkedSegmentPlan)
            and isinstance(sign_plan, ChunkedSegmentPlan)):
        raise AssertionError("citation2 scale did not take the chunked plan")
    params = sketch_params_from_config(cfg)
    t0 = time.perf_counter()
    hop0 = initialise_sketches(n, params, "cuda")
    init_s = time.perf_counter() - t0

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    # the drive
    _reset_k1()
    torch.cuda.synchronize()
    xs, hop_ms = [x], {"sign": [], "minhash": [], "hll": []}
    for _ in range(cfg.sign_k):
        out, ms = timed(lambda: sign_plan.reduce(xs[-1], "add",
                                                 edge_data_slots=wslots))
        xs.append(out)
        hop_ms["sign"].append(ms)
    sketches = [hop0]
    for _ in range(cfg.max_hash_hops):
        mh, ms_mh = timed(lambda: plan.reduce(sketches[-1][0], "min"))
        hll, ms_hll = timed(lambda: plan.reduce(sketches[-1][1], "max"))
        sketches.append((mh, hll))
        hop_ms["minhash"].append(ms_mh)
        hop_ms["hll"].append(ms_hll)
    launches = dict(segscan.launches)
    peak_memory = torch.cuda.max_memory_allocated()
    need = {"segscan_add_f32": cfg.sign_k * sign_plan.num_chunks,
            "segscan_min_i32": cfg.max_hash_hops * plan.num_chunks,
            "segscan_max_i8": cfg.max_hash_hops * plan.num_chunks}
    if any(launches[k] != v for k, v in need.items()):
        raise AssertionError(f"citation2: K1 launches {launches}, one per "
                             f"chunk of every reduce is {need}")

    # every chunk's merge on K1 against its plain version
    add_err = [0.0]

    def merge(v, win, op, ptr):
        got = segscan.segment_combine(v, win, op, ptr)
        want = segscan.segment_combine_plain(v, win, op, ptr)
        if op == "add":
            check_add(got, want, v, win, ptr, "citation2 SIGN chunk")
            add_err[0] = max(add_err[0], float((got - want).abs().max()))
        elif not torch.equal(got, want):
            raise AssertionError(f"citation2: a chunk's {op} merge on K1 is "
                                 f"not bit-equal to its plain version")
        return want

    for k in range(cfg.sign_k):
        sign_plan.reduce(xs[k], "add", edge_data_slots=wslots, merge=merge)
    for h in range(cfg.max_hash_hops):
        for i, op in enumerate(("min", "max")):
            again = plan.reduce(sketches[h][i], op, merge=merge)
            if not torch.equal(again, sketches[h + 1][i]):
                raise AssertionError(f"citation2: hop {h + 1} {op} on the "
                                     f"plain merge differs")
    torch.cuda.synchronize()
    del xs[1:], sketches[1:]

    instances = {
        "segscan_min_i32": _chunk_instance(plan, hop0[0], "min"),
        "segscan_max_i8": _chunk_instance(plan, hop0[1], "max"),
        "segscan_add_f32": _chunk_instance(sign_plan, x, "add", wslots)}
    for name, rec in instances.items():
        rec.update(launches=launches[name],
                   max_abs_err=add_err[0] if name == "segscan_add_f32"
                   else 0.0)
    record = {
        "phase": "datasets", "part": "citation2_scale", **CITATION2,
        "max_in_degree": max_in_degree,
        "undirected_edges": int(g.num_edges), "graph_s": graph_s,
        "sign_k": cfg.sign_k, "max_hash_hops": cfg.max_hash_hops,
        "max_gather_slots": max_slots, "sub_len": plan.sub_len,
        "chunks": plan.num_chunks, "sign_chunks": sign_plan.num_chunks,
        "window_rows": plan.window,
        "plan_tables_cpp_s": native_s, "plan_tables_numpy_s": numpy_s,
        "make_auto_plan_s": {"sketch": plan_s, "sign": sign_plan_s},
        "hop0_init_s": init_s, "hop_device_ms": hop_ms,
        "k1_launches": launches, "peak_memory_bytes": peak_memory,
        "merge_check": "every chunk of every reduce: K1 bit-equal (min/max) "
                       f"to segment_combine_plain, add {ADD_TOLERANCE}",
        "instances": instances}
    return record, instances


# ------------------------------------------ citation2-scale BUDDY training --

# what a model that learned gives on the WS graph, at least (one that
# learned nothing gives about 0.5 and 0.05)
C2_FLOORS = {"auc": 0.90, "mrr": 0.50}
C2_PROFILE_STEPS = 20


def phase_citation2_train(seed: int = 0) -> tuple:
    """BUDDY end to end at citation2 scale through the port's
    ``tools/citation2_train.py`` at the JAX tool's full sizes (2,927,963
    nodes, 29,279,630 directed edges, 28M train and 2M val links and the
    MRR set, batch 262,144, hidden 256, 3 epochs, max_slots 4 << 20), K1's
    counts set to 0 just before the run and read just after: exactly 2
    min and 2 max launches a chunk (2 hops) and 1 add a chunk (SIGN).
    Then every chunk merge of hop 1's min and max on K1 against its plain
    version (bit-equal), and of the SIGN add (within the add bound); the
    epoch losses finite and falling; val AUC and MRR over C2_FLOORS; the
    shifted last prediction chunk against whole chunks on the MRR set;
    C2_PROFILE_STEPS training steps under torch.profiler (idle share, top
    kernels); each K1 instance timed over one reduce's chunks.  Returns
    (the record, the instances)."""
    import dataclasses
    import math

    import torch

    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.tools import citation2_train as c2

    sizes = c2.FULL
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _reset_k1()
    torch.cuda.synchronize()
    st = c2.run(sizes, "cuda", seed=seed, keep_inputs=True,
                log=lambda r: emit({"phase": "citation2_train", **r}))
    launches = dict(segscan.launches)
    plan, chunks = st.plan, st.plan.num_chunks
    if chunks < 2:
        raise AssertionError(f"citation2_train: the plan took {chunks} "
                             f"chunk(s), not the chunked form")
    need = {**{k: 0 for k in launches},
            "segscan_min_i32": c2.MAX_HOPS * chunks,
            "segscan_max_i8": c2.MAX_HOPS * chunks,
            "segscan_add_f32": chunks}
    if launches != need:
        raise AssertionError(f"citation2_train: K1 launches {launches}, one "
                             f"per chunk of every reduce is {need}")
    losses = st.metrics["epoch_loss"]
    if not (all(math.isfinite(v) for v in losses)
            and all(b < a for a, b in zip(losses, losses[1:]))):
        raise AssertionError(f"citation2_train: epoch losses {losses} are "
                             f"not finite and falling")
    short = {k: st.metrics[k] for k, floor in C2_FLOORS.items()
             if not st.metrics[k] >= floor}
    if short:
        raise AssertionError(f"citation2_train: {short} below the floors "
                             f"{C2_FLOORS}")

    # the shifted last chunk against whole chunks on the MRR set
    bf, n_mrr = sizes.feat_batch, len(st.links.mrr)
    shifted = c2.predict_range(st.model, st.mrr_tables, 0, n_mrr, bf)
    whole = torch.cat([
        c2.predict_range(st.model, st.mrr_tables, s, bf, bf)
        for s in range(0, len(st.mrr_tables.links), bf)])[:n_mrr]
    tail_err = float((shifted - whole).abs().max())
    if tail_err > 1e-5:
        raise AssertionError(f"citation2_train: the shifted tail's "
                             f"predictions differ by {tail_err}")
    del shifted, whole

    # every chunk merge of hop 1 and of SIGN, K1 against its plain version
    add_err = [0.0]

    def merge(v, win, op, ptr):
        got = segscan.segment_combine(v, win, op, ptr)
        want = segscan.segment_combine_plain(v, win, op, ptr)
        if op == "add":
            check_add(got, want, v, win, ptr, "citation2_train SIGN chunk")
            add_err[0] = max(add_err[0], float((got - want).abs().max()))
        elif not torch.equal(got, want):
            raise AssertionError(f"citation2_train: a chunk's hop-1 {op} "
                                 f"merge on K1 is not bit-equal to its "
                                 f"plain version")
        return want

    mh0, hll0 = st.hop0
    for table, op in ((mh0, "min"), (hll0, "max")):
        plan.reduce(table, op, merge=merge)
    plan.reduce(st.x, "add", edge_data_slots=st.w_slots, merge=merge)
    torch.cuda.synchronize()

    # the device's idle share over C2_PROFILE_STEPS steps, after 3 warm
    B = sizes.batch
    order = torch.randperm(st.links.n_train, generator=st.generator,
                           device="cuda")
    window_s, busy_ms, per = profile_window(
        lambda: c2.train_epoch(st.model, st.opt, st.tables, order[:3 * B],
                               B, st.generator),
        lambda: c2.train_epoch(st.model, st.opt, st.tables,
                               order[3 * B:(3 + C2_PROFILE_STEPS) * B], B,
                               st.generator))
    profile = {"steps": C2_PROFILE_STEPS, "window_ms": window_s * 1e3,
               "step_ms": window_s * 1e3 / C2_PROFILE_STEPS,
               "device_busy_ms": busy_ms,
               "device_idle_share": 1 - busy_ms / (window_s * 1e3),
               "top_kernels": sorted(([k, v[0], v[1]] for k, v in
                                      per.items()), key=lambda r: -r[1])[:10]}
    del order

    instances = {
        "segscan_min_i32": _chunk_instance(plan, mh0, "min"),
        "segscan_max_i8": _chunk_instance(plan, hll0, "max"),
        "segscan_add_f32": _chunk_instance(plan, st.x, "add", st.w_slots)}
    for name, rec in instances.items():
        rec.update(launches=launches[name],
                   max_abs_err=add_err[0] if name == "segscan_add_f32"
                   else 0.0)
    def key(r):
        return r["stage"] + str(r.get("epoch", ""))

    by_stage = {key(r): r["s"] for r in st.records}
    rates = {key(r): r["links_per_s"] for r in st.records
             if "links_per_s" in r}
    record = {
        "phase": "citation2_train", "sizes": dataclasses.asdict(sizes),
        "nodes": sizes.nodes, "edges": st.records[0]["edges"],
        "train_links": st.links.n_train,
        "val_links": len(st.links.links) - st.links.n_train,
        "mrr_links": n_mrr, "chunks": chunks, "sign_chunks": chunks,
        "steps_per_epoch": st.steps, "stage_s": by_stage,
        "links_per_s": rates, "epoch_loss": losses,
        "auc": st.metrics["auc"], "hits@50": st.metrics["hits@50"],
        "mrr": st.metrics["mrr"], "floors": C2_FLOORS,
        "peak_memory_bytes": max(r.get("peak_memory_bytes", 0)
                                 for r in st.records),
        "k1_launches": launches, "shifted_tail_max_abs_err": tail_err,
        "merge_check": "every chunk of hop 1's min and max: K1 bit-equal to "
                       "segment_combine_plain; SIGN add "
                       f"{ADD_TOLERANCE}",
        "profile": profile, "instances": instances,
        "phase_s": time.perf_counter() - t0}
    del st, mh0, hll0
    torch.cuda.empty_cache()
    return record, instances


# -------------------------------------------------- node embeddings: ddi --

# ogbl-ddi at its published shape (ogb/linkproppred/master.csv and the OGB
# paper's dataset table): nodes, train edges stored one direction, valid
# and test positives, and their negatives
DDI = {"nodes": 4_267, "train": 1_067_911, "valid": 133_489,
       "test": 133_489, "valid_neg": 101_882, "test_neg": 95_599}
# the reference README's two ddi commands (tests/test_cli.py), cut below to
# 2 epochs with eval every epoch
DDI_COMMANDS = {
    "BUDDY": "--dataset ogbl-ddi --K 20 --train_node_embedding "
             "--propagate_embeddings --label_dropout 0.25 --epochs 150 "
             "--hidden_channels 256 --lr 0.0015 --num_negs 6 --use_feature 0 "
             "--sign_k 2 --cache_subgraph_features --batch_size 131072 "
             "--model BUDDY",
    "ELPH": "--dataset ogbl-ddi --K 20 --train_node_embedding "
            "--propagate_embeddings --label_dropout 0.25 --epochs 150 "
            "--hidden_channels 256 --lr 0.0015 --num_negs 6 --use_feature 0 "
            "--sign_k 2 --batch_size 131072 --model ELPH"}
DDI_CUT = ["--epochs", "2", "--eval_steps", "1", "--check_determinism",
           "--save_model", "--device", "cuda"]
DDI_PROFILE_STEPS = 20
# K1 add launches a step with a trainable table and sign_k 2: two forward
# propagations, their two backwards and gather_rows' backward
DDI_ADDS_PER_STEP = 5


def write_ddi(root: str, seed: int = 11) -> dict:
    """An ``ogbl_ddi`` raw-layout tree at the published shape, from a seed,
    in the layout of tests/ogb_fixture.py (no node features): distinct
    unordered pairs without self-loops, endpoints drawn with probability
    proportional to rank^-0.45 (the largest train degree lands near the
    real graph's 2,234), shuffled into train / valid / test, and random
    non-edges as the valid and test negatives.  Returns the train degree
    profile."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n = DDI["nodes"]
    need = DDI["train"] + DDI["valid"] + DDI["test"]
    p = np.arange(1, n + 1, dtype=np.float64) ** -0.45
    p = p[rng.permutation(n)] / p.sum()
    keys = np.zeros(0, np.int64)          # lo * n + hi, lo < hi
    while len(keys) < need:
        k = 2 * (need - len(keys)) + 1000
        a, b = rng.choice(n, k, p=p), rng.choice(n, k, p=p)
        keep = a != b
        lo, hi = np.minimum(a, b)[keep], np.maximum(a, b)[keep]
        keys = np.unique(np.concatenate([keys, lo.astype(np.int64) * n + hi]))
    keys = rng.permutation(keys)[:need]

    def pairs(k):
        return np.stack([k // n, k % n], axis=1)

    def negatives(count):
        out = np.zeros(0, np.int64)
        while len(out) < count:
            a = rng.integers(0, n, 2 * count)
            b = rng.integers(0, n, 2 * count)
            k = np.minimum(a, b) * n + np.maximum(a, b)
            k = np.unique(k[(a != b) & ~np.isin(k, keys)])
            out = np.union1d(out, k)
        return pairs(rng.permutation(out)[:count])

    cut = np.cumsum([DDI["train"], DDI["valid"]])
    train, valid, test = (pairs(k) for k in np.split(keys, cut))
    base = os.path.join(root, "ogbl_ddi")
    raw, split = os.path.join(base, "raw"), os.path.join(base, "split",
                                                         "target")
    os.makedirs(raw)
    os.makedirs(split)
    _write_csv_gz(os.path.join(raw, "edge.csv.gz"), train, "%d")
    _write_csv_gz(os.path.join(raw, "num-node-list.csv.gz"), [n], "%d")
    torch.save({"edge": torch.from_numpy(train)},
               os.path.join(split, "train.pt"))
    for name, e in (("valid", valid), ("test", test)):
        torch.save({"edge": torch.from_numpy(e),
                    "edge_neg": torch.from_numpy(negatives(
                        DDI[f"{name}_neg"]))},
                   os.path.join(split, f"{name}.pt"))
    deg = np.bincount(train.ravel(), minlength=n)
    return {"max": int(deg.max()), "median": float(np.median(deg)),
            "mean": float(deg.mean())}


def _ddi_run(root: str, model: str, name: str) -> tuple:
    """One reference ddi command through ``runners.run.main``, cut by
    DDI_CUT, with its K1 launch counts and peak memory read around it and
    the trainer and datasets the runner built kept.  Returns (record,
    trainer, datasets)."""
    import math
    import shlex

    import torch

    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.runners import run as runner

    ckpt = os.path.join(root, name)
    kept = {}
    build_trainer = runner.build_trainer

    def keep(cfg, datasets, num_features, device):
        kept.update(trainer=build_trainer(cfg, datasets, num_features,
                                          device), datasets=datasets)
        return kept["trainer"]

    argv = shlex.split(DDI_COMMANDS[model]) + DDI_CUT + [
        "--data_root", root, "--checkpoint_dir", ckpt]
    if model == "BUDDY":
        argv += ["--cache_dir", os.path.join(root, "cache")]
    _reset_k1()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    runner.build_trainer = keep
    try:
        t0 = time.perf_counter()
        results = runner.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        runner.build_trainer = build_trainer
    launches = dict(segscan.launches)
    trainer = kept["trainer"]
    cfg = trainer.cfg
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["rep0_loss"] for r in rows]
    if len(rows) != 2 or not all(map(math.isfinite, losses)) \
            or not losses[1] < losses[0]:
        raise AssertionError(f"ddi {name}: losses not finite and falling: "
                             f"{losses}")
    n_links = trainer.num_links("train")
    steps = math.ceil(n_links / cfg.batch_size)
    trained_steps = steps * (cfg.epochs + 2)   # + the determinism check's 2
    adds = launches["segscan_add_f32"]
    if adds < DDI_ADDS_PER_STEP * trained_steps:
        raise AssertionError(f"ddi {name}: {adds} K1 add launches for "
                             f"{trained_steps} steps, expected at least "
                             f"{DDI_ADDS_PER_STEP} a step")
    if "emb_plan" not in trainer._data["train"]:
        raise AssertionError(f"ddi {name}: the trainer staged no PlanSpmm "
                             f"for the table's diffusion")
    metric = f"Hits@{cfg.K}"
    record = {
        "phase": "ddi", "part": name, "model": model,
        "command": DDI_COMMANDS[model] + " " + " ".join(DDI_CUT),
        "hidden_channels": cfg.hidden_channels,
        "batch_size": cfg.batch_size, "num_negs": cfg.num_negs,
        "sign_k": cfg.sign_k, "lr": cfg.lr, "train_links": n_links,
        "steps_per_epoch": steps, "trained_steps": trained_steps,
        "run_s": run_s, "get_data_s": rows[0]["rep0_get_data_time"],
        "preprocess_s": rows[0]["rep0_preprocess_time"],
        "epochs": [{"epoch": i, "loss": r["rep0_loss"],
                    "train_s": r["rep0_train_time"],
                    "eval_s": r["rep0_eval_time"],
                    "trained_links_per_s": n_links / r["rep0_train_time"],
                    "step_ms": 1e3 * r["rep0_train_time"] / steps,
                    metric.lower(): {
                        "train": r[f"rep0_Train{metric}"] / 100,
                        "valid": r[f"rep0_tmp_val{metric}"] / 100,
                        "test": r[f"rep0_tmp_test{metric}"] / 100}}
                   for i, r in enumerate(rows)],
        "results": results,
        "determinism": "epoch 0 bit-identical on two runs",
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "k1_launches": launches,
        "k1_add_launches_per_trained_step": adds / trained_steps,
        "emb_plan_subruns": {
            "forward": trainer._data["train"]["emb_plan"].fwd.num_subruns,
            "backward": trainer._data["train"]["emb_plan"].bwd.num_subruns}}
    return record, trainer, kept["datasets"]


def _ddi_profile(trainer, seed: int) -> dict:
    """The device idle share and top kernels over DDI_PROFILE_STEPS steps
    (after 3 warm ones, ``profile_window``) of the trained model, restored
    from the run's checkpoint, with exactly DDI_ADDS_PER_STEP K1 add
    launches a step by the counter and in the trace."""
    import torch

    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.train import checkpoint
    from subgraph_sketching_tpu_torch.train.loops import make_optimizer

    cfg = trainer.cfg
    model = trainer.init_model(0)
    opt = make_optimizer(cfg, model.parameters())
    checkpoint.restore_into(cfg.checkpoint_dir, model, opt)
    bs = cfg.batch_size
    g = torch.Generator(device="cuda").manual_seed(seed)
    order = torch.randperm(trainer.num_links("train"), generator=g,
                           device="cuda")
    window_s, busy_ms, per = profile_window(
        lambda: trainer.run_epoch(model, opt, seed, order=order[:3 * bs]),
        lambda: trainer.run_epoch(model, opt, seed,
                                  order=order[:DDI_PROFILE_STEPS * bs]))
    counted = segscan.launches["segscan_add_f32"]
    traced = sum(c for k, (_, c) in per.items() if "segscan_kernel" in k)
    if counted != DDI_ADDS_PER_STEP * DDI_PROFILE_STEPS or traced != counted:
        raise AssertionError(
            f"{DDI_PROFILE_STEPS} ddi steps: {counted} K1 add launches "
            f"counted, {traced} traced, expected {DDI_ADDS_PER_STEP} a step")
    return {"steps": DDI_PROFILE_STEPS, "window_ms": window_s * 1e3,
            "step_ms": window_s * 1e3 / DDI_PROFILE_STEPS,
            "k1_add_launches": counted, "k1_add_kernels_traced": traced,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / (window_s * 1e3),
            "top_kernels": sorted(([k, v[0], v[1]] for k, v in per.items()),
                                  key=lambda r: -r[1])[:10]}


def _ddi_serve(trainer, datasets, seed: int) -> dict:
    """The run's saved checkpoint served by ``scorer_from_checkpoint``
    (the table diffused once, by the scatter spmm): its scores for 65536
    random links equal the trainer's ``predict`` on them (staged as a
    split of the train message graph) within 1e-4."""
    import dataclasses

    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.graph.container import Graph
    from subgraph_sketching_tpu_torch.graph.preprocess import (
        build_link_dataset,
    )
    from subgraph_sketching_tpu_torch.graph.splits import SplitData
    from subgraph_sketching_tpu_torch.serving import scorer_from_checkpoint
    from subgraph_sketching_tpu_torch.train import checkpoint

    cfg = trainer.cfg
    train = datasets["train"]
    model = trainer.init_model(0)
    checkpoint.restore_into(cfg.checkpoint_dir, model, step=cfg.epochs)
    links = np.random.default_rng(seed).integers(0, train.num_nodes,
                                                 (65536, 2))
    query = SplitData(Graph(train.edge_index, train.num_nodes), links,
                      np.zeros((0, 2), np.int64))
    trainer.stage("query", build_link_dataset(
        query, dataclasses.replace(cfg, cache_subgraph_features=False),
        "query", reuse_from=train, device="cuda"))
    want, _ = trainer.predict(model, "query")
    del model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scorer = scorer_from_checkpoint(cfg.checkpoint_dir, device="cuda")
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    got = scorer.score(links)
    err = float(np.abs(got - want).max())
    if scorer.restored_step != cfg.epochs or scorer.emb_table is None \
            or not np.isfinite(got).all() or err > 1e-4:
        raise AssertionError(f"ddi: served scores differ from the trainer's "
                             f"predict: max |err| {err}, step "
                             f"{scorer.restored_step}")
    return {"serve_rebuild_s": rebuild_s, "served_links": len(links),
            "served_max_abs_err": err}


def _ddi_k1(trainer, seed: int) -> dict:
    """K1 at the ddi diffusion's shape: the staged PlanSpmm's forward and
    backward sub-run results at W = hidden_channels (256) float32, each
    against the plain merge (ADD_TOLERANCE) and itself across two calls,
    and timed as the kernels phase times it."""
    import torch

    ps = trainer._data["train"]["emb_plan"]
    n, w = ps.num_nodes, trainer.cfg.hidden_channels
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    with torch.no_grad():
        for what, plan, wts in (("forward", ps.fwd, ps._w_fwd),
                                ("backward", ps.bwd, ps._w_bwd)):
            x = torch.randn((n, w), generator=g, device="cuda")
            v = plan.reduce_subruns(x, "add", wts).contiguous()
            out[what] = {
                "phase": "ddi", "direction": what,
                "name": f"segscan_add_f32 (ddi diffusion {what}, W={w})",
                **k1_record(f"ddi diffusion {what}", "add", v, x,
                            plan.sub_ptr)}
            del x, v
    return out


def phase_ddi(root: str, seed: int = 12) -> tuple:
    """Node embeddings at ogbl-ddi's published shape: the raw tree written
    from a seed under ``root`` (which the caller removes; its seconds
    apart), then the reference's ddi BUDDY
    command twice with one --cache_dir (the second run reads the subgraph
    feature caches and equals the first: every split's features and the
    epoch losses) and its ddi ELPH command, each cut to 2 epochs with eval
    every epoch, --check_determinism and --save_model (_ddi_run); for the
    first BUDDY run and the ELPH run the profiled window (_ddi_profile)
    and the served checkpoint (_ddi_serve); K1 at the diffusion's shape
    (_ddi_k1).  Returns ({direction: K1 record}, [run records],
    summary)."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    degrees = write_ddi(root)
    write_s = time.perf_counter() - t0
    runs, features, k1 = [], [], None
    for model, name in (("BUDDY", "buddy"), ("BUDDY", "buddy_cached"),
                        ("ELPH", "elph")):
        record, trainer, datasets = _ddi_run(root, model, name)
        if model == "BUDDY":
            features.append({k: d.subgraph_features
                             for k, d in datasets.items()})
        if name != "buddy_cached":
            record["profile"] = _ddi_profile(trainer, seed)
            record.update(_ddi_serve(trainer, datasets, seed))
        if k1 is None:
            k1 = _ddi_k1(trainer, seed)
        runs.append(record)
        del trainer, datasets
        torch.cuda.empty_cache()
    first, cached = runs[0], runs[1]
    for split, sf in features[0].items():
        if not np.array_equal(sf, features[1][split]):
            raise AssertionError(f"ddi: the cached run's {split} "
                                 f"subgraph features differ")
    if [e["loss"] for e in first["epochs"]] \
            != [e["loss"] for e in cached["epochs"]]:
        raise AssertionError("ddi: the cached BUDDY run's losses differ "
                             "from the first run's")
    if cached["k1_launches"]["segscan_min_i32"] \
            or cached["k1_launches"]["segscan_max_i8"]:
        raise AssertionError("ddi: the cached run built sketches")
    cached_files = sorted(os.listdir(os.path.join(root, "cache")))
    summary = {"phase": "ddi", "part": "summary", "shape": DDI,
               "write_s": write_s, "train_degrees": degrees,
               "cached_files": cached_files,
               "cached_run_equal": ["subgraph_features", "losses"],
               "k1_add_launches": sum(r["k1_launches"]["segscan_add_f32"]
                                      for r in runs)}
    return k1, runs, summary


# biases of the Linear layers that feed a BatchNorm, with node embeddings:
# the heads' and the table diffusion's lin_k (its BatchNorm runs over the
# table's rows)
EMB_PRE_BN_BIAS = {
    "BUDDY": r"(buddy\.(label_lin_layer|lin_out|lin_emb_out|sign\.lin_\d+)"
             r"|sign_embedding\.lin_\d+)\.bias",
    "ELPH": r"(predictor\.(label_lin_layer|lin_out|lin_emb_out)"
            r"|embedding\.sign_embedding\.lin_\d+)\.bias"}


def phase_emb_reference(seed: int = 13) -> dict:
    """A small BUDDY and a small ELPH with a trainable, propagated
    node-embedding table (synth-ws, hidden 32, no node features, sign_k 2,
    dropouts 0, the pre-BN biases frozen), each trained 2 epochs from the
    same weights on the same explicit orders on the card (the diffusion's
    PlanSpmm and gather_rows on K1) and on the CPU (their plain versions),
    in float32 and in float64 (K1's float64 add); held as
    ``hold_card_to_cpu`` holds them.  ELPH's subgraph features are built
    on each device (within rtol 1e-5 / atol 1e-4), and both runs then
    train on the CPU's."""
    import re

    import torch

    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.graph.datasets import get_data
    from subgraph_sketching_tpu_torch.graph.preprocess import build_all_splits
    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.train.loops import (
        BuddyTrainer, ElphTrainer, epoch_seed, make_optimizer,
    )

    out = {"phase": "emb_reference"}
    for name, trainer_cls, floats in (
            ("BUDDY", BuddyTrainer, ("rows",)),
            ("ELPH", ElphTrainer, ("sf", "labels"))):
        cfg = Config(dataset_name="synth-ws", model=name, hidden_channels=32,
                     label_dropout=0.0, feature_dropout=0.0,
                     sign_dropout=0.0, use_feature=False, sign_k=2,
                     train_node_embedding=True, propagate_embeddings=True)
        splits, directed, _ = get_data(cfg)
        ds = build_all_splits(splits, cfg, directed=directed, device="cpu")
        n = ds["train"].num_links
        g = torch.Generator().manual_seed(seed)
        orders = [torch.randperm(n, generator=g) for _ in range(2)]
        trainers = {dev: trainer_cls(cfg, ds["train"], None, device=dev)
                    for dev in ("cpu", "cuda")}
        if name == "ELPH":
            sf_cpu = trainers["cpu"]._data["train"]["sf"]
            torch.testing.assert_close(
                trainers["cuda"]._data["train"]["sf"].cpu(), sf_cpu,
                rtol=1e-5, atol=1e-4)
            trainers["cuda"]._data["train"]["sf"] = sf_cpu.to(
                trainers["cuda"].device)
        if "emb_plan" not in trainers["cuda"]._data["train"]:
            raise AssertionError(f"emb_reference: the {name} trainer "
                                 f"staged no PlanSpmm")
        runs = {}
        _reset_k1()
        for dev, tr in trainers.items():
            base = dict(tr._data["train"])
            for dtype in (torch.float32, torch.float64):
                tr._data["train"] = {k: (v.to(dtype) if k in floats else v)
                                     for k, v in base.items()}
                model = tr.init_model(seed).to(dtype)
                for p_name, p in model.named_parameters():
                    p.requires_grad_(not re.fullmatch(EMB_PRE_BN_BIAS[name],
                                                      p_name))
                opt = make_optimizer(cfg, model.parameters())
                losses = torch.cat([tr.run_epoch(model, opt,
                                                 epoch_seed(0, e),
                                                 order=orders[e])
                                    for e in range(2)])
                runs[dev, dtype] = (
                    losses.double().cpu().numpy(),
                    {k: v.double().cpu()
                     for k, v in model.state_dict().items()
                     if v.is_floating_point()})
            tr._data["train"] = base
        launches = dict(segscan.launches)
        steps = sum(-(-len(o) // cfg.batch_size) for o in orders)
        if launches["segscan_add_f32"] != DDI_ADDS_PER_STEP * steps \
                or launches["segscan_add_f64"] != DDI_ADDS_PER_STEP * steps:
            raise AssertionError(f"emb_reference {name}: K1 add launches "
                                 f"{launches}, expected "
                                 f"{DDI_ADDS_PER_STEP} a step in each "
                                 f"precision over {steps} steps")
        out[name] = {"k1_launches": launches,
                     **hold_card_to_cpu(runs, f"emb_reference {name}")}
    out.update(dataset="synth-ws", hidden_channels=32, sign_k=2,
               tolerance="float64: 1e-9; float32: losses rtol 1e-4, "
                         "parameters rtol 1e-4 / atol 1e-5 or within 4x "
                         "the CPU float32 run's distance from float64; "
                         "pre-BN biases frozen")
    return out


# ------------------------------------------ streaming, RA serving, heuristics

STREAM_HELD_OUT = 1000                 # undirected train edges held out
STREAM_BATCHES = (1, 100, 899)         # inserted, then deleted, in turn
RA_REQUEST_SIZES = (1024, 65536, 262144)
HEURISTIC_SAMPLE = 100_000             # valid/test links held to the host
HUB_LINKS = 16_384                     # ddi hub pairs in one timed call


def _sym(pairs):
    """[2, 2M] edge index of both directions of the pairs [M, 2]."""
    import numpy as np
    return np.concatenate([pairs.T, pairs.T[::-1]], axis=1)


def _timed_merges(scorer) -> list:
    """Record CUDA events around each per-hop merge of ``scorer``'s
    streaming updates; returns the list the (start, end) pairs go to."""
    import torch
    events, merge = [], scorer._merge

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        merge(*args, **kwargs)
        end.record()
        events.append((start, end))

    scorer._merge = timed
    return events


def _hold_stacks(got, want, what: str) -> None:
    """MinHash and HLL stacks bit-equal, cards to rtol 1e-6."""
    import torch
    if not (torch.equal(got.minhash, want.minhash)
            and torch.equal(got.hll, want.hll)):
        raise AssertionError(f"{what}: the streamed stacks differ from the "
                             f"rebuild's")
    torch.testing.assert_close(got.cards, want.cards, rtol=1e-6, atol=0,
                               msg=f"{what}: cards")


def _stream_pass(scorer, events: list, pairs, op: str) -> list:
    """``op`` ('insert' or 'delete') the pairs [M, 2] in STREAM_BATCHES
    batches; one record per batch."""
    import torch
    records, s = [], 0
    for size in STREAM_BATCHES:
        batch = pairs[s:s + size]
        s += size
        events.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        getattr(scorer, f"{op}_edges")(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        stats = scorer.last_update_stats
        records.append({
            "op": op, "pairs": int(len(batch)), "wall_ms": wall_ms,
            "host_ms": stats["host_ms"], "dispatch_ms": stats["dispatch_ms"],
            "device_ms": sum(a.elapsed_time(b) for a, b in events),
            "rows_per_hop": stats["rows"]})
    return records


def phase_streaming(cfg, splits, seed: int = 14) -> dict:
    """Exact streaming edge updates at full width: STREAM_HELD_OUT
    undirected train edges of synth-ws-200000 held out of the message
    graph, a LinkScorer (Config defaults, seeded weights) served on the
    rest, then the held-out pairs inserted in STREAM_BATCHES batches and
    deleted again in the same batches.  After each pass the scorer's
    MinHash and HLL stacks are bit-equal, and its cards within rtol 1e-6,
    to build_hash_tables on that graph by the plan route (K1), and its
    scores within 1e-5 of a scorer rebuilt on that graph (with the served
    node features, which the updates leave as precomputed).  Then once
    more on hops-only stacks.  Per batch: wall, host (the update's own
    ``host_ms``) and dispatch ms, the device ms (CUDA events around each
    hop's merge, so the host's enqueue gaps inside a merge count) and the
    rows rebuilt per hop; the rebuild's seconds for contrast; then the
    largest batch inserted and deleted once more on the full stacks under
    torch.profiler, for the device's busy ms.  K1's launch counts are
    read around the rebuilds."""
    import dataclasses

    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.graph.container import Graph
    from subgraph_sketching_tpu_torch.graph.preprocess import (
        build_link_dataset, sketch_params_from_config,
    )
    from subgraph_sketching_tpu_torch.graph.splits import SplitData
    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.ops.segment_scan import make_auto_plan
    from subgraph_sketching_tpu_torch.serving import LinkScorer
    from subgraph_sketching_tpu_torch.sketch.elph import build_hash_tables
    from subgraph_sketching_tpu_torch.sketch.params import Sketches

    rng = np.random.default_rng(seed)
    g = splits["train"].graph
    n = g.num_nodes
    und = g.edge_index[:, g.edge_index[0] < g.edge_index[1]].T.astype(
        np.int64)
    drop = rng.choice(len(und), STREAM_HELD_OUT, replace=False)
    keep = np.ones(len(und), bool)
    keep[drop] = False
    held = und[drop]
    graphs = {"small": _sym(und[keep]), "full": _sym(und)}
    params = sketch_params_from_config(cfg)
    valid = splits["valid"]
    _reset_k1()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = build_link_dataset(SplitData(Graph(graphs["small"], n, x=g.x),
                                      valid.pos_edges, valid.neg_edges),
                            cfg, "train", device="cuda")
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    ds = dataclasses.replace(ds, sketches=None)
    full_ds = dataclasses.replace(
        ds, edge_index=graphs["full"],
        edge_weight=np.ones(graphs["full"].shape[1], np.float32),
        degrees=Graph(graphs["full"], n).degrees())
    plans = {k: make_auto_plan(ei, n, max_slots=cfg.max_gather_slots,
                               device="cuda") for k, ei in graphs.items()}
    model = seeded_buddy(cfg, 128, seed)
    queries = np.concatenate([held, rng.integers(0, n, (4096, 2))])
    layouts = []
    for hops_only in (False, True):
        c = dataclasses.replace(cfg, hops_only_sketches=hops_only)
        ref, sketch_s = {}, {}
        for name, ei in graphs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref[name] = build_hash_tables(ei, n, params, plan=plans[name],
                                          hops_only=hops_only)
            torch.cuda.synchronize()
            sketch_s[name] = time.perf_counter() - t0
        scorer = LinkScorer(c, model, dataclasses.replace(
            ds, sketches=Sketches(*(t.clone() for t in ref["small"]))),
            device="cuda")
        events = _timed_merges(scorer)
        rebuilt = {
            "insert": LinkScorer(c, model, dataclasses.replace(
                full_ds, sketches=ref["full"]), device="cuda"),
            "delete": LinkScorer(c, model, dataclasses.replace(
                ds, sketches=ref["small"]), device="cuda")}
        passes = []
        for op, other in rebuilt.items():
            batches = _stream_pass(scorer, events, held, op)
            what = f"streaming (hops_only={hops_only}) after the {op}s"
            _hold_stacks(scorer.sk, other.sk, what)
            if not torch.equal(scorer.deg, other.deg):
                raise AssertionError(f"{what}: degrees differ")
            got, want = scorer.score(queries), other.score(queries)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=what)
            passes.append({"op": op, "batches": batches,
                           "max_abs_score_diff": float(
                               np.abs(got - want).max())})
        layouts.append({"hops_only": hops_only,
                        "stack_bytes": sum(t.numel() * t.element_size()
                                           for t in ref["small"][:2]),
                        "rebuild_sketches_s": sketch_s, "passes": passes})
        if not hops_only:
            kept = scorer, rebuilt
        del scorer, rebuilt, ref
    launches = dict(segscan.launches)
    if not (launches["segscan_min_i32"] and launches["segscan_max_i8"]
            and launches["segscan_add_f32"]):
        raise AssertionError(f"streaming: the rebuilds did not run on K1: "
                             f"{launches}")
    # the largest batch again on the full stacks, each way, under the
    # profiler: the device's busy time, which the events above overstate
    # by the host's enqueue gaps
    scorer, rebuilt = kept
    batch = held[-STREAM_BATCHES[-1]:]
    profiled = {}
    for op in ("insert", "delete"):
        host_s, busy_ms, kernels = profile_window(
            lambda: scorer.score(queries[:1024]),
            lambda: getattr(scorer, f"{op}_edges")(batch))
        profiled[op] = {"pairs": int(len(batch)), "wall_ms": host_s * 1e3,
                        "device_busy_ms": busy_ms,
                        "kernels": sum(c for _, c in kernels.values())}
    _hold_stacks(scorer.sk, rebuilt["delete"].sk,
                 f"streaming, the profiled insert and delete of {len(batch)} "
                 f"pairs")
    del kept, scorer, rebuilt
    return {"phase": "streaming", "dataset": cfg.dataset_name, "nodes": n,
            "train_message_edges": int(g.num_edges),
            "held_out_pairs": STREAM_HELD_OUT,
            "batches": list(STREAM_BATCHES),
            "hidden_channels": cfg.hidden_channels,
            "minhash_num_perm": cfg.minhash_num_perm, "hll_p": cfg.hll_p,
            "max_hash_hops": cfg.max_hash_hops,
            "rebuild_s": rebuild_s, "layouts": layouts,
            "profiled_largest_batch": profiled, "k1_launches": launches,
            "tolerance": "stacks bit-equal to build_hash_tables by the plan "
                         "route, cards rtol 1e-6, degrees equal, scores "
                         "1e-5"}


def phase_serve_ra(cfg, splits, seed: int = 15) -> dict:
    """A use_RA BUDDY at Config defaults on synth-ws-200000 with seeded
    weights, served over the valid split's message graph: the scores of
    the split's links equal the trainer's predict (max |err| <= 1e-5);
    request ms at RA_REQUEST_SIZES with the host's RA share (the same
    ``resource_allocation`` call timed alone on the request's links); one
    weighted insert + delete round, after each of which the RA CSR and
    the degrees equal a rebuilt graph's, and after which the scores are
    those of before.  K1's launch counts are read around the rebuild."""
    import dataclasses

    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.graph.container import Graph
    from subgraph_sketching_tpu_torch.graph.preprocess import (
        build_link_dataset,
    )
    from subgraph_sketching_tpu_torch.heuristics import resource_allocation
    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.serving import LinkScorer
    from subgraph_sketching_tpu_torch.train.loops import BuddyTrainer

    cfg = dataclasses.replace(cfg, use_RA=True)
    _reset_k1()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = build_link_dataset(splits["valid"], cfg, "valid", device="cuda")
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    launches = dict(segscan.launches)
    if not (launches["segscan_min_i32"] and launches["segscan_max_i8"]
            and launches["segscan_add_f32"]):
        raise AssertionError(f"serve_ra: the rebuild did not run on K1: "
                             f"{launches}")
    scorer = LinkScorer(cfg, seeded_buddy(cfg, 128, seed), ds,
                        device="cuda")
    trainer = BuddyTrainer(cfg, ds, ds.x.shape[-1], device="cuda")
    want, _ = trainer.predict(scorer.model, "train")
    got = scorer.score(ds.links)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                               err_msg="serve_ra: scorer against predict")
    del trainer
    rng = np.random.default_rng(seed)
    scorer.warmup()
    requests = []
    for size in RA_REQUEST_SIZES:
        links = rng.integers(0, scorer.num_nodes, (size, 2))
        ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores = scorer.score(links)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if scores.shape != (size,) or not np.isfinite(scores).all():
                raise AssertionError(f"serve_ra: bad scores at {size}")
        t0 = time.perf_counter()
        resource_allocation(scorer.ra_csr, links)
        ra_ms = (time.perf_counter() - t0) * 1e3
        requests.append({"links": size, "ms": ms[0], "repeat_ms": ms[1],
                         "ra_host_ms": ra_ms, "ra_share": ra_ms / ms[1]})
    # one weighted insert + delete round of pairs not in the graph
    n = scorer.num_nodes
    have = set((ds.edge_index[0].astype(np.int64) * n
                + ds.edge_index[1]).tolist())
    pairs = []
    while len(pairs) < 100:
        u, v = sorted(rng.integers(0, n, 2).tolist())
        if u != v and u * n + v not in have:
            have.add(u * n + v)
            pairs.append((u, v))
    pairs = np.array(pairs, np.int64)
    w = rng.integers(1, 4, len(pairs)).astype(np.float32)
    q = rng.integers(0, n, (4096, 2))
    before = scorer.score(q)
    base_csr = scorer.ra_csr.copy()
    base_deg = scorer.deg.clone()
    scorer.insert_edges(pairs, weights=w)
    grown = Graph(np.concatenate([ds.edge_index, _sym(pairs)], axis=1), n,
                  np.concatenate([ds.edge_weight, w, w]))
    for what, csr, deg in (
            ("insert", grown.csr(), torch.from_numpy(grown.degrees())),
            ("delete", None, None)):
        if csr is None:
            scorer.delete_edges(pairs, weights=w)
            csr, deg = base_csr, base_deg
        if abs(scorer.ra_csr - csr).max() != 0 \
                or scorer.ra_csr.nnz != csr.nnz:
            raise AssertionError(f"serve_ra: the RA CSR after the {what} "
                                 f"differs from the rebuilt one")
        if not torch.equal(scorer.deg, deg.to(scorer.deg.device)):
            raise AssertionError(f"serve_ra: degrees after the {what}")
    after = scorer.score(q)
    if not np.array_equal(after, before):
        raise AssertionError("serve_ra: scores changed by the insert + "
                             "delete round")
    return {"phase": "serve_ra", "dataset": cfg.dataset_name,
            "split": "valid", "nodes": n,
            "message_edges": int(ds.edge_index.shape[1]),
            "hidden_channels": cfg.hidden_channels, "use_RA": True,
            "rebuild_s": rebuild_s, "k1_launches": launches,
            "links_held_to_predict": int(len(ds.links)),
            "max_abs_err_vs_predict": float(np.abs(got - want).max()),
            "requests": requests,
            "update_round": {"pairs": int(len(pairs)),
                             "weights": "integers 1-3",
                             "ra_csr_equal_rebuilt": ["insert", "delete"],
                             "scores_restored": True}}


@contextlib.contextmanager
def _timed_heuristics(records: dict):
    """Within the block, each ``DeviceHeuristics.scores`` call's seconds
    (the call returns host arrays, so the card is done), its links per
    bucket width and the chunks they take add up in ``records`` by
    kind."""
    import numpy as np

    from subgraph_sketching_tpu_torch.heuristics import DeviceHeuristics
    scores = DeviceHeuristics.scores

    def timed(self, links, kind="CN"):
        t0 = time.perf_counter()
        out = scores(self, links, kind)
        seconds = time.perf_counter() - t0
        rec = records.setdefault(kind, {"seconds": 0.0, "links": 0,
                                        "buckets": {}})
        rec["seconds"] += seconds
        rec["links"] += len(links)
        counts = np.bincount(self.bucket_of(np.asarray(links)),
                             minlength=len(self.buckets))
        for D, c in zip(self.buckets, counts.tolist()):
            b = rec["buckets"].setdefault(str(D), {"links": 0, "chunks": 0})
            b["links"] += c
            if c:
                b["chunks"] += -(-c // max(1, min(
                    c, self.chunk_elems // (D * D))))
        return out

    DeviceHeuristics.scores = timed
    try:
        yield
    finally:
        DeviceHeuristics.scores = scores


def phase_heuristics(collab_root: str, ddi_root: str, seed: int = 16) -> dict:
    """The heuristics tier on the card: ``runners.run_heuristics.run`` with
    RA, CN and AA on the ogbl-collab tree of the datasets phase (one rep),
    each heuristic's seconds of DeviceHeuristics scoring, its links per
    bucket width, Hits@50 and AUC (random data: these measure nothing);
    the card's scores of a seeded sample of HEURISTIC_SAMPLE valid and
    test links against the host functions (rtol 1e-4, atol 1e-5); PPR
    (and the other three) through the runner on synth-ba only, since its
    host power iteration, one solve per unique source, takes hours at
    collab scale; and one call over HUB_LINKS hub pairs of the ddi tree
    (largest degree 2,269: bucket 4096, 2 links a chunk), the compare-all's
    worst case, timed."""
    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.graph.container import Graph
    from subgraph_sketching_tpu_torch.heuristics import (
        DeviceHeuristics, adamic_adar, common_neighbours, resource_allocation,
    )
    from subgraph_sketching_tpu_torch.runners import run_heuristics

    host = {"RA": resource_allocation, "CN": common_neighbours,
            "AA": adamic_adar}
    kept, records = {}, {}
    get_data = run_heuristics.get_data

    def keep(cfg):
        kept["data"] = get_data(cfg)
        return kept["data"]

    run_heuristics.get_data = keep
    try:
        with _timed_heuristics(records):
            t0 = time.perf_counter()
            summary = run_heuristics.run(
                Config(dataset_name="ogbl-collab", data_root=collab_root),
                tuple(host), device="cuda")
            run_s = time.perf_counter() - t0
    finally:
        run_heuristics.get_data = get_data
    ba_records = {}
    with _timed_heuristics(ba_records):
        t0 = time.perf_counter()
        ba = run_heuristics.run(Config(dataset_name="synth-ba"),
                                ("RA", "CN", "AA", "PPR"), device="cuda")
        ba_s = time.perf_counter() - t0
    for name, s in list(summary.items()) + list(ba.items()):
        if not all(np.isfinite(v) for v in s.values()):
            raise AssertionError(f"heuristics: {name} summary not finite: "
                                 f"{s}")
    # the card against the host functions on a seeded sample
    splits = kept["data"][0]
    rng = np.random.default_rng(seed)
    sample = {}
    for split, graph in (("valid", "train"), ("test", "test")):
        links = splits[split].links
        sel = rng.choice(len(links), HEURISTIC_SAMPLE // 2, replace=False)
        sample[split] = (splits[graph].graph.csr(), links[sel])
    held = {}
    for split, (A, links) in sample.items():
        dev = DeviceHeuristics(A, device="cuda")
        for kind, fn in host.items():
            got, want = dev.scores(links, kind), fn(A, links)
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                       err_msg=f"heuristics {kind} {split}")
            held[f"{kind}_{split}"] = float(np.abs(got - want).max())
    # the ddi tree's hub pairs: the widest bucket's compare-all
    edges = torch.load(os.path.join(ddi_root, "ogbl_ddi", "split", "target",
                                    "train.pt"))["edge"].numpy()
    A = Graph(_sym(edges), DDI["nodes"]).csr()
    dev = DeviceHeuristics(A, device="cuda")
    wide = dev.buckets[-1]
    hubs = np.nonzero(dev.deg > dev.buckets[-2])[0]
    top = np.argsort(-dev.deg, kind="stable")[:512]
    links = np.stack([rng.choice(hubs, HUB_LINKS),
                      rng.choice(top, HUB_LINKS)], axis=1)
    links[links[:, 0] == links[:, 1], 1] = top[-1]
    if not (dev.bucket_of(links) == len(dev.buckets) - 1).all():
        raise AssertionError("heuristics: a hub pair outside the widest "
                             "bucket")
    dev.scores(links[:4], "CN")     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = dev.scores(links, "CN")
    hub_s = time.perf_counter() - t0
    np.testing.assert_allclose(got, common_neighbours(A, links), rtol=1e-4,
                               atol=1e-5, err_msg="heuristics: ddi hub pairs")
    per_chunk = max(1, dev.chunk_elems // (wide * wide))
    return {"phase": "heuristics", "dataset": "ogbl-collab",
            "shape": COLLAB, "heuristics": list(host), "reps": 1,
            "device": "cuda", "run_s": run_s,
            "device_scoring": records, "summary": summary,
            "hits@50_test": {k: summary[k][f"{k}_test_mean"] / 100
                             for k in host},
            "auc_test": {k: summary[k][f"{k}_test_auc_mean"] / 100
                         for k in host},
            "held_to_host": {"links": HEURISTIC_SAMPLE,
                             "tolerance": "rtol 1e-4, atol 1e-5",
                             "max_abs_err": held},
            "synth_ba": {"heuristics": ["RA", "CN", "AA", "PPR"],
                         "run_s": ba_s, "summary": ba,
                         "device_scoring": ba_records},
            "ppr_at_collab": "not run: the host power iteration, one solve "
                             "per unique source, takes hours at this scale",
            "ddi_hub_pairs": {"links": HUB_LINKS, "buckets": dev.buckets,
                              "max_degree": int(dev.deg.max()),
                              "width": wide, "links_per_chunk": per_chunk,
                              "chunks": -(-HUB_LINKS // per_chunk),
                              "seconds": hub_s,
                              "ms_per_chunk": hub_s * 1e3
                              / -(-HUB_LINKS // per_chunk)}}


# ----------------------------------------------------- SEAL and KGE tiers --

# the SEAL baseline at Config defaults (hidden 1024, 3 layers, sortpool_k
# 0.6, 1 hop, DRNL, max_dist 4, max_z 1000, batch 1024, lr 1e-4) on the
# collab tree, extracting per batch
SEAL_COMMAND = ("--dataset_name ogbl-collab --model SEALDGCNN --K 50 "
                "--dynamic_train true --dynamic_val true --dynamic_test true "
                "--train_samples 65536 --val_samples 16384 "
                "--test_samples 16384 --epochs 1")
SEAL_SMALL = ["--train_samples", "8192", "--val_samples", "4096",
              "--test_samples", "4096"]
SEAL_PROFILE_STEPS = 50
# K1 add launches of a SEALDGCNN training step: the four union SpMMs each
# way, the gcn_norm degrees and the label embedding's backward
SEAL_DGCNN_ADDS_PER_STEP = 10
KGE_MODELS = ("transE", "distmult", "complEx", "rotatE")


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _run_row(ckpt: str) -> dict:
    """The metrics row of a one-epoch runner run (its metrics.jsonl)."""
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        (row,) = [json.loads(line) for line in f]
    return row


def _runner_run(root: str, name: str, args: list, splits_memo: dict
                ) -> tuple:
    """``runners.run.main`` with ``args`` on the collab tree under
    ``root``, its get_data answered from ``splits_memo`` after the first
    read (one parse of the raw tree for every run of the phase), the
    trainer it built kept; returns (trainer, metrics row, run seconds,
    peak memory, K1 launches)."""
    import torch

    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.runners import run as runner

    read = runner.get_data

    def get_data(cfg):
        if "splits" not in splits_memo:
            splits_memo["splits"] = read(cfg)
        return splits_memo["splits"]

    kept = []

    def keep(build):
        def wrapped(*a, **k):
            kept.append(build(*a, **k))
            return kept[-1]
        return wrapped

    ckpt = os.path.join(root, name)
    _reset_k1()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _patched(runner, "get_data", get_data), \
            _patched(runner, "build_seal_trainer",
                     keep(runner.build_seal_trainer)), \
            _patched(runner, "KgeTrainer", keep(runner.KgeTrainer)):
        runner.main(args + ["--device", "cuda", "--data_root", root,
                            "--checkpoint_dir", ckpt])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    row = _run_row(ckpt)
    if not all(v == v and abs(v) != float("inf") for v in row.values()
               if isinstance(v, float)):
        raise AssertionError(f"{name}: a metric is not finite: {row}")
    return (kept[-1], row, run_s, torch.cuda.max_memory_allocated(),
            dict(segscan.launches))


@contextlib.contextmanager
def _gather_backward_watch(counts: dict, stash: dict = None):
    """``gather_rows``' backward watched: ``counts[(table rows, W)]``
    gains the K1 add launches of each call (K1's counter read around it),
    and with ``stash`` the first call of each (table rows, W) leaves its
    real inputs there, (flat ids, gradient), for ``gather_k1_record``."""
    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.ops.segment_scan import _RowGather
    backward = _RowGather.backward

    def watched(ctx, g):
        key = (ctx.num_rows, g.shape[-1])
        if stash is not None and key not in stash:
            stash[key] = (ctx.saved_tensors[0].clone(), g.detach().clone())
        before = segscan.launches["segscan_add_f32"]
        out = backward(ctx, g)
        counts[key] = (counts.get(key, 0)
                       + segscan.launches["segscan_add_f32"] - before)
        return out

    with _patched(_RowGather, "backward", staticmethod(watched)):
        yield


def gather_k1_record(phase: str, name: str, inputs: tuple, table_rows: int,
                     launches: int) -> dict:
    """K1 on the real inputs of one ``gather_rows`` backward (the ids and
    the gradient a training step gave it): the rows grouped as the
    backward groups them, their sum held against indexing's backward
    (``index_add_``) within ADD_TOLERANCE, then held and timed by
    ``k1_record``.  ``launches``: that backward's K1 adds in the run."""
    import torch

    from subgraph_sketching_tpu_torch.ops.segment_scan import (
        ordered_segment_add, segment_order,
    )
    flat, g = inputs
    width = g.shape[-1]
    g = g.reshape(-1, width)
    with torch.no_grad():
        perm, ptr = segment_order(flat, table_rows)
        v = g.index_select(0, perm).contiguous()
        x = torch.empty((table_rows, width), dtype=g.dtype, device=g.device)
        got = ordered_segment_add(v, ptr, table_rows)
        want = torch.zeros_like(got).index_add_(0, flat, g)
        check_add(got, want, v, x, ptr, f"{name} against indexing's "
                                        f"backward")
        err = float((got - want).abs().max())
        del got, want, g
        return {"phase": phase, "name": name, "launches": launches,
                "rows": int(flat.numel()), "table_rows": table_rows,
                "max_abs_err_vs_index_backward": err,
                **k1_record(name, "add", v, x, ptr)}


def _hits(row: dict) -> dict:
    return {"train": row["rep0_TrainHits@50"] / 100,
            "valid": row["rep0_tmp_valHits@50"] / 100,
            "test": row["rep0_tmp_testHits@50"] / 100}


def phase_seal(root: str, splits_memo: dict, seed: int = 17) -> tuple:
    """The SEAL tier at full width on the collab tree: SEALDGCNN through
    the runner (SEAL_COMMAND, --check_determinism, --save_model), its
    host extraction clocked; 50 steps of the trained model under
    torch.profiler (idle share, top kernels, exactly 10 K1 add launches
    a step by counter and trace); K1 at the step's shapes (the label
    embedding's backward on one step's real inputs, one batch's disjoint
    union at W = 1024 and DGCNN's W = 1) held and timed as the kernels
    phase holds and times it; SEALGCN, SEALSAGE, SEALGIN and
    SEALMLP through the runner at 8,192 train links."""
    import shlex

    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.graph.seal import SEALDataset
    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.train import checkpoint
    from subgraph_sketching_tpu_torch.train.loops import make_optimizer

    clock = {"s": 0.0, "batches": 0}
    extract = SEALDataset.extract_batch

    def timed(self, indices):
        t = time.perf_counter()
        out = extract(self, indices)
        clock["s"] += time.perf_counter() - t
        clock["batches"] += 1
        return out

    gathers = {}   # gather_rows' backward K1 adds by (table rows, W)
    with _patched(SEALDataset, "extract_batch", timed), \
            _gather_backward_watch(gathers):
        trainer, row, run_s, peak, k1 = _runner_run(
            root, "seal_dgcnn", shlex.split(SEAL_COMMAND)
            + ["--check_determinism", "--save_model"], splits_memo)
    extraction = dict(clock)
    cfg, k = trainer.cfg, trainer.k
    # the trained model, from the checkpoint --save_model wrote
    model = trainer.init_model(seed)
    checkpoint.restore_into(os.path.join(root, "seal_dgcnn"), model, step=1)
    if not np.isfinite(row["rep0_loss"]):
        raise AssertionError(f"seal: loss {row['rep0_loss']}")

    # the device's share over 50 steps of the trained model
    ds, bs = trainer.datasets["train"], cfg.batch_size
    order = np.random.default_rng(seed).permutation(len(ds))
    opt = make_optimizer(cfg, model.parameters())
    g = torch.Generator(device="cuda").manual_seed(seed)
    full = np.ones(bs, bool)

    def steps(lo: int, k: int) -> None:
        for i in range(lo, lo + k):
            trainer.step(model, opt, ds.batch(order[i * bs:(i + 1) * bs]),
                         full, g)

    clock.update(s=0.0, batches=0)
    with _patched(SEALDataset, "extract_batch", timed):
        window_s, busy_ms, per = profile_window(
            lambda: steps(0, 2), lambda: steps(2, SEAL_PROFILE_STEPS))
    window_adds = segscan.launches["segscan_add_f32"]
    traced_adds = sum(c for k, (_, c) in per.items()
                      if "segscan_kernel" in k)
    if window_adds != SEAL_DGCNN_ADDS_PER_STEP * SEAL_PROFILE_STEPS \
            or traced_adds != window_adds:
        raise AssertionError(
            f"seal: {SEAL_PROFILE_STEPS} steps, {window_adds} K1 add "
            f"launches counted, {traced_adds} traced, expected "
            f"{SEAL_DGCNN_ADDS_PER_STEP} a step")
    profile = {"steps": SEAL_PROFILE_STEPS, "window_ms": window_s * 1e3,
               "step_ms": window_s * 1e3 / SEAL_PROFILE_STEPS,
               "device_busy_ms": busy_ms,
               "device_step_ms": busy_ms / SEAL_PROFILE_STEPS,
               "extract_ms_per_batch": clock["s"] * 1e3 / max(
                   clock["batches"], 1),
               "device_idle_share": 1 - busy_ms / (window_s * 1e3),
               "k1_add_launches": window_adds,
               "k1_add_kernels_traced": traced_adds,
               "top_kernels": sorted(([k, v[0], v[1]]
                                      for k, v in per.items()),
                                     key=lambda r: -r[1])[:10]}

    # K1 at the step's shapes: the label embedding's backward on one
    # step's real ids and gradient, and one batch's union graph
    z_key = (cfg.max_z, cfg.hidden_channels)
    if set(gathers) != {z_key} or gathers[z_key] <= 0:
        raise AssertionError(f"seal: gather_rows' backward launches "
                             f"{gathers}, expected the label embedding's")
    raw = ds.batch(order[:bs])
    stash = {}
    with _gather_backward_watch({}, stash):
        trainer.step(model, opt, raw, full, g)
    k1_seal = [gather_k1_record(
        "seal", f"segscan_add_f32 (SEAL z_embedding backward, "
                f"W={cfg.hidden_channels})", stash.pop(z_key), cfg.max_z,
        gathers[z_key])]
    batch, _ = trainer.to_device(raw)
    ei, w, ((perm, ptr), _) = batch["graph"].gcn()
    n = batch["graph"].num_nodes
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for width in (cfg.hidden_channels, 1):
        x = torch.randn((n, width), generator=gen, device="cuda")
        v = (x.index_select(0, ei[0][perm]) * w[perm, None]).contiguous()
        k1_seal.append({"phase": "seal", "part": "k1",
                        "name": f"segscan_add_f32 (SEAL union, W={width})",
                        "edges_with_self_loops": int(ei.shape[1]),
                        **k1_record(f"SEAL union W={width}", "add", v, x,
                                    ptr)})
        del x, v
    del batch, raw, trainer, model, opt

    small = []
    for name in ("SEALGCN", "SEALSAGE", "SEALGIN", "SEALMLP"):
        args = shlex.split(SEAL_COMMAND.replace("SEALDGCNN", name)) \
            + SEAL_SMALL
        _, r, s, p, launches = _runner_run(root, f"seal_{name}", args,
                                           splits_memo)
        if not np.isfinite(r["rep0_loss"]):
            raise AssertionError(f"seal: {name} loss {r['rep0_loss']}")
        small.append({"model": name, "run_s": s,
                      "epoch_s": r["rep0_train_time"],
                      "eval_s": r["rep0_eval_time"], "loss": r["rep0_loss"],
                      "hits@50": _hits(r), "peak_memory_bytes": p,
                      "k1_add_launches": launches["segscan_add_f32"]})
    train_links = int(cfg.train_samples)
    record = {
        "phase": "seal", "dataset": "ogbl-collab",
        "command": SEAL_COMMAND + " --check_determinism --save_model",
        "k": k,
        "run_s": run_s, "get_data_s": row["rep0_get_data_time"],
        "preprocess_s": row["rep0_preprocess_time"],
        "epoch_s": row["rep0_train_time"], "eval_s": row["rep0_eval_time"],
        "loss": row["rep0_loss"], "hits@50": _hits(row),
        "train_links_per_s": train_links / row["rep0_train_time"],
        "host_extraction_s": extraction["s"],
        "extracted_batches": extraction["batches"],
        "peak_memory_bytes": peak, "k1_launches": k1,
        "z_embedding_backward_launches": gathers[z_key],
        "determinism": "passed", "profile": profile, "small_models": small}
    return record, k1_seal


ADAM_TOLERANCE = ("loss rtol 1e-5; tables rtol 1e-4 / atol 1e-6 on all "
                  "but 0.1% of elements, every element within 2 lr a step")


def adam_close(got: dict, want: dict, lr: float, steps: int,
               what: str) -> dict:
    """Hold two state dicts after ``steps`` Adam steps from one init:
    every element within rtol 1e-4 / atol 1e-6 but at most 0.1% of them,
    and those within 2 lr a step (Adam's first steps move an element by
    about lr whatever its gradient's size, so a gradient within float32
    rounding of 0, transE's L1 sign at a difference within rounding of
    0, moves it by up to lr either way on either device)."""
    beyond, total, worst = 0, 0, 0.0
    for k, v in want.items():
        d = (got[k].double() - v.double()).abs()
        beyond += int((d > 1e-6 + 1e-4 * v.double().abs()).sum())
        total += d.numel()
        worst = max(worst, float(d.max()))
    if beyond > 1e-3 * total or worst > 2 * lr * steps:
        raise AssertionError(f"{what}: {beyond} of {total} elements beyond "
                             f"rtol 1e-4 / atol 1e-6, max |diff| {worst}")
    return {"elements_beyond_rtol_1e-4_atol_1e-6": beyond,
            "elements": total, "max_param_abs_diff": worst}


GRAD_TOLERANCE = ("each table within 1e-5 of its norm (||card - cpu|| / "
                  "||cpu||), every element within rtol 1e-4 / atol 1e-4 "
                  "* max|grad|")


def grads_close(got: dict, want: dict, what: str) -> dict:
    """Hold two steps' gradients from one init, table by table, within
    GRAD_TOLERANCE, where Adam's update would hide a gradient of the
    wrong size.  float32 sums in another order, and terms that cancel to
    near 0 keep their rounding: rotatE's cos/sin differ by an ulp between
    the devices, and at collab's 67,584 rows a step a few elements of
    483 M land up to 1.5e-5 of the largest gradient apart, so the table's
    norm carries the tight bound."""
    import torch

    rel = {}
    for k, v in want.items():
        v64 = v.double()
        rel[k] = float((got[k].double() - v64).norm()
                       / v64.norm().clamp_min(1e-300))
        if rel[k] > 1e-5:
            raise AssertionError(f"{what} {k}: gradients {rel[k]} of the "
                                 f"norm apart")
        torch.testing.assert_close(got[k], v, rtol=1e-4,
                                   atol=1e-4 * float(v.abs().max()),
                                   msg=lambda m, k=k: f"{what} {k}: {m}")
        del v64
    return {"grad_diff_over_norm": rel}


def phase_seal_reference(seed: int = 18) -> dict:
    """Small SEALGCN, SEALGIN and SEALDGCNN (synth-ba, hidden 32, 2
    layers, dropout 0: DGCNN's fixed dropout set to 0 on both) trained 3
    steps (a padded last batch) from the same weights on the same
    batches on the card and on the CPU, in float32 and float64, each held
    as ``hold_card_to_cpu`` holds them."""
    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.graph.datasets import get_data
    from subgraph_sketching_tpu_torch.train.loops import make_optimizer
    from subgraph_sketching_tpu_torch.train.seal_loop import (
        build_seal_trainer,
    )

    held = {}
    for name in ("SEALGCN", "SEALGIN", "SEALDGCNN"):
        cfg = Config(dataset_name="synth-ba", model=name, hidden_channels=32,
                     num_seal_layers=2, dropout=0.0, batch_size=128,
                     sortpool_k=20)
        splits, _, _ = get_data(cfg)
        order = np.random.default_rng(seed).permutation(
            len(splits["train"].links))[:3 * 128 - 40]
        runs = {}
        for dev in ("cpu", "cuda"):
            tr = build_seal_trainer(cfg, splits, device=dev)
            for dtype in (torch.float32, torch.float64):
                model = tr.init_model(seed).to(dtype)
                if hasattr(model, "drop"):
                    model.drop.p = 0.0
                to_device = tr.to_device

                def cast(raw, to_device=to_device, dtype=dtype):
                    batch, y = to_device(raw)
                    return ({k: v.to(dtype) if torch.is_tensor(v)
                             and v.is_floating_point() else v
                             for k, v in batch.items()}, y.to(dtype))

                tr.to_device = cast
                opt = make_optimizer(cfg, model.parameters())
                losses = []
                for s in range(0, len(order), cfg.batch_size):
                    idx = order[s:s + cfg.batch_size]
                    mask = np.arange(cfg.batch_size) < len(idx)
                    idx = np.concatenate([idx, np.zeros(
                        cfg.batch_size - len(idx), np.int64)])
                    losses.append(float(tr.step(
                        model, opt, tr.datasets["train"].batch(idx), mask)))
                tr.to_device = to_device
                runs[dev, dtype] = (
                    np.asarray(losses, np.float64),
                    {k: v.double().cpu() for k, v in
                     model.state_dict().items() if v.is_floating_point()})
        held[name] = hold_card_to_cpu(runs, f"seal_reference {name}")
    return {"phase": "seal_reference", "dataset": "synth-ba",
            "hidden_channels": 32, "models": held,
            "tolerance": "float64: 1e-9; float32: losses rtol 1e-4, "
                         "parameters rtol 1e-4 / atol 1e-5 or within 4x "
                         "the CPU float32 run's distance from float64"}


def phase_kge(root: str, splits_memo: dict, seed: int = 19) -> dict:
    """The KGE tier at full width on the collab tree: each of transE,
    distmult, complEx and rotatE at Config defaults (hidden 1024, batch
    1024, 64 negatives a positive) one epoch through the runner
    (--check_determinism on transE): epoch seconds, steps/s, loss, Hits@50,
    peak memory, K1 add launches (2 a step: the entity and relation
    rows' backward, each counted by ``_gather_backward_watch``); then one
    step on the card against the CPU's from the same init, positives and
    negatives, for transE and rotatE (loss, gradients, tables), whose
    gather_rows backward inputs K1 is held and timed on: the entity rows
    at W = 1024 and 2048, the relation row at W = 1024."""
    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.train.kge_loop import KgeTrainer
    from subgraph_sketching_tpu_torch.train.loops import make_optimizer

    runs, trainers, gathers = [], {}, {}
    for name in KGE_MODELS:
        args = ["--dataset_name", "ogbl-collab", "--model", name, "--K",
                "50", "--epochs", "1"]
        if name == "transE":
            args.append("--check_determinism")
        gathers[name] = {}   # gather_rows' backward adds by (rows, W)
        with _gather_backward_watch(gathers[name]):
            tr, row, run_s, peak, k1 = _runner_run(root, f"kge_{name}",
                                                   args, splits_memo)
        if not np.isfinite(row["rep0_loss"]):
            raise AssertionError(f"kge: {name} loss {row['rep0_loss']}")
        epochs_run = 3 if name == "transE" else 1
        if k1["segscan_add_f32"] != 2 * tr.steps * epochs_run \
                or sorted(gathers[name].values()) != [tr.steps * epochs_run
                                                      ] * 2:
            raise AssertionError(f"kge: {name} launched {k1} K1 adds "
                                 f"({gathers[name]} by table) for "
                                 f"{tr.steps} steps an epoch")
        runs.append({"model": name, "run_s": run_s,
                     "epoch_s": row["rep0_train_time"], "steps": tr.steps,
                     "steps_per_s": tr.steps / row["rep0_train_time"],
                     "eval_s": row["rep0_eval_time"],
                     "loss": row["rep0_loss"], "hits@50": _hits(row),
                     "peak_memory_bytes": peak,
                     "k1_add_launches": k1["segscan_add_f32"],
                     "determinism": "passed" if name == "transE" else None})
        trainers[name] = tr

    # one step on the card against the CPU's, from one init: the loss,
    # the gradients, the tables after Adam; the card's step leaves its
    # gather_rows backward inputs for the K1 records
    rng = np.random.default_rng(seed)
    step_check, stash = {}, {}
    for name in ("transE", "rotatE"):
        card = trainers[name]
        cpu = KgeTrainer(card.cfg, splits_memo["splits"][0], device="cpu")
        pos = card._pos[:card.batch].cpu()
        negs = torch.from_numpy(rng.integers(0, card.num_nodes,
                                             (card.batch, card.NUM_NEGS)))
        out = {}
        for tr in (cpu, card):
            model = tr.init_model(seed)
            opt = make_optimizer(tr.cfg, model.parameters())
            stash[name] = {}
            with _gather_backward_watch({}, stash[name]):
                loss = tr.step(model, opt, pos.to(tr.device),
                               negs.to(tr.device), "head-batch")
            out[tr.device.type] = (
                float(loss),
                {k: p.grad.cpu() for k, p in model.named_parameters()},
                {k: v.detach().cpu() for k, v in model.state_dict().items()})
            del model, opt
        (l_cpu, g_cpu, s_cpu), (l_card, g_card, s_card) = (out["cpu"],
                                                           out["cuda"])
        np.testing.assert_allclose(l_card, l_cpu, rtol=1e-5)
        step_check[name] = {"loss_cpu": l_cpu, "loss_card": l_card,
                            **grads_close(g_card, g_cpu, f"kge {name}"),
                            **adam_close(s_card, s_cpu, card.cfg.lr, 1,
                                         f"kge {name}")}
        del cpu, out
    trainers.clear()
    n, h = card.num_nodes, card.cfg.hidden_channels
    k1_kge = [
        gather_k1_record("kge", f"segscan_add_f32 (KGE {name} {table} "
                                f"backward, W={width})",
                         stash[name].pop((rows, width)), rows,
                         gathers[name][rows, width])
        for name, table, rows, width in (
            ("transE", "entity", n, h), ("rotatE", "entity", n, 2 * h),
            ("transE", "relation", 1, h))]
    stash.clear()
    return {"phase": "kge", "dataset": "ogbl-collab", "runs": runs,
            "card_vs_cpu_step": step_check,
            "tolerance": f"gradients: {GRAD_TOLERANCE}; tables: "
                         f"{ADAM_TOLERANCE}"}, k1_kge


# ------------------------------------------------------------------ dp --

DP_ELPH_SAMPLES = 65536         # train_elph's first epoch: 64 steps
DP_PROFILE_STEPS = {"BUDDY": 50, "ELPH": 20}
DP_TIMED_STEPS = 10             # steps a turn, unsharded against mesh
# the two-rank check on one card: small, on the bundled synth-ba graph
DP_SMALL = ["--dataset_name", "synth-ba", "--hidden_channels", "64",
            "--epochs", "2", "--eval_steps", "1", "--checkpoint_every", "1"]
DP_TWO_RANKS = ["--mesh_shape", "2", "--mesh_axes", "data"]
DP_LOSS_RTOL = 1e-4   # epoch losses, a mesh run against the run without


def _metric_rows(ckpt: str) -> list:
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _kept_run(cfg) -> tuple:
    """``runners.run.run(cfg)`` on the card with the trainer it built
    kept, K1's counts and the collectives' set to 0 just before it and
    read just after; returns (trainer, results, run seconds, metric rows,
    K1 launches, collectives, peak memory)."""
    import torch

    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.parallel import collectives
    from subgraph_sketching_tpu_torch.runners import run as runner

    kept = []
    build = runner.build_trainer

    def keep(*a, **k):
        kept.append(build(*a, **k))
        return kept[-1]

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _reset_k1()
    collectives.reset_collectives()
    t0 = time.perf_counter()
    with _patched(runner, "build_trainer", keep):
        results = runner.run(cfg, device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    return (kept[-1], results, run_s, _metric_rows(cfg.checkpoint_dir),
            dict(segscan.launches), dict(collectives.collectives),
            torch.cuda.max_memory_allocated())


def _unsharded(trainer):
    """The same staged trainer without its mesh: the single-device
    step on the same data, for timing in turns."""
    import copy

    from subgraph_sketching_tpu_torch.train.losses import get_loss
    plain = copy.copy(trainer)
    plain.mesh = None
    plain.loss_fn = get_loss(trainer.cfg.loss)
    return plain


def _dp_profile(trainer, steps: int, seed: int) -> dict:
    """A meshed trainer's steps and the same trainer's without its mesh,
    each ``steps`` steps under torch.profiler
    (``parallel.breakdown.profile_steps``: idle share, the collectives'
    calls, bytes and NCCL device ms a step, the host's self ms by
    operator and in ``all_reduce``), K1 adds a step on the mesh, the
    operators that the mesh adds host time to (``host_excess_by_op``:
    ms a step on the mesh less unsharded); then the step ms by the host
    clock, unsharded and on the mesh in turns (unsharded, mesh, mesh,
    unsharded), DP_TIMED_STEPS steps each, without the profiler."""
    import torch

    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.parallel import breakdown
    from subgraph_sketching_tpu_torch.train.loops import make_optimizer

    cfg, bs = trainer.cfg, trainer.cfg.batch_size
    g = torch.Generator(device="cuda").manual_seed(seed)
    order = torch.randperm(trainer.num_links("train"), generator=g,
                           device="cuda")
    plain = _unsharded(trainer)
    prof = {}
    for what, tr in (("mesh", trainer), ("unsharded", plain)):
        model = tr.init_model(0)
        opt = make_optimizer(cfg, model.parameters())
        prof[what] = breakdown.profile_steps(tr, model, opt, order, steps,
                                             seed, on_window=_reset_k1)
        if what == "mesh":
            adds = segscan.launches["segscan_add_f32"]
    mesh, base = prof["mesh"], prof["unsharded"]
    if mesh["collective_calls"] == 0:
        raise AssertionError(f"dp: {steps} {cfg.model} steps on the mesh "
                             f"issued no collective")
    ops = set(mesh["host_ops"]) | set(base["host_ops"])
    excess = sorted(
        ([k, mesh["host_ops"].get(k, [0, 0])[0]
          - base["host_ops"].get(k, [0, 0])[0],
          mesh["host_ops"].get(k, [0, 0])[1]
          - base["host_ops"].get(k, [0, 0])[1]] for k in ops),
        key=lambda r: -abs(r[1]))[:12]

    def timed(tr) -> float:
        m = tr.init_model(0)
        o = make_optimizer(cfg, m.parameters())
        return breakdown.timed_steps(tr, m, o, order, DP_TIMED_STEPS, seed)

    step_ms = {"unsharded": [], "mesh": []}
    for what, tr in [("unsharded", plain), ("mesh", trainer),
                     ("mesh", trainer), ("unsharded", plain)]:
        step_ms[what].append(timed(tr))
    for p in prof.values():
        del p["host_ops"]
    return {"steps": steps,
            "step_ms_profiled": mesh["step_ms"],
            "device_busy_ms": mesh["device_busy_ms"] * steps,
            "device_idle_share": mesh["device_idle_share"],
            "collectives_per_step": mesh["collective_calls"],
            "collective_bytes_per_step": mesh["collective_bytes"],
            "nccl_device_ms_per_step": mesh["nccl_device_ms"],
            "all_reduce_host_ms_per_step": mesh["all_reduce_host_ms"],
            "k1_add_launches_per_step": adds / steps,
            "step_ms_in_turns": step_ms,
            "host_op_self_ms": {"mesh": mesh["host_op_self_ms"],
                                "unsharded": base["host_op_self_ms"]},
            "host_excess_by_op": excess,
            "profiled": prof,
            "top_kernels": mesh["top_kernels"][:8]}


def _dp_step_k1(trainer, seed: int, phase: str = "dp") -> list:
    """K1 on one meshed ELPH step's real inputs: the first PlanSpmm
    forward, the first PlanSpmm backward and gather_rows' backward of a
    step (K1's inputs taken as the step passes them), each held against
    its plain version and timed by ``k1_record``.  On a graph axis the
    PlanSpmm is the rank's edge block's (``EdgeShardSpmm.spmm``)."""
    import torch

    from subgraph_sketching_tpu_torch.ops import segment_scan
    from subgraph_sketching_tpu_torch.train.loops import make_optimizer

    plan = trainer._data["train"]["plan"]
    plan = getattr(plan, "spmm", plan)
    which = {plan.fwd.sub_ptr.data_ptr(): "PlanSpmm forward",
             plan.bwd.sub_ptr.data_ptr(): "PlanSpmm backward"}
    stash = {}
    merge = segment_scan.segment_combine

    def watched(v, x, op, ptr):
        what = which.get(ptr.data_ptr(), "gather_rows backward")
        if op == "add" and what not in stash:
            stash[what] = (v.detach().clone(), x.detach().clone(),
                           ptr.clone())
        return merge(v, x, op, ptr)

    model = trainer.init_model(0)
    opt = make_optimizer(trainer.cfg, model.parameters())
    g = torch.Generator(device="cuda").manual_seed(seed)
    order = torch.randperm(trainer.num_links("train"), generator=g,
                           device="cuda")[:trainer.cfg.batch_size]
    with _patched(segment_scan, "segment_combine", watched):
        trainer.run_epoch(model, opt, seed, order=order)
    torch.cuda.synchronize()
    if len(stash) != 3:
        raise AssertionError(f"{phase}: one ELPH step passed K1 "
                             f"{sorted(stash)}")
    records = []
    for what, (v, x, ptr) in stash.items():
        name = f"segscan_add_f32 ({phase} ELPH step, {what}, W={v.shape[1]})"
        records.append({"phase": phase, "name": name,
                        **k1_record(name, "add", v, x, ptr)})
    del stash
    return records


def _world1(cfg, reference: dict, losses_of_reference: list) -> tuple:
    """One runner run at world size 1 on NCCL (``cfg`` with
    ``--mesh_shape 1``), held against the same run without a mesh: each
    epoch loss within DP_LOSS_RTOL; then its steps profiled and timed
    (``_dp_profile``).  Returns (the kept trainer, record)."""
    import math

    trainer, results, run_s, rows, launches, coll, peak = _kept_run(cfg)
    if trainer.mesh is None or trainer.mesh.world_size != 1:
        raise AssertionError(f"dp: the {cfg.model} run built no mesh")
    losses = [r["rep0_loss"] for r in rows]
    for got, want in zip(losses, losses_of_reference):
        if not math.isfinite(got) or abs(got - want) > DP_LOSS_RTOL * abs(
                want):
            raise AssertionError(f"dp: {cfg.model} at world size 1 on the "
                                 f"mesh, epoch losses {losses}; without a "
                                 f"mesh {losses_of_reference}")
    steps = math.ceil(min(cfg.train_samples, trainer.num_links("train"))
                      / cfg.batch_size)
    record = {"phase": "dp", "part": f"world1_{cfg.model.lower()}",
              "model": cfg.model, "dataset": cfg.dataset_name,
              "hidden_channels": cfg.hidden_channels,
              "batch_size": cfg.batch_size, "mesh_shape": cfg.mesh_shape,
              "backend": "nccl", "epochs": cfg.epochs,
              "check_determinism": cfg.check_determinism,
              "steps_per_epoch": steps, "run_s": run_s,
              "epoch_s": [r["rep0_train_time"] for r in rows],
              "step_ms_by_epoch": [r["rep0_train_time"] * 1e3 / steps
                                   for r in rows],
              "losses": losses, "losses_without_mesh": losses_of_reference,
              "loss_tolerance": f"rtol {DP_LOSS_RTOL} a epoch",
              "hits@100": [r["rep0_tmp_testHits@100"] / 100 for r in rows],
              "results": results, "without_mesh": reference,
              "k1_launches": launches, "collectives": coll,
              "peak_memory_bytes": peak,
              "profile": _dp_profile(trainer, DP_PROFILE_STEPS[cfg.model],
                                     seed=31)}
    return trainer, record


def _two_ranks(name: str, args: list, program: list = None) -> list:
    """``runners.run`` (or ``program``, a script and its arguments) as two
    ranks on cuda:0, launched by ``torch.distributed.run --standalone``
    (which picks its rendezvous port itself; gloo, the default where the
    local ranks outnumber the cards), each rank's output to a file;
    returns each rank's output, killing the launch if it does not finish,
    and raises unless both ranks exit 0 as ranks 0 and 1 of one group."""
    import subprocess
    root = os.path.dirname(os.path.abspath(__file__))
    logs = tempfile.mkdtemp(prefix=f"smoke_dp_{name}_")
    if program is None:
        program = ["-m", "subgraph_sketching_tpu_torch.runners.run", *args,
                   "--device", "cuda:0"]
    try:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", "--redirects", "3", "--log_dir", logs,
             *program],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        try:
            launcher = proc.communicate(timeout=300)[0]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        outs = []
        for r in range(2):
            text = ""
            for stream in ("stdout", "stderr"):
                for path in glob.glob(os.path.join(
                        logs, "**", "attempt_0", str(r), f"{stream}.log"),
                        recursive=True):
                    with open(path) as f:
                        text += f.read()
            outs.append(text)
        for r, out in enumerate(outs):
            if proc.returncode != 0 or f"(rank {r} of 2)" not in out:
                raise AssertionError(
                    f"dp {name}: the launch exited {proc.returncode}; "
                    f"rank {r}:\n{out[-4000:]}\nlauncher:\n"
                    f"{launcher[-4000:]}")
        return outs
    finally:
        shutil.rmtree(logs, ignore_errors=True)


class _Launch:
    """A two-rank launch (``_two_ranks`` of ``program``), or a call of
    ``target``, in a thread of its own: ``start()``; ``wait()`` for its
    end; ``result()`` waits, raises its failure and returns its seconds
    from start to end; ``value``: what ``target`` returned."""

    def __init__(self, name: str, program: list = None, target=None):
        self.name, self.program = name, program
        self.target = target or (lambda: _two_ranks(name, [],
                                                    program=program))
        self.thread = self.failure = self.seconds = self.value = None

    def _run(self, t0: float) -> None:
        try:
            self.value = self.target()
        except Exception as e:   # raised by result()
            self.failure = e
        self.seconds = time.perf_counter() - t0

    def start(self) -> None:
        import threading
        self.thread = threading.Thread(target=self._run,
                                       args=(time.perf_counter(),))
        self.thread.start()

    def wait(self) -> None:
        self.thread.join()

    def result(self) -> float:
        self.wait()
        if self.failure is not None:
            raise AssertionError(f"{self.name}: the launch failed: "
                                 f"{self.failure}")
        return self.seconds


def _gloo_two_ranks(work: str) -> dict:
    """BUDDY and ELPH on two gloo ranks sharing cuda:0 (DP_SMALL on
    DP_TWO_RANKS, --heartbeat_dir, a checkpoint every epoch; the runner
    checks after every epoch that the ranks hold the same state bits),
    the two models' launches at once, BUDDY's followed by its ranks
    restarted with --resume from its epoch-1 checkpoint; meanwhile the
    same runs at world size 1 on the card in this process.  Each
    two-rank run's epoch losses within DP_LOSS_RTOL of world size 1, and
    the resumed run's epoch-2 checkpoint bit-equal to the uninterrupted
    run's."""
    import threading

    import torch

    from subgraph_sketching_tpu_torch.runners import run as runner

    models = ("BUDDY", "ELPH")
    failures, seconds, resumed = {}, {}, []
    src = os.path.join(work, "BUDDY_ck")
    ck = os.path.join(work, "BUDDY_resume")

    def launch(model):
        try:
            _two_ranks(model, DP_SMALL + DP_TWO_RANKS + [
                "--model", model,
                "--checkpoint_dir", os.path.join(work, f"{model}_ck"),
                "--heartbeat_dir", os.path.join(work, f"{model}_hb")])
            seconds[model] = time.perf_counter() - t0
            if model != "BUDDY":
                return
            # resume: the run's epoch-1 checkpoint, both ranks restarted
            shutil.copytree(src, ck)
            for f in ("step_2.pt", "meta_step_2.json"):
                os.remove(os.path.join(ck, f))
            t1 = time.perf_counter()
            resumed.extend(_two_ranks("resume", DP_SMALL + DP_TWO_RANKS + [
                "--model", "BUDDY", "--checkpoint_dir", ck,
                "--heartbeat_dir", os.path.join(work, "BUDDY_hb_resume"),
                "--resume"]))
            seconds["resume"] = time.perf_counter() - t1
        except Exception as e:   # reported below, with the other model's
            failures[model] = e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=launch, args=(m,)) for m in models]
    for t in threads:
        t.start()
    want = {}
    for model in models:
        # the same run at world size 1 on the card, without a mesh
        one = os.path.join(work, f"{model}_one")
        runner.run(runner.config_from_parsed(runner.make_parser().parse_args(
            DP_SMALL + ["--model", model, "--checkpoint_dir", one])),
            device="cuda")
        want[model] = [r["rep0_loss"] for r in _metric_rows(one)]
    for t in threads:
        t.join()
    all_s = time.perf_counter() - t0
    if failures:
        raise AssertionError(f"dp: two-rank runs failed: {failures}")
    out = {}
    for model in models:
        got = [r["rep0_loss"] for r in _metric_rows(
            os.path.join(work, f"{model}_ck"))]
        if len(got) != 2 or any(abs(a - b) > DP_LOSS_RTOL * abs(b)
                                for a, b in zip(got, want[model])):
            raise AssertionError(f"dp: {model} on two gloo ranks, epoch "
                                 f"losses {got}; at world size 1 "
                                 f"{want[model]}")
        out[model] = {"losses": got, "losses_world1": want[model],
                      "loss_tolerance": f"rtol {DP_LOSS_RTOL} a epoch"}
    if not all("resumed from checkpoint step 1" in o for o in resumed):
        raise AssertionError("dp: the restarted ranks did not resume from "
                             "step 1")
    a = torch.load(os.path.join(src, "step_2.pt"), map_location="cpu")
    b = torch.load(os.path.join(ck, "step_2.pt"), map_location="cpu")
    same = all(torch.equal(v, b["model"][k]) for k, v in a["model"].items())
    same &= all(torch.equal(v, b["optimizer"]["state"][i][k])
                for i, st in a["optimizer"]["state"].items()
                for k, v in st.items())
    if not same:
        raise AssertionError("dp: the resumed two-rank run ended apart from "
                             "the uninterrupted one")
    return {"phase": "dp", "part": "gloo_two_ranks_one_card",
            "backend": "gloo", "device": "cuda:0 for both ranks",
            "args": " ".join(DP_SMALL + DP_TWO_RANKS), "runs": out,
            "launches_s": all_s, "run_s": {k: seconds[k] for k in models},
            "resume_s": seconds["resume"],
            "ranks_agree": "checked by the runner after every epoch "
                           "(sha256 of every state tensor, all ranks)",
            "resume": "epoch-2 checkpoint bit-equal to the uninterrupted "
                      "run's"}


def _degrees_twice(g, seed: int) -> dict:
    """gcn_norm's degrees of the synth-ws-200000 train graph with
    non-integer weights (seeded): K1's ordered add, bit-equal across two
    calls, within ADD_TOLERANCE of index_add_."""
    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.ops.graph_ops import degrees_from_edges

    n = g.num_nodes
    ei = torch.from_numpy(g.edge_index.astype(np.int64)).to("cuda")
    w = torch.from_numpy(np.random.default_rng(seed).random(
        ei.shape[1]).astype(np.float32) * 3).to("cuda")
    _reset_k1()
    first = degrees_from_edges(ei, w, n)
    second = degrees_from_edges(ei, w, n)
    torch.cuda.synchronize()
    adds = segscan.launches["segscan_add_f32"]
    want = torch.zeros(n, device="cuda").index_add_(0, ei[1], w)
    scale = torch.zeros(n, device="cuda").index_add_(0, ei[1], w.abs())
    err = (first - want).abs()
    if adds != 2 or not torch.equal(first, second) \
            or bool((err > 1e-4 * scale + 1e-6).any()):
        raise AssertionError(f"dp: gcn_norm degrees: {adds} K1 adds, equal "
                             f"across calls {torch.equal(first, second)}, "
                             f"max |err| vs index_add_ {float(err.max())}")
    return {"phase": "dp", "part": "gcn_norm_degrees", "nodes": n,
            "edges": int(ei.shape[1]), "k1_add_launches": adds,
            "bit_equal_across_two_calls": True,
            "max_abs_err_vs_index_add": float(err.max()),
            "tolerance": ADD_TOLERANCE}


def phase_dp(splits, train: dict, elph: dict, alongside=()) -> tuple:
    """Data parallelism (parallel/, the trainers' data axis) on the card.
    (a) world size 1 on NCCL at full width: BUDDY at Config defaults on
    synth-ws-200000 through runners.run with --mesh_shape 1 (1 epoch of
    BUDDY_TRAIN_SAMPLES links, --check_determinism) held against the
    first epoch of the train
    phase's run without a mesh, and ELPH at Config defaults with
    --mesh_shape 1 (one epoch of DP_ELPH_SAMPLES links) held against the
    train_elph run's first epoch;
    each profiled (step ms on the mesh and unsharded, idle share,
    collectives a step, K1 adds a step); K1 on one meshed ELPH step's
    real inputs.  (b) two gloo ranks on cuda:0 (``_gloo_two_ranks``).
    (c) ``parallel.dryrun.dryrun_multichip(1)`` on NCCL.  Then gcn_norm's
    degrees on the card (``_degrees_twice``).  ``alongside``: launches
    (:class:`_Launch`) started with (b) and waited for after it, so that
    they share (b)'s untimed window and no timed one.  Returns (the K1
    records, the phase's records)."""
    import dataclasses

    import torch

    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.ops.cuda_build import BUILD_DIR
    from subgraph_sketching_tpu_torch.parallel import multihost
    from subgraph_sketching_tpu_torch.parallel.dryrun import dryrun_multichip

    work = tempfile.mkdtemp(prefix="smoke_dp_")
    records = []
    t0 = time.perf_counter()
    try:
        multihost.initialize("file://" + os.path.join(work, "store"),
                             num_processes=1, process_id=0, backend="nccl",
                             device="cuda:0")
        # one epoch (the train phase ran two): room for mesh_graph
        buddy_cfg = Config(dataset_name="synth-ws-200000", epochs=1,
                           eval_steps=1, check_determinism=True,
                           train_samples=BUDDY_TRAIN_SAMPLES,
                           mesh_shape=[1], mesh_axes=["data"],
                           checkpoint_dir=os.path.join(work, "buddy"))
        _, buddy = _world1(buddy_cfg, {k: train[k] for k in (
            "run_s", "epochs")}, [e["loss"] for e in train["epochs"]])
        records.append(buddy)
        elph_cfg = dataclasses.replace(
            buddy_cfg, model="ELPH", epochs=1, check_determinism=False,
            train_samples=DP_ELPH_SAMPLES,
            checkpoint_dir=os.path.join(work, "elph"))
        trainer, elph_dp = _world1(elph_cfg, {"epochs": elph["epochs"][:1]},
                                   [elph["epochs"][0]["loss"]])
        k1 = _dp_step_k1(trainer, seed=32)
        for r in k1:
            r["launches"] = elph_dp["k1_launches"]["segscan_add_f32"]
        del trainer
        records.append(elph_dp)
        torch.cuda.empty_cache()   # the launches' ranks share this card
        for launch in alongside:
            launch.start()
        try:
            records.append(_gloo_two_ranks(work))
        finally:
            for launch in alongside:
                launch.wait()
        t1 = time.perf_counter()
        dry = dryrun_multichip(1, device="cuda")
        records.append({"phase": "dp", "part": "dryrun_multichip",
                        "ranks": 1, "backend": "nccl", **dry,
                        "s": time.perf_counter() - t1})
        records.append(_degrees_twice(splits["train"].graph, seed=33))
    finally:
        multihost.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    records.append({"phase": "dp", "part": "summary",
                    "phase_s": time.perf_counter() - t0})
    return k1, records


# ---------------------------------------------------------- mesh_graph --

MG_SAMPLES = 65536      # train_elph's first epoch: 64 steps of batch 1024
MG_PROFILE_STEPS = 20
MG_STREAM_EDGES = 100   # undirected train edges deleted, then inserted
MG_SERVE_LINKS = 65536
# the two-rank check on one card, as the dp phase's
MG_SMALL = ["--dataset_name", "synth-ba", "--hidden_channels", "64",
            "--epochs", "2", "--eval_steps", "1"]
MG_TWO_RANKS = ["--mesh_shape", "2", "--mesh_axes", "graph",
                "--memory_sharded", "1"]
MG_LOSS_RTOL = 1e-5     # two gloo ranks against world size 1, a epoch
MG_ELPH_RTOL = 1e-4     # the memory-sharded ELPH epoch against train_elph's
MG_SF_TOLERANCE = dict(rtol=1e-5, atol=1e-4)
# what each mesh_graph K1 entry's launches count, by the use its name gives
MG_LAUNCHES_OF = {
    "node-sharded hop local merge": "this instance's K1 launches in the "
    "world-size-1 node-sharded build (2 hops)",
    "edge-sharded build": "this instance's K1 launches in the world-size-1 "
    "edge-sharded build (2 hops)",
    "node-sharded hop halo merge": "this instance's K1 launches in rank "
    "0's node-sharded build at D = 2 (local and halo merges, 2 hops)",
    "ELPH step": "segscan_add_f32 in the memory-sharded ELPH run at world "
    "size 1, all three ELPH add uses together"}

# one rank of the two-rank check (run by torch.distributed.run from the
# checkout's root): the node-sharded build of the synth-ba train graph
# at D = 2 (its shard, the halo route, K1's launches, K1 on the rank's
# halo merge held and timed), then the memory-sharded ELPH run and the
# graph-mesh BUDDY run through runners.run
MG_RANK = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
work = sys.argv[1]
import numpy as np
import torch
from subgraph_sketching_tpu_torch.parallel import multihost
multihost.initialize(device="cuda:0")
try:
    import chip_smoke
    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.graph.datasets import get_data
    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.ops.segment_scan import (
        _reduce_slots, with_identity_row)
    from subgraph_sketching_tpu_torch.parallel.collectives import (
        halo_exchange, halo_route)
    from subgraph_sketching_tpu_torch.parallel.mesh import make_mesh
    from subgraph_sketching_tpu_torch.parallel.node_sharded import (
        ShardedHop, make_node_partition, node_sharded_build_hash_tables)
    from subgraph_sketching_tpu_torch.runners import run
    from subgraph_sketching_tpu_torch.sketch.params import SketchParams

    rank = multihost.rank()
    g = get_data(Config(dataset_name="synth-ba"))[0]["train"].graph
    params = SketchParams()
    mesh = make_mesh([2], ["graph"], "cuda:0")
    group = mesh.group("graph")
    plan = make_node_partition(g.edge_index, g.num_nodes, 2)
    hop = ShardedHop(plan, mesh.axis_index("graph"), group, "cuda:0")
    chip_smoke._reset_k1()
    sk = node_sharded_build_hash_tables(plan, params, mesh, hop=hop)
    torch.cuda.synchronize()
    launches = dict(segscan.launches)
    np.savez(os.path.join(work, f"shard{rank}.npz"),
             minhash=sk.minhash.cpu().numpy(), hll=sk.hll.cpu().numpy(),
             cards=sk.cards.cpu().numpy())
    # K1 on this rank's halo merges, on the hop-0 rows (both ranks run
    # the exchange, a collective)
    k1 = []
    for op, t in (("min", sk.minhash[0]), ("max", sk.hll[0])):
        recv = halo_exchange(hop._send(t, op), group, op).wait().reshape(
            -1, t.shape[1])
        acc = hop.local.reduce(t, op)
        v = _reduce_slots(with_identity_row(recv, op), hop.halo.gather_idx,
                          None, hop.halo.sub_len, op).contiguous()
        name = (f"{'segscan_min_i32' if op == 'min' else 'segscan_max_i8'} "
                f"(mesh_graph, node-sharded hop halo merge, D=2, rank "
                f"{rank})")
        k1.append({"name": name, "launches": launches[name.split()[0]],
                   **chip_smoke.k1_record(name, op, v, acc,
                                          hop.halo.sub_ptr)})
    record = {"rank": rank, "route": halo_route(group, "cuda:0"),
              "halo_rows_per_hop": plan.halo_rows_per_dev,
              "halo_width": plan.halo_width,
              "rows_per_rank": plan.shard_size,
              "padded_nodes": plan.padded_nodes,
              "local_edges": hop.local_edges, "halo_edges": hop.halo_edges,
              "k1_launches_build": launches, "k1": k1,
              "perm": plan.perm.tolist()}
    small = json.loads(os.environ["MG_SMALL"])
    for model in ("ELPH", "BUDDY"):
        run.main(small + json.loads(os.environ["MG_TWO_RANKS"]) + [
            "--model", model, "--device", "cuda:0",
            "--checkpoint_dir", os.path.join(work, model + "_ck")])
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)
finally:
    multihost.shutdown()
"""


def _node_order(sk, perm):
    """A node-sharded stack set at D = 1 (the whole table, position
    order) in node order."""
    from subgraph_sketching_tpu_torch.sketch.params import Sketches
    return Sketches(minhash=sk.minhash[:, perm], hll=sk.hll[:, perm],
                    cards=sk.cards[perm])


def _mg_sharded_build(g, cfg, params) -> tuple:
    """World size 1 on the graph axis: the locality partition at D = 1,
    the node-sharded build (K1 counted per hop by op), bit-equal in node
    order to the plan route's build; the sharded hop timed beside the
    plan route's hop; the bytes the rank holds; K1 on the hop's local
    merges and on the edge-sharded build's, held and timed.  Returns (the
    record, the K1 records, the mesh, the stacks, the partition)."""
    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.ops.segment_scan import (
        SortedSegmentPlan, make_auto_plan,
    )
    from subgraph_sketching_tpu_torch.parallel.collectives import halo_route
    from subgraph_sketching_tpu_torch.parallel.dist_sketch import (
        edge_block, edge_sharded_build_hash_tables,
    )
    from subgraph_sketching_tpu_torch.parallel.mesh import make_mesh
    from subgraph_sketching_tpu_torch.parallel.node_sharded import (
        ShardedHop, make_node_partition, node_sharded_build_hash_tables,
    )
    from subgraph_sketching_tpu_torch.sketch.elph import build_hash_tables

    n = g.num_nodes
    mesh = make_mesh([1], ["graph"], "cuda")
    t0 = time.perf_counter()
    plan = make_node_partition(g.edge_index, n, 1)
    partition_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hop = ShardedHop(plan, 0, mesh.group("graph"), "cuda",
                     cfg.max_gather_slots)
    torch.cuda.synchronize()
    plans_s = time.perf_counter() - t0
    if not isinstance(hop.local, SortedSegmentPlan):
        raise AssertionError("mesh_graph: the local plan chunked")
    node_sharded_build_hash_tables(plan, params, mesh, hop=hop)  # warm
    torch.cuda.synchronize()
    _reset_k1()
    t0 = time.perf_counter()
    sk = node_sharded_build_hash_tables(plan, params, mesh, hop=hop)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = dict(segscan.launches)
    ref_plan = make_auto_plan(g.edge_index, n, max_slots=cfg.max_gather_slots,
                              device="cuda")
    ref = build_hash_tables(g.edge_index, n, params, plan=ref_plan)
    perm = torch.from_numpy(plan.perm.astype(np.int64)).to("cuda")
    got = _node_order(sk, perm)
    if not (torch.equal(got.minhash, ref.minhash)
            and torch.equal(got.hll, ref.hll)
            and torch.equal(got.cards, ref.cards)):
        raise AssertionError("mesh_graph: the node-sharded stacks differ "
                             "from the plan route's in node order")
    mh0, hll0 = sk.minhash[0], sk.hll[0]
    hop_ms = cuda_ms(lambda: hop(mh0, hll0), iters=10)
    plan_hop_ms = cuda_ms(lambda: (ref_plan.reduce(ref.minhash[0], "min"),
                                   ref_plan.reduce(ref.hll[0], "max")),
                          iters=10)
    held = sum(t.numel() * t.element_size() for t in sk)
    k1 = []
    for op, t, inst in (("min", mh0, "segscan_min_i32"),
                        ("max", hll0, "segscan_max_i8")):
        name = f"{inst} (mesh_graph, node-sharded hop local merge, D=1)"
        v = hop.local.reduce_subruns(t, op).contiguous()
        k1.append({"phase": "mesh_graph", "name": name,
                   "launches": launches[inst],
                   **k1_record(name, op, v, t, hop.local.sub_ptr)})
    # the edge-sharded build at world size 1: its plan is the rank's edge
    # block's (the whole graph here), merged by K1, then the MIN / MAX
    # all-reduce over the graph axis
    _reset_k1()
    t0 = time.perf_counter()
    esk = edge_sharded_build_hash_tables(
        g.edge_index, n, params, mesh,
        max_gather_slots=cfg.max_gather_slots)
    torch.cuda.synchronize()
    edge_s = time.perf_counter() - t0
    edge_launches = dict(segscan.launches)
    if not (torch.equal(esk.minhash, ref.minhash)
            and torch.equal(esk.hll, ref.hll)):
        raise AssertionError("mesh_graph: the edge-sharded stacks differ "
                             "from the plan route's")
    eplan = make_auto_plan(edge_block(g.edge_index, None, mesh), n,
                           max_slots=cfg.max_gather_slots, device="cuda")
    for op, t, inst in (("min", ref.minhash[0], "segscan_min_i32"),
                        ("max", ref.hll[0], "segscan_max_i8")):
        name = f"{inst} (mesh_graph, edge-sharded build, D=1)"
        v = eplan.reduce_subruns(t, op).contiguous()
        k1.append({"phase": "mesh_graph", "name": name,
                   "launches": edge_launches[inst],
                   **k1_record(name, op, v, t, eplan.sub_ptr)})
    del ref, esk, eplan, ref_plan
    per_hop = {k: v / params.max_hops for k, v in launches.items() if v}
    record = {"phase": "mesh_graph", "part": "node_sharded_build",
              "ranks": 1, "backend": "nccl", "nodes": n,
              "edges": int(g.edge_index.shape[1]),
              "partition": "locality (the identity at D = 1, as the JAX "
                           "package's make_node_partition gives it)",
              "identity_perm": plan.is_identity_perm,
              "halo_rows_per_hop": plan.halo_rows_per_dev,
              "halo_width": plan.halo_width,
              "route": halo_route(mesh.group("graph"), "cuda"),
              "rows_per_rank": plan.shard_size,
              "bytes_held_per_rank": held,
              "partition_s": partition_s, "plans_s": plans_s,
              "build_s": build_s, "k1_launches_per_hop": per_hop,
              "sharded_hop_ms": hop_ms, "plan_route_hop_ms": plan_hop_ms,
              "edge_sharded_build_s": edge_s,
              "edge_sharded_k1_launches": edge_launches,
              "stacks": "bit-equal in node order to the plan route's"}
    return record, k1, mesh, sk, plan


def _mg_buddy_and_serving(splits, work: str, seed: int) -> list:
    """BUDDY preprocessing on ``--mesh_shape 1 --mesh_axes graph``
    against the unsharded preprocessing (subgraph features within
    MG_SF_TOLERANCE); a seeded BUDDY saved under both configs and served
    through runners/serve.py (the graph mesh's at world size 1, its
    tables node-sharded at D = 1): scores equal; one delete and one
    insert batch of MG_STREAM_EDGES undirected edges on the
    position-ordered state, bit-equal in node order to node-sharded
    rebuilds of the changed graph."""
    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.graph.preprocess import (
        build_link_dataset, sketch_params_from_config,
    )
    from subgraph_sketching_tpu_torch.parallel.mesh import make_mesh
    from subgraph_sketching_tpu_torch.parallel.node_sharded import (
        make_node_partition, node_sharded_build_hash_tables,
    )
    from subgraph_sketching_tpu_torch.runners import serve
    from subgraph_sketching_tpu_torch.serving import (
        LinkScorer, save_buddy_checkpoint,
    )

    cfg = Config(dataset_name="synth-ws-200000")
    cfg_mesh = Config(dataset_name="synth-ws-200000", mesh_shape=[1],
                      mesh_axes=["graph"])
    records = []
    t0 = time.perf_counter()
    ds_mesh = build_link_dataset(splits["train"], cfg_mesh, "train",
                                 device="cuda")
    mesh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = build_link_dataset(splits["train"], cfg, "train", device="cuda")
    plain_s = time.perf_counter() - t0
    if ds_mesh.sketch_perm is None:
        raise AssertionError("mesh_graph: the graph-mesh preprocessing "
                             "kept no permutation")
    err = np.abs(ds_mesh.subgraph_features - ds.subgraph_features)
    np.testing.assert_allclose(ds_mesh.subgraph_features,
                               ds.subgraph_features, **MG_SF_TOLERANCE)
    records.append({"phase": "mesh_graph", "part": "buddy_preprocessing",
                    "links": len(ds.links), "graph_mesh_s": mesh_s,
                    "unsharded_s": plain_s,
                    "max_abs_err_sf": float(err.max()),
                    "tolerance": str(MG_SF_TOLERANCE)})
    width = ds.x.shape[-1]
    del ds
    model = seeded_buddy(cfg, width, seed)
    rng = np.random.default_rng(seed)
    n = splits["train"].graph.num_nodes
    queries = os.path.join(work, "queries.npy")
    np.save(queries, rng.integers(0, n, (MG_SERVE_LINKS, 2)).astype(np.int32))
    scores, serve_s = {}, {}
    for what, c in (("graph_mesh", cfg_mesh), ("unsharded", cfg)):
        ck = os.path.join(work, f"buddy_{what}")
        save_buddy_checkpoint(ck, c, model)
        t0 = time.perf_counter()
        scores[what] = serve.main(["--checkpoint_dir", ck, "--links",
                                   queries, "--device", "cuda"])
        serve_s[what] = time.perf_counter() - t0
    err = np.abs(scores["graph_mesh"] - scores["unsharded"])
    if not np.allclose(scores["graph_mesh"], scores["unsharded"], rtol=1e-5,
                       atol=1e-5):
        raise AssertionError(f"mesh_graph: served scores differ, max |err| "
                             f"{float(err.max())}")
    records.append({"phase": "mesh_graph", "part": "serve",
                    "links": MG_SERVE_LINKS, "serve_s": serve_s,
                    "max_abs_err": float(err.max()),
                    "bit_equal": bool(np.array_equal(
                        scores["graph_mesh"], scores["unsharded"])),
                    "tolerance": "rtol 1e-5, atol 1e-5"})

    # streaming on the position-ordered state
    params = sketch_params_from_config(cfg)
    g = splits["train"].graph
    ei = g.edge_index
    und = ei[:, ei[0] < ei[1]]
    pick = und[:, rng.choice(und.shape[1], MG_STREAM_EDGES, replace=False)]
    keys = lambda a: a[0].astype(np.int64) * n + a[1]   # noqa: E731
    gone = np.isin(keys(ei), np.concatenate([keys(pick), keys(pick[::-1])]))
    mesh = make_mesh([1], ["graph"], "cuda")

    def rebuild(edges):
        part = make_node_partition(edges, n, 1)
        return part, node_sharded_build_hash_tables(part, params, mesh)

    original = type(ds_mesh.sketches)(*(t.clone()
                                        for t in ds_mesh.sketches))
    scorer = LinkScorer(cfg_mesh, model, ds_mesh, device="cuda")
    perm = scorer.sk_perm
    stream = {}
    for op, want_edges, want in (("delete", ei[:, ~gone], None),
                                 ("insert", ei, original)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        getattr(scorer, f"{op}_edges")(pick.T)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if want is None:
            part, want = rebuild(want_edges)
            want_perm = torch.from_numpy(part.perm.astype(np.int64)).cuda()
        else:
            want_perm = perm
        got, exp = _node_order(scorer.sk, perm), _node_order(want, want_perm)
        _hold_stacks(got, exp, f"mesh_graph {op}")
        stream[op] = {"wall_ms": wall * 1e3, **scorer.last_update_stats}
    records.append({"phase": "mesh_graph", "part": "streaming",
                    "undirected_edges": MG_STREAM_EDGES, "batches": stream,
                    "stacks": "bit-equal in node order to node-sharded "
                              "rebuilds (cards rtol 1e-6)"})
    return records


def _mg_elph(elph: dict, work: str, seed: int) -> tuple:
    """ELPH with --memory_sharded 1 --mesh_shape 1 --mesh_axes graph at
    Config defaults on synth-ws-200000 through runners.run (one epoch of
    MG_SAMPLES links), its epoch loss within MG_ELPH_RTOL of the
    train_elph run's first epoch; MG_PROFILE_STEPS steps under
    torch.profiler (step ms, idle share, K1 adds a step); K1 on one
    step's real inputs (the edge shard's PlanSpmm each way, gather_rows'
    backward).  Returns (record, K1 records)."""
    import math

    import torch

    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.parallel import breakdown
    from subgraph_sketching_tpu_torch.train.loops import make_optimizer

    cfg = Config(dataset_name="synth-ws-200000", model="ELPH", epochs=1,
                 eval_steps=1, train_samples=MG_SAMPLES, mesh_shape=[1],
                 mesh_axes=["graph"], memory_sharded=True,
                 checkpoint_dir=os.path.join(work, "elph"))
    trainer, results, run_s, rows, launches, coll, peak = _kept_run(cfg)
    data = trainer._data["train"]
    if not trainer._memory_sharded or "sk_shard" not in data:
        raise AssertionError("mesh_graph: the ELPH run staged no "
                             "node-sharded tables")
    loss, want = rows[0]["rep0_loss"], elph["epochs"][0]["loss"]
    if not math.isfinite(loss) or abs(loss - want) > MG_ELPH_RTOL * abs(want):
        raise AssertionError(f"mesh_graph: memory-sharded ELPH epoch loss "
                             f"{loss}, train_elph's {want}")
    steps = math.ceil(MG_SAMPLES / cfg.batch_size)
    g = torch.Generator(device="cuda").manual_seed(seed)
    order = torch.randperm(trainer.num_links("train"), generator=g,
                           device="cuda")
    model = trainer.init_model(0)
    opt = make_optimizer(cfg, model.parameters())
    prof = breakdown.profile_steps(trainer, model, opt, order,
                                   MG_PROFILE_STEPS, seed,
                                   on_window=_reset_k1)
    adds = segscan.launches["segscan_add_f32"] / MG_PROFILE_STEPS
    k1 = _dp_step_k1(trainer, seed, phase="mesh_graph")
    for r in k1:
        r["launches"] = launches["segscan_add_f32"]
    record = {"phase": "mesh_graph", "part": "elph_memory_sharded",
              "ranks": 1, "backend": "nccl", "mesh_shape": cfg.mesh_shape,
              "mesh_axes": cfg.mesh_axes, "memory_sharded": True,
              "steps": steps, "run_s": run_s,
              "epoch_s": rows[0]["rep0_train_time"],
              "step_ms": rows[0]["rep0_train_time"] * 1e3 / steps,
              "loss": loss, "train_elph_loss": want,
              "loss_tolerance": f"rtol {MG_ELPH_RTOL}",
              "hits@100": rows[0]["rep0_tmp_testHits@100"] / 100,
              "rows_per_rank": int(data["sk_shard"].minhash.shape[1]),
              "k1_launches": launches, "collectives": coll,
              "peak_memory_bytes": peak,
              "profiled_step_ms": prof["step_ms"],
              "device_idle_share": prof["device_idle_share"],
              "k1_adds_per_step": adds,
              "collectives_per_step": prof["collective_calls"],
              "top_kernels": prof["top_kernels"][:6]}
    del trainer
    return record, k1


def _mg_launch(work: str) -> _Launch:
    """MG_RANK on two gloo ranks sharing cuda:0, written to ``work``, as
    a :class:`_Launch` (not started)."""
    script = os.path.join(work, "mg_rank.py")
    with open(script, "w") as f:
        f.write(MG_RANK)
    os.environ["MG_SMALL"] = json.dumps(MG_SMALL)
    os.environ["MG_TWO_RANKS"] = json.dumps(MG_TWO_RANKS)
    return _Launch("mesh_graph", [script, work])


def _mg_two_ranks(work: str, launch: _Launch) -> dict:
    """MG_RANK on two gloo ranks sharing cuda:0 (the node-sharded build at
    D = 2, the memory-sharded ELPH and graph-mesh BUDDY runs of MG_SMALL
    on MG_TWO_RANKS; ``launch``, from ``_mg_launch``, which the dp phase
    ran beside its own two-rank launches), and the same two runs at world
    size 1 on the card in this process (``--mesh_shape 1 --mesh_axes
    graph``): the shards, in node order, bit-equal to the world-size-1
    build, and each run's epoch losses within MG_LOSS_RTOL."""
    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.graph.datasets import get_data
    from subgraph_sketching_tpu_torch.parallel.mesh import make_mesh
    from subgraph_sketching_tpu_torch.parallel.node_sharded import (
        make_node_partition, node_sharded_build_hash_tables,
    )
    from subgraph_sketching_tpu_torch.runners import run as runner
    from subgraph_sketching_tpu_torch.sketch.params import SketchParams

    launch_s = launch.result()
    want = {}
    world1 = ["--mesh_shape", "1", "--mesh_axes", "graph",
              "--memory_sharded", "1"]
    for model in ("ELPH", "BUDDY"):
        one = os.path.join(work, f"{model}_one")
        runner.run(runner.config_from_parsed(runner.make_parser().parse_args(
            MG_SMALL + world1 + ["--model", model, "--checkpoint_dir", one])),
            device="cuda")
        want[model] = [r["rep0_loss"] for r in _metric_rows(one)]
    g = get_data(Config(dataset_name="synth-ba"))[0]["train"].graph
    params = SketchParams()
    one = node_sharded_build_hash_tables(
        make_node_partition(g.edge_index, g.num_nodes, 1), params,
        make_mesh([1], ["graph"], "cuda"))
    ranks = []
    for r in range(2):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    perm = np.asarray(ranks[0]["perm"], np.int64)
    shards = [np.load(os.path.join(work, f"shard{r}.npz")) for r in range(2)]
    for key in ("minhash", "hll"):
        full = np.concatenate([s[key] for s in shards], axis=1)[:, perm]
        if not np.array_equal(full, getattr(one, key).cpu().numpy()):
            raise AssertionError(f"mesh_graph: the two ranks' {key} shards "
                                 f"differ from world size 1's")
    runs = {}
    for model in ("ELPH", "BUDDY"):
        got = [r["rep0_loss"] for r in _metric_rows(
            os.path.join(work, f"{model}_ck"))]
        if len(got) != 2 or any(abs(a - b) > MG_LOSS_RTOL * abs(b)
                                for a, b in zip(got, want[model])):
            raise AssertionError(f"mesh_graph: {model} on two gloo ranks, "
                                 f"epoch losses {got}; at world size 1 "
                                 f"{want[model]}")
        runs[model] = {"losses": got, "losses_world1": want[model]}
    del one
    torch.cuda.synchronize()
    return {"phase": "mesh_graph", "part": "gloo_two_ranks_one_card",
            "backend": "gloo", "device": "cuda:0 for both ranks",
            "args": " ".join(MG_SMALL + MG_TWO_RANKS),
            "halo_route": ranks[0]["route"],
            "halo_rows_per_hop": ranks[0]["halo_rows_per_hop"],
            "rows_per_rank": ranks[0]["rows_per_rank"],
            "padded_nodes": ranks[0]["padded_nodes"],
            "edges_by_rank": [[r["local_edges"], r["halo_edges"]]
                              for r in ranks],
            "k1_launches_build": [r["k1_launches_build"] for r in ranks],
            "stacks": "bit-equal in node order to world size 1's",
            "runs": runs, "loss_tolerance": f"rtol {MG_LOSS_RTOL} a epoch",
            "launches_s": launch_s, "k1": ranks[0]["k1"]}


def phase_mesh_graph(splits, elph: dict, work: str,
                     launch: _Launch) -> tuple:
    """The graph and lane axes' layer on the card (parallel/node_sharded,
    dist_sketch, the trainers' graph branches, serving on position-ordered
    state).  (a) World size 1 on NCCL at full width (synth-ws-200000,
    Config defaults): the node-sharded and edge-sharded builds
    (``_mg_sharded_build``), BUDDY preprocessing, serving and streaming on
    the graph mesh (``_mg_buddy_and_serving``), memory-sharded ELPH
    (``_mg_elph``).  (b) Two gloo ranks on cuda:0 (``_mg_two_ranks``:
    ``launch``, which ran during the dp phase, and its references).
    ``work``: the phase's directory (the launch's too), removed here.
    Returns (the K1 records, the phase's records)."""
    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.graph.preprocess import (
        sketch_params_from_config,
    )
    from subgraph_sketching_tpu_torch.parallel import multihost

    records, k1 = [], []
    t0 = time.perf_counter()
    try:
        multihost.initialize("file://" + os.path.join(work, "store"),
                             num_processes=1, process_id=0, backend="nccl",
                             device="cuda:0")
        cfg = Config(dataset_name="synth-ws-200000")
        build, k1_build, _, sk, _ = _mg_sharded_build(
            splits["train"].graph, cfg, sketch_params_from_config(cfg))
        del sk
        records.append(build)
        k1 += k1_build
        elph_record, k1_elph = _mg_elph(elph, work, seed=41)
        records.append(elph_record)
        k1 += k1_elph
        records += _mg_buddy_and_serving(splits, work, seed=42)
        two = _mg_two_ranks(work, launch)
        k1 += [{"phase": "mesh_graph", **r} for r in two.pop("k1")]
        records.append(two)
        idle = [r["name"] for r in k1 if r["launches"] <= 0]
        if idle:
            raise AssertionError(f"mesh_graph: K1 instances never launched "
                                 f"on the path: {idle}")
    finally:
        multihost.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    records.append({"phase": "mesh_graph", "part": "summary",
                    "phase_s": time.perf_counter() - t0})
    return k1, records


# -------------------------------------------------------- scale_equality --

# the scale of every other phase: at the JAX artifact's 500,000 nodes the
# phase took 153-231 s of its 120, its evaluation cut too (PERF.md)
SE_NODES = 200_000
SE_GRAPH_RANKS = 2        # gloo ranks sharing cuda:0, buddy and ELPH alike
SE_ELPH_MESH = "1,2"
SE_EPOCHS = 1             # ELPH cut in depth only: one epoch of 16,384
SE_TRAIN_SAMPLES = 16384  # links (4 steps of 4096), the JAX test's depth
SE_EVAL_SAMPLES = 16384   # val and test links evaluated (and train's 16,384)
SE_FEATURE_ATOL = 1e-4    # sharded probe features against one process's
SE_LOSS_ATOL = 1e-4       # sharded ELPH epoch losses against one process's
SE_METRIC_ATOL = 0.01     # and its metrics (the JAX test's envelope)
SE_HLL_PS = range(4, 11)  # HLL++ tables made on the card, p = 4..10


def _se_halo_k1(work: str, launches: dict) -> list:
    """K1 on rank 0's halo merges at the tool's scale, rebuilt from the
    partition its buddy phase wrote: rank 0's halo plan, the hop-0 rows
    each rank sends rank 0 (the exchange's result), folded into rank 0's
    local merge.  The merged rows are bit-equal to rank 0's hop-1 shard
    from the run; K1 is held against its plain version and timed
    (``k1_record``).  ``launches``: rank 0's K1 launches in the build."""
    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.ops.segment_scan import (
        SortedSegmentPlan,
    )
    from subgraph_sketching_tpu_torch.parallel.node_sharded import (
        _IDENTITY, ShardedHop,
    )
    from subgraph_sketching_tpu_torch.sketch.params import SketchParams
    from subgraph_sketching_tpu_torch.tools import scale_equality as tool

    part = tool.load_partition(os.path.join(work, "partition.npz"))
    params = SketchParams(max_hops=2)
    hop = ShardedHop(part, 0, None, "cuda", tool.MAX_GATHER_ROWS)
    if not isinstance(hop.halo, SortedSegmentPlan):
        raise AssertionError("scale_equality: rank 0's halo plan is "
                             "chunked; K1's inputs are a chunk's")
    rows = [[torch.from_numpy(t).cuda() for t in part.shard_init(params, s)]
            for s in range(part.n_dev)]
    shard0 = np.load(os.path.join(work, "shard0.npz"))
    k1 = []
    for i, (op, key) in enumerate((("min", "minhash"), ("max", "hll"))):
        recv = torch.cat([torch.where(
            torch.from_numpy(part.send_mask[s][0]).cuda()[:, None],
            rows[s][i][torch.from_numpy(part.send_idx[s][0]).cuda().long()],
            torch.full((), _IDENTITY[(op, rows[s][i].dtype)],
                       dtype=rows[s][i].dtype, device="cuda"))
            for s in range(part.n_dev)])
        acc = hop.local.reduce(rows[0][i], op)
        v = hop.halo.reduce_subruns(recv, op).contiguous()
        merged = hop.halo.merge_subruns(v, acc, op)
        if not np.array_equal(merged.cpu().numpy(), shard0[key][1]):
            raise AssertionError(f"scale_equality: rank 0's {key} halo "
                                 f"merge, rebuilt, differs from its hop-1 "
                                 f"shard")
        name = (f"{'segscan_min_i32' if op == 'min' else 'segscan_max_i8'} "
                f"(scale_equality, node-sharded hop halo merge, "
                f"N={part.num_nodes}, D={part.n_dev}, rank 0)")
        k1.append({"phase": "scale_equality", "name": name,
                   "launches": launches[name.split()[0]],
                   **k1_record(name, op, v, acc, hop.halo.sub_ptr)})
    return k1


def _se_hll_tables(work: str) -> dict:
    """``tools/gen_hll_tables.py`` on the card for p = 4..10 at its
    default seed, one ``--only-p`` run each into one file: every array
    bit-equal to the committed ``_hll_tables.npz``."""
    import numpy as np

    from subgraph_sketching_tpu_torch.tools import gen_hll_tables

    out = os.path.join(work, "hll_tables.npz")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        for p in SE_HLL_PS:
            gen_hll_tables.main(["--only-p", str(p), "--out", out,
                                 "--device", "cuda"])
    seconds = time.perf_counter() - t0
    committed = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "subgraph_sketching_tpu_torch", "sketch",
                             "_hll_tables.npz")
    with np.load(out) as got, np.load(committed) as want:
        for p in SE_HLL_PS:
            for key in (f"raw_estimate_p{p}", f"bias_p{p}"):
                if not np.array_equal(got[key], want[key]):
                    raise AssertionError(f"scale_equality: {key} made on "
                                         f"the card differs from the "
                                         f"committed table")
        arrays = sorted(got.files)
    return {"phase": "scale_equality", "part": "hll_tables",
            "p": list(SE_HLL_PS), "seconds": seconds, "arrays": arrays,
            "raw_and_bias": "bit-equal to the committed _hll_tables.npz"}


def _se_launch(work: str) -> _Launch:
    """The port's ``tools/scale_equality.py`` on the card at N =
    SE_NODES (synth-ws), every sharded phase on SE_GRAPH_RANKS gloo ranks
    sharing cuda:0 (the halo exchange's all-reduce route), ELPH on
    SE_ELPH_MESH cut to one epoch of SE_TRAIN_SAMPLES links, as a
    :class:`_Launch` (not started) whose value is the tool's report; its
    files in ``work``."""
    from subgraph_sketching_tpu_torch.tools import scale_equality as tool

    return _Launch("scale_equality", target=lambda: tool.run(
        SE_NODES, None, SE_ELPH_MESH, "cuda", graph_ranks=SE_GRAPH_RANKS,
        epochs=SE_EPOCHS, train_samples=SE_TRAIN_SAMPLES,
        eval_samples=SE_EVAL_SAMPLES, timeout=600, work=work,
        log=lambda blob: None))


def phase_scale_equality(work: str, launch: _Launch) -> tuple:
    """The tool's run (``launch``, from ``_se_launch``, which the dp
    phase ran beside its own two-rank launches) held: MinHash and HLL
    tables bit-equal in node order to one process's, the probe features
    within SE_FEATURE_ATOL, each rank holding exactly 1/2 of the tables,
    the sharded ELPH run's losses and metrics within SE_LOSS_ATOL and
    SE_METRIC_ATOL of the one-process run's; K1 on rank 0's halo merges
    (``_se_halo_k1``); then the HLL++ tables made on the card
    (``_se_hll_tables``).  ``work``: the launch's directory, removed by
    the caller.  Returns (the K1 records, the phase's records)."""
    import numpy as np

    t0 = time.perf_counter()
    tool_s = launch.result()
    report = launch.value
    buddy = report["buddy_preprocessing"]
    ms = report["elph_memory_sharded"]
    problems = []
    if not (buddy["minhash_tables_bit_equal"]
            and buddy["hll_tables_bit_equal"]):
        problems.append("the sharded tables differ from one process's")
    if not buddy["max_feature_delta"] <= SE_FEATURE_ATOL:
        problems.append(f"probe features off by {buddy['max_feature_delta']}")
    fractions = [buddy["per_device_fraction"]] + [
        s["fraction"] for s in report["elph_shard_bytes"].values()]
    if any(f != 1 / SE_GRAPH_RANKS for f in fractions):
        problems.append(f"shard fractions {fractions}")
    losses = ms["sharded"]["losses"] + ms["single_device"]["losses"]
    if len(losses) != 2 * SE_EPOCHS or not np.isfinite(losses).all():
        problems.append(f"epoch losses {losses}")
    if ms["max_loss_delta"] is None or \
            not ms["max_loss_delta"] <= SE_LOSS_ATOL:
        problems.append(f"loss delta {ms['max_loss_delta']}")
    if not ms["max_metric_delta"] <= SE_METRIC_ATOL:
        problems.append(f"metric delta {ms['max_metric_delta']}")
    if problems:
        raise AssertionError("scale_equality: " + "; ".join(problems))
    launches = buddy["k1_launches_build"][0]
    k1 = _se_halo_k1(work, launches)
    idle = [r["name"] for r in k1 if r["launches"] <= 0]
    if idle:
        raise AssertionError(f"scale_equality: K1 instances never launched "
                             f"in rank 0's build: {idle}")
    tables = _se_hll_tables(work)
    records = [{"phase": "scale_equality", "part": "tool",
                "args": f"{SE_NODES} - {SE_ELPH_MESH} --graph_ranks "
                        f"{SE_GRAPH_RANKS} --epochs {SE_EPOCHS} "
                        f"--train_samples {SE_TRAIN_SAMPLES} --eval_samples "
                        f"{SE_EVAL_SAMPLES}",
                "tool_s": tool_s, "window": "beside the dp phase's "
                                            "two-rank launches",
                "tolerances": {"features": SE_FEATURE_ATOL,
                               "losses": SE_LOSS_ATOL,
                               "metrics": SE_METRIC_ATOL},
                "report": report},
               tables,
               {"phase": "scale_equality", "part": "summary",
                "phase_s": time.perf_counter() - t0}]
    return k1, records


# -------------------------------------------------------------- bfloat16 --

BF16_ELPH_SAMPLES = 65536      # 64 steps of the default batch 1024
BF16_PROFILE_STEPS = 20
BF16_TIMED_STEPS = 5           # steps a turn, float32 against bfloat16
BF16_SEAL_BATCHES = 16         # SEALDGCNN's train links: 16 batches of 1024
BF16_SEAL_PROFILE_STEPS = 10
# K1 launches of one training step at --dtype bfloat16, by instance
BF16_ELPH_ADDS = {"segscan_add_bf16": 4,   # PlanSpmm each way, 2 convs
                  "segscan_add_f32": 1}    # gather_rows' backward (float32
#                                            GCN output: its float32 bias)
BF16_SEAL_ADDS = {"segscan_add_bf16": 9,   # 4 union SpMMs each way, the
                  "segscan_add_f32": 1}    # label table's backward; degrees
BF16_ADD_TOLERANCE = ("dyadic inputs bit-equal to the plain version; random "
                      "ones |err| <= 2^-8 |sum| + 2 k 2^-24 sum|v| of the "
                      "float64 sum of a row's k terms (half a bfloat16 ulp "
                      "and the float32 accumulation), kernel and plain alike")
BF16_CARD_TOLERANCE = ("logits rtol = atol = 0.05 (tests/test_dtype.py's); "
                       "each gradient within 0.1 of the CPU's by norm, "
                       "but the pre-BN biases' (a true gradient of 0)")
F16_CARD_TOLERANCE = ("logits rtol = atol = 0.01; each gradient within 0.02 "
                      "of the CPU's by norm, but the pre-BN biases' (a true "
                      "gradient of 0): a fifth of bfloat16's, as float16 "
                      "keeps three more bits (measured on an H100: 6.1e-5 "
                      "and 5.3e-4)")
# --dtype -> (logit rtol and atol, gradient tolerance by norm, its text) of
# a small run on the card against the CPU
CARD_TOLERANCE = {"bfloat16": (0.05, 0.1, BF16_CARD_TOLERANCE),
                  "float16": (0.01, 0.02, F16_CARD_TOLERANCE)}


F16_ADD_TOLERANCE = ("dyadic inputs bit-equal to the plain version; random "
                     "ones |err| <= 2^-11 |sum| + 2 k 2^-24 sum|v| of the "
                     "float64 sum of a row's k terms (half a float16 ulp "
                     "and the float32 accumulation), kernel and plain alike")


def half_add(dtype):
    """(half an ulp, tolerance) of K1's bfloat16 or float16 add, each
    summed in float32 and rounded once; None for another dtype."""
    import torch
    return {torch.bfloat16: (2.0 ** -8, BF16_ADD_TOLERANCE),
            torch.float16: (2.0 ** -11, F16_ADD_TOLERANCE)}.get(dtype)


def check_half_add(got, v, ptr, what: str) -> float:
    """K1's bfloat16 or float16 add (summed in float32, rounded once)
    within its bound of the float64 sum; returns the largest |err|."""
    import torch

    from subgraph_sketching_tpu_torch.ops import segscan
    half_ulp = half_add(v.dtype)[0]
    n, width = got.shape
    ids = segscan.segment_ids(ptr)
    zeros = torch.zeros((n, width), dtype=torch.float64, device=v.device)
    want = zeros.index_add(0, ids, v.double())
    scale = zeros.index_add(0, ids, v.double().abs())
    k = ptr.diff().double()[:, None]
    err = (got.double() - want).abs()
    if bool((err > half_ulp * want.abs() + 2 * k * 2.0 ** -24 * scale)
            .any()):
        raise AssertionError(f"{what}: beyond the {v.dtype} add's bound of "
                             f"the float64 sum: max |err| {float(err.max())}")
    return float(err.max())


def half_k1_record(what: str, v, ptr, seed: int) -> dict:
    """K1's bfloat16 or float16 add (``v``'s dtype) on one shape: a dyadic
    [S, W] input (multiples of 1/4 in [-8, 8): every float32 partial sum
    exact) bit-equal to the plain version, then the real input ``v``
    held by ``k1_record`` (kernel and plain version within ``half_add``'s
    bound of the float64 sum, two calls bit-equal) and timed."""
    import torch

    from subgraph_sketching_tpu_torch.ops import segscan
    n = ptr.shape[0] - 1
    x = torch.empty((n, v.shape[1]), dtype=v.dtype, device=v.device)
    g = torch.Generator(device=v.device).manual_seed(seed)
    dy = (torch.randint(-32, 32, v.shape, generator=g, device=v.device)
          .float() / 4).to(v.dtype)
    got = segscan.segment_combine(dy, x, "add", ptr)
    want = segscan.segment_combine_plain(dy, x, "add", ptr)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
        raise AssertionError(f"{what}: dyadic inputs not bit-equal to the "
                             f"plain version")
    del dy, got, want
    return {**k1_record(what, "add", v, x, ptr),
            "dyadic": "bit-equal to the plain version"}


def _float32_twin(trainer, cfg):
    """A float32 twin of a bfloat16 or float16 trainer: the same staged
    data, the model built at float32 (the staging does not read
    --dtype)."""
    import copy
    import dataclasses
    twin = copy.copy(trainer)
    twin.cfg = dataclasses.replace(cfg, dtype="float32")
    twin.dtype = None
    return twin


def _turns_ms(timed, a, b) -> tuple:
    """(a ms, b ms): ``timed`` over each of a and b in turns a, b, b, a;
    each the mean of its two turns."""
    ta = [timed(a)]
    tb = [timed(b), timed(b)]
    ta.append(timed(a))
    return sum(ta) / 2, sum(tb) / 2


def _bf16_elph(splits, elph: dict, work: str, seed: int) -> tuple:
    """ELPH at full width at --dtype bfloat16 through runners.run.run (the
    train_elph phase's run: synth-ws-200000, Config defaults, 2 epochs of
    BF16_ELPH_SAMPLES links, --check_determinism, --save_model) with
    --profile_dir: the trace of epoch 1 names the bfloat16 K1 kernel.
    Returns (the PlanSpmm-forward K1 record, the run's record)."""
    import math

    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.graph.preprocess import (
        build_all_splits, build_link_dataset,
    )
    from subgraph_sketching_tpu_torch.graph.splits import SplitData
    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.runners.run import build_trainer, run
    from subgraph_sketching_tpu_torch.serving import scorer_from_checkpoint
    from subgraph_sketching_tpu_torch.train import checkpoint
    from subgraph_sketching_tpu_torch.train.loops import make_optimizer

    ckpt, prof = os.path.join(work, "elph"), os.path.join(work, "elph_trace")
    cfg = Config(dataset_name="synth-ws-200000", model="ELPH", epochs=2,
                 eval_steps=1, train_samples=BF16_ELPH_SAMPLES,
                 check_determinism=True, save_model=True,
                 checkpoint_dir=ckpt, profile_dir=prof, dtype="bfloat16")
    _reset_k1()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(cfg, device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(segscan.launches)
    peak = torch.cuda.max_memory_allocated()
    steps = math.ceil(BF16_ELPH_SAMPLES / cfg.batch_size)
    trained = steps * (cfg.epochs + 2)   # + the determinism check's 2
    for name, per_step in BF16_ELPH_ADDS.items():
        if launches[name] < per_step * trained:
            raise AssertionError(f"bf16 ELPH run: K1 launches {launches}, "
                                 f"{per_step} {name} a step expected")
    traces = glob.glob(os.path.join(prof, "*.json"))
    if len(traces) != 1:
        raise AssertionError(f"bf16 ELPH run: traces {traces}")
    trace_bytes = os.path.getsize(traces[0])
    with open(traces[0]) as f:
        named = "BF16Bits" in f.read()   # Add16<BF16Bits>, segscan.cu
    if not named:
        raise AssertionError("the epoch-1 trace does not name K1's "
                             "bfloat16 kernel")
    shutil.rmtree(prof)
    rows = _metric_rows(ckpt)
    losses = [r["rep0_loss"] for r in rows]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"bf16 ELPH losses {losses}")

    # the trained state: parameters and Adam moments float32
    datasets = build_all_splits(splits, cfg, device="cuda")
    trainer = build_trainer(cfg, datasets, datasets["train"].x.shape[-1],
                            "cuda")
    model = trainer.init_model(0)
    opt = make_optimizer(cfg, model.parameters())
    checkpoint.restore_into(ckpt, model, opt)
    kinds = {str(t.dtype) for t in model.state_dict().values()} | {
        str(t.dtype) for st in opt.state.values() for k, t in st.items()
        if k != "step"}
    if kinds - {"torch.float32", "torch.int64"}:
        raise AssertionError(f"bf16 ELPH state dtypes {kinds}")

    # 20 steps under torch.profiler: idle share, top kernels, K1 launches
    # by instance; then a step at bfloat16 beside one at float32 (the same
    # staged data), in turns
    n_links = trainer.num_links("train")
    g = torch.Generator(device="cuda").manual_seed(seed)
    order = torch.randperm(n_links, generator=g, device="cuda")
    bs = cfg.batch_size
    window_s, busy_ms, per = profile_window(
        lambda: trainer.run_epoch(model, opt, seed, order=order[:3 * bs]),
        lambda: trainer.run_epoch(model, opt, seed,
                                  order=order[:BF16_PROFILE_STEPS * bs]))
    window = {k: v for k, v in segscan.launches.items() if v}
    if window != {k: v * BF16_PROFILE_STEPS
                  for k, v in BF16_ELPH_ADDS.items()}:
        raise AssertionError(f"bf16 ELPH: {BF16_PROFILE_STEPS} steps, K1 "
                             f"launches {window}")
    twin = _float32_twin(trainer, cfg)

    def timed(tr) -> float:
        m = tr.init_model(1)
        o = make_optimizer(cfg, m.parameters())
        tr.run_epoch(m, o, seed, order=order[:2 * bs])
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.run_epoch(m, o, seed,
                     order=order[2 * bs:(2 + BF16_TIMED_STEPS) * bs])
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / BF16_TIMED_STEPS

    f32_ms, bf16_ms = _turns_ms(timed, twin, trainer)

    # K1 on the PlanSpmm forward's sub-run results at bfloat16 (one step's
    # GCN input width, random rows through the staged plan)
    ps = trainer._data["train"]["plan"]
    xb = torch.randn((trainer._data["train"]["num_nodes"],
                      cfg.hidden_channels), generator=g,
                     device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        v = ps.fwd.reduce_subruns(xb, "add", ps._w_fwd).contiguous()
    del xb
    k1 = {"phase": "bf16", "part": "k1", "launches":
          launches["segscan_add_bf16"],
          "name": f"segscan_add_bf16 (PlanSpmm forward, "
                  f"W={cfg.hidden_channels})",
          **half_k1_record("bf16 PlanSpmm forward", v, ps.fwd.sub_ptr, seed)}
    del v

    # serve what was trained: the scorer rebuilt from the checkpoint (its
    # config: bfloat16) against the trainer's predict
    model = trainer.init_model(0)
    checkpoint.restore_into(ckpt, model, step=cfg.epochs)
    links = np.random.default_rng(seed).integers(
        0, datasets["train"].num_nodes, (65536, 2))
    query = SplitData(splits["train"].graph, links,
                      np.zeros((0, 2), np.int64))
    trainer.stage("query", build_link_dataset(
        query, cfg, "query", reuse_from=datasets["train"], device="cuda"))
    want, _ = trainer.predict(model, "query")
    del datasets, trainer, twin, model, opt
    scorer = scorer_from_checkpoint(ckpt, device="cuda")
    got = scorer.score(links)
    serve_err = float(np.abs(got - want).max())
    if not np.isfinite(got).all() or serve_err > 1e-2:
        raise AssertionError(f"bf16 ELPH served scores differ from predict: "
                             f"max |err| {serve_err}")
    del scorer
    shutil.rmtree(ckpt)
    return k1, {
        "phase": "bf16", "part": "elph", "dataset": cfg.dataset_name,
        "dtype": cfg.dtype, "hidden_channels": cfg.hidden_channels,
        "train_samples": BF16_ELPH_SAMPLES, "steps_per_epoch": steps,
        "trained_steps": trained, "run_s": run_s,
        "epochs": [{"epoch": i, "loss": r["rep0_loss"],
                    "train_s": r["rep0_train_time"],
                    "eval_s": r["rep0_eval_time"],
                    "step_ms": r["rep0_train_time"] * 1e3 / steps}
                   for i, r in enumerate(rows)],
        "determinism": "epoch 0 bit-identical on two runs",
        "trace": {"epoch": 1, "bytes": trace_bytes,
                  "names_bf16_kernel": named},
        "k1_launches": launches,
        "k1_launches_per_step": {k: launches[k] / trained
                                 for k in BF16_ELPH_ADDS},
        "state_dtypes": sorted(kinds), "peak_memory_bytes": peak,
        "step_ms": {"bfloat16": bf16_ms, "float32": f32_ms,
                    "timed_steps": BF16_TIMED_STEPS,
                    "turns": "float32, bfloat16, bfloat16, float32",
                    "train_elph_plan_step_ms_float32":
                        elph.get("plan_step_ms")},
        "profile": {"steps": BF16_PROFILE_STEPS,
                    "window_ms": window_s * 1e3,
                    "step_ms": window_s * 1e3 / BF16_PROFILE_STEPS,
                    "device_busy_ms": busy_ms,
                    "device_idle_share": 1 - busy_ms / (window_s * 1e3),
                    "k1_launches": window,
                    "top_kernels": sorted(([k, v[0], v[1]]
                                           for k, v in per.items()),
                                          key=lambda r: -r[1])[:10]},
        "served_links": len(links), "served_max_abs_err": serve_err,
        "serve_tolerance": 1e-2}


def _bf16_buddy(work: str, seed: int) -> dict:
    """BUDDY at full width at --dtype bfloat16 through runners.run.run (one
    epoch of BUDDY_TRAIN_SAMPLES links, synth-ws-200000, Config defaults,
    --save_model), then served from its checkpoint in bfloat16."""
    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.runners.run import run
    from subgraph_sketching_tpu_torch.serving import scorer_from_checkpoint

    ckpt = os.path.join(work, "buddy")
    cfg = Config(dataset_name="synth-ws-200000", epochs=1, save_model=True,
                 train_samples=BUDDY_TRAIN_SAMPLES, checkpoint_dir=ckpt,
                 dtype="bfloat16")
    _reset_k1()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run(cfg, device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    (row,) = _metric_rows(ckpt)
    launches = dict(segscan.launches)
    peak = torch.cuda.max_memory_allocated()
    t1 = time.perf_counter()
    scorer = scorer_from_checkpoint(ckpt, device="cuda")
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t1
    if scorer.model.lin.dtype != torch.bfloat16:
        raise AssertionError("the bf16 BUDDY checkpoint served at "
                             f"{scorer.model.lin.dtype}")
    links = np.random.default_rng(seed).integers(0, scorer.num_nodes,
                                                 (65536, 2))
    scores = scorer.score(links)
    del scorer
    shutil.rmtree(ckpt)
    if not (np.isfinite(scores).all() and np.isfinite(row["rep0_loss"])):
        raise AssertionError(f"bf16 BUDDY: loss {row['rep0_loss']}, scores "
                             f"finite {np.isfinite(scores).all()}")
    return {"phase": "bf16", "part": "buddy", "dtype": cfg.dtype,
            "dataset": cfg.dataset_name, "run_s": run_s,
            "loss": row["rep0_loss"], "epoch_s": row["rep0_train_time"],
            "eval_s": row["rep0_eval_time"],
            "preprocess_s": row["rep0_preprocess_time"],
            "k1_launches": launches, "peak_memory_bytes": peak,
            "serve_rebuild_s": rebuild_s, "served_links": len(links),
            "served_finite": True}


def _bf16_seal(root: str, splits_memo: dict, seed: int) -> tuple:
    """SEALDGCNN at --dtype bfloat16 at Config defaults on the collab tree
    (SEAL_COMMAND cut to BF16_SEAL_BATCHES train batches) through the
    runner; then BF16_SEAL_PROFILE_STEPS steps under torch.profiler (K1
    launches a step by instance) and a step at bfloat16 beside one at
    float32 in turns; K1's bfloat16 add on one batch's union at W = 1024
    and W = 1.  Returns (K1 records, the record)."""
    import shlex

    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.train.loops import make_optimizer

    cut = ["--train_samples", str(BF16_SEAL_BATCHES * 1024),
           "--val_samples", "4096", "--test_samples", "4096",
           "--dtype", "bfloat16"]
    trainer, row, run_s, peak, launches = _runner_run(
        root, "seal_dgcnn_bf16", shlex.split(SEAL_COMMAND) + cut,
        splits_memo)
    cfg = trainer.cfg
    if launches["segscan_add_bf16"] < BF16_SEAL_ADDS["segscan_add_bf16"] \
            * BF16_SEAL_BATCHES:
        raise AssertionError(f"bf16 SEAL run: K1 launches {launches}")
    ds, bs = trainer.datasets["train"], cfg.batch_size
    order = np.random.default_rng(seed).permutation(len(ds))
    g = torch.Generator(device="cuda").manual_seed(seed)
    full = np.ones(bs, bool)
    model = trainer.init_model(seed)
    opt = make_optimizer(cfg, model.parameters())

    def steps(tr, m, o, lo: int, k: int) -> None:
        for i in range(lo, lo + k):
            tr.step(m, o, ds.batch(order[i * bs:(i + 1) * bs]), full, g)

    window_s, busy_ms, per = profile_window(
        lambda: steps(trainer, model, opt, 0, 2),
        lambda: steps(trainer, model, opt, 2, BF16_SEAL_PROFILE_STEPS))
    window = {k: v for k, v in segscan.launches.items() if v}
    if window != {k: v * BF16_SEAL_PROFILE_STEPS
                  for k, v in BF16_SEAL_ADDS.items()}:
        raise AssertionError(f"bf16 SEAL: {BF16_SEAL_PROFILE_STEPS} steps, "
                             f"K1 launches {window}")
    twin = _float32_twin(trainer, cfg)

    def timed(tr) -> float:
        m = tr.init_model(seed)
        o = make_optimizer(cfg, m.parameters())
        steps(tr, m, o, 0, 1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        steps(tr, m, o, 1, BF16_TIMED_STEPS)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / BF16_TIMED_STEPS

    f32_ms, bf16_ms = _turns_ms(timed, twin, trainer)
    batch, _ = trainer.to_device(ds.batch(order[:bs]))
    ei, w, ((perm, ptr), _) = batch["graph"].gcn()
    n = batch["graph"].num_nodes
    k1 = []
    for width in (cfg.hidden_channels, 1):
        x = torch.randn((n, width), generator=g,
                        device="cuda").to(torch.bfloat16)
        v = (x.index_select(0, ei[0][perm])
             * w[perm, None].to(torch.bfloat16)).contiguous()
        k1.append({"phase": "bf16", "part": "k1",
                   "launches": launches["segscan_add_bf16"],
                   "name": f"segscan_add_bf16 (SEAL union, W={width})",
                   **half_k1_record(f"bf16 SEAL union W={width}", v, ptr,
                                    seed + width)})
        del x, v
    del batch, trainer, twin, model, opt
    return k1, {
        "phase": "bf16", "part": "seal", "model": "SEALDGCNN",
        "dtype": "bfloat16",
        "command": SEAL_COMMAND + " " + " ".join(cut),
        "train_batches": BF16_SEAL_BATCHES, "run_s": run_s,
        "epoch_s": row["rep0_train_time"], "loss": row["rep0_loss"],
        "peak_memory_bytes": peak, "k1_launches": launches,
        "step_ms": {"bfloat16": bf16_ms, "float32": f32_ms,
                    "timed_steps": BF16_TIMED_STEPS,
                    "turns": "float32, bfloat16, bfloat16, float32"},
        "profile": {"steps": BF16_SEAL_PROFILE_STEPS,
                    "step_ms": window_s * 1e3 / BF16_SEAL_PROFILE_STEPS,
                    "device_busy_ms": busy_ms,
                    "device_idle_share": 1 - busy_ms / (window_s * 1e3),
                    "k1_launches_per_step": {
                        k: v / BF16_SEAL_PROFILE_STEPS
                        for k, v in window.items()},
                    "top_kernels": sorted(([k, v[0], v[1]]
                                           for k, v in per.items()),
                                          key=lambda r: -r[1])[:10]}}


# the biases that feed a BatchNorm in the card-vs-CPU ELPH (its head and
# the diffused table's SIGN): a true gradient of zero, and each device's
# own rounding noise
BF16_PRE_BN_BIAS = (r"(predictor\.(label_lin_layer|lin_out|lin_emb_out)"
                    r"|embedding\.sign_embedding\.lin_\d+)\.bias")


def _grads_by_norm(card: dict, cpu: dict, what: str,
                   tol: float = 0.1) -> float:
    """The largest ||card - cpu|| / ||cpu|| over the gradients but those of
    BF16_PRE_BN_BIAS; each must be within ``tol``."""
    import re
    worst = 0.0
    for k, want in cpu.items():
        if re.fullmatch(BF16_PRE_BN_BIAS, k):
            continue
        d = float((card[k].double().cpu() - want.double()).norm())
        rel = d / max(float(want.double().norm()), 1e-30)
        worst = max(worst, rel)
        if rel > tol:
            raise AssertionError(f"{what}: gradient {k} is {rel} of its "
                                 f"norm from the CPU's")
    return worst


def _card_vs_cpu(seed: int, dtype: str = "bfloat16",
                 card: str = "cuda") -> dict:
    """A small ELPH with a SIGN-diffused node-embedding table (the ddi
    kind: synth-ws, hidden 32, sign_k 2) and a small SEALDGCNN (synth-ba,
    hidden 32) at ``--dtype`` ``dtype`` (bfloat16 or float16) from one
    init on the card and on the CPU: eval logits and one training step's
    gradients (dropout off), within CARD_TOLERANCE; the card's step
    went through K1's add of that dtype (the embedding path's gather_rows
    backward included).  At bfloat16, then ``GCN``, ``SAGE`` and
    ``MLPLinkPredictor`` forward and backward on the card against the CPU
    in float32 (rtol 1e-4, atol 1e-5)."""
    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.graph.datasets import get_data
    from subgraph_sketching_tpu_torch.graph.preprocess import build_all_splits
    from subgraph_sketching_tpu_torch.graph.synthetic import (
        watts_strogatz_graph,
    )
    from subgraph_sketching_tpu_torch.models import gnn
    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.ops.segment_scan import gather_rows
    from subgraph_sketching_tpu_torch.train.loops import ElphTrainer
    from subgraph_sketching_tpu_torch.train.seal_loop import (
        build_seal_trainer,
    )

    devices = {"cpu": "cpu", "card": card}
    instance = segscan._ENTRY[("add", getattr(torch, dtype))][0]
    phase = {"bfloat16": "bf16", "float16": "f16"}[dtype]

    def no_dropout(m):
        for mod in m.modules():
            if isinstance(mod, gnn.Dropout):
                mod.p = 0.0
        return m

    def grads(model) -> dict:
        return {k: p.grad.detach().cpu() for k, p in model.named_parameters()
                if p.grad is not None}

    logit_tol, grad_tol, tolerance = CARD_TOLERANCE[dtype]

    def held(res, what) -> dict:
        np.testing.assert_allclose(res["card"][0], res["cpu"][0],
                                   rtol=logit_tol, atol=logit_tol)
        return {"max_logit_abs_diff": float((res["card"][0]
                                             - res["cpu"][0]).abs().max()),
                "max_grad_rel_diff": _grads_by_norm(res["card"][1],
                                                    res["cpu"][1], what,
                                                    grad_tol),
                "card_k1_launches_one_step": res["card"][2]}

    out = {}
    # ELPH with the diffused table
    cfg = Config(dataset_name="synth-ws", model="ELPH", hidden_channels=32,
                 train_node_embedding=True, propagate_embeddings=True,
                 sign_k=2, dtype=dtype)
    splits, directed, _ = get_data(cfg)
    ds = build_all_splits(splits, cfg, directed=directed, device="cpu")
    width = ds["train"].x.shape[-1]
    trainers = {k: ElphTrainer(cfg, ds["train"], width, device=d)
                for k, d in devices.items()}
    state = trainers["cpu"].init_model(seed).state_dict()
    sf = trainers["cpu"]._data["train"]["sf"]
    res = {}
    for k, tr in trainers.items():
        d = devices[k]
        model = tr.init_model(seed)
        model.load_state_dict(state)
        data = tr._data["train"]
        data["sf"] = sf.to(d)
        idx = torch.arange(512, device=d)
        links = data["links"][idx]
        model.eval()
        with torch.no_grad():
            feats = tr.node_features(model, data)
            emb = tr.embedding_table(model, data)[links]
            logits = model.predictor(data["sf"][idx], feats[links],
                                     emb).float().cpu()
        no_dropout(model).train()
        _reset_k1()
        feats = tr.node_features(model, data)
        emb = gather_rows(tr.embedding_table(model, data), links)
        y = model.predictor(data["sf"][idx], gather_rows(feats, links), emb)
        y.float().square().mean().backward()
        res[k] = (logits, grads(model), dict(segscan.launches))
    # the GCN's PlanSpmm each way for 2 convolutions, and the diffused
    # table's gather_rows backward (the diffusion itself runs on the
    # float32 table, as in JAX)
    if res["card"][2][instance] != 5:
        raise AssertionError(f"{phase} ELPH with embeddings on the card: K1 "
                             f"launches {res['card'][2]}")
    out["elph_embedding"] = held(res, f"{phase} ELPH")
    # SEALDGCNN
    cfg = Config(dataset_name="synth-ba", model="SEALDGCNN",
                 hidden_channels=32, dtype=dtype)
    splits, _, _ = get_data(cfg)
    trainers = {k: build_seal_trainer(cfg, splits, d)
                for k, d in devices.items()}
    state = trainers["cpu"].init_model(seed).state_dict()
    raw = trainers["cpu"].datasets["train"].batch(np.arange(256))
    res = {}
    for k, tr in trainers.items():
        model = tr.init_model(seed)
        model.load_state_dict(state)
        batch, y = tr.to_device(raw)
        model.eval()
        with torch.no_grad():
            logits = model(batch).float().cpu()
        no_dropout(model).train()
        _reset_k1()
        tr.loss_fn(model(batch), y, torch.ones(
            len(y), dtype=torch.bool, device=devices[k])).backward()
        res[k] = (logits, grads(model), dict(segscan.launches))
    if res["card"][2][instance] != BF16_SEAL_ADDS["segscan_add_bf16"]:
        raise AssertionError(f"{phase} SEALDGCNN on the card: K1 launches "
                             f"{res['card'][2]}")
    out["seal_dgcnn"] = held(res, f"{phase} SEALDGCNN")
    if dtype != "bfloat16":
        return {"phase": phase, "part": "card_vs_cpu", **out,
                "tolerance": tolerance}
    # the last classes, float32
    n = 2000
    ei = torch.from_numpy(watts_strogatz_graph(n, 8, 0.2, seed=seed)
                          .astype(np.int64))
    x = torch.randn((n, 64), generator=torch.Generator().manual_seed(seed))
    cases = {"GCN": (lambda: gnn.GCN(64, 128, 32, 3, 0.0), (ei, n)),
             "SAGE": (lambda: gnn.SAGE(64, 128, 32, 3, 0.0), (ei, n)),
             "MLPLinkPredictor": (lambda: gnn.MLPLinkPredictor(
                 64, 128, 1, 3, 0.0), None)}
    for name, (make, rest) in cases.items():
        torch.manual_seed(seed)
        ref = make().eval()
        got = {}
        for k, d in devices.items():
            m = make().to(d).eval()
            m.load_state_dict(ref.state_dict())
            xd = x.to(d).requires_grad_()
            y = (m(xd, *(r.to(d) if torch.is_tensor(r) else r
                         for r in rest)) if rest is not None
                 else m(xd[:1000], xd[1000:]))
            (g_x,) = torch.autograd.grad(y.square().sum(), xd)
            got[k] = (y.detach().cpu(), g_x.cpu())
        for a, b in zip(got["card"], got["cpu"]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        out[name] = {"max_abs_diff": max(float((a - b).abs().max())
                                         for a, b in zip(got["card"],
                                                         got["cpu"]))}
    return {"phase": "bf16", "part": "card_vs_cpu", **out,
            "tolerance": tolerance + "; the classes in float32: "
                         "rtol 1e-4, atol 1e-5"}


def phase_bf16(splits, elph: dict, collab_root: str, splits_memo: dict,
               seed: int = 20) -> tuple:
    """The bfloat16 compute dtype (``--dtype bfloat16``) at full width:
    ELPH (``_bf16_elph``), BUDDY (``_bf16_buddy``) and SEALDGCNN
    (``_bf16_seal``) through the runner, the card against the CPU on
    small runs (``_card_vs_cpu``), and K1's bfloat16 add at three
    shapes (PlanSpmm's forward at W = 1024, SEAL's union at W = 1024 and
    W = 1).  Returns (the K1 records, the phase's records)."""
    work = tempfile.mkdtemp(prefix="smoke_bf16_")
    try:
        t0 = time.perf_counter()
        k1_elph, elph_rec = _bf16_elph(splits, elph, work, seed)
        elph_rec["part_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        buddy = _bf16_buddy(work, seed)
        buddy["part_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        k1_seal, seal = _bf16_seal(collab_root, splits_memo, seed)
        seal["part_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        card = _card_vs_cpu(seed)
        card["part_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return [k1_elph, *k1_seal], [elph_rec, buddy, seal, card]


# --------------------------------------------------------------- float16 --

F16_ELPH_SAMPLES = 8192        # 8 steps of the default batch 1024
F16_PROFILE_STEPS = 5
F16_TIMED_STEPS = 3            # steps a turn, float32 against float16
F16_SEAL_BATCHES = 4           # SEALDGCNN's train links: 4 batches of 1024
# K1 launches of one ELPH training step at --dtype float16, by instance
# (those of the bfloat16 step, with the float16 add), and the float16 adds
# of a SEALDGCNN step (the union SpMMs each way, the label table's
# backward)
F16_ELPH_ADDS = {"segscan_add_f16": 4, "segscan_add_f32": 1}
F16_SEAL_ADDS = 9
F16_SERVE_ATOL = 0.05          # a float16 ELPH served on the card and the CPU
# small SEAL and KGE runs, each run with and without --mesh_shape 1, which
# one process ignores for them (as the JAX runner does)
F16_MESH_RUNS = {
    "SEALGCN": "--dataset_name synth-ba --model SEALGCN --hidden_channels 32 "
               "--epochs 1 --train_samples 2048 --val_samples 512 "
               "--test_samples 512 --dtype float16",
    "transE": "--dataset_name synth-ba --model transE --hidden_channels 32 "
              "--epochs 1"}


def _f16_elph(data: tuple, work: str, seed: int) -> tuple:
    """ELPH at full width at --dtype float16 through runners.run.run
    (synth-ws-200000, Config defaults, one epoch of F16_ELPH_SAMPLES
    links; its get_data answered by ``data``, the splits the script read
    at the start): K1 launches a step by instance, F16_PROFILE_STEPS steps
    profiled (idle share, top kernels), a step at float16 beside one at
    float32 on the same staged data in turns, and K1's float16 add on the
    sub-run results of PlanSpmm's forward and backward at W = 1024.
    Returns (the K1 records, the run's record)."""
    import math

    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.runners import run as runner
    from subgraph_sketching_tpu_torch.train.loops import make_optimizer

    cfg = Config(dataset_name="synth-ws-200000", model="ELPH", epochs=1,
                 train_samples=F16_ELPH_SAMPLES,
                 checkpoint_dir=os.path.join(work, "elph"), dtype="float16")
    with _patched(runner, "get_data", lambda _: data):
        trainer, results, run_s, rows, launches, _, peak = _kept_run(cfg)
    steps = math.ceil(F16_ELPH_SAMPLES / cfg.batch_size)
    for name, per_step in F16_ELPH_ADDS.items():
        if launches[name] < per_step * steps:
            raise AssertionError(f"f16 ELPH run: K1 launches {launches}, "
                                 f"{per_step} {name} a step expected")
    (row,) = rows
    if not (math.isfinite(row["rep0_loss"]) and np.isfinite(results).all()):
        raise AssertionError(f"f16 ELPH: loss {row['rep0_loss']}, results "
                             f"{results}")
    model = trainer.init_model(0)
    opt = make_optimizer(cfg, model.parameters())
    g = torch.Generator(device="cuda").manual_seed(seed)
    order = torch.randperm(trainer.num_links("train"), generator=g,
                           device="cuda")
    bs = cfg.batch_size
    window_s, busy_ms, per = profile_window(
        lambda: trainer.run_epoch(model, opt, seed, order=order[:2 * bs]),
        lambda: trainer.run_epoch(model, opt, seed,
                                  order=order[:F16_PROFILE_STEPS * bs]))
    window = {k: v for k, v in segscan.launches.items() if v}
    if window != {k: v * F16_PROFILE_STEPS
                  for k, v in F16_ELPH_ADDS.items()}:
        raise AssertionError(f"f16 ELPH: {F16_PROFILE_STEPS} steps, K1 "
                             f"launches {window}")
    kinds = {str(t.dtype) for t in model.state_dict().values()} | {
        str(t.dtype) for st in opt.state.values() for k, t in st.items()
        if k != "step"}
    if kinds - {"torch.float32", "torch.int64"}:
        raise AssertionError(f"f16 ELPH state dtypes {kinds}")
    twin = _float32_twin(trainer, cfg)

    def timed(tr) -> float:
        m = tr.init_model(1)
        o = make_optimizer(cfg, m.parameters())
        tr.run_epoch(m, o, seed, order=order[:bs])
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.run_epoch(m, o, seed, order=order[bs:(1 + F16_TIMED_STEPS) * bs])
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / F16_TIMED_STEPS

    f32_ms, f16_ms = _turns_ms(timed, twin, trainer)
    del twin, model, opt
    # K1 on PlanSpmm's sub-run results each way at float16 (random rows of
    # the GCN's width through the staged plans)
    ps = trainer._data["train"]["plan"]
    n = trainer._data["train"]["num_nodes"]
    k1 = []
    for way, plan, w in (("forward", ps.fwd, ps._w_fwd),
                         ("backward", ps.bwd, ps._w_bwd)):
        xh = torch.randn((n, cfg.hidden_channels), generator=g,
                         device="cuda").to(torch.float16)
        with torch.no_grad():
            v = plan.reduce_subruns(xh, "add", w).contiguous()
        del xh
        k1.append({"phase": "f16", "part": "k1",
                   "launches": launches["segscan_add_f16"],
                   "name": f"segscan_add_f16 (PlanSpmm {way}, "
                           f"W={cfg.hidden_channels})",
                   **half_k1_record(f"f16 PlanSpmm {way}", v, plan.sub_ptr,
                                    seed)})
        del v
    del trainer
    return k1, {
        "phase": "f16", "part": "elph", "dataset": cfg.dataset_name,
        "dtype": cfg.dtype, "hidden_channels": cfg.hidden_channels,
        "train_samples": F16_ELPH_SAMPLES, "steps": steps, "run_s": run_s,
        "loss": row["rep0_loss"], "epoch_s": row["rep0_train_time"],
        "eval_s": row["rep0_eval_time"], "results": results,
        "k1_launches": launches, "state_dtypes": sorted(kinds),
        "peak_memory_bytes": peak,
        "step_ms": {"float16": f16_ms, "float32": f32_ms,
                    "timed_steps": F16_TIMED_STEPS,
                    "turns": "float32, float16, float16, float32"},
        "profile": {"steps": F16_PROFILE_STEPS,
                    "step_ms": window_s * 1e3 / F16_PROFILE_STEPS,
                    "device_busy_ms": busy_ms,
                    "device_idle_share": 1 - busy_ms / (window_s * 1e3),
                    "k1_launches": window,
                    "top_kernels": sorted(([k, v[0], v[1]]
                                           for k, v in per.items()),
                                          key=lambda r: -r[1])[:10]}}


def _f16_seal(root: str, splits_memo: dict, seed: int) -> tuple:
    """SEALDGCNN at --dtype float16 at Config defaults on the collab tree
    (SEAL_COMMAND cut to F16_SEAL_BATCHES train batches) through the
    runner, its label table's gather_rows backward inputs kept; K1's
    float16 add on that backward (W = 1024) and on one batch's union at
    W = 1024 and W = 1.  Returns (K1 records, the record)."""
    import shlex

    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.ops.segment_scan import segment_order

    cut = ["--train_samples", str(F16_SEAL_BATCHES * 1024),
           "--val_samples", "4096", "--test_samples", "4096",
           "--dtype", "float16"]
    counts, stash = {}, {}
    with _gather_backward_watch(counts, stash):
        trainer, row, run_s, peak, launches = _runner_run(
            root, "seal_dgcnn_f16", shlex.split(SEAL_COMMAND) + cut,
            splits_memo)
    cfg = trainer.cfg
    if launches["segscan_add_f16"] < F16_SEAL_ADDS * F16_SEAL_BATCHES:
        raise AssertionError(f"f16 SEAL run: K1 launches {launches}")
    k1 = []
    (rows, width), (flat, grad) = next(
        (k, v) for k, v in stash.items() if v[1].dtype == torch.float16)
    perm, ptr = segment_order(flat, rows)
    v = grad.reshape(-1, width).index_select(0, perm).contiguous()
    k1.append({"phase": "f16", "part": "k1",
               "launches": launches["segscan_add_f16"],
               "name": f"segscan_add_f16 (SEAL label table gather_rows "
                       f"backward, W={width})",
               "rows": int(flat.numel()), "table_rows": rows,
               **half_k1_record("f16 SEAL label table backward", v, ptr,
                                seed)})
    del v, stash
    ds, bs = trainer.datasets["train"], cfg.batch_size
    order = np.random.default_rng(seed).permutation(len(ds))
    g = torch.Generator(device="cuda").manual_seed(seed)
    batch, _ = trainer.to_device(ds.batch(order[:bs]))
    ei, w, ((perm, ptr), _) = batch["graph"].gcn()
    n = batch["graph"].num_nodes
    for width in (cfg.hidden_channels, 1):
        x = torch.randn((n, width), generator=g,
                        device="cuda").to(torch.float16)
        v = (x.index_select(0, ei[0][perm])
             * w[perm, None].to(torch.float16)).contiguous()
        k1.append({"phase": "f16", "part": "k1",
                   "launches": launches["segscan_add_f16"],
                   "name": f"segscan_add_f16 (SEAL union, W={width})",
                   **half_k1_record(f"f16 SEAL union W={width}", v, ptr,
                                    seed + width)})
        del x, v
    del batch, trainer
    return k1, {"phase": "f16", "part": "seal", "model": "SEALDGCNN",
                "dtype": "float16",
                "command": SEAL_COMMAND + " " + " ".join(cut),
                "train_batches": F16_SEAL_BATCHES, "run_s": run_s,
                "epoch_s": row["rep0_train_time"], "loss": row["rep0_loss"],
                "peak_memory_bytes": peak, "k1_launches": launches}


def _f16_serve_and_mesh(work: str, seed: int) -> dict:
    """A small float16 ELPH trained through the runner on the card and its
    checkpoint served in float16 on the card and on the CPU (scores
    within F16_SERVE_ATOL); then each F16_MESH_RUNS run with and without
    ``--mesh_shape 1``, equal bit for bit (SEAL and KGE ignore the mesh in
    one process, as the JAX runner does)."""
    import shlex

    import numpy as np
    import torch

    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.runners import run as runner
    from subgraph_sketching_tpu_torch.serving import scorer_from_checkpoint

    ckpt = os.path.join(work, "elph_small")
    runner.main(shlex.split("--dataset_name synth-ba --model ELPH "
                            "--hidden_channels 32 --epochs 1 --dtype "
                            "float16 --save_model") +
                ["--checkpoint_dir", ckpt, "--device", "cuda"])
    links = np.random.default_rng(seed).integers(0, 100, (4096, 2))
    _reset_k1()
    card = scorer_from_checkpoint(ckpt, device="cuda")
    got = card.score(links)
    serve_launches = segscan.launches["segscan_add_f16"]
    if card.model.predictor.lin.dtype != torch.float16 \
            or serve_launches < 2:
        raise AssertionError(f"f16 ELPH served at "
                             f"{card.model.predictor.lin.dtype}, float16 "
                             f"K1 adds {serve_launches}")
    want = scorer_from_checkpoint(ckpt, device="cpu").score(links)
    serve_err = float(np.abs(got - want).max())
    if not np.isfinite(got).all() or serve_err > F16_SERVE_ATOL:
        raise AssertionError(f"f16 ELPH served on the card and the CPU: max "
                             f"|err| {serve_err}")
    mesh = {}
    for model, args in F16_MESH_RUNS.items():
        argv = shlex.split(args) + ["--device", "cuda"]
        without = runner.main(argv)
        with_mesh = runner.main(argv + ["--mesh_shape", "1"])
        if with_mesh != without:
            raise AssertionError(f"{model} with --mesh_shape 1: {with_mesh}, "
                                 f"without: {without}")
        mesh[model] = {"args": args, "results": without,
                       "with_mesh_shape_1": "equal bit for bit"}
    return {"phase": "f16", "part": "serve_and_mesh",
            "served_links": len(links), "served_max_abs_err": serve_err,
            "serve_tolerance": F16_SERVE_ATOL,
            "serve_k1_f16_launches": serve_launches, "mesh_runs": mesh}


def phase_f16(data: tuple, collab_root: str, splits_memo: dict,
              seed: int = 21) -> tuple:
    """The float16 compute dtype (``--dtype float16``): ELPH at full width
    on ``data`` (get_data's synth-ws-200000) (``_f16_elph``) and SEALDGCNN
    (``_f16_seal``) through the runner, the
    card against the CPU on small runs (``_card_vs_cpu``), a small
    float16 checkpoint served and SEAL and KGE with ``--mesh_shape 1``
    (``_f16_serve_and_mesh``), and K1's float16 add at five shapes.
    Returns (the K1 records, the phase's records)."""
    work = tempfile.mkdtemp(prefix="smoke_f16_")
    t_phase = time.perf_counter()
    try:
        t0 = time.perf_counter()
        k1_elph, elph = _f16_elph(data, work, seed)
        elph["part_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        k1_seal, seal = _f16_seal(collab_root, splits_memo, seed)
        seal["part_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        card = _card_vs_cpu(seed, "float16")
        card["part_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rest = _f16_serve_and_mesh(work, seed)
        rest["part_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return [*k1_elph, *k1_seal], [
        elph, seal, card, rest,
        {"phase": "f16", "part": "summary",
         "phase_s": time.perf_counter() - t_phase}]


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
    data = get_data(cfg)
    splits = data[0]
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
    train = phase_train(splits)
    emit(train)
    emit(phase_train_reference())
    spmm_k1, plan_spmm = phase_plan_spmm(splits["train"].graph, cfg)
    emit(plan_spmm)
    for r in spmm_k1.values():
        emit(r)
    gather_k1, elph = phase_train_elph(splits)
    emit(elph)
    emit(gather_k1)
    emit(phase_elph_reference())
    collab_root = tempfile.mkdtemp(prefix="smoke_collab_")
    ddi_root = tempfile.mkdtemp(prefix="smoke_ddi_")
    mg_work = tempfile.mkdtemp(prefix="smoke_mesh_graph_")
    se_work = tempfile.mkdtemp(prefix="smoke_scale_equality_")
    try:
        emit(phase_datasets_collab(collab_root))
        emit(phase_datasets_chunked(plans))
        del plans, hub
        citation2, chunked = phase_datasets_citation2()
        emit(citation2)
        c2_train, c2_k1 = phase_citation2_train()
        emit(c2_train)
        ddi_k1, ddi_runs, ddi = phase_ddi(ddi_root)
        for r in ddi_runs + [ddi] + list(ddi_k1.values()):
            emit(r)
        emit(phase_emb_reference())
        streaming = phase_streaming(cfg, splits)
        emit(streaming)
        serve_ra = phase_serve_ra(cfg, splits)
        emit(serve_ra)
        emit(phase_heuristics(collab_root, ddi_root))
        splits_memo = {}   # the collab splits, read once for both tiers
        seal, k1_seal = phase_seal(collab_root, splits_memo)
        emit(seal)
        for r in k1_seal:
            emit(r)
        emit(phase_seal_reference())
        kge, k1_kge = phase_kge(collab_root, splits_memo)
        emit(kge)
        for r in k1_kge:
            emit(r)
        k1_bf16, bf16 = phase_bf16(splits, elph, collab_root, splits_memo)
        for r in bf16 + k1_bf16:
            emit(r)
        k1_f16, f16 = phase_f16(data, collab_root, splits_memo)
        for r in f16 + k1_f16:
            emit(r)
        del splits_memo
        # mesh_graph's two-rank launch and the scale_equality tool run
        # beside dp's (untimed) two-rank launches
        mg_launch = _mg_launch(mg_work)
        se_launch = _se_launch(se_work)
        k1_dp, dp = phase_dp(splits, train, elph,
                             alongside=(mg_launch, se_launch))
        for r in dp + k1_dp:
            emit(r)
        k1_mg, mesh_graph = phase_mesh_graph(splits, elph, mg_work,
                                             mg_launch)
        for r in mesh_graph + k1_mg:
            emit(r)
        k1_se, scale_equality = phase_scale_equality(se_work, se_launch)
        for r in scale_equality + k1_se:
            emit(r)
    finally:
        shutil.rmtree(collab_root, ignore_errors=True)
        shutil.rmtree(ddi_root, ignore_errors=True)
        shutil.rmtree(mg_work, ignore_errors=True)
        shutil.rmtree(se_work, ignore_errors=True)

    # each K1, K2 and K3 instance's bench_hub record, by name
    at_hub = {r["name"]: r for r in hub_records + hub_routes if "name" in r}

    def line(r, lib, ms_key="kernel_ms"):
        rec = {"name": r["name"], "route": "cuda",
               "source": f"{CSRC}/{lib}.cu", "replaces": REPLACES[lib],
               "launches": r["launches"], "max_abs_err": r["max_abs_err"],
               "ms": r[ms_key], "plain_ms": r["plain_ms"],
               "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               "library_ms": r["library_ms"]}
        if lib == "segscan":
            rec["graph_ms"] = r["graph_ms"]
            rec["train_launches"] = train["k1_launches"][r["name"]]
            rec["streaming_launches"] = streaming["k1_launches"][r["name"]]
            rec["serve_ra_launches"] = serve_ra["k1_launches"][r["name"]]
            rec["seal_launches"] = seal["k1_launches"][r["name"]]
            rec["kge_launches"] = kge_launches[r["name"]]
        if lib == "block_prop":
            rec["fold_launches"] = r["fold_launches"]
        if lib in ("segscan", "gather_reduce", "block_prop"):
            h = at_hub[r["name"]]
            rec.update(hub_ms=h["kernel_ms"], hub_bound_ms=h["bound_ms"],
                       hub_library_ms=h["library_ms"])
        return rec

    dp_elph = next(r for r in dp if r.get("part") == "world1_elph")
    # K1 in the four KGE runs: the add alone (the rows' backward)
    kge_launches = {name: 0 for name, *_ in INSTANCES}
    kge_launches["segscan_add_f32"] = sum(r["k1_add_launches"]
                                          for r in kge["runs"])
    # the ELPH run's K1 add launches: each convolution's PlanSpmm forward
    # and backward and gather_rows' backward a step, and the eval forwards,
    # on one counter
    elph_adds = elph["k1_launches"]["segscan_add_f32"]
    # K1: the instances the main path launched (int32 max is checked and
    # timed above, but serving does not run it); K2 and K3 on the served
    # graph, launched by the hop_routes drive; K4 by its study
    k1 = serve["k1_launches"]
    emit({"kernels": [
        line({**r, "launches": k1[r["name"]]}, "segscan")
        for r in main_records if k1[r["name"]] > 0] + [
        line(r, {"K3": "gather_reduce", "K2": "block_prop"}[r["route"]])
        for r in served if "name" in r] + [
        line({**k4, "library_ms": k4["torch_gather_min_ms"]},
             "dma_gather")] + [
        {"name": f"{name} (chunk merge, citation2 scale)", "route": "cuda",
         "source": f"{CSRC}/segscan.cu", "replaces": REPLACES["segscan"],
         "launches": r["launches"], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "chunks": citation2["sign_chunks" if name == "segscan_add_f32"
                             else "chunks"]}
        for name, r in chunked.items()] + [
        {"name": f"{name} (chunk merge, citation2 training)",
         "route": "cuda", "source": f"{CSRC}/segscan.cu",
         "replaces": REPLACES["segscan"], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "chunks": c2_train["chunks"],
         "launches_of": "this instance in the citation2_train run: the "
                        "2 hops' sketches and SIGN"}
        for name, r in c2_k1.items()] + [
        {"name": r["name"], "route": "cuda", "source": f"{CSRC}/segscan.cu",
         "replaces": REPLACES["segscan"], "launches": elph_adds,
         "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "graph_ms": r["graph_ms"], "train_launches": elph_adds,
         "launches_of": "segscan_add_f32 in the train_elph run, "
                        "all three ELPH add uses together",
         "launches_per_step_counted_in_trace":
             elph["profile"]["k1_add_launches"] / ELPH_PROFILE_STEPS}
        for r in [*spmm_k1.values(), gather_k1]] + [
        {"name": r["name"], "route": "cuda", "source": f"{CSRC}/segscan.cu",
         "replaces": REPLACES["segscan"], "launches": ddi["k1_add_launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "graph_ms": r["graph_ms"],
         "launches_of": "segscan_add_f32 in the three ddi runs, the "
                        "diffusion each way, gather_rows' backward and "
                        "eval together",
         "launches_per_step_counted_in_trace": [
             run["profile"]["k1_add_launches"] / DDI_PROFILE_STEPS
             for run in ddi_runs if "profile" in run]}
        for r in ddi_k1.values()] + [
        {"name": r["name"], "route": "cuda", "source": f"{CSRC}/segscan.cu",
         "replaces": REPLACES["segscan"],
         "launches": seal["k1_launches"]["segscan_add_f32"]
         - seal["z_embedding_backward_launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "graph_ms": r["graph_ms"],
         "launches_of": "segscan_add_f32 in the SEALDGCNN run but the "
                        "label embedding's backward: the union SpMMs each "
                        "way and the degrees, both widths together",
         "launches_per_step_counted_in_trace":
             seal["profile"]["k1_add_launches"] / SEAL_PROFILE_STEPS}
        for r in k1_seal if "union" in r["name"]] + [
        {"name": r["name"], "route": "cuda", "source": f"{CSRC}/segscan.cu",
         "replaces": REPLACES["segscan"], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "graph_ms": r["graph_ms"],
         "launches_of": "this gather_rows backward's K1 adds in its run "
                        "(SEALDGCNN; KGE: that model's)"}
        for r in k1_seal + k1_kge if "backward" in r["name"]] + [
        {"name": r["name"], "route": "cuda", "source": f"{CSRC}/segscan.cu",
         "replaces": REPLACES["segscan"], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "graph_ms": r["graph_ms"],
         "launches_of": "segscan_add_f32 in the dp phase's ELPH run at world "
                        "size 1 on NCCL, all three ELPH add uses together",
         "launches_per_step_counted_in_trace": dp_elph["profile"][
             "k1_add_launches_per_step"]}
        for r in k1_dp] + [
        {"name": r["name"], "route": "cuda", "source": f"{CSRC}/segscan.cu",
         "replaces": REPLACES["segscan"], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "graph_ms": r["graph_ms"],
         "launches_of": next(v for k, v in MG_LAUNCHES_OF.items()
                             if k in r["name"])}
        for r in k1_mg] + [
        {"name": r["name"], "route": "cuda", "source": f"{CSRC}/segscan.cu",
         "replaces": REPLACES["segscan"], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "graph_ms": r["graph_ms"],
         "launches_of": "this instance's K1 launches in rank 0's "
                        "node-sharded build in the scale_equality tool run "
                        "(local and halo merges, 2 hops)"}
        for r in k1_se] + [
        {"name": r["name"], "route": "cuda", "source": f"{CSRC}/segscan.cu",
         "replaces": REPLACES["segscan"], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "graph_ms": r["graph_ms"],
         "launches_of": "segscan_add_bf16 in the bf16 phase's "
                        + ("ELPH run (PlanSpmm each way)" if "PlanSpmm"
                           in r["name"] else "SEALDGCNN run (the union "
                           "SpMMs each way, both widths, and the label "
                           "table's backward)")}
        for r in k1_bf16] + [
        {"name": r["name"], "route": "cuda", "source": f"{CSRC}/segscan.cu",
         "replaces": REPLACES["segscan"], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "graph_ms": r["graph_ms"],
         "launches_of": "segscan_add_f16 in the f16 phase's "
                        + ("ELPH run (PlanSpmm each way)" if "PlanSpmm"
                           in r["name"] else "SEALDGCNN run (the union "
                           "SpMMs each way, both widths, and the label "
                           "table's backward)")}
        for r in k1_f16]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
