"""The port's graph and lane mesh axes (subgraph_sketching_tpu_torch/
parallel: node_sharded, dist_sketch, the mesh's subgroups, the trainers'
graph branches, serving on position-ordered state) on the CPU: one
four-rank gloo session that makes in turn the meshes [4] over graph,
[2, 2] over graph and lane, [2, 2] over data and graph and [2, 2] over
data and lane, held against the JAX package on the conftest's virtual
CPU devices (computed in the parent while the ranks run) and against one
process.

The session runs once per test run (``test_torch_parallel.run_once``);
the ranks import neither jax nor the JAX package.

Tolerances:
  * the partitions, the node-sharded and edge-sharded sketch stacks (in
    node order) and every rank's row count: equal;
  * cardinalities against JAX's: rtol 1e-6, atol 1e-4 (the lane sums
    round differently);
  * node-sharded and lane-sharded subgraph features against JAX's
    ``node_sharded_subgraph_features`` / ``lane_sharded_subgraph_features``
    and BUDDY's graph-mesh preprocessing against the unsharded one:
    rtol 1e-5, atol 1e-4;
  * the memory-sharded ELPH step against the port's single-device
    oracle: losses rtol 1e-5;
  * a [2, 2] data x graph ``--memory_sharded`` ELPH epoch against JAX's
    ``ElphTrainer`` on the same mesh (dropout 0, the biases that feed a
    BatchNorm frozen on both sides): step losses rtol 1e-4;
  * data x graph and data x lane epochs (dropout on) against one
    process's epoch of the same seed: step losses rtol 1e-5 (a sum over
    the world instead of the data axis would count every batch twice);
  * a bfloat16 data x graph ELPH epoch (dropout on) against one
    process's bfloat16 epoch: step losses rtol 1e-2 (each edge shard
    rounds its partial SpMM to bfloat16 before the bfloat16 sum over the
    graph axis; one process rounds each row once);
  * streaming on position-ordered state against a node-sharded rebuild:
    MinHash and HLL bit-equal in node order, cardinalities rtol 1e-6,
    scores rtol 1e-5, atol 1e-5.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from subgraph_sketching_tpu.config import Config as JConfig
from subgraph_sketching_tpu.graph.container import Graph as JGraph
from subgraph_sketching_tpu.graph.preprocess import (
    build_link_dataset as jbuild_link_dataset,
)
from subgraph_sketching_tpu.graph.splits import (
    random_link_split as jrandom_link_split,
)
from subgraph_sketching_tpu.graph.synthetic import barabasi_albert_graph
from subgraph_sketching_tpu.parallel import dist_sketch as jdist
from subgraph_sketching_tpu.parallel import node_sharded as jns
from subgraph_sketching_tpu.parallel.mesh import make_mesh as jmake_mesh
from subgraph_sketching_tpu.sketch import SketchParams as JSketchParams
from subgraph_sketching_tpu.sketch.elph import (
    build_hash_tables as jbuild_hash_tables,
)
from subgraph_sketching_tpu.train import loops as jloops
from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.graph.container import Graph
from subgraph_sketching_tpu_torch.graph.preprocess import (
    LinkDataset, build_link_dataset,
)
from subgraph_sketching_tpu_torch.graph.splits import random_link_split
from subgraph_sketching_tpu_torch.models import elph_state_dict_from_flax
from subgraph_sketching_tpu_torch.parallel import scaling
from subgraph_sketching_tpu_torch.parallel.node_sharded import (
    make_node_partition,
)
from subgraph_sketching_tpu_torch.serving import LinkScorer
from subgraph_sketching_tpu_torch.sketch.minhash import from_biased
from subgraph_sketching_tpu_torch.train import loops

from test_torch_parallel import run_once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
N = 64            # the BA-64 graph of tests/test_parallel.py
MESHES = {"graph4": ([4], ["graph"]), "graph_lane": ([2, 2], ["graph", "lane"]),
          "data_graph": ([2, 2], ["data", "graph"]),
          "data_lane": ([2, 2], ["data", "lane"])}
# the trainer cases: a small split of the BA-64 graph with 8 features
TRAIN = dict(dataset_name="synth-ba", hidden_channels=8, batch_size=64,
             eval_batch_size=64, K=10)
NO_DROPOUT = dict(label_dropout=0.0, feature_dropout=0.0)
PRE_BN = re.compile(r"predictor\.(label_lin_layer|lin_out)\.bias")
STREAM_N = 120
SCALING = ["--dataset_name", "synth-ba", "--device", "cpu",
           "--train_samples", "256", "--scaling_nodes", "200",
           "--scaling_avg_deg", "4", "--iters", "1",
           "--runner_args", "--hidden_channels 8 --batch_size 128 "
           "--eval_batch_size 256 --val_samples 256 --test_samples 256"]
RUNNER = ["--dataset_name", "synth-ba", "--hidden_channels", "8",
          "--batch_size", "128", "--eval_batch_size", "256",
          "--train_samples", "512", "--val_samples", "256",
          "--test_samples", "256", "--epochs", "1", "--K", "10",
          "--device", "cpu"]

_RANK = r'''
import os, re, sys
repo, work, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
sys.path.insert(0, repo)
import numpy as np
import torch
torch.set_num_threads(1)
from subgraph_sketching_tpu_torch.parallel import multihost
multihost.initialize("file://" + os.path.join(work, "store"), num_processes=4,
                     process_id=rank, backend="gloo")
try:
    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.graph.preprocess import (
        build_link_dataset)
    from subgraph_sketching_tpu_torch.parallel.collectives import halo_route
    from subgraph_sketching_tpu_torch.parallel.dist_sketch import (
        edge_sharded_build_hash_tables, lane_sharded_subgraph_features)
    from subgraph_sketching_tpu_torch.parallel.dryrun import dryrun_multichip
    from subgraph_sketching_tpu_torch.parallel.mesh import make_mesh
    from subgraph_sketching_tpu_torch.parallel.node_sharded import (
        make_node_partition, node_sharded_build_hash_tables,
        node_sharded_subgraph_features)
    from subgraph_sketching_tpu_torch.parallel.train import (
        make_distributed_train_step, single_device_reference_step)
    from subgraph_sketching_tpu_torch.parallel import scaling
    from subgraph_sketching_tpu_torch.runners import run
    from subgraph_sketching_tpu_torch.serving import ElphLinkScorer
    from subgraph_sketching_tpu_torch.sketch.elph import build_hash_tables
    from subgraph_sketching_tpu_torch.sketch.params import SketchParams
    from subgraph_sketching_tpu_torch.train import loops

    import time
    seconds, t0 = {}, [time.perf_counter()]

    def lap(what):
        t = time.perf_counter()
        seconds[what] = t - t0[0]
        t0[0] = t

    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    params = SketchParams(max_hops=2)
    ei, links = inp["edge_index"], inp["links"]
    out = {}
    for name, (shape, axes) in inp["meshes"].items():
        mesh = make_mesh(shape, axes, "cpu")
        rec = {"coords": mesh.coords}
        lane = "lane" if "lane" in axes else None
        if "graph" in axes:
            D = mesh.axis_size("graph")
            plan = make_node_partition(ei, inp["num_nodes"], D)
            sk = node_sharded_build_hash_tables(plan, params, mesh,
                                                lane_axis=lane)
            rec["node_sharded"] = sk
            rec["node_features"] = node_sharded_subgraph_features(
                links, sk, params, mesh, perm=plan.perm, lane_axis=lane)
            rec["route"] = halo_route(mesh.group("graph"), "cpu")
            pad = (-ei.shape[1]) % D
            eip = np.concatenate([ei, np.zeros((2, pad), ei.dtype)], axis=1)
            rec["edge_sharded"] = edge_sharded_build_hash_tables(
                eip, inp["num_nodes"], params, mesh,
                mask=np.arange(eip.shape[1]) < ei.shape[1])
        if lane is not None:
            whole = build_hash_tables(ei, inp["num_nodes"], params,
                                      device="cpu")
            rec["lane_features"] = lane_sharded_subgraph_features(
                links, whole, params, mesh)
        out[name] = rec
        lap(name)

    # the memory-sharded ELPH step against its oracle ([4] graph and
    # [2, 2] data x graph)
    s = inp["step"]
    kw = dict(hidden_channels=16, num_nodes=inp["num_nodes"],
              label_dropout=0.0, feature_dropout=0.0)
    ref_init, ref_step, ref_build = single_device_reference_step(
        params, device="cpu", **kw)
    for name in ("graph4", "data_graph"):
        shape, axes = inp["meshes"][name]
        mesh = make_mesh(shape, axes, "cpu")
        plan = make_node_partition(ei, inp["num_nodes"],
                                   mesh.axis_size("graph"))
        init_fn, step_fn, build = make_distributed_train_step(
            mesh, params, node_partition=plan, **kw)
        runs = {"mesh": (init_fn, step_fn, build),
                "oracle": (ref_init, ref_step, ref_build)}
        for what, (i_fn, st_fn, b_fn) in runs.items():
            state = i_fn(0, s["x"])
            sk = b_fn(s["edge_index"])
            out[f"ms_step/{name}/{what}"] = torch.stack([
                st_fn(state, s["x"], s["edge_index"], None, sk, s["links"],
                      s["labels"], torch.Generator().manual_seed(7 + i))
                for i in range(2)])
    lap("ms_steps")

    # trainers on the small split: the JAX-comparison ELPH epoch and the
    # dropout epochs of the data x graph / data x lane meshes
    for case, c in inp["trainer_cases"].items():
        shape, axes = inp["meshes"][c["mesh"]]
        cfg = Config(**c["cfg"], mesh_shape=shape, mesh_axes=axes)
        ds = build_link_dataset(inp["split"]["train"], cfg, "train",
                                device="cpu")
        trainer = {"BUDDY": loops.BuddyTrainer,
                   "ELPH": loops.ElphTrainer}[cfg.model]
        tr = trainer(cfg, ds, ds.x.shape[-1], device="cpu")
        model = tr.init_model(0)
        if c["state"] is not None:
            model.load_state_dict(c["state"])
        for p_name, p in model.named_parameters():
            p.requires_grad_(c["frozen"] is None
                             or not re.fullmatch(c["frozen"], p_name))
        opt = loops.make_optimizer(cfg, model.parameters())
        losses = [tr.run_epoch(model, opt, loops.epoch_seed(0, e),
                               order=None if c["orders"] is None
                               else c["orders"][e])
                  for e in range(c["epochs"])]
        rec = {"losses": torch.cat(losses)}
        if cfg.model == "BUDDY":
            rec["sf"] = torch.from_numpy(ds.subgraph_features)
            rec["sketch_perm"] = ds.sketch_perm
        else:
            rec["predict"] = tr.predict(model, "train")[0]
            if cfg.memory_sharded:
                d = tr._data["train"]
                rec["rows_per_rank"] = int(d["sk_shard"].minhash.shape[1])
                tr.stage("valid", build_link_dataset(
                    inp["split"]["valid"], cfg, "valid", device="cpu"))
                rec["valid_shares_tables"] = (
                    tr._data["valid"]["sk_shard"] is d["sk_shard"])
                # serving on the node-sharded state, beside predict
                rec["served"] = ElphLinkScorer(
                    tr, model, split="valid", min_bucket=64).score(
                        tr._data["valid"]["links"].numpy())
                rec["predict_valid"] = tr.predict(model, "valid")[0]
        out["trainer/" + case] = rec
        lap(case)

    # node-sharded builds of the streaming graphs ([4] graph)
    mesh = make_mesh([4], ["graph"], "cpu")
    for which in ("small", "full"):
        g = inp["stream"][which]
        plan = make_node_partition(g, inp["stream"]["n"], 4)
        out["stream/" + which] = dict(
            sk=node_sharded_build_hash_tables(plan, params, mesh), plan=plan)
    lap("stream")

    # the runner end to end
    out["runner/elph_data_graph_ms"] = run.main(inp["runner"] + [
        "--model", "ELPH", "--mesh_shape", "2,2", "--mesh_axes",
        "data,graph", "--memory_sharded", "1"])
    out["runner/buddy_graph_lane"] = run.main(inp["runner"] + [
        "--model", "BUDDY", "--mesh_shape", "2,2", "--mesh_axes",
        "graph,lane"])
    lap("runner")
    out["dryrun"] = dryrun_multichip(4, device="cpu")
    lap("dryrun")
    # the scaling CLI: the [4] graph mesh's hop and ELPH epoch, then the
    # harness over subgroups of the first 1 and 2 ranks and all 4
    out["scaling"] = scaling.main(inp["scaling"] + [
        "--out", os.path.join(work, "scaling")])
    lap("scaling")
    out["seconds"] = seconds
    out["jax_modules"] = sorted(
        k for k in sys.modules if k in ("jax", "flax", "subgraph_sketching_tpu")
        or k.startswith(("jax.", "jaxlib", "flax.", "subgraph_sketching_tpu.")))
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
finally:
    multihost.shutdown()
'''


def _np(t):
    return np.asarray(t)


def _jax_meshes_features(ei, links):
    """JAX's single-device stacks, and its node- and lane-sharded features
    on the session's meshes (the virtual CPU devices, jitted).  The
    node-sharded features read JAX's single-device stacks laid out at the
    partition's row positions (what its node-sharded build gives, bit for
    bit: tests/test_parallel.py), which spares the sharded build's
    compile."""
    params = JSketchParams(max_hops=2)
    sk = jbuild_hash_tables(jnp.asarray(ei), N, params)
    stacks = {k: _np(getattr(sk, k)) for k in ("minhash", "hll", "cards")}
    out = {"stacks": stacks}
    lk = jnp.asarray(links)
    for name in ("graph4", "graph_lane"):
        shape, axes = MESHES[name]
        mesh = jmake_mesh(shape, tuple(axes))
        lane = "lane" if "lane" in axes else None
        plan = jns.make_node_partition(ei, N, mesh.shape["graph"])
        rows = plan.padded_nodes
        mh = np.full((3, rows, 128), np.iinfo(np.uint32).max, np.uint32)
        hll = np.zeros((3, rows, 256), np.int8)
        cards = np.zeros((rows, 2), np.float32)
        mh[:, plan.perm], hll[:, plan.perm] = stacks["minhash"], stacks["hll"]
        cards[plan.perm] = stacks["cards"]
        pos = type(sk)(jnp.asarray(mh), jnp.asarray(hll), jnp.asarray(cards))
        perm = jnp.asarray(plan.perm)
        out[name] = _np(jax.jit(
            lambda lk, s, m=mesh, pe=perm, la=lane:
            jns.node_sharded_subgraph_features(lk, s, params, m, perm=pe,
                                               lane_axis=la))(lk, pos))
    for name in ("graph_lane", "data_lane"):
        shape, axes = MESHES[name]
        mesh = jmake_mesh(shape, tuple(axes))
        out[name + "/lane"] = _np(jax.jit(
            lambda lk, s, m=mesh: jdist.lane_sharded_subgraph_features(
                lk, s, params, m, axis="lane"))(lk, sk))
    return out


def _split():
    """The trainers' split: the BA-64 graph with 8 seeded features."""
    ei = barabasi_albert_graph(N, 4, seed=0)
    x = np.random.default_rng(1).random((N, 8), dtype=np.float32)
    return (random_link_split(Graph(ei, N, x=x), 0.1, 0.2, seed=0),
            jrandom_link_split(JGraph(ei, N, x=x), 0.1, 0.2, seed=0))


def _freeze(jtr):
    def frozen(path, _):
        return bool(PRE_BN.fullmatch(".".join(k.key for k in path)))
    jtr.optimizer = optax.chain(jtr.optimizer, optax.masked(
        optax.set_to_zero(),
        lambda p: jax.tree_util.tree_map_with_path(frozen, p)))


def _jax_elph(jsplit):
    """JAX's [2, 2] data x graph --memory_sharded ElphTrainer (dropout 0,
    PRE_BN frozen): its initial weights as a port state_dict, its two
    epochs' orders and step losses."""
    jcfg = JConfig(**TRAIN, **NO_DROPOUT, model="ELPH", mesh_shape=[2, 2],
                   mesh_axes=["data", "graph"], memory_sharded=True)
    jds = jbuild_link_dataset(jsplit["train"], jcfg, "train")
    jtr = jloops.ElphTrainer(jcfg, jds, _jparams(jcfg), 8)
    _freeze(jtr)
    state = jtr.init_state(jax.random.PRNGKey(0))
    init = elph_state_dict_from_flax(jax.tree.map(np.asarray, state.params),
                                     jax.tree.map(np.asarray,
                                                  state.batch_stats))
    n = jtr.num_links("train")
    n_used, steps = jloops._epoch_plan(n, jcfg.batch_size, jcfg.train_samples)
    orders = [torch.from_numpy(np.asarray(jax.random.permutation(
        jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), e))[0],
        n)[:n_used]).astype(np.int64)) for e in range(2)]
    epoch = jtr._train_epoch_fn(n_used, steps)
    arrays = {k: v for k, v in jtr._data["train"].items() if k != "num_nodes"}
    losses = []
    for e in range(2):
        state, step_losses = epoch(state, jax.random.fold_in(
            jax.random.PRNGKey(0), e), arrays)
        losses.append(np.asarray(step_losses))
    return init, orders, np.concatenate(losses)


def _jparams(jcfg):
    from subgraph_sketching_tpu.graph.preprocess import (
        sketch_params_from_config,
    )
    return sketch_params_from_config(jcfg)


def _single_process(split, model: str, dtype: str = "float32",
                    epochs: int = 2) -> np.ndarray:
    cfg = Config(**TRAIN, model=model, dtype=dtype)
    ds = build_link_dataset(split["train"], cfg, "train", device="cpu")
    tr = (loops.BuddyTrainer if model == "BUDDY" else loops.ElphTrainer)(
        cfg, ds, ds.x.shape[-1], device="cpu")
    m = tr.init_model(0)
    opt = loops.make_optimizer(cfg, m.parameters())
    return torch.cat([tr.run_epoch(m, opt, loops.epoch_seed(0, e))
                      for e in range(epochs)]).numpy(), ds


def _stream_graphs():
    """JAX's streaming test shape, smaller: a BA graph and the same graph
    less 15 undirected edges."""
    ei_full = barabasi_albert_graph(STREAM_N, 4, seed=7)
    und = ei_full[:, ei_full[0] < ei_full[1]]
    rng = np.random.default_rng(0)
    drop = rng.choice(und.shape[1], 15, replace=False)
    keep = np.ones(und.shape[1], bool)
    keep[drop] = False
    kept = und[:, keep]
    ei_small = np.concatenate([kept, kept[::-1]], axis=1)
    ei_small = ei_small[:, np.lexsort((ei_small[1], ei_small[0]))]
    return ei_small, ei_full, und[:, drop]


def _session(work: str) -> dict:
    ei = barabasi_albert_graph(N, 4, seed=0).astype(np.int64)
    b = 32
    links = torch.from_numpy(np.stack([np.arange(b) % N,
                                       (np.arange(b) * 7 + 3) % N], axis=1))
    x = torch.from_numpy(np.random.default_rng(0).random((N, 16),
                                                         dtype=np.float32))
    split, jsplit = _split()
    jinit, orders, jlosses = _jax_elph(jsplit)
    ei_small, ei_full, dropped = _stream_graphs()
    cases = {
        "elph_jax": dict(mesh="data_graph", epochs=2, orders=orders,
                         state=jinit, frozen=PRE_BN.pattern,
                         cfg={**TRAIN, **NO_DROPOUT, "model": "ELPH",
                              "memory_sharded": True}),
    }
    for m in ("data_graph", "data_lane"):
        for model in ("BUDDY", "ELPH"):
            cases[f"{model}/{m}"] = dict(mesh=m, epochs=2, orders=None,
                                         state=None, frozen=None,
                                         cfg={**TRAIN, "model": model})
    cases["ELPH_bf16/data_graph"] = dict(
        mesh="data_graph", epochs=1, orders=None, state=None, frozen=None,
        cfg={**TRAIN, "model": "ELPH", "dtype": "bfloat16"})
    inputs = dict(edge_index=ei, links=links, num_nodes=N, meshes=MESHES,
                  step=dict(x=x, edge_index=torch.from_numpy(ei),
                            links=links,
                            labels=(torch.arange(b) % 2).float()),
                  split=split, trainer_cases=cases, runner=RUNNER,
                  scaling=SCALING,
                  stream=dict(n=STREAM_N, small=ei_small, full=ei_full))
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    script = os.path.join(work, "rank.py")
    with open(script, "w") as f:
        f.write(_RANK)
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    procs = [subprocess.Popen([sys.executable, script, REPO, work, str(r)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(WORLD)]
    try:   # the references, while the ranks run
        jax_side = _jax_meshes_features(ei, links.numpy())
        single = {m: _single_process(split, m) for m in ("BUDDY", "ELPH")}
        single_bf16 = _single_process(split, "ELPH", dtype="bfloat16",
                                      epochs=1)[0]
    finally:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-6000:]}"
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return dict(ranks=ranks, jax=jax_side, jax_elph_losses=jlosses,
                single={m: v[0] for m, v in single.items()},
                single_bf16=single_bf16,
                unsharded_sf=single["BUDDY"][1].subgraph_features,
                stream=dict(small=ei_small, full=ei_full, dropped=dropped),
                split=split, edge_index=ei, links=links)


@pytest.fixture(scope="module")
def session(request, tmp_path_factory):
    return run_once(request, tmp_path_factory, "graph_mesh_session",
                    _session)


def gather_node_order(shards: list, plan) -> np.ndarray:
    """The graph ranks' shards of one table ([..., S, w] each, in graph
    order) as one [..., num_nodes, w] table in node order."""
    return plan.to_node_order(np.concatenate(shards, axis=-2))


def _ranks_at(session, name):
    """{coords: rank record} of one mesh."""
    return {r[name]["coords"]: r[name] for r in session["ranks"]}


def _jax_stacks(session):
    return session["jax"]["stacks"]


# ------------------------------------------------------------ the stacks --

@pytest.mark.parametrize("name", ["graph4", "graph_lane", "data_graph"])
def test_node_sharded_stacks_equal_jax_single_device(session, name):
    """Every graph line's shards, in graph order (and lane blocks side by
    side), in node order: bit-equal to JAX's build_hash_tables; each rank
    holds padded_nodes / D rows."""
    shape, axes = MESHES[name]
    D = shape[axes.index("graph")]
    plan = make_node_partition(session["edge_index"], N, D)
    want = _jax_stacks(session)
    at = _ranks_at(session, name)
    gi = axes.index("graph")
    li = axes.index("lane") if "lane" in axes else None
    for coords in at:
        if coords[gi] != 0:
            continue
        line = []
        for g in range(D):
            c = list(coords)
            c[gi] = g
            if li is None:
                line.append(at[tuple(c)]["node_sharded"])
            else:
                blocks = []
                for lane in range(shape[li]):
                    c[li] = lane
                    blocks.append(at[tuple(c)]["node_sharded"])
                line.append(type(blocks[0])(
                    *(torch.cat([getattr(bk, f) for bk in blocks], dim=-1)
                      if f != "cards" else blocks[0].cards
                      for f in ("minhash", "hll", "cards"))))
        for sk in line:
            assert sk.minhash.shape[1] * D == plan.padded_nodes
        mh = gather_node_order([s.minhash.numpy() for s in line], plan)
        hll = gather_node_order([s.hll.numpy() for s in line], plan)
        cards = plan.to_node_order(np.concatenate(
            [s.cards.numpy() for s in line])[None])[0]
        np.testing.assert_array_equal(from_biased(mh), want["minhash"])
        np.testing.assert_array_equal(hll, want["hll"])
        np.testing.assert_allclose(cards, want["cards"], rtol=1e-6,
                                   atol=1e-4)


@pytest.mark.parametrize("name", ["graph4", "graph_lane", "data_graph"])
def test_edge_sharded_stacks_equal_jax_single_device(session, name):
    want = _jax_stacks(session)
    for r in session["ranks"]:
        sk = r[name]["edge_sharded"]
        np.testing.assert_array_equal(from_biased(sk.minhash.numpy()),
                                      want["minhash"])
        np.testing.assert_array_equal(sk.hll.numpy(), want["hll"])
        np.testing.assert_allclose(sk.cards.numpy(), want["cards"],
                                   rtol=1e-6, atol=1e-4)


def test_halo_exchange_takes_all_to_all_on_the_cpu(session):
    assert {r["graph4"]["route"] for r in session["ranks"]} \
        == {"all_to_all_single"}


# ---------------------------------------------------------- the features --

@pytest.mark.parametrize("name", ["graph4", "graph_lane"])
def test_node_sharded_features_match_jax(session, name):
    want = session["jax"][name]
    for r in session["ranks"]:
        np.testing.assert_allclose(r[name]["node_features"].numpy(), want,
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", ["graph_lane", "data_lane"])
def test_lane_sharded_features_match_jax(session, name):
    want = session["jax"][name + "/lane"]
    for r in session["ranks"]:
        np.testing.assert_allclose(r[name]["lane_features"].numpy(), want,
                                   rtol=1e-5, atol=1e-4)


# ------------------------------------------------------------- training --

@pytest.mark.parametrize("name", ["graph4", "data_graph"])
def test_memory_sharded_step_equals_its_oracle(session, name):
    for r in session["ranks"]:
        np.testing.assert_allclose(r[f"ms_step/{name}/mesh"].numpy(),
                                   r[f"ms_step/{name}/oracle"].numpy(),
                                   rtol=1e-5)


def test_memory_sharded_epoch_matches_jax_trainer(session):
    want = session["jax_elph_losses"]
    for r in session["ranks"]:
        rec = r["trainer/elph_jax"]
        np.testing.assert_allclose(rec["losses"].numpy(), want, rtol=1e-4)
        assert rec["rows_per_rank"] * 2 >= N
        assert rec["valid_shares_tables"]


def test_serving_node_sharded_elph_matches_predict(session):
    """ElphLinkScorer over the memory-sharded trainer ([2, 2] data x
    graph) scores the valid links as the trainer's predict does."""
    for r in session["ranks"]:
        rec = r["trainer/elph_jax"]
        np.testing.assert_allclose(rec["served"], rec["predict_valid"],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["BUDDY/data_graph", "ELPH/data_graph",
                                  "BUDDY/data_lane", "ELPH/data_lane"])
def test_no_sum_runs_over_the_world(session, case):
    """Dropout on, two epochs: data x graph and data x lane repeat the
    single-process epochs of the same seed; the graph and lane peers of a
    data rank hold the same state bits."""
    model = case.split("/")[0]
    want = session["single"][model]
    losses = [r["trainer/" + case]["losses"].numpy()
              for r in session["ranks"]]
    for got in losses:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert all(np.array_equal(losses[0], got) for got in losses)


def test_bf16_elph_epoch_on_a_data_graph_mesh(session):
    """One bfloat16 ELPH epoch, dropout on, on the [2, 2] data x graph
    mesh (each rank's edge shard through the bfloat16 SpMM, summed over
    the graph axis in bfloat16 by gloo): one process's bfloat16 epoch of
    the same seed, and the four ranks' losses bit-equal."""
    want = session["single_bf16"]
    losses = [r["trainer/ELPH_bf16/data_graph"]["losses"].numpy()
              for r in session["ranks"]]
    for got in losses:
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want, rtol=1e-2)
    assert all(np.array_equal(losses[0], got) for got in losses)


def test_buddy_graph_mesh_preprocessing_matches_unsharded(session):
    want = session["unsharded_sf"]
    for r in session["ranks"]:
        rec = r["trainer/BUDDY/data_graph"]
        assert rec["sketch_perm"] is not None
        np.testing.assert_allclose(rec["sf"].numpy(), want, rtol=1e-5,
                                   atol=1e-4)


# -------------------------------------------------------------- serving --

def _stream_dataset(session, which: str) -> LinkDataset:
    """A LinkDataset holding the ranks' node-sharded build of a streaming
    graph, its shards concatenated in graph order: position-ordered
    state at world size 1, served under its partition's permutation."""
    recs = [r["stream/" + which] for r in session["ranks"]]
    plan = recs[0]["plan"]
    sks = [r["sk"] for r in recs]
    sk = type(sks[0])(*(torch.cat([getattr(s, f) for s in sks],
                                  dim=0 if f == "cards" else 1)
                        for f in ("minhash", "hll", "cards")))
    ei = session["stream"][which]
    g = Graph(ei, STREAM_N)
    rng = np.random.default_rng(0)
    links = rng.integers(0, STREAM_N, (40, 2)).astype(np.int32)
    return LinkDataset(links, np.zeros(40, np.float32), ei, g.weights,
                       STREAM_N, None, g.degrees(), sketches=sk,
                       sketch_perm=plan.perm)


def _node_order(scorer):
    perm = torch.from_numpy(scorer._perm_np)
    return (scorer.sk.minhash[:, perm], scorer.sk.hll[:, perm],
            scorer.sk.cards[perm])


def test_streaming_on_position_ordered_state(session):
    """insert_edges / delete_edges on position-ordered serving state (the
    JAX package's tests/test_serving.py test_streaming_updates_on_node_
    sharded_state): bit-equal in node order to a node-sharded rebuild of
    the changed graph, and its scores to the rebuild's."""
    from subgraph_sketching_tpu_torch.train.loops import build_buddy
    cfg = Config(dataset_name="synth-ba", hidden_channels=16, model="BUDDY",
                 use_feature=False)
    torch.manual_seed(0)
    model = build_buddy(cfg, None, STREAM_N)

    def scorer(which):
        return LinkScorer(cfg, model, _stream_dataset(session, which),
                          min_bucket=64, device="cpu")

    small, full = scorer("small"), scorer("full")
    assert not np.array_equal(small._perm_np, np.arange(STREAM_N))
    queries = np.random.default_rng(3).integers(0, STREAM_N, (128, 2))
    small.insert_edges(session["stream"]["dropped"].T)
    for got, want in zip(_node_order(small), _node_order(full)):
        if got.dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-4)
        else:
            assert torch.equal(got, want)
    np.testing.assert_allclose(small.score(queries), full.score(queries),
                               rtol=1e-5, atol=1e-5)
    golden = scorer("small")
    small.delete_edges(session["stream"]["dropped"].T)
    for got, want in zip(_node_order(small)[:2], _node_order(golden)[:2]):
        assert torch.equal(got, want)


# ------------------------------------------------------ the runner, dry run --

def test_runner_end_to_end_on_graph_meshes(session):
    """--mesh_shape 2,2 --mesh_axes data,graph --memory_sharded 1 trains
    and evaluates ELPH; --mesh_shape 2,2 --mesh_axes graph,lane trains
    BUDDY; every rank reports the same results."""
    for key in ("runner/elph_data_graph_ms", "runner/buddy_graph_lane"):
        results = [r[key] for r in session["ranks"]]
        assert len(results[0]) == 1
        assert all(np.isfinite(v) for v in results[0][0])
        assert all(res == results[0] for res in results)


def test_dryrun_multichip_on_four_ranks(session):
    """[1, 2, 2] over data, graph and lane: the two steps equal the
    single-device step, and the node-sharded half holds 1/2 the rows."""
    for r in session["ranks"]:
        d = r["dryrun"]
        assert len(d["losses"]) == 2 and np.isfinite(d["losses"]).all()
        assert d["rows_per_rank"] * 2 == d["padded_nodes"]
    assert all(r["dryrun"] == session["ranks"][0]["dryrun"]
               for r in session["ranks"])


def test_scaling_cli_over_rank_subgroups(session):
    """``python -m ...parallel.scaling`` on the four ranks: the [4] graph
    mesh's partition, hop and memory-sharded ELPH epoch on synth-ba, then
    measure_node_sharded_scaling at D = 2 (a subgroup of the first two
    ranks) and 4 and measure_scaling at D = 1, 2 and 4: rank 0 gets a
    positive rate for each D, and the stats carry the partition's halo
    rows."""
    from subgraph_sketching_tpu_torch.graph.datasets import get_data
    recs = [r["scaling"] for r in session["ranks"]]
    rank0 = recs[0]
    g = get_data(Config(dataset_name="synth-ba"))[0]["train"].graph
    plan = make_node_partition(g.edge_index, g.num_nodes, WORLD)
    assert [r["halo_rows_per_hop"] for r in recs] == \
        [plan.halo_rows_per_dev] * WORLD
    assert all(r["rows_per_rank"] == plan.shard_size and r["hop_ms"] > 0
               for r in recs)
    assert np.isfinite(rank0["elph_loss"]) and rank0["elph_step_ms"] > 0
    for key, counts in (("node_sharded_edges_per_s", [2, 4]),
                        ("edge_sharded_edges_per_s", [1, 2, 4])):
        assert sorted(rank0[key]) == counts
        assert all(np.isfinite(v) and v > 0 for v in rank0[key].values())
    i = SCALING.index("--scaling_nodes") + 1
    ei = scaling._random_graph(int(SCALING[i]), int(SCALING[i + 2]))
    for d, st in rank0["node_sharded_stats"].items():
        sub = make_node_partition(ei, int(SCALING[i]), d)
        assert st["halo_rows_per_hop"] == sub.halo_rows_per_dev > 0
        assert st["rows_per_rank"] == sub.shard_size
        assert st["build_s"] > 0
    # a rank past a subgroup reports no figure for it
    assert sorted(recs[3]["node_sharded_edges_per_s"]) == [4]
    assert sorted(recs[3]["edge_sharded_edges_per_s"]) == [4]


def test_ranks_import_no_jax(session):
    assert [r["jax_modules"] for r in session["ranks"]] == [[]] * WORLD
