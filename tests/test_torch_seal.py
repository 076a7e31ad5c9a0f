"""The port's SEAL tier (labelling.py, graph/native.py, graph/seal.py,
models/seal.py, the masked ``BatchNorm``, ``seal_state_dict_from_flax``,
train/seal_loop.py and the runner's SEAL path) against the JAX package's,
on the CPU.

Both packages get the same seeded numpy graph, links and features.  JAX
runs on the CPU as its own tests run it; its models start from flax's
initialisation and ``seal_state_dict_from_flax`` carries the weights over.

Tolerances:
  * labels, extracted batches (both paths, every label scheme, fringe
    sampling with ``random`` seeded alike) and sort-pool picks: bit-equal;
  * eval forwards: rtol 1e-5, atol 1e-6 (float32 sums in another order:
    the union SpMM against XLA's per-graph segment sums, and gcn_norm's
    1/sqrt against ``deg ** -0.5``);
  * the masked BatchNorm: outputs and running statistics rtol 1e-5,
    atol 1e-6 (both take flax's E[x²] − E[x]² variance);
  * one batch's gradients (dropout 0): rtol 1e-5 (SEALGIN 1e-4, its
    masked BatchNorm's variance), atol 1e-6 of each parameter's largest
    gradient (Adam's update, about lr a step whatever the gradient's
    size, would hide a wrong magnitude);
  * two training steps (dropout 0, Adam at lr 1e-3): the epoch loss rtol
    1e-5, every parameter and BN buffer rtol 1e-4, atol 1e-5.
"""

import copy
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subgraph_sketching_tpu import labelling as jlabelling
from subgraph_sketching_tpu.config import Config as JConfig
from subgraph_sketching_tpu.graph.container import Graph as JGraph
from subgraph_sketching_tpu.graph.seal import SEALDataset as JSEALDataset
from subgraph_sketching_tpu.models import seal as jseal
from subgraph_sketching_tpu.train.seal_loop import SealTrainer as JSealTrainer
from subgraph_sketching_tpu_torch import labelling
from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.graph.container import Graph
from subgraph_sketching_tpu_torch.graph.native import (
    seal_extract_batch_native,
)
from subgraph_sketching_tpu_torch.graph.seal import SEALDataset
from subgraph_sketching_tpu_torch.graph.synthetic import barabasi_albert_graph
from subgraph_sketching_tpu_torch.models import seal as pseal
from subgraph_sketching_tpu_torch.models.convert import (
    seal_state_dict_from_flax,
)
from subgraph_sketching_tpu_torch.models.gnn import batch_norm
from subgraph_sketching_tpu_torch.runners import run
from subgraph_sketching_tpu_torch.train import checkpoint
from subgraph_sketching_tpu_torch.train.loops import make_optimizer
from subgraph_sketching_tpu_torch.train.seal_loop import SealTrainer

N_NODES, N_FEAT, MAX_NODES, MAX_EDGES = 60, 5, 16, 40


@pytest.fixture(scope="module")
def graphs():
    """A 60-node BA graph (m = 3) with integer weights and features, as a
    JAX and a port ``Graph``, and 14 positive + 14 negative links (one a
    self-link, one between far nodes)."""
    rng = np.random.default_rng(0)
    ei = barabasi_albert_graph(N_NODES, 3, seed=1)
    w = rng.integers(1, 4, ei.shape[1]).astype(np.float32)
    w = np.minimum(w, w[np.lexsort((ei[0], ei[1]))])   # keep it symmetric
    x = rng.standard_normal((N_NODES, N_FEAT)).astype(np.float32)
    pos = ei[:, rng.choice(ei.shape[1], 14, replace=False)].T.astype(np.int64)
    neg = rng.integers(0, N_NODES, (14, 2)).astype(np.int64)
    neg[0] = [7, 7]
    neg[1] = [0, N_NODES - 1]
    return (JGraph(ei, N_NODES, edge_weight=w, x=x),
            Graph(ei, N_NODES, edge_weight=w, x=x), pos, neg)


def _datasets(graphs, native=True, **kw):
    jg, pg, pos, neg = graphs
    kw = dict(max_nodes=MAX_NODES, max_edges=MAX_EDGES, **kw)
    return (JSEALDataset(jg, pos, neg, **kw),
            SEALDataset(pg, pos, neg, native=native, **kw))


def _assert_batches_equal(a, b):
    for f in ("z", "node_mask", "edge_index", "edge_weight", "edge_mask", "x",
              "node_ids", "y", "src_degree", "dst_degree"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)


# ----------------------------------------------------------- labelling --

@pytest.mark.parametrize("fn", ["drnl_node_labeling", "de_node_labeling",
                                "de_plus_node_labeling"])
def test_labels_equal_jax(graphs, fn):
    """Each labelling of the 1- and 2-hop subgraphs of every link, with
    unreachable nodes (max_dist 3 and 100)."""
    _, pg, pos, neg = graphs
    A = pg.csr()
    for src, dst in np.concatenate([pos, neg])[:10]:
        for hops in (1, 2):
            nodes = sorted({src, dst} | set(A[[src, dst]].indices)
                           | (set(A[A[[src, dst]].indices].indices)
                              if hops == 2 else set()))
            adj = A[nodes, :][:, nodes]
            s, d = nodes.index(src), nodes.index(dst)
            for max_dist in (3, 100):
                want = getattr(jlabelling, fn)(adj, s, d, max_dist)
                got = getattr(labelling, fn)(adj, s, d, max_dist)
                np.testing.assert_array_equal(got, want)
    assert labelling.get_drnl_lookup(4, 2) == jlabelling.get_drnl_lookup(4, 2)
    assert labelling.get_max_label("drnl", 4, 1) == \
        jlabelling.get_max_label("drnl", 4, 1)


# ----------------------------------------------------------- extraction --

@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("label", ["drnl", "de", "de+", "hop", "zo",
                                   "degree"])
def test_batches_bit_equal_jax(graphs, native, label):
    """Every link through the C++ extractor (``_extract_batch_native``) or
    the python path, 1 and 2 hops (2 hops fill max_nodes and max_edges,
    so both caps act), against the JAX package's same path."""
    for hops in (1, 2):
        jds, pds = _datasets(graphs, native, num_hops=hops,
                             node_label=label)
        idx = np.arange(len(pds))
        want = (jds._extract_batch_native(idx) if native
                else jds._extract_batch_python(idx))
        _assert_batches_equal(pds.extract_batch(idx), want)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_sampled_batches_follow_the_random_stream(graphs, native):
    """Fringe sampling (ratio_per_hop 0.5, max_nodes_per_hop 3) draws from
    the stdlib ``random`` stream: seeded alike, both packages extract the
    same subgraphs, batch after batch."""
    kw = dict(num_hops=2, ratio_per_hop=0.5, max_nodes_per_hop=3)
    jds, pds = _datasets(graphs, native, **kw)
    idx = np.arange(len(pds))
    random.seed(5)
    want = [(jds._extract_batch_native(idx) if native
             else jds._extract_batch_python(idx)) for _ in range(2)]
    random.seed(5)
    got = [pds.extract_batch(idx) for _ in range(2)]
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
    assert not np.array_equal(got[0].node_ids, got[1].node_ids)


def test_static_dataset_and_extract_one_equal_jax(graphs):
    jds, _ = _datasets(graphs, dynamic=False)
    _, pds = _datasets(graphs, dynamic=False)
    idx = np.array([3, 0, 27, 3])
    _assert_batches_equal(pds.batch(idx), jds.batch(idx))
    for i in (0, 15):
        got, want = pds.extract_one(i), jds.extract_one(i)
        assert list(got[0]) == list(want[0])
        np.testing.assert_array_equal(got[1], want[1])
        for a, b in zip(got[2], want[2]):
            np.testing.assert_array_equal(a, b)
        assert got[5:] == want[5:]


@pytest.mark.parametrize("case", ["max_nodes", "overflow", "negative",
                                  "past_int32"])
def test_native_binding_refuses(case):
    """The binding's checks before any pointer reaches the C++: the two
    centres need max_nodes >= 2, an int32 CSR cannot hold 2^31 nonzeros,
    and out-of-range link ids are refused on the int64 array (2^32 + 3
    would wrap to the valid id 3 through the int32 cast)."""
    indptr = np.array([0, 1, 2, 2], np.int64)
    indices = np.array([1, 0], np.int32)
    links = np.array([[0, 1]], np.int64)
    args = dict(max_nodes=4, max_edges=8)
    err = ValueError
    if case == "max_nodes":
        args["max_nodes"] = 1
    elif case == "overflow":
        indptr = np.array([0, 1, 2, 2 ** 31], np.int64)
        err = OverflowError
    elif case == "negative":
        links = np.array([[0, 1], [-1, 2]], np.int64)
    else:
        links = np.array([[0, 2 ** 32 + 3]], np.int64)
    with pytest.raises(err):
        seal_extract_batch_native(indptr, indices, None, 3, links, 1,
                                  args["max_nodes"], args["max_edges"], 4,
                                  "drnl")


# --------------------------------------------------------------- models --

def _j_batch(raw, node_ids=False, node_emb=None):
    b = {"z": jnp.asarray(raw.z), "node_mask": jnp.asarray(raw.node_mask),
         "edge_index": jnp.asarray(raw.edge_index),
         "edge_weight": jnp.asarray(raw.edge_mask.astype(np.float32)),
         "edge_mask": jnp.asarray(raw.edge_mask)}
    if raw.x is not None:
        b["x"] = jnp.asarray(raw.x)
    if node_ids:
        b["node_ids"] = jnp.asarray(raw.node_ids)
    if node_emb is not None:
        b["node_emb"] = jnp.asarray(node_emb[np.maximum(raw.node_ids, 0)])
    return b


def _p_batch(raw, node_ids=False, node_emb=None):
    b = {"z": torch.from_numpy(raw.z.astype(np.int64)),
         "node_mask": torch.from_numpy(raw.node_mask),
         "graph": pseal.UnionGraph.from_padded(
             raw.edge_index, raw.edge_mask.astype(np.float32), raw.edge_mask,
             raw.z.shape[1], "cpu")}
    if raw.x is not None:
        b["x"] = torch.from_numpy(raw.x)
    if node_ids:
        b["node_ids"] = torch.from_numpy(raw.node_ids.astype(np.int64))
    if node_emb is not None:
        b["node_emb"] = torch.from_numpy(node_emb[np.maximum(raw.node_ids,
                                                             0)])
    return b


# name, label, use_feature, extra JAX/port kwargs, node embedding kind
MODEL_CASES = {
    "gcn_feat_edge": ("SEALGCN", "drnl", True, {"pooling": "edge"}, None),
    "gcn_de_add": ("SEALGCN", "de", False, {"pooling": "add"}, None),
    "sage_frozen_emb": ("SEALSAGE", "drnl", True, {}, "frozen"),
    "gin_trainable_emb_eps": ("SEALGIN", "drnl", False, {"train_eps": True},
                              "trainable"),
    "dgcnn_pad_k": ("SEALDGCNN", "drnl", False, {"k": 24}, None),
    "dgcnn_ties": ("SEALDGCNN", "drnl", False, {"k": 10}, None),
    "mlp": ("SEALMLP", "drnl", False, {}, None),
}


def _models(name, use_feature, kw, emb, hidden=8, layers=2):
    if name == "SEALMLP":
        return (jseal.SEALMLP(emb_dim=12, dropout=0.0, pooling="mean"),
                pseal.SEALMLP(12, dropout=0.0, pooling="mean"))
    common = dict(hidden_channels=hidden, num_layers=layers, max_z=7,
                  use_feature=use_feature, dropout=0.0,
                  use_node_embedding=emb == "trainable", num_nodes=N_NODES)
    port_kw = dict(common, num_features=N_FEAT if use_feature else 0,
                   node_emb_dim=6 if emb == "frozen" else 0)
    return (getattr(jseal, name)(**common, **kw),
            getattr(pseal, name)(**port_kw, **kw))


def _jinit(jmodel, jbatch, seed=0):
    """flax's initialisation of ``jmodel`` (jitted: eager init dispatches
    op by op)."""
    key = jax.random.PRNGKey(seed)
    return jax.jit(lambda b: jmodel.init({"params": key, "dropout": key}, b,
                                         training=False))(jbatch)


def _carry(jmodel, pmodel, jbatch, seed=0):
    variables = _jinit(jmodel, jbatch, seed)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables.get("batch_stats", {}))
    if "eps_0" in params:   # zero-initialised: move them off zero
        params = dict(params, eps_0=np.float32(0.3), eps_1=np.float32(-0.2))
    pmodel.load_state_dict(seal_state_dict_from_flax(params, stats))
    return {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_seal_models_eval_forward_match_jax(graphs, case):
    """Each SEAL model's eval forward from the same weights: DE labels,
    node features, a frozen and a trainable node embedding, GIN's eps,
    DGCNN's sort pool with fewer nodes than k and with k below the
    subgraph sizes (tied keys on label-only inputs)."""
    name, label, use_feature, kw, emb = MODEL_CASES[case]
    _, pds = _datasets(graphs, num_hops=2, node_label=label,
                       use_feature=use_feature)
    raw = pds.extract_batch(np.arange(len(pds)))
    table = (np.random.default_rng(1).standard_normal((N_NODES, 6))
             .astype(np.float32) if emb == "frozen" else None)
    jb = _j_batch(raw, emb == "trainable", table)
    pb = _p_batch(raw, emb == "trainable", table)
    jmodel, pmodel = _models(name, use_feature, kw, emb)
    variables = _carry(jmodel, pmodel, jb)
    want = np.asarray(jax.jit(lambda v, b: jmodel.apply(
        v, b, training=False))(variables, jb))
    pmodel.eval()
    with torch.no_grad():
        got = pmodel(pb).numpy()
    assert got.shape == want.shape == (len(pds), 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_global_sort_pool_ties_signed_zeros_and_short_graphs():
    """The stable sort on the negated last channel: ties (and +0 against
    -0) keep node order, padding sorts last, graphs shorter than k are
    padded with zero rows; bit-equal picks."""
    x = np.zeros((3, 5, 2), np.float32)
    x[0, :, 1] = [0.0, -0.0, 0.5, 0.0, -0.0]
    x[0, :, 0] = np.arange(5)
    x[1, :, 1] = [1.0, 1.0, 1.0, -1.0, 1.0]
    x[1, :, 0] = np.arange(5) + 10
    x[2, :, 1] = [-0.0, 2.0, 0.0, 2.0, 5.0]
    x[2, :, 0] = np.arange(5) + 20
    mask = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 1, 1], [1, 1, 1, 0, 0]],
                    bool)
    for k in (3, 5, 7):
        _, want = jseal.global_sort_pool(jnp.asarray(x), jnp.asarray(mask),
                                         k)
        got = pseal.global_sort_pool(torch.from_numpy(x),
                                     torch.from_numpy(mask), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_masked_batch_norm_matches_flax():
    """Training mode with a row mask: outputs, the input gradient and the
    running statistics after two calls equal flax's masked BatchNorm;
    eval mode reads the running statistics."""
    import flax.linen as nn

    rng = np.random.default_rng(2)
    xs = [(rng.standard_normal((40, 6)) * 3 + 5).astype(np.float32)
          for _ in range(2)]
    mask = rng.random(40) < 0.6
    jbn = nn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]),
                 mask=jnp.asarray(mask)[:, None])
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = v["batch_stats"]
    bn = batch_norm(6)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    bn.train()
    for x in xs:
        def f(xx, stats=stats):
            return jbn.apply({"params": params, "batch_stats": stats}, xx,
                             mask=jnp.asarray(mask)[:, None],
                             mutable=["batch_stats"])
        (want, upd) = f(jnp.asarray(x))
        stats = upd["batch_stats"]
        jgrad = jax.grad(lambda xx: jnp.sum(f(xx)[0] ** 3))(jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_(True)
        got = bn(xt, mask=torch.from_numpy(mask))
        (got ** 3).sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-5,
                               atol=1e-6)


# -------------------------------------------------------------- trainer --

def _trainers(graphs, model, **kw):
    jg, pg, pos, neg = graphs
    base = dict(dataset_name="synth-ba", model=model, hidden_channels=8,
                num_seal_layers=2, dropout=0.0, batch_size=18, lr=1e-3,
                num_hops=2, **kw)
    ds_kw = dict(num_hops=2, max_nodes=MAX_NODES, max_edges=MAX_EDGES)
    jds = {s: JSEALDataset(jg, pos, neg, **ds_kw)
           for s in ("train", "valid", "test")}
    pds = {s: SEALDataset(pg, pos, neg, use_feature=False, **ds_kw)
           for s in ("train", "valid", "test")}
    jtr = JSealTrainer(JConfig(**base), jds, N_FEAT)
    return jtr, SealTrainer(Config(**base), pds, {s: pg.x for s in pds},
                            device="cpu")


def _grads_match_jax(jtr, tr, state, pmodel, idx):
    """One batch's gradient in every parameter: the port's loss.backward
    (on a copy of the model, in training mode, dropout off) against
    jax.grad of the JAX trainer's loss from the same state (DGCNN, whose
    dropout is fixed, applied with training=False as in
    ``_jax_dgcnn_epoch``).  rtol 1e-5 (SEALGIN 1e-4, as the masked
    BatchNorm's own gradient is held: flax's E[x²] − E[x]² variance
    cancels), atol 1e-6 of the parameter's largest gradient: Adam's
    update would hide a gradient of the wrong size."""
    mask = np.ones(len(idx), bool)
    jbatch, jy = jtr._to_device(jtr.datasets["train"].batch(idx))
    training = not isinstance(jtr.model, jseal.SEALDGCNN)
    rtol = 1e-4 if isinstance(jtr.model, jseal.SEALGIN) else 1e-5

    def loss_fn(params):
        logits, _ = jtr.model.apply(
            {"params": params, "batch_stats": state.batch_stats}, jbatch,
            training=training, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        return jtr.loss_fn(logits, jy, jnp.asarray(mask))

    want = seal_state_dict_from_flax(
        jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(state.params)),
        jax.tree.map(np.asarray, state.batch_stats))
    model = copy.deepcopy(pmodel).train()
    model.drop.p = 0.0
    batch, y = tr.to_device(tr.datasets["train"].batch(idx))
    tr.loss_fn(model(batch), y, torch.from_numpy(mask)).backward()
    for k, p in model.named_parameters():
        w = want[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=rtol,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)


def _jax_dgcnn_epoch(jtr, state, order):
    """The JAX trainer's epoch with DGCNN's fixed dropout off: its own
    batches, loss and optimizer, the model applied with training=False
    (DGCNN has no BatchNorm, so that differs in dropout alone)."""
    import optax

    @jax.jit
    def step(params, opt_state, batch, y, mask):
        def loss_fn(p):
            logits = jtr.model.apply({"params": p}, batch, training=False)
            return jtr.loss_fn(logits, y, mask)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = jtr.optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    bs = jtr.cfg.batch_size
    params, opt_state, losses = state.params, state.opt_state, []
    for s in range(0, len(order), bs):
        idx = order[s:s + bs]
        mask = np.arange(bs) < len(idx)
        idx = np.concatenate([idx, np.zeros(bs - len(idx), np.int64)])
        batch, y = jtr._to_device(jtr.datasets["train"].batch(idx))
        params, opt_state, loss = step(params, opt_state, batch, y,
                                       jnp.asarray(mask))
        losses.append(float(loss))
    return params, {}, sum(losses) * bs / len(order)


@pytest.mark.parametrize("model", ["SEALGCN", "SEALGIN", "SEALDGCNN"])
def test_trainer_steps_match_jax(graphs, model):
    """Two SealTrainer steps (28 links at batch 18: a padded second
    batch) from the JAX trainer's initial state, on its permutation,
    against the JAX step: the first batch's gradients, the epoch loss,
    every parameter, SEALGIN's BatchNorm running statistics (padded
    subgraphs included, as in JAX) and ``predict``."""
    from subgraph_sketching_tpu.train.loops import TrainState
    jtr, tr = _trainers(graphs, model)
    batch, _ = jtr._to_device(jtr.datasets["train"].batch(np.arange(2)))
    v = _jinit(jtr.model, batch)
    state = TrainState(v["params"], v.get("batch_stats", {}),
                       jtr.optimizer.init(v["params"]))
    pmodel = tr.init_model(0)
    pmodel.load_state_dict(seal_state_dict_from_flax(
        jax.tree.map(np.asarray, state.params),
        jax.tree.map(np.asarray, state.batch_stats)))
    opt = make_optimizer(tr.cfg, pmodel.parameters())
    rng = np.random.default_rng(3)
    order = copy.deepcopy(rng).permutation(len(tr.datasets["train"]))
    _grads_match_jax(jtr, tr, state, pmodel, order[:18])
    if model == "SEALDGCNN":
        params, stats, jloss = _jax_dgcnn_epoch(jtr, state, order)
        pmodel.drop.p = 0.0
    else:
        state, jloss = jtr.train_epoch(state, rng, jax.random.PRNGKey(1))
        params, stats = state.params, state.batch_stats
    loss = tr.train_epoch(pmodel, opt, 0, order=order)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    want = seal_state_dict_from_flax(jax.tree.map(np.asarray, params),
                                     jax.tree.map(np.asarray, stats))
    got = pmodel.state_dict()
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    if model == "SEALGIN":
        assert any(k.endswith("running_var") for k in want)
    if model != "SEALDGCNN":
        jpred, jlab = jtr.predict(state, "valid")
        pred, lab = tr.predict(pmodel, "valid")
        np.testing.assert_array_equal(lab, jlab)
        np.testing.assert_allclose(pred, jpred, rtol=1e-4, atol=1e-4)


def test_determinism_check_replays_the_sampling_stream(graphs):
    """With fringe sampling (ratio_per_hop 0.5) an epoch draws its
    subgraphs from the stdlib ``random`` stream: the check runs both
    epochs from one state of it, passes, and leaves it as it was."""
    from subgraph_sketching_tpu_torch.train.determinism import (
        check_epoch_determinism,
    )
    _, tr = _trainers(graphs, "SEALGCN", ratio_per_hop=0.5)
    for ds in tr.datasets.values():
        ds.ratio_per_hop = 0.5
    model = tr.init_model(0)
    opt = make_optimizer(tr.cfg, model.parameters())
    random.seed(4)
    before = random.getstate()
    check_epoch_determinism(tr, model, opt, 7)
    assert random.getstate() == before


def test_edge_weights_reach_the_model_only_with_the_flag(graphs):
    _, tr = _trainers(graphs, "SEALGCN")
    raw = tr.datasets["train"].batch(np.arange(4))
    off = tr.to_device(raw)[0]["graph"].edge_weight
    tr.cfg.use_edge_weight = True
    on = tr.to_device(raw)[0]["graph"].edge_weight
    assert bool((off == 1).all())
    np.testing.assert_array_equal(on.numpy(),
                                  raw.edge_weight[raw.edge_mask])


# --------------------------------------------------------------- runner --

SMALL = ["--dataset_name", "synth-ba", "--model", "SEALDGCNN",
         "--hidden_channels", "8", "--num_seal_layers", "2", "--epochs", "2",
         "--sortpool_k", "20",
         "--batch_size", "256", "--dynamic_train", "--train_samples", "512",
         "--dynamic_val", "--val_samples", "256", "--dynamic_test",
         "--test_samples", "256", "--K", "20", "--device", "cpu"]


@pytest.fixture(scope="module")
def seal_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("seal_runs")
    straight, resumed = str(base / "straight"), str(base / "resumed")
    first = run.main(SMALL + ["--checkpoint_dir", straight,
                              "--checkpoint_every", "1",
                              "--check_determinism"])
    run.main(SMALL + ["--checkpoint_dir", resumed, "--checkpoint_every",
                      "1", "--epochs", "1"])
    again = run.main(SMALL + ["--checkpoint_dir", resumed,
                              "--checkpoint_every", "1", "--resume"])
    return straight, resumed, first, again


def test_seal_runner_resume_is_bit_equal(seal_runs):
    """--model SEALDGCNN through runners.run on the CPU: the determinism
    check passes, and 1 epoch, save, --resume, 1 epoch give the straight
    2-epoch run's model, Adam state and results bit for bit."""
    straight, resumed, first, again = seal_runs
    a, _ = checkpoint.load_checkpoint(straight, 2)
    b, _ = checkpoint.load_checkpoint(resumed, 2)
    assert "conv2.weight" in a["model"]
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)
    assert again == first and np.isfinite(np.asarray(first)).all()
