"""The port's node-embedding modules (models/gnn.py ``SIGNEmbedding``,
BUDDY's embedding branch, train/loops.py ``ElphEmbedding`` /
``BuddyWithEmbedding`` and their init, utils.py
``load_pretrained_embedding``, and models/convert.py on trees that carry
a table) against the JAX package's, on the CPU.

Both sides get the same seeded numpy inputs and the same weights (flax
initialises them, models/convert.py carries them over); JAX runs on the
CPU as its own tests run it (the plan reduce with the XLA merge).

Tolerances:
  * SIGNEmbedding outputs and the table's gradient, in eval and in
    training mode (dropout 0), by the plan and by the scatter route: rtol
    1e-5, atol 1e-6; the BatchNorm statistics it leaves: rtol 1e-5, atol
    1e-6;
  * BUDDY with embedding rows, eval and training mode: rtol 1e-5, atol
    1e-6;
  * conversions: equal.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from subgraph_sketching_tpu.models.buddy import BUDDY as JBUDDY
from subgraph_sketching_tpu.models.gnn import SIGNEmbedding as JSIGNEmbedding
from subgraph_sketching_tpu.ops.graph_ops import gcn_norm as jgcn_norm
from subgraph_sketching_tpu.ops.segment_scan import PlanSpmm as JPlanSpmm
from subgraph_sketching_tpu.train import loops as jloops
from subgraph_sketching_tpu.utils import (
    load_pretrained_embedding as jload_pretrained_embedding,
)
from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.graph.synthetic import watts_strogatz_graph
from subgraph_sketching_tpu_torch.models import (
    BUDDY, adam_state_from_optax, buddy_state_dict_from_flax,
    elph_state_dict_from_flax,
)
from subgraph_sketching_tpu_torch.models import gnn
from subgraph_sketching_tpu_torch.models.convert import (
    _batch_stats_from_flax, _parameters_from_flax,
)
from subgraph_sketching_tpu_torch.models.gnn import SIGNEmbedding
from subgraph_sketching_tpu_torch.ops.graph_ops import gcn_norm
from subgraph_sketching_tpu_torch.ops.segment_scan import PlanSpmm
from subgraph_sketching_tpu_torch.train import loops
from subgraph_sketching_tpu_torch.utils import load_pretrained_embedding


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs in several worker processes on
    one machine, where each worker's default of one thread per core
    oversubscribes it; the tolerances hold at any count."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _graph(n=300, seed=4):
    return watts_strogatz_graph(n, 6, 0.2, seed=seed).astype(np.int32), n


def _state_dict(variables) -> dict:
    return {**_parameters_from_flax(_np_tree(variables["params"])),
            **_batch_stats_from_flax(_np_tree(variables.get("batch_stats",
                                                            {})))}


# -------------------------------------------------------- SIGNEmbedding --

class _Counted:
    """A PlanSpmm that counts its calls."""

    def __init__(self, plan):
        self.plan, self.calls = plan, 0

    def __call__(self, x):
        self.calls += 1
        return self.plan(x)


@pytest.mark.parametrize("route", ["plan", "scatter"])
@pytest.mark.parametrize("K", [1, 2])
def test_sign_embedding_matches_flax(K, route, monkeypatch):
    """Eval-mode outputs, then a training-mode forward (dropout 0): its
    outputs, the table's gradient under a random cotangent, and the
    BatchNorm statistics over the table's rows; the port propagates K
    times (the JAX loop's last propagation is dead)."""
    ei, n = _graph()
    rng = np.random.default_rng(K)
    x = rng.normal(size=(n, 24)).astype(np.float32)
    cot = rng.normal(size=(n, 16)).astype(np.float32)
    jm = JSIGNEmbedding(32, 16, K, 0.0)
    variables = jm.init(jax.random.PRNGKey(K), jnp.asarray(x),
                        jnp.asarray(ei), n)
    model = SIGNEmbedding(24, 32, 16, K, 0.0)
    model.load_state_dict(_state_dict(variables))
    tei = torch.from_numpy(ei.astype(np.int64))
    kw, jkw = {}, {}
    calls = []
    if route == "plan":
        jei, jw, _ = jgcn_norm(jnp.asarray(ei), None, n)
        jps = JPlanSpmm(np.asarray(jei), np.asarray(jw), n)
        jkw["spmm_ctx"] = (jps, jps.tables)
        nei, nw = gcn_norm(tei, None, n)
        kw["plan"] = counted = _Counted(PlanSpmm(nei.numpy(), nw.numpy(), n,
                                                 device="cpu"))
    else:
        spmm = gnn.spmm
        monkeypatch.setattr(gnn, "spmm",
                            lambda *a: calls.append(1) or spmm(*a))

    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(ei), n, **jkw)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), tei, n, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)

    def jloss(table):
        out, upd = jm.apply(variables, table, jnp.asarray(ei), n,
                            training=True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(0)}, **jkw)
        return jnp.sum(out * jnp.asarray(cot)), (out, upd)

    (_, (want, upd)), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = model.train()(tx, tei, n, **kw)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-5, atol=1e-6)
    for k, v in _batch_stats_from_flax(_np_tree(upd["batch_stats"])).items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(model.state_dict()[k].numpy(),
                                       v.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    # two forwards (eval, train), K propagations each
    n_calls = counted.calls if route == "plan" else len(calls)
    assert n_calls == 2 * K


# ---------------------------------------------------------------- BUDDY --

@pytest.mark.parametrize("use_feature", [False, True])
def test_buddy_with_embedding_matches_flax(use_feature):
    """BUDDY's embedding branch (lin_emb -> Hadamard -> lin_emb_out ->
    bn_embs), with and without the feature branch beside it: eval-mode
    logits, then training mode (dropout 0) and its BN statistics."""
    rng = np.random.default_rng(5)
    B, sf_dim, d, emb_dim = 48, 8, 12, 20
    sf = rng.normal(size=(B, sf_dim)).astype(np.float32)
    nf = rng.normal(size=(B, 2, d)).astype(np.float32)
    emb = rng.normal(size=(B, 2, emb_dim)).astype(np.float32)
    deg = rng.integers(1, 9, (2, B)).astype(np.float32)
    jm = JBUDDY(sf_dim, 16, use_feature=use_feature, use_embedding=True,
                label_dropout=0.0, feature_dropout=0.0)
    jargs = dict(sf=jnp.asarray(sf),
                 node_features=jnp.asarray(nf) if use_feature else None,
                 src_degree=jnp.asarray(deg[0]),
                 dst_degree=jnp.asarray(deg[1]), emb=jnp.asarray(emb))
    variables = jm.init(jax.random.PRNGKey(3), **jargs)
    model = BUDDY(sf_dim, 16, d if use_feature else None,
                  use_feature=use_feature, use_embedding=True,
                  label_dropout=0.0, feature_dropout=0.0, emb_dim=emb_dim)
    model.load_state_dict(_state_dict(variables))
    targs = dict(sf=torch.from_numpy(sf),
                 node_features=torch.from_numpy(nf) if use_feature else None,
                 src_degree=torch.from_numpy(deg[0]),
                 dst_degree=torch.from_numpy(deg[1]),
                 emb=torch.from_numpy(emb))
    with torch.no_grad():
        got = model.eval()(**targs)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jm.apply(variables, **jargs)),
                                   rtol=1e-5, atol=1e-6)
        got = model.train()(**targs)
    want, upd = jm.apply(variables, **jargs, training=True,
                         mutable=["batch_stats"],
                         rngs={"dropout": jax.random.PRNGKey(2)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    for k, v in _batch_stats_from_flax(_np_tree(upd["batch_stats"])).items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(model.state_dict()[k].numpy(),
                                       v.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


# ------------------------------------------------------------ conversion --

def _jax_buddy_with_embedding(propagate=True, frozen=None, n=120):
    """A flax BuddyWithEmbedding (the JAX BUDDY trainer's model) and its
    variables; ``frozen`` a pretrained table."""
    ei, _ = _graph(n)
    buddy = JBUDDY(8, 16, use_feature=False, use_embedding=True)
    jm = jloops.BuddyWithEmbedding(buddy=buddy, num_nodes=n,
                                   hidden_channels=16, use_embedding=True,
                                   propagate=propagate, sign_k=2)
    links = np.random.default_rng(0).integers(0, n, (8, 2)).astype(np.int32)
    variables = jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        links=jnp.asarray(links), edge_index=jnp.asarray(ei), num_nodes=n,
        frozen_table=None if frozen is None else jnp.asarray(frozen),
        sf=jnp.zeros((8, 8)), src_degree=jnp.ones(8), dst_degree=jnp.ones(8))
    return _np_tree(variables["params"]), _np_tree(variables["batch_stats"])


def _port_buddy(propagate=True, frozen=None, n=120, embedding=True):
    cfg = Config(hidden_channels=16, sign_k=2, use_feature=False,
                 train_node_embedding=embedding and frozen is None,
                 pretrained_node_embedding=(None if frozen is None
                                            else "table.npy"),
                 propagate_embeddings=propagate)
    return loops.build_buddy(
        cfg, None, n, None if frozen is None else torch.from_numpy(frozen))


def test_buddy_conversion_carries_the_table():
    """The JAX tree {buddy, node_embedding, sign_embedding} loads into a
    BuddyWithEmbedding whole (strict), node_embedding as it is and the
    sign_embedding kernels transposed; the old unwrap kept only
    ``buddy`` and lost the table; a plain BUDDY refuses the tree."""
    params, stats = _jax_buddy_with_embedding()
    model = _port_buddy()
    assert isinstance(model, loops.BuddyWithEmbedding)
    sd = buddy_state_dict_from_flax(params, stats, model)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    np.testing.assert_array_equal(sd["node_embedding"].numpy(),
                                  params["node_embedding"])
    np.testing.assert_array_equal(
        sd["sign_embedding.lin_1.weight"].numpy(),
        params["sign_embedding"]["lin_1"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["sign_embedding.bn_2.running_var"].numpy(),
        stats["sign_embedding"]["bn_2"]["var"])
    np.testing.assert_array_equal(sd["buddy.lin_emb.weight"].numpy(),
                                  params["buddy"]["lin_emb"]["kernel"].T)
    # without the model the target follows the tree
    assert set(buddy_state_dict_from_flax(params, stats)) == set(sd)

    def old_unwrap(p):
        return p["buddy"] if "buddy" in p else p

    assert "node_embedding" not in _parameters_from_flax(old_unwrap(params))
    assert "node_embedding" in _parameters_from_flax(params)
    plain = _port_buddy(embedding=False, propagate=False)
    assert isinstance(plain, BUDDY)
    with pytest.raises(ValueError, match="node-embedding table"):
        buddy_state_dict_from_flax(params, stats, plain)


@pytest.mark.parametrize("propagate", [False, True])
def test_buddy_conversion_of_a_frozen_table(propagate):
    """A pretrained table rides as data: the JAX tree has no
    node_embedding (and no sign_embedding without propagation), the port
    model holds the table as a buffer outside its state_dict."""
    frozen = np.random.default_rng(1).normal(size=(120, 8)).astype(
        np.float32)
    params, stats = _jax_buddy_with_embedding(propagate, frozen)
    assert "node_embedding" not in params
    model = _port_buddy(propagate, frozen)
    assert "frozen_table" not in model.state_dict()
    assert not any("node_embedding" in k for k, _ in model.named_parameters())
    model.load_state_dict(buddy_state_dict_from_flax(params, stats, model))
    assert model.buddy.lin_emb.in_features == (16 if propagate else 8)


def test_elph_conversion_carries_the_embedding():
    """elph_state_dict_from_flax maps embedding/node_embedding and
    embedding/sign_embedding/{lin_k, bn_k, lin_out} into the ELPH model's
    ``embedding`` child, which loads strictly."""
    from subgraph_sketching_tpu.config import Config as JConfig
    from subgraph_sketching_tpu.graph.preprocess import (
        LinkDataset as JLinkDataset,
    )
    from subgraph_sketching_tpu.graph.preprocess import (
        sketch_params_from_config as jsketch_params,
    )
    from subgraph_sketching_tpu_torch.graph.preprocess import LinkDataset
    ei, n = _graph(120)
    links = np.random.default_rng(0).integers(0, n, (40, 2)).astype(np.int32)
    labels = np.ones(40, np.float32)
    kw = dict(dataset_name="synth-ws", model="ELPH", hidden_channels=16,
              use_feature=False, use_struct_feature=False,
              train_node_embedding=True, propagate_embeddings=True,
              sign_k=2, max_hash_hops=1)
    jcfg = JConfig(**kw)
    w = np.ones(ei.shape[1], np.float32)
    jtr = jloops.ElphTrainer(
        jcfg, JLinkDataset(links, labels, ei, w, n, None, np.ones(n)),
        jsketch_params(jcfg), None)
    state = jtr.init_state(jax.random.PRNGKey(0))
    params, stats = _np_tree(state.params), _np_tree(state.batch_stats)
    tr = loops.ElphTrainer(Config(**kw), LinkDataset(
        links, labels, ei, w, n, None, np.ones(n, np.float32)), None,
        device="cpu")
    model = tr.init_model(0)
    sd = elph_state_dict_from_flax(params, stats)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    np.testing.assert_array_equal(
        sd["embedding.node_embedding"].numpy(),
        params["embedding"]["node_embedding"])
    np.testing.assert_array_equal(
        sd["embedding.sign_embedding.lin_out.weight"].numpy(),
        params["embedding"]["sign_embedding"]["lin_out"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["embedding.sign_embedding.bn_1.running_mean"].numpy(),
        stats["embedding"]["sign_embedding"]["bn_1"]["mean"])
    opt = loops.make_optimizer(tr.cfg, model.parameters())
    adam = optax.adam(1e-3)
    st = adam.init(state.params)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.5), state.params)
    _, st = adam.update(grads, st, state.params)
    opt.load_state_dict(adam_state_from_optax(_np_tree(st), model, opt))
    names = [k for k, _ in model.named_parameters()]
    i = names.index("embedding.node_embedding")
    np.testing.assert_allclose(opt.state_dict()["state"][i]["exp_avg"],
                               np.full((n, 16), 0.05, np.float32))


def test_adam_state_carries_the_table_moments():
    """adam_state_from_optax on a BuddyWithEmbedding: the table's moments
    and sign_embedding's come across with the BUDDY's."""
    params, _ = _jax_buddy_with_embedding()
    model = _port_buddy()
    opt = loops.make_optimizer(Config(), model.parameters())
    adam = optax.adam(1e-3)
    rng = np.random.default_rng(2)
    grads = jax.tree.map(
        lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)),
        params)
    _, st = adam.update(grads, adam.init(params), params)
    st = _np_tree(st)
    opt.load_state_dict(adam_state_from_optax(st, model, opt))
    names = [k for k, _ in model.named_parameters()]
    got = opt.state_dict()["state"]
    np.testing.assert_array_equal(
        got[names.index("node_embedding")]["exp_avg_sq"].numpy(),
        st[0].nu["node_embedding"])
    np.testing.assert_array_equal(
        got[names.index("sign_embedding.lin_0.weight")]["exp_avg"].numpy(),
        st[0].mu["sign_embedding"]["lin_0"]["kernel"].T)
    plain = _port_buddy(embedding=False, propagate=False)
    with pytest.raises(ValueError, match="node-embedding table"):
        adam_state_from_optax(st, plain, loops.make_optimizer(
            Config(), plain.parameters()))


# ---------------------------------------------------------- init, loading --

def test_node_embedding_init_is_xavier_uniform():
    """flax's xavier_uniform for a (num_nodes, hidden) table: fan_in =
    num_nodes, fan_out = hidden, bound sqrt(6 / (N + hidden)); the same
    bound and spread as flax's draw."""
    n, hidden = 3000, 64
    cfg = Config(hidden_channels=hidden, train_node_embedding=True,
                 use_feature=False)
    model = loops.build_buddy(cfg, None, n)
    loops._init_like_flax(model, torch.Generator().manual_seed(0))
    w = model.node_embedding.detach()
    a = (6 / (n + hidden)) ** 0.5
    want = np.asarray(jax.nn.initializers.xavier_uniform()(
        jax.random.PRNGKey(0), (n, hidden)))
    assert float(w.abs().max()) <= a and float(np.abs(want).max()) <= a
    assert float(w.abs().max()) > 0.999 * a
    assert abs(float(w.std()) / float(want.std()) - 1) < 0.01
    assert abs(float(w.mean())) < 0.01 * a


@pytest.mark.parametrize("suffix", [".npy", ".npz", ".pt"])
def test_load_pretrained_embedding_matches_jax(tmp_path, suffix):
    w = np.random.default_rng(3).normal(size=(50, 7))
    path = str(tmp_path / f"emb{suffix}")
    if suffix == ".npy":
        np.save(path, w)
    elif suffix == ".npz":
        np.savez(path, table=w, other=np.zeros(3))
    else:
        torch.save(torch.from_numpy(w), path)
    got = load_pretrained_embedding(path, 50)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jload_pretrained_embedding(path, 50))
    for fn in (load_pretrained_embedding, jload_pretrained_embedding):
        with pytest.raises(ValueError, match="49 nodes"):
            fn(path, 49)
    flat = str(tmp_path / "flat.npy")
    np.save(flat, np.zeros(5))
    for fn in (load_pretrained_embedding, jload_pretrained_embedding):
        with pytest.raises(ValueError, match="2-D"):
            fn(flat)
