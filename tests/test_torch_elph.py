"""The port's ELPH (models/gnn.py ``GCNConv``, models/elph.py,
models/predictor.py, models/convert.py ``elph_state_dict_from_flax`` and
train/loops.py ``ElphTrainer``) against the JAX package's, on the CPU.

Both sides get the same seeded numpy inputs and start from the same
weights: flax initialises them and ``elph_state_dict_from_flax`` carries
them over.  JAX runs on the CPU as its own tests run it (the plan reduce
with the XLA merge).

Tolerances:
  * GCNConv and the ELPH node features, by either SpMM route: rtol 1e-5,
    atol 1e-5 (float32 sums in another order, in the SpMM and in
    gcn_norm's degrees);
  * ELPH's sketches: MinHash and HLL bit-equal, cardinalities rtol 1e-5;
  * LinkPredictor logits and BN running statistics: rtol 1e-5, atol 1e-6;
  * trainer parity over 2 epochs (synth-ws, hidden 32, a padded last
    batch, dropout 0, JAX's permutation as ``order``): step losses rtol
    1e-4; parameters and BN buffers rtol 1e-4, atol 1e-5; predict rtol =
    atol = 1e-4.  As in tests/test_torch_train.py, the biases of the
    Linear layers that feed a BatchNorm (``PRE_BN``) are frozen on both
    sides: their true gradient is zero and each package steps them by its
    own float32 rounding noise, which Adam scales to up to ``lr`` a step.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from subgraph_sketching_tpu.config import Config as JConfig
from subgraph_sketching_tpu.graph.preprocess import (
    LinkDataset as JLinkDataset,
)
from subgraph_sketching_tpu.models.elph import ELPHPredictor as JELPHPredictor
from subgraph_sketching_tpu.models.gnn import GCNConv as JGCNConv
from subgraph_sketching_tpu.models.predictor import (
    LinkPredictor as JLinkPredictor,
)
from subgraph_sketching_tpu.ops.graph_ops import gcn_norm as jgcn_norm
from subgraph_sketching_tpu.ops.segment_scan import PlanSpmm as JPlanSpmm
from subgraph_sketching_tpu.sketch.elph import (
    initialise_sketches as jinitialise_sketches,
)
from subgraph_sketching_tpu.sketch.params import SketchParams as JSketchParams
from subgraph_sketching_tpu.train import loops as jloops
from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.graph.datasets import get_data
from subgraph_sketching_tpu_torch.graph.preprocess import build_all_splits
from subgraph_sketching_tpu_torch.graph.synthetic import watts_strogatz_graph
from subgraph_sketching_tpu_torch.models import (
    ELPHPredictor, GCNConv, LinkPredictor, adam_state_from_optax,
    elph_state_dict_from_flax,
)
from subgraph_sketching_tpu_torch.models.convert import (
    _batch_stats_from_flax, _parameters_from_flax,
)
from subgraph_sketching_tpu_torch.ops.graph_ops import gcn_norm
from subgraph_sketching_tpu_torch.ops.segment_scan import PlanSpmm
from subgraph_sketching_tpu_torch.sketch.elph import initialise_sketches
from subgraph_sketching_tpu_torch.sketch.minhash import from_biased
from subgraph_sketching_tpu_torch.sketch.params import SketchParams
from subgraph_sketching_tpu_torch.train import loops


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _graph(n=400, seed=1):
    ei = watts_strogatz_graph(n, 6, 0.2, seed=seed).astype(np.int32)
    x = np.random.default_rng(seed).normal(size=(n, 20)).astype(np.float32)
    return ei, n, x


# -------------------------------------------------------------- GCNConv --

@pytest.mark.parametrize("route", ["plan", "scatter"])
def test_gcn_conv_matches_flax(route):
    ei, n, x = _graph()
    conv = JGCNConv(16)
    jei, jw, _ = jgcn_norm(jnp.asarray(ei), None, n)
    params = conv.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ei),
                       n)
    port = GCNConv(20, 16)
    port.load_state_dict(_parameters_from_flax(_np_tree(params["params"])))
    # a nonzero bias, so that its add is held too
    port.bias.data.normal_(generator=torch.Generator().manual_seed(1))
    params = {"params": {**params["params"],
                         "bias": jnp.asarray(port.bias.detach().numpy())}}
    tei = torch.from_numpy(ei.astype(np.int64))
    if route == "plan":
        jps = JPlanSpmm(np.asarray(jei), np.asarray(jw), n)
        want = conv.apply(params, jnp.asarray(x), jnp.asarray(ei), n,
                          spmm_ctx=(jps, jps.tables))
        nei, nw = gcn_norm(tei, None, n)
        got = port(torch.from_numpy(x), tei, n,
                   plan=PlanSpmm(nei.numpy(), nw.numpy(), n, device="cpu"))
    else:
        want = conv.apply(params, jnp.asarray(x), jnp.asarray(ei), n)
        got = port(torch.from_numpy(x), tei, n)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_glorot_init_distribution():
    """_init_like_flax: a GCNConv kernel is glorot-uniform (bound
    sqrt(6 / (fan_in + fan_out)), variance 2 / (fan_in + fan_out)), its
    bias zero; every other Linear stays lecun-normal."""
    model = ELPHPredictor(SketchParams(max_hops=2), 256, 512)
    loops._init_like_flax(model, torch.Generator().manual_seed(0))
    for k, fan_in in ((0, 256), (1, 512)):
        conv = getattr(model.gnn, f"conv_{k}")
        w = conv.lin.weight.detach()
        a = (6 / (fan_in + 512)) ** 0.5
        assert float(w.abs().max()) <= a
        assert float(w.abs().max()) > 0.99 * a
        assert abs(float(w.std()) / (a / 3 ** 0.5) - 1) < 0.02
        assert abs(float(w.mean())) < 0.02 * a
        assert float(conv.bias.detach().abs().max()) == 0.0
    w = model.predictor.lin_out.weight.detach()
    assert float(w.abs().max()) <= 2 * (1 / 512) ** 0.5 / .87962566103423978
    assert float(model.predictor.lin_out.bias.detach().abs().max()) == 0.0


# ----------------------------------------------------------------- ELPH --

def _elph_pair(feature_prop, use_feature=True, hops=2):
    """The flax ELPHPredictor's weights in the port's ELPHPredictor, and
    both packages' hop-0 sketches of ``_graph``."""
    ei, n, x = _graph()
    jp = JSketchParams(max_hops=hops, num_perm=32, hll_p=6)
    p = SketchParams(max_hops=hops, num_perm=32, hll_p=6)
    jmh0, jhll0 = jinitialise_sketches(n, jp)
    mh0, hll0 = initialise_sketches(n, p, device="cpu")
    links = np.random.default_rng(2).integers(0, n, (64, 2)).astype(np.int32)
    jmodel = JELPHPredictor(jp, 16, use_feature=use_feature,
                            feature_prop=feature_prop)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(ei), n, jnp.asarray(jmh0),
                            jnp.asarray(jhll0), jnp.asarray(links))
    model = ELPHPredictor(p, 20 if use_feature else None, 16,
                          use_feature=use_feature, feature_prop=feature_prop)
    model.load_state_dict(elph_state_dict_from_flax(
        _np_tree(variables["params"]),
        _np_tree(variables.get("batch_stats", {}))))
    model.eval()
    return (jmodel, variables, model, ei, n, x, links,
            (jmh0, jhll0), (mh0, hll0))


@pytest.mark.parametrize("feature_prop", ["gcn", "residual", "cat"])
def test_elph_matches_flax(feature_prop):
    """Features alone (no hop-0 sketches), then with sketches: node
    features, every hop's sketches and the full model's logits."""
    jmodel, variables, model, ei, n, x, links, (jmh0, jhll0), (mh0, hll0) \
        = _elph_pair(feature_prop)
    tei = torch.from_numpy(ei.astype(np.int64))
    tx = torch.from_numpy(x)
    gnn = jmodel.bind(variables).gnn
    want, none = gnn(jnp.asarray(x), jnp.asarray(ei), n)
    with torch.no_grad():
        got, sk_none = model.gnn(tx, tei, n)
    assert none is None and sk_none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)

    want, jsk = gnn(jnp.asarray(x), jnp.asarray(ei), n, jnp.asarray(jmh0),
                    jnp.asarray(jhll0))
    with torch.no_grad():
        got, sk = model.gnn(tx, tei, n, mh0, hll0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(from_biased(sk.minhash),
                                  np.asarray(jsk.minhash))
    np.testing.assert_array_equal(sk.hll.numpy(), np.asarray(jsk.hll))
    np.testing.assert_allclose(sk.cards.numpy(), np.asarray(jsk.cards),
                               rtol=1e-5)

    want = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(ei), n,
                        jnp.asarray(jmh0), jnp.asarray(jhll0),
                        jnp.asarray(links))
    with torch.no_grad():
        got = model(tx, tei, n, mh0, hll0, torch.from_numpy(links).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_elph_without_features_returns_sketches_only():
    jmodel, variables, model, ei, n, x, links, (jmh0, jhll0), (mh0, hll0) \
        = _elph_pair("gcn", use_feature=False, hops=3)
    assert not any(k.startswith("gnn.") for k in model.state_dict())
    feats, sk = model.gnn(None, torch.from_numpy(ei.astype(np.int64)), n,
                          mh0, hll0)
    _, jsk = jmodel.bind(variables).gnn(None, jnp.asarray(ei), n,
                                        jnp.asarray(jmh0), jnp.asarray(jhll0))
    assert feats is None and sk.minhash.shape[0] == 4
    np.testing.assert_array_equal(from_biased(sk.minhash),
                                  np.asarray(jsk.minhash))


def test_elph_state_dict_from_flax_maps_every_entry():
    """Every port tensor comes from a flax entry and back: the GCN kernels
    transposed (gnn/conv_k/Dense_0/kernel -> gnn.conv_k.lin.weight), the
    conv biases, the feature encoder and the head by name."""
    jmodel, variables, model, *_ = _elph_pair("residual")
    sd = elph_state_dict_from_flax(_np_tree(variables["params"]),
                                   _np_tree(variables["batch_stats"]))
    assert set(sd) == set(model.state_dict())
    params = variables["params"]
    np.testing.assert_array_equal(
        sd["gnn.conv_1.lin.weight"].numpy(),
        np.asarray(params["gnn"]["conv_1"]["Dense_0"]["kernel"]).T)
    np.testing.assert_array_equal(sd["gnn.conv_0.bias"].numpy(),
                                  np.asarray(params["gnn"]["conv_0"]["bias"]))
    np.testing.assert_array_equal(
        sd["gnn.feature_encoder.weight"].numpy(),
        np.asarray(params["gnn"]["feature_encoder"]["kernel"]).T)
    np.testing.assert_array_equal(
        sd["predictor.bn_labels.running_var"].numpy(),
        np.asarray(variables["batch_stats"]["predictor"]["bn_labels"]["var"]))
    # a node-embedding table and its diffusion map into ``embedding``
    table = np.arange(8, dtype=np.float32).reshape(4, 2)
    kernel = np.ones((2, 3), np.float32)
    sd = elph_state_dict_from_flax(
        {**_np_tree(variables["params"]), "embedding": {
            "node_embedding": table,
            "sign_embedding": {"lin_0": {"kernel": kernel,
                                         "bias": np.zeros(3)}}}},
        {"embedding": {"sign_embedding": {"bn_0": {"mean": np.ones(3),
                                                   "var": np.ones(3)}}}})
    np.testing.assert_array_equal(sd["embedding.node_embedding"].numpy(),
                                  table)
    assert sd["embedding.sign_embedding.lin_0.weight"].shape == (3, 2)
    assert "embedding.sign_embedding.bn_0.running_var" in sd


# -------------------------------------------------------- LinkPredictor --

@pytest.mark.parametrize("use_feature,use_embedding", [
    (True, False), (False, False), (True, True), (False, True)])
def test_link_predictor_matches_flax(use_feature, use_embedding):
    """Eval-mode logits, then a training-mode forward (dropout 0): its
    logits and the BatchNorm running statistics it leaves."""
    rng = np.random.default_rng(3)
    sf = rng.normal(size=(48, 8)).astype(np.float32)
    nf = rng.normal(size=(48, 2, 16)).astype(np.float32)
    emb = rng.normal(size=(48, 2, 16)).astype(np.float32)
    jm = JLinkPredictor(8, 16, use_feature, use_embedding, 0.0, 0.0)
    args = (jnp.asarray(sf), jnp.asarray(nf) if use_feature else None,
            jnp.asarray(emb) if use_embedding else None)
    variables = jm.init(jax.random.PRNGKey(1), *args)
    model = LinkPredictor(8, 16, use_feature, use_embedding, 0.0, 0.0)
    model.load_state_dict({
        **_parameters_from_flax(_np_tree(variables["params"])),
        **_batch_stats_from_flax(_np_tree(variables["batch_stats"]))})
    targs = (torch.from_numpy(sf),
             torch.from_numpy(nf) if use_feature else None,
             torch.from_numpy(emb) if use_embedding else None)
    with torch.no_grad():
        got = model.eval()(*targs)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jm.apply(variables, *args)),
                                   rtol=1e-5, atol=1e-6)
        got = model.train()(*targs)
    want, upd = jm.apply(variables, *args, training=True,
                         mutable=["batch_stats"],
                         rngs={"dropout": jax.random.PRNGKey(2)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    stats = _batch_stats_from_flax(_np_tree(upd["batch_stats"]))
    for k, v in stats.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(model.state_dict()[k].numpy(),
                                       v.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


# ------------------------------------------------------------- trainer --

BASE = dict(dataset_name="synth-ws", model="ELPH", hidden_channels=32,
            batch_size=1536, eval_batch_size=4096, label_dropout=0.0,
            feature_dropout=0.0, K=100)

# biases of the Linear layers that feed a BatchNorm (module docstring)
PRE_BN = re.compile(r"predictor\.(label_lin_layer|lin_out)\.bias")

TRAINER_CASES = {
    "gcn": {},
    "residual": {"feature_prop": "residual"},
    "no_struct_feature": {"use_struct_feature": False},
    "no_plan": {"use_plan": False},
    "no_feature": {"use_feature": False},
}

_DATASETS = {}


def _datasets():
    """The port's ELPH splits of synth-ws, and JAX LinkDatasets holding the
    same arrays."""
    if not _DATASETS:
        cfg = Config(**BASE)
        splits, directed, _ = get_data(cfg)
        ds = build_all_splits(splits, cfg, directed=directed, device="cpu")
        jds = {k: JLinkDataset(d.links, d.labels, d.edge_index,
                               d.edge_weight, d.num_nodes, d.x, d.degrees)
               for k, d in ds.items()}
        _DATASETS.update(ds=ds, jds=jds)
    return _DATASETS["ds"], _DATASETS["jds"]


def _pair(overrides):
    """JAX and port ELPH trainers on the same arrays, and the port model
    and optimizer holding the JAX state's weights; PRE_BN frozen in
    both."""
    from subgraph_sketching_tpu.graph.preprocess import (
        sketch_params_from_config as jsketch_params,
    )
    kw = {**BASE, **overrides}
    jcfg, cfg = JConfig(**kw), Config(**kw)
    ds, jds = _datasets()
    width = ds["train"].x.shape[-1]
    jtr = jloops.ElphTrainer(jcfg, jds["train"], jsketch_params(jcfg), width)
    jtr.optimizer = optax.chain(jtr.optimizer, optax.masked(
        optax.set_to_zero(), lambda params: jax.tree_util.tree_map_with_path(
            lambda path, _: bool(PRE_BN.fullmatch(
                ".".join(k.key for k in path))), params)))
    tr = loops.ElphTrainer(cfg, ds["train"], width, device="cpu")
    for s in ("valid", "test"):
        jtr.stage(s, jds[s])
        tr.stage(s, ds[s])
    state = jtr.init_state(jax.random.PRNGKey(0))
    model = tr.init_model(0)
    model.load_state_dict(elph_state_dict_from_flax(
        _np_tree(state.params), _np_tree(state.batch_stats)))
    for name, p in model.named_parameters():
        p.requires_grad_(not PRE_BN.fullmatch(name))
    opt = loops.make_optimizer(cfg, model.parameters())
    return jtr, state, tr, model, opt


def _jax_epoch(jtr, state, epoch):
    """One JAX epoch of the runner's key for ``epoch``: (state, step
    losses, the permutation it walked)."""
    data = jtr._data["train"]
    n = jtr.num_links("train")
    n_used, steps = jloops._epoch_plan(n, jtr.cfg.batch_size,
                                       jtr.cfg.train_samples)
    key = jax.random.fold_in(jax.random.PRNGKey(0), epoch)
    perm_key, _ = jax.random.split(key)
    order = np.asarray(jax.random.permutation(perm_key, n)[:n_used])
    if not hasattr(jtr, "_epoch_jit"):   # the jit train_epoch also uses
        jtr._epoch_jit = jtr._train_epoch_fn(n_used, steps)
    arrays = {k: v for k, v in data.items() if k != "num_nodes"}
    state, step_losses = jtr._epoch_jit(state, key, arrays)
    return state, np.asarray(step_losses), order


@pytest.mark.parametrize("case", list(TRAINER_CASES))
def test_trainer_matches_jax_over_two_epochs(case):
    jtr, state, tr, model, opt = _pair(TRAINER_CASES[case])
    assert tr.num_links("train") % tr.cfg.batch_size != 0   # a padded tail
    assert ("plan" in tr._data["train"]) == (tr.cfg.use_plan
                                             and tr.cfg.use_feature)
    np.testing.assert_allclose(tr._data["test"]["sf"].numpy(),
                               np.asarray(jtr._data["test"]["sf"]),
                               rtol=1e-5, atol=1e-4)
    for epoch in range(2):
        state, want, order = _jax_epoch(jtr, state, epoch)
        got = tr.run_epoch(model, opt, seed=loops.epoch_seed(0, epoch),
                           order=torch.from_numpy(order.copy()))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    want = elph_state_dict_from_flax(_np_tree(state.params),
                                     _np_tree(state.batch_stats))
    got = model.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    for split in ("valid", "test"):
        jp, jl = jtr.predict(state, split)
        p, lab = tr.predict(model, split)
        np.testing.assert_array_equal(lab, jl)
        np.testing.assert_allclose(p, jp, rtol=1e-4, atol=1e-4)


def test_optimizer_state_carries_across():
    """A JAX ELPH state after one epoch crosses over with its Adam moments
    (``adam_state_from_optax``); one more epoch then matches in both."""
    jtr, state, tr, model, opt = _pair({"weight_decay": 0.01})
    state, _, _ = _jax_epoch(jtr, state, 0)
    model.load_state_dict(elph_state_dict_from_flax(
        _np_tree(state.params), _np_tree(state.batch_stats)))
    opt.load_state_dict(adam_state_from_optax(_np_tree(state.opt_state),
                                              model, opt))
    steps = -(-tr.num_links("train") // tr.cfg.batch_size)
    assert all(float(s["step"]) == steps for s in opt.state.values())
    state, want, order = _jax_epoch(jtr, state, 1)
    got = tr.run_epoch(model, opt, seed=1,
                       order=torch.from_numpy(order.copy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    want = elph_state_dict_from_flax(_np_tree(state.params),
                                     _np_tree(state.batch_stats))
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(model.state_dict()[k].numpy(),
                                       v.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def test_valid_reuses_the_train_graph_and_test_does_not():
    """One SpMM plan and one sketch set per distinct message graph: valid
    shares the train split's plan, test (train + valid edges) has its
    own."""
    ds, _ = _datasets()
    tr = loops.ElphTrainer(Config(**BASE), ds["train"], 128, device="cpu")
    for s in ("valid", "test"):
        tr.stage(s, ds[s])
    data = tr._data
    assert data["valid"]["plan"] is data["train"]["plan"]
    assert data["test"]["plan"] is not data["train"]["plan"]
    assert tr._sk_graph[0] is ds["test"].edge_index


def test_epoch_is_a_function_of_its_seed():
    """Dropout on: the same seed repeats the epoch bit for bit, another
    seed does not."""
    ds, _ = _datasets()
    cfg = Config(**{**BASE, "label_dropout": 0.5, "feature_dropout": 0.5})
    tr = loops.ElphTrainer(cfg, ds["train"], 128, device="cpu")
    runs = []
    for seed in (7, 7, 8):
        model = tr.init_model(0)
        opt = loops.make_optimizer(cfg, model.parameters())
        runs.append((tr.run_epoch(model, opt, seed), model.state_dict()))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(v, runs[1][1][k]) for k, v in runs[0][1].items())
    assert not torch.equal(runs[0][0], runs[2][0])
