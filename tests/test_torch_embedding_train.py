"""The port's BUDDY and ELPH trainers with node embeddings
(``--train_node_embedding --propagate_embeddings``, the reference's
ogbl-ddi shape, and ``--pretrained_node_embedding``) against the JAX
package's, on the CPU.

As in tests/test_torch_train.py and tests/test_torch_elph.py: both
trainers get the same split arrays (synth-ws, built once by the port's
preprocessing), the port model starts from the JAX state's weights, every
dropout is 0 and JAX's own epoch permutation is passed to the port as
``order``.  The biases of the Linear layers that feed a BatchNorm
(``PRE_BN``, here also ``lin_emb_out`` and the table diffusion's
``lin_k``, whose BatchNorm runs over the table's rows) are frozen on both
sides: their true gradient is zero and each package steps them by its own
float32 rounding noise, which Adam scales to up to ``lr`` a step.

Tolerances: step losses rtol 1e-4; BN buffers rtol 1e-4, atol 1e-5;
predict rtol = atol = 1e-4.  Parameters, the table included, are held to
the same rtol 1e-4 / atol 1e-5 on all but 0.5% of each tensor's
elements, and none of those is more than one Adam step (lr) away.  One
step from the same state gives table gradients within 6e-10 of JAX's
(typical |g| 1e-4) by either route, but over 2 epochs the two float32
runs drift apart on a few elements: the table's [N, hidden] activations
pass relu and BatchNorm each step, so a pre-activation within rounding of
0 switches a unit's gradient on one side only, and Adam's per-element
normalisation turns any such difference into a fraction of lr.
Measured: on ELPH by the scatter route 145 of 64,000 table elements
beyond atol 1e-5 (by at most 5.2e-5) and 1 of 1,024 of
``sign_embedding.lin_2``'s (1.1e-5); none elsewhere.
The plan and the scatter route agree as the JAX package holds them
(tests/test_train.py): losses rtol 1e-4 / atol 1e-5, logits rtol = atol =
1e-2 after two epochs.  Served scores equal ``predict`` within 1e-5 and
the JAX scorers' within 1e-4.
"""

import re

import jax
import numpy as np
import optax
import pytest
import torch

from subgraph_sketching_tpu.config import Config as JConfig
from subgraph_sketching_tpu.graph.preprocess import (
    sketch_params_from_config as jsketch_params,
)
from subgraph_sketching_tpu.train import loops as jloops
from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.models import (
    buddy_state_dict_from_flax, elph_state_dict_from_flax,
)
from subgraph_sketching_tpu_torch.ops import segscan
from subgraph_sketching_tpu_torch.serving import ElphLinkScorer, LinkScorer
from subgraph_sketching_tpu_torch.train import loops
from test_torch_elph import _datasets as elph_datasets
from test_torch_train import _datasets as buddy_datasets

EMB = dict(dataset_name="synth-ws", hidden_channels=32, batch_size=1536,
           eval_batch_size=4096, label_dropout=0.0, feature_dropout=0.0,
           sign_dropout=0.0, K=100, train_node_embedding=True,
           propagate_embeddings=True, sign_k=2)

PRE_BN = {
    "BUDDY": re.compile(r"(buddy\.(label_lin_layer|lin_out|lin_emb_out|"
                        r"sign\.lin_\d+)|sign_embedding\.lin_\d+)\.bias"),
    "ELPH": re.compile(r"(predictor\.(label_lin_layer|lin_out|lin_emb_out)"
                       r"|embedding\.sign_embedding\.lin_\d+)\.bias"),
}

# (model, case) -> overrides; "ddi" is the reference's ogbl-ddi shape
# (no node features: the table alone); BUDDY's embedding branch beside its
# feature branch is held in tests/test_torch_embedding.py
CASES = {
    ("BUDDY", "ddi"): {"use_feature": False},
    ("BUDDY", "ddi_no_plan"): {"use_feature": False, "use_plan": False},
    ("ELPH", "ddi"): {"use_feature": False},
    ("ELPH", "ddi_no_plan"): {"use_feature": False, "use_plan": False},
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs in several worker processes on
    one machine, where each worker's default of one thread per core
    oversubscribes it; the tolerances hold at any count."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TRAINERS = {"BUDDY": loops.BuddyTrainer, "ELPH": loops.ElphTrainer}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _to_port(model_name, state, model) -> dict:
    params, stats = _np_tree(state.params), _np_tree(state.batch_stats)
    if model_name == "BUDDY":
        return buddy_state_dict_from_flax(params, stats, model)
    return elph_state_dict_from_flax(params, stats)


def _pair(model_name, overrides):
    """JAX and port trainers of ``model_name`` on the same arrays, every
    split staged, and the port model and optimizer holding the JAX
    state's weights; PRE_BN frozen in both."""
    kw = {**EMB, "model": model_name, **overrides}
    jcfg, cfg = JConfig(**kw), Config(**kw)
    if model_name == "BUDDY":
        ds, jds = buddy_datasets(2)
        width = ds["train"].x.shape[-1]
        jtr = jloops.BuddyTrainer(jcfg, jds["train"], width)
        tr = loops.BuddyTrainer(cfg, ds["train"], width, device="cpu")
    else:
        ds, jds = elph_datasets()
        width = ds["train"].x.shape[-1]
        jtr = jloops.ElphTrainer(jcfg, jds["train"], jsketch_params(jcfg),
                                 width)
        tr = loops.ElphTrainer(cfg, ds["train"], width, device="cpu")
    pre_bn = PRE_BN[model_name]
    jtr.optimizer = optax.chain(jtr.optimizer, optax.masked(
        optax.set_to_zero(), lambda params: jax.tree_util.tree_map_with_path(
            lambda path, _: bool(pre_bn.fullmatch(
                ".".join(k.key for k in path))), params)))
    for s in ("valid", "test"):
        jtr.stage(s, jds[s])
        tr.stage(s, ds[s])
    state = jtr.init_state(jax.random.PRNGKey(0))
    model = tr.init_model(0)
    model.load_state_dict(_to_port(model_name, state, model))
    for name, p in model.named_parameters():
        p.requires_grad_(not pre_bn.fullmatch(name))
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
    order = np.asarray(jax.random.permutation(jax.random.split(key)[0],
                                              n)[:n_used])
    if not hasattr(jtr, "_epoch_jit"):   # the jit train_epoch also uses
        jtr._epoch_jit = jtr._train_epoch_fn(n_used, steps)
    arrays = {k: v for k, v in data.items() if k != "num_nodes"}
    state, step_losses = jtr._epoch_jit(state, key, arrays)
    return state, np.asarray(step_losses), order


def _assert_param_close(got: np.ndarray, want: np.ndarray, lr: float,
                        name: str):
    """rtol 1e-4 / atol 1e-5 on all but 0.5% of the elements, none of
    them more than lr away (the module docstring)."""
    err = np.abs(got - want)
    beyond = err > 1e-5 + 1e-4 * np.abs(want)
    assert beyond.mean() <= 0.005, (name, int(beyond.sum()),
                                    float(err.max()))
    assert float(err.max()) <= lr, (name, float(err.max()))


def _assert_matches_jax_over_two_epochs(model_name, jtr, state, tr, model,
                                        opt):
    assert tr.num_links("train") % tr.cfg.batch_size != 0   # a padded tail
    for epoch in range(2):
        state, want, order = _jax_epoch(jtr, state, epoch)
        got = tr.run_epoch(model, opt, seed=loops.epoch_seed(0, epoch),
                           order=torch.from_numpy(order.copy()))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    got = model.state_dict()
    params = dict(model.named_parameters())
    for k, v in _to_port(model_name, state, model).items():
        if k in params:
            _assert_param_close(got[k].numpy(), v.numpy(), tr.cfg.lr, k)
        elif not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    for split in ("valid", "test"):
        jp, jl = jtr.predict(state, split)
        p, lab = tr.predict(model, split)
        np.testing.assert_array_equal(lab, jl)
        np.testing.assert_allclose(p, jp, rtol=1e-4, atol=1e-4)
    return state


@pytest.mark.parametrize("model_name,case", list(CASES))
def test_trainer_with_embedding_matches_jax(model_name, case):
    jtr, state, tr, model, opt = _pair(model_name, CASES[model_name, case])
    want_plan = tr.cfg.use_plan
    assert ("emb_plan" in tr._data["train"]) == want_plan
    assert "emb_plan" not in tr._data["valid"]
    if want_plan:
        assert isinstance(tr._data["train"]["emb_plan"], loops.PlanSpmm)
    table = model.node_embedding if model_name == "BUDDY" \
        else model.embedding.node_embedding
    assert table.shape == (tr.num_nodes, 32)
    _assert_matches_jax_over_two_epochs(model_name, jtr, state, tr, model,
                                        opt)


# (model, file suffix, table width, propagate)
PRETRAINED = [("BUDDY", ".npy", 8, False), ("BUDDY", ".pt", 48, True),
              ("ELPH", ".npz", 32, True)]


@pytest.mark.parametrize("model_name,suffix,width,propagate", PRETRAINED)
def test_pretrained_table_is_frozen_and_matches_jax(tmp_path, model_name,
                                                    suffix, width,
                                                    propagate):
    """A pretrained table (a width other than hidden_channels included)
    gets no gradient and no Adam state, is not in the state_dict, and the
    run agrees with JAX's."""
    n = (buddy_datasets(2) if model_name == "BUDDY"
         else elph_datasets())[0]["train"].num_nodes
    w = np.random.default_rng(width).normal(size=(n, width)).astype(
        np.float32)
    path = str(tmp_path / f"table{suffix}")
    if suffix == ".npy":
        np.save(path, w)
    elif suffix == ".npz":
        np.savez(path, w)
    else:
        torch.save(torch.from_numpy(w), path)
    jtr, state, tr, model, opt = _pair(model_name, {
        "train_node_embedding": False, "pretrained_node_embedding": path,
        "propagate_embeddings": propagate, "use_feature": False})
    assert "node_embedding" not in str(jax.tree_util.tree_structure(
        state.params))
    emb = model if model_name == "BUDDY" else model.embedding
    np.testing.assert_array_equal(emb.frozen_table.numpy(), w)
    assert not any("frozen_table" in k or "node_embedding" in k
                   for k in model.state_dict())
    assert all(p is not emb.frozen_table for p in model.parameters())
    _assert_matches_jax_over_two_epochs(model_name, jtr, state, tr, model,
                                        opt)
    assert emb.frozen_table.grad is None
    np.testing.assert_array_equal(emb.frozen_table.numpy(), w)
    assert len(opt.state) == sum(1 for p in model.parameters()
                                 if p.requires_grad)


@pytest.mark.parametrize("model_name", ["BUDDY", "ELPH"])
def test_plan_and_scatter_routes_agree(model_name):
    """The staged PlanSpmm and the scatter spmm diffuse the table with the
    same math (tests/test_train.py's check of the JAX package)."""
    out = {}
    for use_plan in (True, False):
        cfg = Config(**{**EMB, "model": model_name, "use_feature": False,
                        "use_plan": use_plan})
        ds = (buddy_datasets(2) if model_name == "BUDDY"
              else elph_datasets())[0]
        tr = TRAINERS[model_name](cfg, ds["train"], None, device="cpu")
        tr.stage("valid", ds["valid"])
        model = tr.init_model(0)
        opt = loops.make_optimizer(cfg, model.parameters())
        losses = [tr.train_epoch(model, opt, seed) for seed in (3, 4)]
        out[use_plan] = (np.asarray(losses), tr.predict(model, "valid")[0])
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(out[True][1], out[False][1], rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("model_name", ["BUDDY", "ELPH"])
@pytest.mark.parametrize("use_plan", [True, False])
@pytest.mark.parametrize("frozen", [False, True])
def test_add_merges_a_step(tmp_path, monkeypatch, model_name, use_plan,
                           frozen):
    """A step of the ddi shape (sign_k 2) runs exactly 5 add merges (K1
    on the card; here its plain version): 2 forward propagations, 2
    backward ones and gather_rows' backward.  With a frozen table the
    diffused tables x_1 = A x_0 and x_2 = A x_1 depend on no parameter,
    so neither propagation has a backward: 3."""
    ds = (buddy_datasets(2) if model_name == "BUDDY"
          else elph_datasets())[0]
    kw = {"use_feature": False, "use_plan": use_plan,
          "use_struct_feature": False}
    if frozen:
        path = str(tmp_path / "t.npy")
        np.save(path, np.ones((ds["train"].num_nodes, 4), np.float32))
        kw.update(train_node_embedding=False, pretrained_node_embedding=path)
    cfg = Config(**{**EMB, "model": model_name, **kw})
    tr = TRAINERS[model_name](cfg, ds["train"], None, device="cpu")
    model = tr.init_model(0)
    opt = loops.make_optimizer(cfg, model.parameters())
    adds = []
    plain = segscan.segment_combine_plain

    def counted(v, x, op, ptr):
        adds.append(op)
        return plain(v, x, op, ptr)

    monkeypatch.setattr(segscan, "segment_combine_plain", counted)
    tr.run_epoch(model, opt, 0, order=torch.arange(3 * cfg.batch_size))
    assert adds == ["add"] * 3 * (3 if frozen else 5)


@pytest.mark.parametrize("model_name", ["BUDDY", "ELPH"])
def test_scorers_serve_the_diffused_table(model_name):
    """LinkScorer / ElphLinkScorer with a propagated trainable table
    (ogbl-ddi's shape) resolve the table once and score as the trainer's
    predict does, and as the JAX scorer does with the same state (no
    structure features: the JAX BUDDY scorer would need its own sketch
    stacks)."""
    from subgraph_sketching_tpu.serving import (
        ElphLinkScorer as JElphLinkScorer, LinkScorer as JLinkScorer,
    )
    jtr, state, tr, model, opt = _pair(model_name, {
        "use_feature": False, "use_struct_feature": False, "lr": 0.003})
    state, _, order = _jax_epoch(jtr, state, 0)
    model.load_state_dict(_to_port(model_name, state, model))
    ds, jds = (buddy_datasets(2) if model_name == "BUDDY"
               else elph_datasets())
    links = ds["valid"].links
    want, _ = tr.predict(model, "valid")
    if model_name == "BUDDY":
        scorer = LinkScorer(tr.cfg, model, ds["train"], device="cpu")
        jscorer = JLinkScorer(jtr, jds["train"], state)
    else:
        scorer = ElphLinkScorer(tr, model, split="valid")
        jscorer = JElphLinkScorer(jtr, state, split="valid")
    assert scorer.emb_table.shape == (tr.num_nodes, 32)
    got = scorer.score(links)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, jscorer.score(links), rtol=1e-4,
                               atol=1e-4)
