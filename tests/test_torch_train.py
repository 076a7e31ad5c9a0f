"""The port's BUDDY training and evaluation (subgraph_sketching_tpu_torch/
train) against the JAX package's, on the CPU.

Both sides get the same numpy inputs: the trainers are fed the same split
arrays (built once by the port's preprocessing, which
tests/test_torch_serving.py holds against the JAX build) and start from the
same weights (``buddy_state_dict_from_flax``), with every dropout at 0 and
JAX's own epoch permutation passed to the port as ``order``.

Tolerances:
  * losses and their gradients w.r.t. the logits: rtol 1e-6, atol 1e-7;
  * Hits@K, AUC, eval_subset, _epoch_plan, batched_predict: equal;
  * MRR: equal where every rank's reciprocal is a power of two (the sum is
    exact); otherwise rtol 1e-6 (XLA sums the float32 reciprocals in
    another order);
  * BatchNorm running statistics after two training steps: rtol 1e-6;
  * trainer parity over 2 epochs with a padded last batch: step losses
    rtol 1e-4; parameters and BN buffers rtol 1e-4, atol 1e-5; predict
    logits rtol = atol = 1e-4; test() Hits@K equal, except that a positive
    whose logit lies within 1e-4 of the K-th negative may count on either
    side (each such positive moves Hits@K by 1/num_pos at most).

The trainer tests freeze, on both sides, the biases of the Linear layers
that feed a BatchNorm (``PRE_BN``).  In training mode BatchNorm subtracts
the batch mean, so their true gradient is zero; each package computes it
as float32 rounding noise (about 1e-6 of the other gradients), and Adam
scales that noise to steps of up to ``lr``, with a sign no other
implementation can reproduce.  Those biases, and the running means they
shift, then differ by ~lr per step.  The tests run at ``Config``'s
default lr (1e-4); at 1e-3 the same Adam amplification of near-zero
gradients moves some weights by ~1e-4 within 20 steps.
"""

import copy
import re

import flax.linen as fnn
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
from subgraph_sketching_tpu.models.gnn import batch_norm as jbatch_norm
from subgraph_sketching_tpu.train import evaluation as jeval
from subgraph_sketching_tpu.train import inference as jinference
from subgraph_sketching_tpu.train import loops as jloops
from subgraph_sketching_tpu.train import losses as jlosses
from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.graph.datasets import get_data
from subgraph_sketching_tpu_torch.graph.preprocess import build_all_splits
from subgraph_sketching_tpu_torch.models import (
    adam_state_from_optax, buddy_state_dict_from_flax,
)
from subgraph_sketching_tpu_torch.models.gnn import batch_norm
from subgraph_sketching_tpu_torch.train import evaluation, inference, loops
from subgraph_sketching_tpu_torch.train import losses

# ---------------------------------------------------------------- losses --

LOSS_CASES = [("bce", False), ("bce", True), ("auc", False), ("auc", True)]


@pytest.mark.parametrize("name,masked", LOSS_CASES)
def test_loss_and_gradient_match_jax(name, masked):
    rng = np.random.default_rng(3)
    n = 96
    logits = (3 * rng.standard_normal(n)).astype(np.float32)
    labels = (rng.random(n) < 0.4).astype(np.float32)
    mask = rng.random(n) < 0.8 if masked else None

    jfn = jlosses.get_loss(name)
    want, jgrad = jax.value_and_grad(
        lambda z: jfn(z, jnp.asarray(labels),
                      None if mask is None else jnp.asarray(mask)))(
        jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_(True)
    got = losses.get_loss(name)(
        z, torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(jgrad), rtol=1e-6,
                               atol=1e-7)


# --------------------------------------------------------------- metrics --

def _quantised(rng, n, q=4):
    """Scores on a coarse grid, so ties are common."""
    return (np.round(rng.standard_normal(n) * q) / q).astype(np.float32)


@pytest.mark.parametrize("n_pos,n_neg,k", [
    (40, 300, 100), (40, 300, 1), (200, 1000, 20),
    (30, 50, 100),          # len(neg) < k -> 1.0
    (30, 100, 100),         # len(neg) == k
])
def test_hits_at_k_equal_to_jax(n_pos, n_neg, k):
    rng = np.random.default_rng(n_pos + n_neg + k)
    pos, neg = _quantised(rng, n_pos), _quantised(rng, n_neg)
    want = jeval.hits_at_k(jnp.asarray(pos), jnp.asarray(neg), k)
    assert evaluation.hits_at_k(pos, neg, k) == want
    assert (evaluation.evaluate_hits(pos, neg, pos, neg, pos, neg, Ks=[k])
            == jeval.evaluate_hits(pos, neg, pos, neg, pos, neg, Ks=[k]))


@pytest.mark.parametrize("negs_per_pos", [1, 4])
def test_mrr_equal_to_jax(negs_per_pos):
    rng = np.random.default_rng(negs_per_pos)
    n = 64
    # exact case: each positive's rank 0.5 * (opt + pess) + 1 is 1, 2 or 4
    # (ties included: opt 0, pess 2 gives 2), so 1/rank sums exactly
    pos = np.zeros(n, np.float32)
    rows = []
    for i in range(n):
        kind = i % 3
        above, tied = [(0, 0), (1, 0), (0, 2)][kind] if negs_per_pos > 1 \
            else [(0, 0), (1, 0), (0, 0)][kind]
        row = ([1.0] * above + [0.0] * tied
               + [-1.0] * (negs_per_pos - above - tied))
        rows.append(row)
    neg = np.asarray(rows, np.float32).ravel()   # the flat per-positive shape
    want = jeval.evaluate_mrr(pos, neg, pos, neg, pos, neg)
    assert evaluation.evaluate_mrr(pos, neg, pos, neg, pos, neg) == want
    # general case: float32 reciprocals summed in another order
    pos = _quantised(rng, n)
    neg = _quantised(rng, n * negs_per_pos)
    want = jeval.evaluate_mrr(pos, neg, pos, neg, pos, neg)["MRR"]
    got = evaluation.evaluate_mrr(pos, neg, pos, neg, pos, neg)["MRR"]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_auc_equal_to_jax():
    rng = np.random.default_rng(5)
    preds = [_quantised(rng, n) for n in (120, 90, 60)]
    trues = [(rng.random(len(p)) < 0.5).astype(np.float32) for p in preds]
    args = (preds[1], trues[1], preds[2], trues[2])
    assert evaluation.evaluate_auc(*args) == jeval.evaluate_auc(*args)
    args += (preds[0], trues[0])
    assert evaluation.evaluate_auc(*args) == jeval.evaluate_auc(*args)
    one_class = np.ones(10, np.float32)
    assert np.isnan(evaluation.roc_auc(one_class, one_class))


# ------------------------------------------------------- loop utilities --

@pytest.mark.parametrize("total,n,name,num_pos", [
    (1000, None, "synth-ws", None), (1000, 2000, "synth-ws", None),
    (1000, 137, "synth-ws", None), (600, 250, "ogbl-citation2", 100),
    (600, 250, "ogbl-citation2", None), (600, 3, "ogbl-citation2", 100),
])
def test_eval_subset_equal_to_jax(total, n, name, num_pos):
    np.testing.assert_array_equal(
        loops.eval_subset(total, n, name, num_pos),
        jloops.eval_subset(total, n, name, num_pos))


@pytest.mark.parametrize("num_links,batch_size,train_samples", [
    (13996, 1536, np.inf), (1024, 1024, np.inf), (10, 1024, np.inf),
    (13996, 1536, 0.25), (13996, 1536, 5000), (13996, 1536, 10 ** 6),
])
def test_epoch_plan_equal_to_jax(num_links, batch_size, train_samples):
    assert (loops._epoch_plan(num_links, batch_size, train_samples)
            == jloops._epoch_plan(num_links, batch_size, train_samples))


@pytest.mark.parametrize("n,batch_size,pad_value", [
    (1000, 300, -1), (900, 300, 0), (7, 4096, -1), (0, 16, 0)])
def test_batched_predict_equal_to_jax(n, batch_size, pad_value):
    table = np.random.default_rng(n).standard_normal(1001).astype(np.float32)
    sel = np.random.default_rng(1).permutation(1000)[:n].astype(np.int32)
    seen = []

    def score(idx):
        seen.append(len(idx))
        return torch.from_numpy(table[idx])   # -1 reads the last entry

    got = loops.batched_predict(score, sel, batch_size, pad_value)
    if n == 0:
        assert got.shape == (0,)
        return
    want = jloops.batched_predict(lambda idx: jnp.asarray(table[idx]), sel,
                                  batch_size, pad_value)
    np.testing.assert_array_equal(got, want)
    assert set(seen) == {min(batch_size, n)}   # one batch shape


# ------------------------------------------------------------ batch norm --

def test_batch_norm_running_stats_match_flax():
    """Two training steps of one BatchNorm on 16-row batches: the running
    mean and variance follow flax's (biased variance).  torch's own
    BatchNorm1d updates from the unbiased variance and misses by 16/15."""

    class BN(fnn.Module):
        @fnn.compact
        def __call__(self, x, training):
            return jbatch_norm(training)(x)

    rng = np.random.default_rng(0)
    xs = [(1.5 * rng.standard_normal((16, 8)) + 0.5).astype(np.float32)
          for _ in range(2)]
    jm = BN()
    var = jm.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), False)
    stats = var["batch_stats"]
    bn = batch_norm(8).train()
    for x in xs:
        want, upd = jm.apply({"params": var["params"], "batch_stats": stats},
                             jnp.asarray(x), True, mutable=["batch_stats"])
        stats = upd["batch_stats"]
        got = bn(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    s = stats["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(s["mean"]),
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(s["var"]),
                               rtol=1e-6)
    assert isinstance(bn, torch.nn.BatchNorm1d)
    assert set(bn.state_dict()) == set(
        torch.nn.BatchNorm1d(8).state_dict())


# --------------------------------------------------------------- trainer --

BASE = dict(dataset_name="synth-ws", hidden_channels=32, batch_size=1536,
            eval_batch_size=4096, label_dropout=0.0, feature_dropout=0.0,
            sign_dropout=0.0, K=100, model="BUDDY")

# biases of the Linear layers that feed a BatchNorm (module docstring)
PRE_BN = re.compile(r"(label_lin_layer|lin_out|sign\.lin_\d+)\.bias")

TRAINER_CASES = {
    "plain": {},
    "weight_decay": {"weight_decay": 0.01},
    "normed_sign2": {"add_normed_features": True, "sign_k": 2},
}

_DATASETS = {}


def _datasets(sign_k: int):
    """The port's train/valid/test LinkDatasets on synth-ws, and the JAX
    package's LinkDatasets holding the same arrays."""
    if sign_k not in _DATASETS:
        cfg = Config(**{**BASE, "sign_k": sign_k})
        splits, directed, _ = get_data(cfg)
        ds = build_all_splits(splits, cfg, directed=directed, device="cpu")
        jds = {k: JLinkDataset(d.links, d.labels, d.edge_index,
                               d.edge_weight, d.num_nodes, d.x, d.degrees,
                               subgraph_features=d.subgraph_features)
               for k, d in ds.items()}
        _DATASETS[sign_k] = ds, jds
    return _DATASETS[sign_k]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(overrides):
    """JAX and port trainers on the same arrays, and the port model and
    optimizer holding the JAX state's weights; PRE_BN frozen in both."""
    kw = {**BASE, **overrides}
    jcfg, cfg = JConfig(**kw), Config(**kw)
    ds, jds = _datasets(cfg.sign_k)
    width = ds["train"].x.shape[-1]
    jtr = jloops.BuddyTrainer(jcfg, jds["train"], width)
    jtr.optimizer = optax.chain(jtr.optimizer, optax.masked(
        optax.set_to_zero(), lambda params: jax.tree_util.tree_map_with_path(
            lambda path, _: bool(PRE_BN.fullmatch(
                ".".join(k.key for k in path[1:]))), params)))
    tr = loops.BuddyTrainer(cfg, ds["train"], width, device="cpu")
    for s in ("valid", "test"):
        jtr.stage(s, jds[s])
        tr.stage(s, ds[s])
    state = jtr.init_state(jax.random.PRNGKey(0))
    model = tr.init_model(0)
    model.load_state_dict(buddy_state_dict_from_flax(
        _np_tree(state.params), _np_tree(state.batch_stats)))
    for name, p in model.named_parameters():
        p.requires_grad_(not PRE_BN.fullmatch(name))
    opt = loops.make_optimizer(cfg, model.parameters())
    return jtr, state, tr, model, opt


def _jax_epoch(jtr, state, epoch):
    """One JAX epoch of the runner's key for ``epoch``: (state, step
    losses, the permutation it walked)."""
    n = jtr.num_links("train")
    n_used, steps = jloops._epoch_plan(n, jtr.cfg.batch_size,
                                       jtr.cfg.train_samples)
    key = jax.random.fold_in(jax.random.PRNGKey(0), epoch)
    perm_key, _ = jax.random.split(key)
    order = np.asarray(jax.random.permutation(perm_key, n)[:n_used])
    if not hasattr(jtr, "_epoch_jit"):   # the jit train_epoch also uses
        jtr._epoch_jit = jtr._train_epoch_fn(n_used, steps)
    state, step_losses = jtr._epoch_jit(state, key, jtr._data["train"])
    return state, np.asarray(step_losses), order


def _assert_states_close(model, state):
    want = buddy_state_dict_from_flax(_np_tree(state.params),
                                      _np_tree(state.batch_stats))
    got = model.state_dict()
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def _assert_hits_close(got: dict, want: dict, tr, model, split_names):
    """test() Hits@K equal, up to positives within 1e-4 of the K-th
    negative (see the module docstring)."""
    for key, triple in want.items():
        for g, w, split in zip(got[key], triple, split_names):
            if g == w:
                continue
            pred, labels = tr.predict(model, split)
            pos, neg = pred[labels == 1], pred[labels == 0]
            kth = np.sort(neg)[-tr.cfg.K]
            near = int(np.sum(np.abs(pos - kth) <= 1e-4))
            assert abs(g - w) * len(pos) <= near + 1e-6, (key, split, g, w)


@pytest.mark.parametrize("case", list(TRAINER_CASES))
def test_trainer_matches_jax_over_two_epochs(case):
    jtr, state, tr, model, opt = _pair(TRAINER_CASES[case])
    assert tr.num_links("train") % tr.cfg.batch_size != 0   # a padded tail
    for epoch in range(2):
        state, want, order = _jax_epoch(jtr, state, epoch)
        got = tr.run_epoch(model, opt, seed=loops.epoch_seed(0, epoch),
                           order=torch.from_numpy(order.copy()))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    _assert_states_close(model, state)
    for split in ("valid", "test"):
        jp, jl = jtr.predict(state, split)
        p, lab = tr.predict(model, split)
        np.testing.assert_array_equal(lab, jl)
        np.testing.assert_allclose(p, jp, rtol=1e-4, atol=1e-4)
    _assert_hits_close(inference.test(tr, model, tr.cfg),
                       jinference.test(jtr, state, jtr.cfg), tr, model,
                       ("train", "valid", "test"))


def test_optimizer_state_carries_across():
    """A JAX state after one epoch crosses over with its Adam moments; one
    more epoch then matches in both."""
    jtr, state, tr, model, opt = _pair(TRAINER_CASES["weight_decay"])
    state, _, _ = _jax_epoch(jtr, state, 0)
    model.load_state_dict(buddy_state_dict_from_flax(
        _np_tree(state.params), _np_tree(state.batch_stats)))
    opt.load_state_dict(adam_state_from_optax(_np_tree(state.opt_state),
                                              model, opt))
    assert all(float(s["step"]) == 10 for s in opt.state.values())
    # the epoch's loss as the JAX trainer reports it, on the same order
    key = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    n = jtr.num_links("train")
    order = np.asarray(jax.random.permutation(jax.random.split(key)[0], n))
    before = jax.tree.map(jnp.array, state)
    want_loss = jtr.train_epoch(before, None, key)[1]
    state, want, _ = _jax_epoch(jtr, state, 1)
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    opt_snapshot = copy.deepcopy(opt.state_dict())
    got = tr.run_epoch(model, opt, seed=1,
                       order=torch.from_numpy(order.copy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    _assert_states_close(model, state)
    model.load_state_dict(snapshot)
    opt.load_state_dict(opt_snapshot)
    got_loss = tr.train_epoch(model, opt, seed=1,
                              order=torch.from_numpy(order.copy()))
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)


@pytest.mark.parametrize("trainer", ["BuddyTrainer", "ElphTrainer"])
@pytest.mark.parametrize("overrides", [
    {"mesh_shape": [1], "mesh_axes": ["rows"]},
    {"memory_sharded": True, "mesh_shape": [2], "mesh_axes": ["graph"]},
    {"dtype": "float16"}])
def test_trainer_refuses_what_is_not_ported(overrides, trainer):
    """A compute dtype other than float32 and bfloat16, an unknown mesh
    axis and a mesh that one process does not divide into raise
    ValueError."""
    ds, _ = _datasets(0)
    cfg = Config(**{**BASE, **overrides})
    with pytest.raises(ValueError):
        getattr(loops, trainer)(cfg, ds["train"], 128, device="cpu")


def test_epoch_is_a_function_of_its_seed():
    """Dropout on: the same seed repeats the epoch bit for bit, another
    seed does not."""
    ds, _ = _datasets(0)
    cfg = Config(**{**BASE, "label_dropout": 0.5, "feature_dropout": 0.5})
    tr = loops.BuddyTrainer(cfg, ds["train"], 128, device="cpu")
    runs = []
    for seed in (7, 7, 8):
        model = tr.init_model(0)
        opt = loops.make_optimizer(cfg, model.parameters())
        runs.append((tr.run_epoch(model, opt, seed), model.state_dict()))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(v, runs[1][1][k]) for k, v in runs[0][1].items())
    assert not torch.equal(runs[0][0], runs[2][0])


def test_init_model_is_deterministic_and_flax_like():
    ds, _ = _datasets(0)
    tr = loops.BuddyTrainer(Config(**BASE), ds["train"], 128, device="cpu")
    a, b = tr.init_model(3).state_dict(), tr.init_model(3).state_dict()
    assert all(torch.equal(v, b[k]) for k, v in a.items())
    w = a["lin_out.weight"]
    assert float(w.abs().max()) <= 2 * (1 / 32) ** 0.5 / .87962566103423978
    assert float(a["lin_out.bias"].abs().max()) == 0.0
