"""The port's KGE tier (models/transx.py ``KGEModel``, train/kge_loop.py
``KgeTrainer`` and the runner's KGE path) against the JAX package's, on
the CPU.

Both packages get the same parameters, links and negatives (the JAX
trainer's own draws, fed to the port's ``step``).

Tolerances:
  * scores in the three modes: rtol 1e-5, atol 1e-5 (float32 sums over
    the embedding dimension in another order; rotatE's sqrt and cos/sin);
  * one step and one epoch (Adam, the self-adversarial loss): losses rtol
    1e-5; parameters rtol 1e-4, atol 1e-6 (Adam's first steps move each
    touched element by about lr, whatever the size of its gradient);
  * so one step's gradients are held too: rtol 1e-5, atol 1e-6 of the
    table's largest gradient (an element that cancels to near 0 keeps
    float32 rounding of the terms it cancels);
  * ``predict``: rtol 1e-5, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from subgraph_sketching_tpu.config import Config as JConfig
from subgraph_sketching_tpu.graph.datasets import get_data as jget_data
from subgraph_sketching_tpu.models.transx import KGEModel as JKGEModel
from subgraph_sketching_tpu.train.kge_loop import KgeTrainer as JKgeTrainer
from subgraph_sketching_tpu.train.loops import TrainState
from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.graph.datasets import get_data
from subgraph_sketching_tpu_torch.models.transx import KGE_MODELS, KGEModel
from subgraph_sketching_tpu_torch.runners import run
from subgraph_sketching_tpu_torch.train import checkpoint
from subgraph_sketching_tpu_torch.train.kge_loop import KgeTrainer
from subgraph_sketching_tpu_torch.train.loops import make_optimizer

DOUBLE = {"transE": (False, False), "distmult": (False, False),
          "complEx": (True, True), "rotatE": (True, False)}


def _models(name, n=40, hidden=6, nrel=3):
    de, dr = DOUBLE[name]
    kw = dict(nentity=n, nrelation=nrel, hidden_dim=hidden, gamma=12.0,
              double_entity_embedding=de, double_relation_embedding=dr)
    jm = JKGEModel(name, **kw)
    pm = KGEModel(name, **kw)
    params = jm.init_params(jax.random.PRNGKey(0))
    with torch.no_grad():
        pm.entity_embedding.copy_(torch.from_numpy(np.array(
            params.entity_embedding)))
        pm.relation_embedding.copy_(torch.from_numpy(np.array(
            params.relation_embedding)))
    return jm, pm, params


@pytest.mark.parametrize("name", KGE_MODELS)
def test_scorers_match_jax(name):
    """Each scorer in 'single', 'head-batch' and 'tail-batch' mode, and
    ``score_links`` (relation 0)."""
    jm, pm, params = _models(name)
    rng = np.random.default_rng(1)
    h, t = rng.integers(0, 40, 9), rng.integers(0, 40, 9)
    r = rng.integers(0, 3, 9)
    corrupt = rng.integers(0, 40, (9, 5))
    cases = [(h, t, "single"), (corrupt, t, "head-batch"),
             (h, corrupt, "tail-batch")]
    with torch.no_grad():
        for heads, tails, mode in cases:
            want = jm.score_triples(params, jnp.asarray(heads),
                                    jnp.asarray(r), jnp.asarray(tails), mode)
            got = pm.score_triples(torch.from_numpy(heads),
                                   torch.from_numpy(r),
                                   torch.from_numpy(tails), mode)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5, err_msg=mode)
        links = np.stack([h, t], 1)
        np.testing.assert_allclose(
            pm.score_links(torch.from_numpy(links)).numpy(),
            np.asarray(jm.score_links(params, jnp.asarray(links))),
            rtol=1e-5, atol=1e-5)


def _jax_grads(jm, params, pos3, negs, head):
    """The gradient of the JAX model's self-adversarial loss: its own
    train step, under a transformation that keeps the gradient as its
    state and moves nothing."""
    keep = optax.GradientTransformation(
        lambda p: p,
        lambda g, state, params=None: (jax.tree.map(jnp.zeros_like, g), g))
    step = jm.make_train_step(keep, negative_adversarial_sampling=True)
    _, grads, _ = step(params, keep.init(params), jnp.asarray(pos3),
                       jnp.asarray(negs), head)
    return grads


@pytest.mark.parametrize("name", KGE_MODELS)
@pytest.mark.parametrize("mode", ["head-batch", "tail-batch"])
def test_one_step_matches_jax(name, mode):
    """One KgeTrainer step against the JAX model's self-adversarial train
    step from the same parameters, positives and negatives (a row of each
    gathered many times): the loss, both tables' gradients, and both
    tables after Adam."""
    jm, pm, params = _models(name, nrel=1)
    rng = np.random.default_rng(2)
    links = rng.integers(0, 40, (16, 2))
    negs = rng.integers(0, 40, (16, 8))
    negs[:, :3] = 5                       # entity 5: 48 negatives and more
    head = mode == "head-batch"
    opt = optax.adam(1e-2)
    step = jm.make_train_step(opt, negative_adversarial_sampling=True)
    pos3 = np.stack([links[:, 0], np.zeros(16, np.int64), links[:, 1]], 1)
    new, _, jloss = step(params, opt.init(params), jnp.asarray(pos3),
                         jnp.asarray(negs), head)
    jgrads = _jax_grads(jm, params, pos3, negs, head)
    tr = KgeTrainer.__new__(KgeTrainer)   # the step alone needs no splits
    popt = torch.optim.Adam(pm.parameters(), lr=1e-2)
    loss = tr.step(pm, popt, torch.from_numpy(links), torch.from_numpy(negs),
                   mode)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for got, want in ((pm.entity_embedding, jgrads.entity_embedding),
                      (pm.relation_embedding, jgrads.relation_embedding)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
    for got, want in ((pm.entity_embedding, new.entity_embedding),
                      (pm.relation_embedding, new.relation_embedding)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["transE", "complEx"])
def test_trainer_epoch_matches_jax(name):
    """A whole KgeTrainer epoch (synth-ba, 6 steps: 3 head-, 3
    tail-corruption) driven with the JAX trainer's permutation and
    negatives, against the JAX epoch; then ``predict`` on valid."""
    kw = dict(dataset_name="synth-ba", model=name, hidden_channels=8,
              batch_size=512, lr=0.01, eval_batch_size=700)
    jcfg, cfg = JConfig(**kw), Config(**kw)
    jtr = JKgeTrainer(jcfg, jget_data(jcfg)[0])
    tr = KgeTrainer(cfg, get_data(cfg)[0], device="cpu")
    assert (tr.batch, tr.steps) == (jtr._B, jtr._steps) == (512, 6)
    state = jtr.init_state(jax.random.PRNGKey(0))
    model = tr.init_model(0)
    with torch.no_grad():
        model.entity_embedding.copy_(torch.from_numpy(np.array(
            state.params.entity_embedding)))
        model.relation_embedding.copy_(torch.from_numpy(np.array(
            state.params.relation_embedding)))
    opt = make_optimizer(cfg, model.parameters())
    key = jax.random.PRNGKey(7)
    # the JAX epoch's draws (kge_loop.py epoch): permutation, then the
    # negatives of each half
    pk, nk1, nk2 = jax.random.split(key, 3)
    perm = np.asarray(jax.random.permutation(pk, len(tr._pos)))
    losses = []
    for mode, nk, lo, k in (("head-batch", nk1, 0, 3),
                            ("tail-batch", nk2, 3, 3)):
        negs = np.asarray(jax.random.randint(nk, (k, 512, 64), 0,
                                             tr.num_nodes))
        for i in range(k):
            idx = perm[(lo + i) * 512:(lo + i + 1) * 512]
            losses.append(float(tr.step(
                model, opt, tr._pos[torch.from_numpy(idx.astype(np.int64))],
                torch.from_numpy(negs[i].astype(np.int64)), mode)))
    jstate, jloss = jtr.train_epoch(
        TrainState(state.params, {}, state.opt_state), None, key)
    np.testing.assert_allclose(np.mean(losses), jloss, rtol=1e-5)
    np.testing.assert_allclose(model.entity_embedding.detach().numpy(),
                               np.asarray(jstate.params.entity_embedding),
                               rtol=1e-4, atol=1e-6)
    jpred, jlab = jtr.predict(jstate, "valid")
    pred, lab = tr.predict(model, "valid")
    np.testing.assert_array_equal(lab, jlab)
    np.testing.assert_allclose(pred, jpred, rtol=1e-5, atol=1e-5)


def test_kge_model_refuses_bad_embeddings():
    with pytest.raises(ValueError):
        KGEModel("rotatE", 5, 1, 4, 12.0)
    with pytest.raises(ValueError):
        KGEModel("complEx", 5, 1, 4, 12.0, double_entity_embedding=True)
    with pytest.raises(ValueError):
        KGEModel("holE", 5, 1, 4, 12.0)


@pytest.mark.parametrize("model", ["SEALDGCNN", "transE"])
def test_both_tiers_need_cuda_unless_asked_for_the_cpu(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(["--dataset_name", "synth-ba", "--model", model])


SMALL = ["--dataset_name", "synth-ba", "--model", "transE",
         "--hidden_channels", "8", "--epochs", "2", "--batch_size", "512",
         "--K", "20", "--device", "cpu"]


def test_kge_runner_determinism_and_resume(tmp_path):
    """--model transE through runners.run on the CPU: the determinism
    check passes, and 1 epoch, save, --resume, 1 epoch give the straight
    2-epoch run's tables, Adam state and results bit for bit."""
    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")
    first = run.main(SMALL + ["--checkpoint_dir", straight,
                              "--checkpoint_every", "1",
                              "--check_determinism"])
    run.main(SMALL + ["--checkpoint_dir", resumed, "--checkpoint_every", "1",
                      "--epochs", "1"])
    again = run.main(SMALL + ["--checkpoint_dir", resumed,
                              "--checkpoint_every", "1", "--resume"])
    a, _ = checkpoint.load_checkpoint(straight, 2)
    b, _ = checkpoint.load_checkpoint(resumed, 2)
    assert sorted(a["model"]) == ["entity_embedding", "relation_embedding"]
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)
    assert again == first
