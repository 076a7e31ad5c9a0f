"""The port's serving slice (subgraph_sketching_tpu_torch) against the JAX
package, end to end on the CPU: BUDDY's ``LinkScorer`` and ELPH's
``ElphLinkScorer``.

Tolerances: SIGN features rtol=atol=1e-5 (float32 sums in another order);
subgraph features rtol=1e-5, atol=1e-4 (as tests/test_torch_sketch.py);
BUDDY logits rtol=2e-4, atol=2e-5 (as tests/test_torch_parity.py);
LinkScorer and ElphLinkScorer scores rtol=atol=1e-4 (features and MLP
together); a scorer against its own trainer's predict rtol=atol=1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subgraph_sketching_tpu.config import Config as JConfig
from subgraph_sketching_tpu.graph.datasets import get_data as jget_data
from subgraph_sketching_tpu.graph.preprocess import (
    build_all_splits as jbuild_all_splits, sign_features as jsign_features,
)
from subgraph_sketching_tpu.models import BUDDY as JBUDDY
from subgraph_sketching_tpu.serving import LinkScorer as JLinkScorer
from subgraph_sketching_tpu.train.loops import BuddyTrainer
from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.device import resolve_device
from subgraph_sketching_tpu_torch.graph.datasets import get_data
from subgraph_sketching_tpu_torch.graph.preprocess import (
    build_all_splits, sign_features,
)
from subgraph_sketching_tpu_torch.models import (
    BUDDY, buddy_state_dict_from_flax,
)
from subgraph_sketching_tpu_torch.runners import serve
from subgraph_sketching_tpu_torch.serving import (
    LinkScorer, save_buddy_checkpoint, scorer_from_checkpoint,
)
from subgraph_sketching_tpu_torch.sketch.minhash import from_biased

CFG = dict(dataset_name="synth-ws", hidden_channels=32, batch_size=512,
           eval_batch_size=4096, model="BUDDY", K=50, lr=0.003)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _perturbed(tree, rng, scale):
    """Non-trivial copies of BN statistics / parameters (variances stay
    positive)."""
    return jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) * rng.uniform(0.5, 1.5, a.shape)
                              + scale * rng.standard_normal(a.shape),
                              dtype=a.dtype), tree)


@pytest.fixture(scope="module")
def both():
    jcfg, cfg = JConfig(**CFG), Config(**CFG)
    jsplits, jdirected, _ = jget_data(jcfg)
    splits, directed, _ = get_data(cfg)
    jds = jbuild_all_splits(jsplits, jcfg, directed=jdirected)
    ds = build_all_splits(splits, cfg, directed=directed, device="cpu")
    return jcfg, cfg, jds, ds


def test_get_data_matches_jax(both):
    jcfg, cfg, _, _ = both
    jsplits, _, _ = jget_data(jcfg)
    splits, _, _ = get_data(cfg)
    for name in ("train", "valid", "test"):
        np.testing.assert_array_equal(splits[name].links, jsplits[name].links)
        np.testing.assert_array_equal(splits[name].graph.edge_index,
                                      jsplits[name].graph.edge_index)
        np.testing.assert_array_equal(splits[name].graph.x,
                                      jsplits[name].graph.x)


@pytest.mark.parametrize("sign_k", [0, 2])
def test_sign_features_match_jax(sign_k):
    rng = np.random.default_rng(sign_k)
    n, e = 120, 900
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]).astype(np.int32)
    ew = rng.random(e).astype(np.float32)
    x = rng.standard_normal((n, 24)).astype(np.float32)
    for w in (None, ew):
        want = jsign_features(x, ei, w, n, sign_k)
        got = sign_features(x, ei, w, n, sign_k, device="cpu")
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("split", ["train", "valid", "test"])
def test_link_dataset_matches_jax(both, split):
    _, _, jds, ds = both
    j, t = jds[split], ds[split]
    np.testing.assert_array_equal(t.links, j.links)
    np.testing.assert_array_equal(t.labels, j.labels)
    np.testing.assert_array_equal(t.edge_index, j.edge_index)
    np.testing.assert_array_equal(t.edge_weight, j.edge_weight)
    assert t.num_nodes == j.num_nodes
    np.testing.assert_array_equal(t.degrees, j.degrees)
    np.testing.assert_allclose(t.x, j.x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.subgraph_features, j.subgraph_features,
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(from_biased(t.sketches.minhash),
                                  np.asarray(j.sketches.minhash))
    np.testing.assert_array_equal(t.sketches.hll.numpy(),
                                  np.asarray(j.sketches.hll))
    np.testing.assert_allclose(t.sketches.cards.numpy(),
                               np.asarray(j.sketches.cards), rtol=1e-5)


@pytest.mark.parametrize("use_feature,sign_k,append", [
    (True, 0, False), (True, 0, True), (True, 2, False), (False, 0, True)])
def test_buddy_logits_match_flax(use_feature, sign_k, append):
    rng = np.random.default_rng(sign_k + 2 * append)
    B, sf_dim, d, h = 24, 8, 12, 16
    sf = rng.standard_normal((B, sf_dim)).astype(np.float32)
    nf = rng.random((B, 2, d * (sign_k + 1))).astype(np.float32)
    sd = rng.integers(0, 5, B).astype(np.float32)  # includes zero degrees
    dd = rng.integers(0, 5, B).astype(np.float32)
    jm = JBUDDY(sf_dim=sf_dim, hidden_channels=h, use_feature=use_feature,
                sign_k=sign_k, append_normalised=append)
    args = (jnp.asarray(sf), jnp.asarray(nf), jnp.asarray(sd), jnp.asarray(dd))
    key = jax.random.PRNGKey(1)
    var = jm.init({"params": key, "dropout": key}, *args, training=False)
    params = _perturbed(var["params"], rng, 0.1)
    stats = _perturbed(var["batch_stats"], rng, 0.25)
    want = np.asarray(jm.apply({"params": params, "batch_stats": stats},
                               *args, training=False))
    tm = BUDDY(sf_dim=sf_dim, hidden_channels=h, num_features=d,
               use_feature=use_feature, sign_k=sign_k,
               append_normalised=append)
    tm.load_state_dict(buddy_state_dict_from_flax(_numpy_tree(params),
                                                  _numpy_tree(stats)))
    tm.eval()
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (sf, nf, sd, dd))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def scorers(both):
    """The JAX LinkScorer (built as tests/test_serving.py builds it, with
    perturbed untrained weights) and the port's, on the same weights."""
    jcfg, cfg, jds, ds = both
    tr = BuddyTrainer(jcfg, jds["train"], jds["train"].x.shape[-1])
    for s in ("valid", "test"):
        tr.stage(s, jds[s])
    state = tr.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    state = state._replace(params=_perturbed(state.params, rng, 0.05),
                           batch_stats=_perturbed(state.batch_stats, rng,
                                                  0.25))
    jscorer = JLinkScorer(tr, jds["valid"], state, min_bucket=64)
    model = BUDDY.from_config(cfg, ds["train"].x.shape[-1])
    model.load_state_dict(buddy_state_dict_from_flax(
        _numpy_tree(state.params), _numpy_tree(state.batch_stats)))
    scorer = LinkScorer(cfg, model, ds["valid"], max_bucket=500,
                        device="cpu")
    return cfg, jscorer, scorer


def _queries(num_nodes, valid_links):
    rng = np.random.default_rng(12)
    return np.concatenate([valid_links,
                           rng.integers(0, num_nodes, (300, 2))]).astype(np.int32)


def test_link_scorer_matches_jax(both, scorers):
    _, _, _, ds = both
    _, jscorer, scorer = scorers
    links = _queries(ds["valid"].num_nodes, ds["valid"].links)
    want = jscorer.score(links)
    got = scorer.score(links)        # several max_bucket chunks
    assert got.shape == (len(links),) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(scorer.score(links[:1]), got[:1], rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="link ids"):
        scorer.score(np.array([[0, ds["valid"].num_nodes]]))


def test_checkpoint_and_serve_cli_round_trip(both, scorers, tmp_path):
    _, _, _, ds = both
    cfg, _, scorer = scorers
    save_buddy_checkpoint(str(tmp_path / "ckpt"), cfg, scorer.model)
    links = _queries(ds["valid"].num_nodes, ds["valid"].links[:50])
    np.save(tmp_path / "q.npy", links)
    want = scorer.score(links)
    got = serve.main(["--checkpoint_dir", str(tmp_path / "ckpt"),
                      "--links", str(tmp_path / "q.npy"),
                      "--out", str(tmp_path / "s.npy"),
                      "--split", "valid", "--device", "cpu"])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.load(tmp_path / "s.npy"), got)
    rebuilt = scorer_from_checkpoint(str(tmp_path / "ckpt"), split="valid",
                                     device="cpu")
    np.testing.assert_allclose(rebuilt.score(links), want, rtol=1e-6,
                               atol=1e-6)


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sign_features(np.zeros((3, 2), np.float32),
                      np.zeros((2, 0), np.int32), None, 3, 0)


def test_elph_scorer_matches_jax():
    """Mirrors tests/test_serving.py::test_elph_scorer_matches_offline_predict
    (without embeddings, not ported): a JAX ELPH trained one epoch, served
    by the JAX ElphLinkScorer and, carried over, by the port's."""
    from subgraph_sketching_tpu.graph.preprocess import (
        LinkDataset as JLinkDataset, sketch_params_from_config,
    )
    from subgraph_sketching_tpu.serving import ElphLinkScorer as JElphScorer
    from subgraph_sketching_tpu.train.loops import ElphTrainer as JElph
    from subgraph_sketching_tpu_torch.models import elph_state_dict_from_flax
    from subgraph_sketching_tpu_torch.serving import ElphLinkScorer
    from subgraph_sketching_tpu_torch.train.loops import ElphTrainer

    kw = {**CFG, "model": "ELPH"}
    jcfg, cfg = JConfig(**kw), Config(**kw)
    splits, directed, _ = get_data(cfg)
    ds = build_all_splits(splits, cfg, directed=directed, device="cpu")
    jds = {k: JLinkDataset(d.links, d.labels, d.edge_index, d.edge_weight,
                           d.num_nodes, d.x, d.degrees)
           for k, d in ds.items()}
    width = ds["train"].x.shape[-1]
    jtr = JElph(jcfg, jds["train"], sketch_params_from_config(jcfg), width)
    jtr.stage("valid", jds["valid"])
    state = jtr.init_state(jax.random.PRNGKey(0))
    state, _ = jtr.train_epoch(state, np.random.default_rng(0),
                               jax.random.PRNGKey(0))
    jscorer = JElphScorer(jtr, state, split="valid", min_bucket=64)

    tr = ElphTrainer(cfg, ds["train"], width, device="cpu")
    tr.stage("valid", ds["valid"])
    model = tr.init_model(0)
    model.load_state_dict(elph_state_dict_from_flax(
        _numpy_tree(state.params), _numpy_tree(state.batch_stats)))
    scorer = ElphLinkScorer(tr, model, split="valid", max_bucket=500)
    links = _queries(ds["valid"].num_nodes, ds["valid"].links)
    got = scorer.score(links)        # several max_bucket chunks
    assert got.shape == (len(links),) and np.isfinite(got).all()
    np.testing.assert_allclose(got, jscorer.score(links), rtol=1e-4,
                               atol=1e-4)
    offline, _ = tr.predict(model, "valid")
    np.testing.assert_allclose(scorer.score(ds["valid"].links), offline,
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="link ids"):
        scorer.score(np.array([[0, ds["valid"].num_nodes]]))


def test_ra_scorer_matches_predict_and_jax():
    """A use_RA BUDDY served (the counterpart of tests/test_serving.py's
    test_scorer_with_use_RA): each query chunk's RA comes from the host
    CSR of the message graph, as preprocessing scored it, so the scorer
    equals the trainer's predict within 1e-5; and the JAX scorer on the
    same (perturbed) weights within 1e-4."""
    from subgraph_sketching_tpu_torch.train.loops import (
        BuddyTrainer as TBuddyTrainer,
    )

    kw = {**CFG, "hidden_channels": 16, "use_RA": True}
    jcfg, cfg = JConfig(**kw), Config(**kw)
    jsplits, jdirected, _ = jget_data(jcfg)
    jds = jbuild_all_splits(jsplits, jcfg, directed=jdirected)
    splits, directed, _ = get_data(cfg)
    ds = build_all_splits(splits, cfg, directed=directed, device="cpu")
    np.testing.assert_array_equal(ds["valid"].RA, jds["valid"].RA)
    width = ds["train"].x.shape[-1]
    jtr = BuddyTrainer(jcfg, jds["train"], width)
    jtr.stage("valid", jds["valid"])
    state = jtr.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    state = state._replace(params=_perturbed(state.params, rng, 0.05),
                           batch_stats=_perturbed(state.batch_stats, rng,
                                                  0.25))
    jscorer = JLinkScorer(jtr, jds["valid"], state, min_bucket=64)
    model = BUDDY.from_config(cfg, width)
    model.load_state_dict(buddy_state_dict_from_flax(
        _numpy_tree(state.params), _numpy_tree(state.batch_stats)))
    assert model.use_RA
    scorer = LinkScorer(cfg, model, ds["valid"], max_bucket=500,
                        device="cpu")
    tr = TBuddyTrainer(cfg, ds["train"], width, device="cpu")
    tr.stage("valid", ds["valid"])
    want, _ = tr.predict(scorer.model, "valid")
    got = scorer.score(ds["valid"].links)          # several chunks
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    links = _queries(ds["valid"].num_nodes, ds["valid"].links)
    np.testing.assert_allclose(scorer.score(links), jscorer.score(links),
                               rtol=1e-4, atol=1e-4)
    # the RA column moves the scores: zeroing it changes them
    saved = scorer.ra_csr
    scorer.ra_csr = saved.multiply(0).tocsr()
    assert not np.allclose(scorer.score(ds["valid"].links), got)
    scorer.ra_csr = saved
