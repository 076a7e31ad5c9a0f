"""The port's citation2-scale pipeline
(``subgraph_sketching_tpu_torch/tools/citation2_train.py``) against the
JAX package, stage by stage, on the CPU at a small size (3,000 nodes,
32 permutations, 6 plan chunks, batch 512, hidden 16).

The JAX tool (``tools/citation2_train.py``) is a script, so its host
recipe is restated here line for line (``_jax_recipe``) and its device
stages are the JAX package's functions it calls: ``make_plan(...).chunk``,
the chunked plan's reduce, ``hll_count``, ``subgraph_features``, the flax
``BUDDY`` stepped by optax's Adam, and ``train/evaluation.py``.  Both
packages get the same numpy arrays: the hop-0 tables (drawn by the port's
generator; MinHash un-biased for JAX), the node features, the link
tables and the epoch order.

Tolerances:
  * the graph and link arrays: equal;
  * the chunk count: equal;
  * both hops' MinHash and HLL: bit-equal (MinHash after un-biasing);
  * cardinalities: rtol 1e-5;
  * SIGN(k=0): rtol 1e-5, atol 1e-5 (float32 sums in another order);
  * subgraph features: rtol 1e-5, atol 1e-4;
  * four training steps from the flax-initialised weights, dropouts 0,
    one fixed order: step losses rtol 1e-4; the first step's gradients
    rtol 1e-4, with an absolute slack of 1e-4 of each tensor's largest
    JAX gradient, except the biases that feed a BatchNorm, whose true
    gradient is 0 (see tests/test_torch_train.py): their float32 noise,
    a sum of ``batch`` terms, is held to batch * 2^-24 of the step's
    largest gradient;
  * AUC and Hits@50: equal; MRR equal where every reciprocal rank is a
    power of two (the sum is exact), else rtol 1e-6 (XLA sums the
    float32 reciprocals in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from subgraph_sketching_tpu.models.buddy import BUDDY as JBUDDY
from subgraph_sketching_tpu.ops.segment_scan import make_plan as jmake_plan
from subgraph_sketching_tpu.sketch.elph import (
    subgraph_features as jsubgraph_features,
)
from subgraph_sketching_tpu.sketch.hll import hll_count as jhll_count
from subgraph_sketching_tpu.sketch.params import SketchParams as JParams
from subgraph_sketching_tpu.sketch.params import Sketches as JSketches
from subgraph_sketching_tpu.train import evaluation as jeval
from subgraph_sketching_tpu.train.losses import bce_loss as jbce_loss
from subgraph_sketching_tpu_torch.models.convert import (
    buddy_state_dict_from_flax,
)
from subgraph_sketching_tpu_torch.sketch.minhash import from_biased
from subgraph_sketching_tpu_torch.tools import citation2_train as c2

SIZES = c2.Sizes(nodes=3_000, n_pos=8_000, n_val=2_000, mrr_pos=50,
                 mrr_negs=100, batch=512, feat_batch=1_024, epochs=2,
                 num_perm=32, hidden=16, features=16, max_slots=8_192)
SEED = 3
STEPS = 4
# the Linear layers whose output feeds a BatchNorm
PRE_BN = ("label_lin_layer.bias", "lin_out.bias")
SMALL_ARGS = [f"--{k}={v}" for k, v in dataclasses.asdict(SIZES).items()]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tier-1 run shares the cores between its
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_recipe(n, s, seed):
    """The JAX tool's host recipe (tools/citation2_train.py:85-99,
    :115-136) at sizes ``s``, as it is written there."""
    rng = np.random.default_rng(seed)
    base_i = np.arange(n, dtype=np.int64)
    srcs, dsts = [], []
    for off in range(1, 5 + 1):
        srcs += [base_i, base_i]
        dsts += [(base_i + off) % n, (base_i - off) % n]
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    E = len(src)
    rw = rng.random(E) < 0.10
    dst[rw] = rng.integers(0, n, int(rw.sum()), dtype=np.int32)
    deg = (np.bincount(src, minlength=n)
           + np.bincount(dst, minlength=n)).astype(np.float32)
    N_POS, N_VAL = s.n_pos, s.n_val
    perm_e = rng.permutation(E)
    pos_idx = perm_e[:N_POS + N_VAL]
    pos_links = np.stack([src[pos_idx], dst[pos_idx]], axis=1)
    neg_links = rng.integers(0, n, (N_POS + N_VAL, 2), dtype=np.int32)
    links_np = np.concatenate([pos_links[:N_POS], neg_links[:N_POS],
                               pos_links[N_POS:], neg_links[N_POS:]])
    labels_np = np.concatenate([np.ones(N_POS), np.zeros(N_POS),
                                np.ones(N_VAL), np.zeros(N_VAL)]
                               ).astype(np.float32)
    mrr_pos = pos_links[N_POS:N_POS + s.mrr_pos]
    mrr_neg = np.stack([np.repeat(mrr_pos[:, 0], s.mrr_negs),
                        rng.integers(0, n, s.mrr_pos * s.mrr_negs,
                                     dtype=np.int32)], axis=1)
    return {"src": src, "dst": dst, "deg": deg, "rewired": rw,
            "links": links_np, "labels": labels_np,
            "mrr": np.concatenate([mrr_pos, mrr_neg])}


@pytest.fixture(scope="module")
def host():
    rng = np.random.default_rng(SEED)
    src, dst, deg = c2.ws_graph(SIZES.nodes, rng)
    lk = c2.make_links(src, dst, SIZES, rng)
    return src, dst, deg, lk


@pytest.fixture(scope="module")
def stages(host):
    """Every stage on both packages from the same arrays."""
    src, dst, deg, lk = host
    n, params = SIZES.nodes, c2.SketchParams(
        max_hops=c2.MAX_HOPS, num_perm=SIZES.num_perm, hll_p=c2.HLL_P)
    jparams = JParams(max_hops=c2.MAX_HOPS, num_perm=SIZES.num_perm,
                      hll_p=c2.HLL_P)
    plan = c2.make_plan(src, dst, n, SIZES.max_slots, "cpu")
    jplan = jmake_plan(np.stack([src, dst]), n).chunk(SIZES.max_slots)
    gen = torch.Generator().manual_seed(SEED)
    mh0, hll0 = c2.hop0_tables(n, SIZES.num_perm, c2.HLL_P, gen)
    sk = c2.build_sketches(plan, mh0, hll0, params)

    jmh, jhll, jcards = [jnp.asarray(from_biased(mh0.numpy()))], \
        [jnp.asarray(hll0.numpy())], []
    for _ in range(c2.MAX_HOPS):
        jmh.append(jplan.reduce(jmh[-1], "min"))
        jhll.append(jplan.reduce(jhll[-1], "max"))
        jcards.append(jhll_count(jhll[-1], c2.HLL_P))
    jsk = JSketches(minhash=jnp.stack(jmh[1:]), hll=jnp.stack(jhll[1:]),
                    cards=jnp.stack(jcards, axis=1))

    links = torch.from_numpy(c2.pad_rows(lk.links, SIZES.feat_batch)).long()
    sf = c2.features_all(links, sk, params, SIZES.feat_batch)
    jsf = jsubgraph_features(jnp.asarray(links.numpy().astype(np.int32)),
                             jsk, jparams)

    x = torch.randn((n, SIZES.features), generator=gen)
    w = c2.gcn_slots(plan, src, dst, deg)
    deg_t = torch.from_numpy(deg)
    x_sign = c2.sign0(plan, x, deg_t, w)
    w_e = (1.0 / np.sqrt((deg[src] + 1.0) * (deg[dst] + 1.0))).astype(
        np.float32)
    jx = jnp.asarray(x.numpy())
    jx_sign = jplan.reduce(jx, "add", edge_data_slots=jplan.stage_edge_data(
        w_e)) + jx / (jnp.asarray(deg)[:, None] + 1.0)
    tables = c2.Tables(sf, links, x_sign, deg_t, torch.from_numpy(lk.labels))
    return dict(plan=plan, jplan=jplan, sk=sk, jsk=jsk, sf=sf, jsf=jsf,
                x_sign=x_sign, jx_sign=jx_sign, tables=tables, params=params)


def test_graph_and_links_equal_the_jax_recipe(host):
    src, dst, deg, lk = host
    want = _jax_recipe(SIZES.nodes, SIZES, SEED)
    n = SIZES.nodes
    assert len(src) == 2 * c2.RING_K * n
    for name, got in (("src", src), ("dst", dst), ("deg", deg),
                      ("links", lk.links), ("labels", lk.labels),
                      ("mrr", lk.mrr)):
        np.testing.assert_array_equal(got, want[name], err_msg=name)
    assert deg.sum() == 2 * len(src)
    assert abs(want["rewired"].mean() - c2.REWIRE) < 0.01
    assert lk.n_train == 2 * SIZES.n_pos and lk.mrr_pos == SIZES.mrr_pos
    assert (lk.mrr[SIZES.mrr_pos:, 0]
            == np.repeat(lk.mrr[:SIZES.mrr_pos, 0], SIZES.mrr_negs)).all()


def test_chunk_count_equals_jax(stages):
    assert stages["plan"].num_chunks == stages["jplan"].num_chunks >= 3


@pytest.mark.parametrize("hop", [1, 2])
@pytest.mark.parametrize("sketch", ["minhash", "hll"])
def test_sketches_bit_equal_jax(stages, hop, sketch):
    got = getattr(stages["sk"], sketch)[hop - 1].numpy()
    if sketch == "minhash":
        got = from_biased(got)
    np.testing.assert_array_equal(
        got, np.asarray(getattr(stages["jsk"], sketch)[hop - 1]))


def test_cards_match_jax(stages):
    np.testing.assert_allclose(stages["sk"].cards.numpy(),
                               np.asarray(stages["jsk"].cards), rtol=1e-5)


def test_sign0_matches_jax(stages):
    np.testing.assert_allclose(stages["x_sign"].numpy(),
                               np.asarray(stages["jx_sign"]), rtol=1e-5,
                               atol=1e-5)


def test_features_match_jax(stages):
    np.testing.assert_allclose(stages["sf"].numpy(), np.asarray(
        stages["jsf"]), rtol=1e-5, atol=1e-4)


def _jax_model():
    """The JAX tool's BUDDY at the test's sizes, dropouts 0, initialised
    as the tool initialises it."""
    model = JBUDDY(sf_dim=c2.SketchParams(max_hops=c2.MAX_HOPS).sf_dim,
                   hidden_channels=SIZES.hidden, use_feature=True, sign_k=0,
                   label_dropout=0.0, feature_dropout=0.0)
    sf_dim, d = model.sf_dim, SIZES.features
    var0 = model.init({"params": jax.random.PRNGKey(3),
                       "dropout": jax.random.PRNGKey(4)},
                      jnp.zeros((8, sf_dim)), jnp.zeros((8, 2, d)),
                      jnp.zeros(8), jnp.zeros(8), training=False)
    return model, var0["params"], var0["batch_stats"]


def _jax_steps(model, params, batch_stats, t, order):
    """The JAX tool's step (tools/citation2_train.py:262-275) over
    ``order`` in batches: (step losses, the first step's gradients)."""
    sf, lnk, x, d, y = (jnp.asarray(a.numpy()) for a in t)
    opt = optax.adam(c2.LR)

    def loss_fn(p, bs, idx):
        lk = lnk[idx]
        logits, upd = model.apply(
            {"params": p, "batch_stats": bs}, sf[idx], x[lk], d[lk[:, 0]],
            d[lk[:, 1]], training=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        return jbce_loss(logits, y[idx]), upd["batch_stats"]

    @jax.jit
    def step(p, bs, o, idx):
        (loss, nbs), g = jax.value_and_grad(loss_fn, has_aux=True)(p, bs,
                                                                   idx)
        up, no = opt.update(g, o)
        return optax.apply_updates(p, up), nbs, no, loss, g

    o, losses, first = opt.init(params), [], None
    for i in range(len(order) // SIZES.batch):
        idx = jnp.asarray(order[i * SIZES.batch:(i + 1) * SIZES.batch])
        params, batch_stats, o, loss, g = step(params, batch_stats, o, idx)
        losses.append(float(loss))
        first = g if first is None else first
    return np.array(losses), first


def test_training_steps_match_jax(stages):
    model, params, batch_stats = _jax_model()
    order = np.random.default_rng(SEED).permutation(
        2 * SIZES.n_pos)[:STEPS * SIZES.batch]
    want_losses, want_grads = _jax_steps(model, params, batch_stats,
                                         stages["tables"], order)

    port = c2.make_model(SIZES, stages["params"], "cpu", dropout=0.0)
    port.load_state_dict(buddy_state_dict_from_flax(
        jax.tree.map(np.asarray, params),
        jax.tree.map(np.asarray, batch_stats)))
    # the first step's gradients, on a copy of the initial weights
    first = c2.make_model(SIZES, stages["params"], "cpu", dropout=0.0)
    first.load_state_dict(port.state_dict())
    first.train()
    c2.batch_loss(first, stages["tables"],
                  torch.from_numpy(order[:SIZES.batch])).backward()
    got_grads = {k: p.grad.numpy() for k, p in first.named_parameters()}
    want = buddy_state_dict_from_flax(jax.tree.map(np.asarray, want_grads),
                                      {})
    scale = max(float(np.abs(v.numpy()).max()) for v in want.values())
    for k, g in got_grads.items():
        w = want[k].numpy()
        atol = (SIZES.batch * 2.0 ** -24 * scale if k in PRE_BN
                else 1e-4 * float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol, err_msg=k)

    opt = torch.optim.Adam(port.parameters(), lr=c2.LR)
    got_losses = c2.train_epoch(port, opt, stages["tables"],
                                torch.from_numpy(order), SIZES.batch)
    assert len(got_losses) == STEPS
    np.testing.assert_allclose(got_losses.numpy(), want_losses, rtol=1e-4)


def _mrr_predictions(lk, exact: bool) -> np.ndarray:
    """Scores of the MRR set (positives, then their negatives): random
    ones rounded to 0.01 (ties), or, with ``exact``, each positive at 0.5
    with 2^j - 1 of its negatives above it (rank 2^j)."""
    rng = np.random.default_rng(SEED)
    if not exact:
        return np.round(rng.random(len(lk.mrr)), 2).astype(np.float32)
    neg = np.zeros((lk.mrr_pos, SIZES.mrr_negs), np.float32)
    for i, j in enumerate(rng.integers(0, 7, lk.mrr_pos)):
        neg[i, :2 ** j - 1] = 1.0
    return np.concatenate([np.full(lk.mrr_pos, 0.5, np.float32),
                           neg.ravel()])


@pytest.mark.parametrize("exact", [True, False])
def test_metrics_equal_jax(stages, host, exact):
    """On one set of predictions (a fresh model's over the val links, and
    scores of the MRR set), the port's AUC, Hits@50 and MRR equal
    JAX's."""
    lk = host[3]
    t = stages["tables"]
    model = c2.make_model(SIZES, stages["params"], "cpu", seed=1)
    val = c2.predict_range(model, t, lk.n_train, len(lk.links) - lk.n_train,
                           SIZES.feat_batch).numpy()
    mrr_pred = _mrr_predictions(lk, exact)
    got = c2.evaluate(val, lk.labels[lk.n_train:], mrr_pred, lk.mrr_pos)
    y = lk.labels[lk.n_train:]
    assert got["auc"] == jeval.roc_auc(val, y)
    assert got["hits@50"] == jeval.hits_at_k(jnp.asarray(val[y > 0.5]),
                                             jnp.asarray(val[y < 0.5]), 50)
    want = jeval.mrr(jnp.asarray(mrr_pred[:lk.mrr_pos]),
                     jnp.asarray(mrr_pred[lk.mrr_pos:]).reshape(lk.mrr_pos,
                                                                -1))
    if exact:
        assert got["mrr"] == want
    else:
        np.testing.assert_allclose(got["mrr"], want, rtol=1e-6)


def test_predict_range_shifted_tail_equals_whole_chunks(stages, host):
    """The shifted last chunk gives the rows the unshifted chunks give."""
    lk = host[3]
    t = stages["tables"]
    model = c2.make_model(SIZES, stages["params"], "cpu", seed=2)
    lo, n = lk.n_train + 100, len(lk.links) - lk.n_train - 100
    got = c2.predict_range(model, t, lo, n, SIZES.feat_batch)
    whole = torch.cat([c2.predict_range(model, t, s, SIZES.feat_batch,
                                        SIZES.feat_batch)
                       for s in range(0, len(t.links), SIZES.feat_batch)])
    assert torch.equal(got, whole[lo:lo + n])


def test_main_end_to_end_on_the_cpu(capsys):
    metrics = c2.main(SMALL_ARGS + ["--device", "cpu"])
    stages = [line for line in capsys.readouterr().out.splitlines()
              if line.startswith("{")]
    names = [__import__("json").loads(s)["stage"] for s in stages]
    assert names == ["graph", "plan", "links", "uploads", "hop0", "sketches",
                     "features", "features_steady", "sign", "model", "epoch",
                     "epoch",
                     "eval", "total"]
    assert len(metrics["epoch_loss"]) == SIZES.epochs
    assert all(np.isfinite(metrics["epoch_loss"]))
    assert metrics["epoch_loss"][-1] < metrics["epoch_loss"][0]
    assert 0.5 < metrics["auc"] <= 1.0 and 0.0 <= metrics["mrr"] <= 1.0


def test_main_without_a_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        c2.main(SMALL_ARGS)
