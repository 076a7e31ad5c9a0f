"""The port's BUDDY trainer on the reference's dataset families against
the JAX trainer, on the CPU: Planetoid (Cora), ogbl-collab with its year
filter, ogbl-citation2 with its ``train_eval`` split and MRR, and ogbl-ppa
with RA (``bn_RA``) and ``use_feature 0``.

The pattern and tolerances of tests/test_torch_train.py: both trainers get
the same split arrays (the port's preprocessing of the fixtures of
tests/test_torch_datasets.py, which tests/test_torch_preprocess.py holds
against the JAX build), start from the same weights, with every dropout at
0 and the pre-BatchNorm biases frozen on both sides, and walk JAX's own
epoch permutations.  Over 2 epochs with a padded last batch: step losses
rtol 1e-4; parameters and BN buffers rtol 1e-4, atol 1e-5; predict logits
rtol = atol = 1e-4; Hits@K equal up to positives within 1e-4 of the K-th
negative; MRR within rtol 1e-6 unless a positive lies within 1e-4 of one
of its own negatives (each such positive moves the MRR by 1/num_pos at
most).
"""

import jax
import numpy as np
import optax
import pytest
import torch

from subgraph_sketching_tpu.config import Config as JConfig
from subgraph_sketching_tpu.graph import preprocess as jpre
from subgraph_sketching_tpu.train import inference as jinference
from subgraph_sketching_tpu.train import loops as jloops
from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.graph.datasets import get_data
from subgraph_sketching_tpu_torch.graph.preprocess import (
    build_all_splits, make_train_eval_dataset,
)
from subgraph_sketching_tpu_torch.models import buddy_state_dict_from_flax
from subgraph_sketching_tpu_torch.train import inference, loops
from test_torch_preprocess import FAMILIES, _write
from test_torch_train import (
    PRE_BN, _assert_hits_close, _assert_states_close, _jax_epoch, _np_tree,
)

BASE = dict(hidden_channels=32, batch_size=56, eval_batch_size=256,
            label_dropout=0.0, feature_dropout=0.0, sign_dropout=0.0,
            model="BUDDY")

# case -> (fixture family, Config overrides)
CASES = {
    "cora": ("cora", {"K": 20}),
    "collab_year": ("collab_year", {"K": 50}),
    "citation2_mrr": ("citation2", {"sign_k": 2}),
    "ppa_RA": ("ppa_RA", {"K": 20}),
}


def _jax_dataset(d):
    return jpre.LinkDataset(d.links, d.labels, d.edge_index, d.edge_weight,
                            d.num_nodes, d.x, d.degrees,
                            subgraph_features=d.subgraph_features, RA=d.RA)


def _pair(tmp_path, case):
    family, overrides = CASES[case]
    _write(tmp_path, family)
    name, _, fam = FAMILIES[family]
    kw = {**BASE, **fam, **overrides, "dataset_name": name,
          "data_root": str(tmp_path)}
    jcfg, cfg = JConfig(**kw), Config(**kw)
    splits, directed, metric = get_data(cfg)
    ds = build_all_splits(splits, cfg, directed=directed, device="cpu")
    jds = {k: _jax_dataset(d) for k, d in ds.items()}
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
    train_split = "train"
    if directed:
        train_split = "train_eval"
        jtr.stage(train_split, jpre.make_train_eval_dataset(jds["train"]))
        tr.stage(train_split, make_train_eval_dataset(ds["train"]))
    state = jtr.init_state(jax.random.PRNGKey(0))
    model = tr.init_model(0)
    model.load_state_dict(buddy_state_dict_from_flax(
        _np_tree(state.params), _np_tree(state.batch_stats)))
    for pname, p in model.named_parameters():
        p.requires_grad_(not PRE_BN.fullmatch(pname))
    opt = loops.make_optimizer(cfg, model.parameters())
    return jtr, state, tr, model, opt, metric, train_split


def _assert_mrr_close(got, want, tr, model, split_names):
    for g, w, split in zip(got["MRR"], want["MRR"], split_names):
        pred, labels = tr.predict(model, split)
        pos = pred[labels == 1]
        neg = pred[labels == 0].reshape(len(pos), -1)
        near = int(np.sum(np.any(np.abs(neg - pos[:, None]) <= 1e-4,
                                 axis=1)))
        if near == 0:
            np.testing.assert_allclose(g, w, rtol=1e-6)
        else:
            assert abs(g - w) * len(pos) <= near + 1e-6, (split, g, w)


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_matches_jax_on_dataset_family(tmp_path, case):
    jtr, state, tr, model, opt, metric, train_split = _pair(tmp_path, case)
    assert tr.num_links("train") % tr.cfg.batch_size != 0   # a padded tail
    if case == "ppa_RA":
        assert "bn_RA.weight" in dict(model.named_parameters())
        assert not tr.use_feature
    for epoch in range(2):
        state, want, order = _jax_epoch(jtr, state, epoch)
        got = tr.run_epoch(model, opt, seed=loops.epoch_seed(0, epoch),
                           order=torch.from_numpy(order.copy()))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    _assert_states_close(model, state)
    for split in (train_split, "valid", "test"):
        jp, jl = jtr.predict(state, split)
        p, lab = tr.predict(model, split)
        np.testing.assert_array_equal(lab, jl)
        np.testing.assert_allclose(p, jp, rtol=1e-4, atol=1e-4)
    got = inference.test(tr, model, tr.cfg, metric, train_split=train_split)
    want = jinference.test(jtr, state, jtr.cfg, metric,
                           train_split=train_split)
    assert set(got) == set(want)
    if metric == "mrr":
        _assert_mrr_close(got, want, tr, model,
                          (train_split, "valid", "test"))
    else:
        _assert_hits_close(got, want, tr, model,
                           (train_split, "valid", "test"))
