"""The port's runner (subgraph_sketching_tpu_torch/runners/run.py) for
BUDDY and ELPH, checkpoints and serving from a training run, on the CPU.

  * the parser gives the JAX runner's Namespace (less ``device``) on the
    reference README commands of tests/test_cli.py;
  * a CPU run on synth-ba (2 epochs, hidden 32, dropout 0, lr 0.01) lands
    its test Hits@100 within 0.05 of the JAX runner's on the same splits
    (the two start from different random weights of the same
    distribution; same-weight parity is tests/test_torch_train.py's);
  * 2 epochs straight and 1 epoch, save, --resume, 1 epoch give bit-equal
    model and optimizer states and the same best-val meta;
  * ``scorer_from_checkpoint`` on a --save_model run scores links as the
    trainer's ``predict`` does, within 1e-5;
  * the same for ELPH (``SMALL_ELPH``): Hits@100 within 0.05 of the JAX
    runner's, resume bit-equal, the served checkpoint equal to
    ``predict``, and the reference's ELPH commands reach training;
  * a ``--use_RA`` run serves (the ogbl-ppa command on its fixture, and
    ELPH, whose model reads no RA), by ``scorer_from_checkpoint`` and the
    serve CLI, equal to ``predict`` within 1e-5.
"""

import dataclasses
import json
import os
import shlex

import numpy as np
import pytest
import torch

from subgraph_sketching_tpu.runners import run as jrun
from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.device import device_from_flags
from subgraph_sketching_tpu_torch.graph.datasets import get_data
from subgraph_sketching_tpu_torch.graph.preprocess import build_all_splits
from subgraph_sketching_tpu_torch.metrics_logging import apply_sweep_overrides
from subgraph_sketching_tpu_torch.runners import run
from subgraph_sketching_tpu_torch.serving import scorer_from_checkpoint
from subgraph_sketching_tpu_torch.train import checkpoint
from subgraph_sketching_tpu_torch.train.determinism import (
    check_epoch_determinism,
)
from subgraph_sketching_tpu_torch.utils import str2bool
from test_cli import REFERENCE_COMMANDS

SMALL = ["--dataset_name", "synth-ba", "--model", "BUDDY", "--epochs", "2",
         "--hidden_channels", "32", "--batch_size", "256",
         "--eval_batch_size", "1024", "--lr", "0.01",
         "--label_dropout", "0", "--feature_dropout", "0"]
SMALL_ELPH = [("ELPH" if a == "BUDDY" else a) for a in SMALL]
# the ogbl-ddi shape: a trainable table diffused in every step, no
# features; a larger batch, as each step diffuses the whole table
EMB = ["--train_node_embedding", "--propagate_embeddings", "--use_feature",
       "0", "--sign_k", "2", "--batch_size", "1024"]


# ---------------------------------------------------------------- parser --

@pytest.mark.parametrize("cmd", REFERENCE_COMMANDS + [
    "", "--wandb_offline", "--mesh_shape 4,2 --mesh_axes data,graph",
    "--train_samples -1 --max_nodes_per_hop 50 --use_feature 0"])
def test_parser_matches_jax(cmd):
    argv = shlex.split(cmd)
    args = run.make_parser().parse_args(argv)
    assert args.device is None
    assert device_from_flags(args.device, args.platform) == "cuda"
    jargs = jrun.make_parser().parse_args(argv)
    assert {k: v for k, v in vars(args).items()
            if k != "device"} == vars(jargs)
    assert (dataclasses.asdict(run.config_from_parsed(args))
            == dataclasses.asdict(jrun.config_from_parsed(jargs)))


def test_str2bool_and_sweep_overrides(monkeypatch):
    assert [str2bool(v) for v in ("yes", "0", "", True, 1.0)] == [
        True, False, False, True, True]
    with pytest.raises(ValueError):
        str2bool("maybe")
    monkeypatch.setenv("SWEEP_OVERRIDES", '{"lr": 0.5, "no_such_field": 1}')
    assert apply_sweep_overrides(Config()).lr == 0.5


# ---------------------------------------------------------- refusals ------

def test_main_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(SMALL)


@pytest.mark.parametrize("extra", [
    ["--model", "GCN"], ["--model", "SAGE"],
    ["--model", "transE", "--mesh_shape", "1", "--mesh_axes", "graph"],
    ["--model", "SEALDGCNN", "--mesh_shape", "1", "--mesh_axes", "graph"],
    ["--model", "SEALGCN", "--mesh_shape", "1"],
    ["--model", "rotatE", "--mesh_shape", "1"]])
def test_unported_options_raise(extra):
    """What the port does not run: models the runner has no trainer for,
    and SEAL or KGE on a mesh (their trainers have no mesh, as the JAX
    package's)."""
    with pytest.raises(NotImplementedError):
        run.main(SMALL + extra + ["--device", "cpu"])


@pytest.mark.parametrize("extra, match", [
    (["--mesh_shape", "1", "--mesh_axes", "rows"], "the axes are"),
    (["--mesh_shape", "2", "--mesh_axes", "graph"], "needs 2 ranks"),
    (["--mesh_shape", "1,1", "--mesh_axes", "graph"], "does not match"),
    (["--mesh_shape", "1", "--mesh_axes", "data", "--memory_sharded", "1"],
     "graph")])
def test_mesh_refusals(extra, match):
    """The graph and lane axes run; an unknown axis, a shape that the
    process group (one process here) does not divide into, a shape of
    another length than the axes and --memory_sharded without a graph
    axis raise ValueError."""
    with pytest.raises(ValueError, match=match):
        run.main(SMALL + extra + ["--device", "cpu"])


def test_platform_maps_onto_the_device(capsys):
    """--platform cpu runs on the CPU without --device; --platform gpu
    asks for CUDA (absent here); a conflicting or unknown platform
    raises."""
    run.main(SMALL + ["--epochs", "0", "--platform", "cpu"])
    assert "executing on cpu" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run.main(SMALL + ["--platform", "gpu"])
    for bad in (["--platform", "cpu", "--device", "cuda"],
                ["--platform", "tpu", "--device", "cpu"]):
        with pytest.raises(ValueError, match="--platform"):
            run.main(SMALL + bad)


def test_determinism_check_catches_a_nondeterministic_epoch():
    class NoisyTrainer:
        calls = 0

        def train_epoch(self, model, optimizer, seed):
            self.calls += 1
            with torch.no_grad():
                model.weight.add_(1e-7 * self.calls)
            return 0.5

    model = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(model.parameters())
    with pytest.raises(AssertionError, match="nondeterministic epoch"):
        check_epoch_determinism(NoisyTrainer(), model, opt, 0)
    # the caller's model is left as it was
    assert float(model.weight.detach().abs().max()) < 1


# ------------------------------------------------------------ CPU runs ----

def _runs(base, small):
    """One straight 2-epoch run (checkpoint every epoch, --save_model,
    --check_determinism) and a resumed one (1 epoch, then --resume to 2)."""
    straight, resumed = str(base / "straight"), str(base / "resumed")
    first = run.main(small + ["--device", "cpu", "--checkpoint_dir", straight,
                              "--checkpoint_every", "1", "--save_model",
                              "--check_determinism"])
    part = run.main(small + ["--device", "cpu", "--checkpoint_dir", resumed,
                             "--checkpoint_every", "1", "--epochs", "1"])
    again = run.main(small + ["--device", "cpu", "--checkpoint_dir", resumed,
                              "--checkpoint_every", "1", "--resume"])
    return {"straight": straight, "resumed": resumed, "first": first,
            "part": part, "again": again, "small": small}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _runs(tmp_path_factory.mktemp("runs"), SMALL)


@pytest.fixture(scope="module")
def elph_runs(tmp_path_factory):
    return _runs(tmp_path_factory.mktemp("elph_runs"), SMALL_ELPH)


@pytest.fixture(scope="module")
def emb_runs(tmp_path_factory):
    return _runs(tmp_path_factory.mktemp("emb_runs"), SMALL + EMB)


@pytest.fixture(scope="module")
def elph_emb_runs(tmp_path_factory):
    return _runs(tmp_path_factory.mktemp("elph_emb_runs"), SMALL_ELPH + EMB)


# model -> the fixture of its runs ("emb": with node embeddings)
RUNS = {"BUDDY": "runs", "ELPH": "elph_runs", "BUDDY emb": "emb_runs",
        "ELPH emb": "elph_emb_runs"}


def _assert_hits_within_band_of_jax(runs):
    want = jrun.main(runs["small"] + ["--platform", "cpu"])
    got = runs["first"]
    assert 0.0 < got[0][0] <= 1.0
    assert abs(got[0][0] - want[0][0]) <= 0.05, (got, want)


def test_runner_hits_within_band_of_jax(runs):
    _assert_hits_within_band_of_jax(runs)


def test_elph_runner_hits_within_band_of_jax(elph_runs):
    _assert_hits_within_band_of_jax(elph_runs)


def test_metrics_log_carries_the_reference_keys(runs):
    with open(os.path.join(runs["straight"], "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [0, 1]
    for key in ("loss", "TrainHits@100", "ValHits@100", "tmp_valHits@100",
                "tmp_testHits@100", "TestHits@100", "best_epoch",
                "epoch_time", "preprocess_time", "train_time", "eval_time"):
        assert all(f"rep0_{key}" in r for r in rows), key
    assert rows[0]["rep0_loss"] > rows[1]["rep0_loss"]
    with open(os.path.join(runs["straight"], "config.json")) as f:
        assert Config(**{k: v for k, v in json.load(f).items()}) is not None


@pytest.mark.parametrize("model", list(RUNS))
def test_resume_is_bit_equal_to_a_straight_run(request, model):
    runs = request.getfixturevalue(RUNS[model])
    assert checkpoint.latest_step(runs["straight"]) == 2
    assert checkpoint.latest_step(runs["resumed"]) == 2
    a, _ = checkpoint.load_checkpoint(runs["straight"], 2)
    b, _ = checkpoint.load_checkpoint(runs["resumed"], 2)
    assert a["model"].keys() == b["model"].keys()
    if model.endswith("emb"):   # the table and its diffusion's BN stats
        assert any(k.endswith("node_embedding") for k in a["model"])
        assert any(k.endswith("sign_embedding.bn_2.running_var")
                   for k in a["model"])
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys() and len(sa) > 0
    for i in sa:
        for k, v in sa[i].items():
            assert torch.equal(v, sb[i][k]), (i, k)
    assert (checkpoint.load_run_meta(runs["straight"], 2)
            == checkpoint.load_run_meta(runs["resumed"], 2))
    assert runs["again"] == runs["first"]


def test_resume_past_final_epoch_evaluates(runs):
    """--resume from the --save_model checkpoint at step == epochs skips
    the loop and evaluates the restored model with the saved meta."""
    again = run.main(SMALL + ["--device", "cpu", "--checkpoint_dir",
                              runs["straight"], "--resume"])
    assert again == runs["first"]


def test_latest_step_skips_partial_files(tmp_path):
    for name in ("step_3.pt", "step_10.pt.tmp", "step_x.pt", "meta_step_12.json",
                 "step_7.pt"):
        (tmp_path / name).write_bytes(b"")
    assert checkpoint.latest_step(str(tmp_path)) == 7
    assert checkpoint.latest_step(str(tmp_path / "missing")) is None


@pytest.mark.parametrize("model", list(RUNS))
def test_serving_a_trained_checkpoint_matches_predict(request, model):
    d = request.getfixturevalue(RUNS[model])["straight"]
    scorer = scorer_from_checkpoint(d, split="valid", device="cpu")
    assert scorer.restored_step == 2
    with open(os.path.join(d, "config.json")) as f:
        cfg = Config.from_json(f.read())
    splits, directed, _ = get_data(cfg)
    datasets = build_all_splits(splits, cfg, directed=directed, device="cpu")
    trainer = run.build_trainer(cfg, datasets, datasets["train"].x.shape[-1],
                                "cpu")
    trained = trainer.init_model(0)
    assert checkpoint.restore_into(d, trained) == 2
    want, _ = trainer.predict(trained, "valid")
    got = scorer.score(datasets["valid"].links)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert type(scorer).__name__ == {"BUDDY": "LinkScorer",
                                     "ELPH": "ElphLinkScorer"}[
        model.split()[0]]
    assert (scorer.emb_table is not None) == model.endswith("emb")


def test_serving_a_run_that_cached_its_features(tmp_path):
    """A BUDDY run with --cache_subgraph_features (the reference's ddi and
    collab commands) serves: the rebuild builds the sketch stacks the
    cached per-link features stand in for during training."""
    d = str(tmp_path / "run")
    run.main(SMALL + EMB + ["--epochs", "1", "--device", "cpu",
                            "--cache_subgraph_features", "--cache_dir",
                            str(tmp_path / "cache"), "--checkpoint_dir", d,
                            "--save_model"])
    assert os.listdir(tmp_path / "cache")
    scorer = scorer_from_checkpoint(d, device="cpu")
    with open(os.path.join(d, "config.json")) as f:
        cfg = Config.from_json(f.read())
    datasets = build_all_splits(get_data(cfg)[0], cfg, device="cpu")
    trainer = run.build_trainer(cfg, datasets, None, "cpu")
    trained = trainer.init_model(0)
    checkpoint.restore_into(d, trained)
    want, _ = trainer.predict(trained, "train")
    got = scorer.score(datasets["train"].links)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pretrained_table_is_reread_not_saved(tmp_path):
    """--pretrained_node_embedding (wider than hidden_channels, diffused):
    the checkpoint holds no table, and serving reads it again from the
    config's path and scores as the trainer's predict does."""
    cfg = Config(dataset_name="synth-ba")
    splits, _, _ = get_data(cfg)
    n = splits["train"].graph.num_nodes
    path = str(tmp_path / "table.npy")
    np.save(path, np.random.default_rng(0).normal(size=(n, 40)).astype(
        np.float32))
    d = str(tmp_path / "run")
    run.main(SMALL + ["--pretrained_node_embedding", path,
                      "--propagate_embeddings", "--use_feature", "0",
                      "--batch_size", "1024", "--epochs", "1",
                      "--device", "cpu",
                      "--checkpoint_dir", d, "--save_model"])
    saved, _ = checkpoint.load_checkpoint(d)
    assert not any("node_embedding" in k or "frozen" in k
                   for k in saved["model"])
    assert "sign_embedding.lin_0.weight" in saved["model"]
    scorer = scorer_from_checkpoint(d, split="valid", device="cpu")
    with open(os.path.join(d, "config.json")) as f:
        cfg = Config.from_json(f.read())
    datasets = build_all_splits(get_data(cfg)[0], cfg, device="cpu")
    trainer = run.build_trainer(cfg, datasets, None, "cpu")
    trained = trainer.init_model(0)
    checkpoint.restore_into(d, trained)
    want, _ = trainer.predict(trained, "valid")
    got = scorer.score(datasets["valid"].links)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------- the reference's datasets ----

# the reference README's BUDDY commands (tests/test_cli.py) on the fixtures
# of tests/test_torch_datasets.py, cut to one epoch, and its two ogbl-ddi
# commands (BUDDY and ELPH: node embeddings diffused in every step).
# citation2's and ddi's batch sizes (261424 / 522848, 131072) are cut to
# the fixture's size: a batch pads to its full size, and the command's
# would cost the CPU seconds for a few hundred links.
# name -> (fixture, command, extra flags, the metric it logs)
DATASET_COMMANDS = {
    "Cora": ("cora", REFERENCE_COMMANDS[1], [], "Hits@100"),
    "Citeseer": ("citeseer", REFERENCE_COMMANDS[3], [], "Hits@100"),
    "Pubmed": ("pubmed", REFERENCE_COMMANDS[5], [], "Hits@100"),
    "ogbl-collab": ("collab_year", REFERENCE_COMMANDS[7], [], "Hits@50"),
    "ogbl-citation2": ("citation2", REFERENCE_COMMANDS[10],
                       ["--batch_size", "256", "--eval_batch_size", "1024"],
                       "MRR"),
    "ogbl-ppa": ("ppa_RA", "--dataset_name ogbl-ppa --label_dropout 0.1 "
                 "--use_feature 0 --use_RA 1 --lr 0.03 --epochs 100 "
                 "--hidden_channels 256 --cache_subgraph_features "
                 "--add_normed_features 1 --use_zero_one 1 --model BUDDY",
                 [], "Hits@100"),
    "ogbl-ddi": ("ddi", REFERENCE_COMMANDS[9], ["--batch_size", "256"],
                 "Hits@20"),
    "ogbl-ddi ELPH": ("ddi", REFERENCE_COMMANDS[8], ["--batch_size", "256"],
                      "Hits@20"),
}


@pytest.mark.parametrize("name", list(DATASET_COMMANDS))
def test_reference_buddy_commands_reach_training(tmp_path, name):
    from test_torch_datasets import _write_planetoid
    from test_torch_preprocess import FAMILIES, _write
    family, cmd, extra, metric = DATASET_COMMANDS[name]
    if family in FAMILIES:
        _write(tmp_path, family)
    else:
        _write_planetoid(str(tmp_path), name, family, gap=name == "Citeseer")
    assert all(word in cmd for word in name.split())
    ckpt = str(tmp_path / "run")
    result = run.main(shlex.split(cmd) + extra + [
        "--epochs", "1", "--device", "cpu", "--data_root", str(tmp_path),
        "--cache_dir", str(tmp_path / "cache"), "--checkpoint_dir", ckpt])
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        (row,) = [json.loads(line) for line in f]
    assert np.isfinite(row["rep0_loss"])
    assert f"rep0_Train{metric}" in row
    assert all(0.0 <= r <= 1.0 for r in result[0])
    if "--cache_subgraph_features" in cmd:
        assert any(f.endswith("subgraph_features.npz")
                   for f in os.listdir(tmp_path / "cache"))


# the reference README's ELPH commands (tests/test_cli.py) on the same
# fixtures, cut to one epoch and to hidden 32 (the GCN runs over the whole
# graph in every step); ogbl-ddi's runs with DATASET_COMMANDS
ELPH_COMMANDS = {
    "Cora": ("cora", REFERENCE_COMMANDS[0], "Hits@100"),
    "Citeseer": ("citeseer", REFERENCE_COMMANDS[2], "Hits@100"),
    "Pubmed": ("pubmed", REFERENCE_COMMANDS[4], "Hits@100"),
    "ogbl-collab": ("collab_year", REFERENCE_COMMANDS[6], "Hits@50"),
}


@pytest.mark.parametrize("name", list(ELPH_COMMANDS))
def test_reference_elph_commands_reach_training(tmp_path, name):
    from test_torch_datasets import _write_planetoid
    from test_torch_preprocess import FAMILIES, _write
    family, cmd, metric = ELPH_COMMANDS[name]
    if family in FAMILIES:
        _write(tmp_path, family)
    else:
        _write_planetoid(str(tmp_path), name, family, gap=name == "Citeseer")
    assert name in cmd and "--model ELPH" in cmd
    ckpt = str(tmp_path / "run")
    result = run.main(shlex.split(cmd) + [
        "--epochs", "1", "--hidden_channels", "32", "--device", "cpu",
        "--data_root", str(tmp_path), "--checkpoint_dir", ckpt])
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        (row,) = [json.loads(line) for line in f]
    assert np.isfinite(row["rep0_loss"])
    assert f"rep0_Train{metric}" in row
    assert all(0.0 <= r <= 1.0 for r in result[0])


def _served_equals_predict(ckpt, split="valid", cli=True):
    """The checkpoint served by scorer_from_checkpoint (and by the serve
    CLI, with ``cli``) scores the split's links as the restored trainer's
    predict does, within 1e-5; returns the scorer."""
    from subgraph_sketching_tpu_torch.runners import serve
    scorer = scorer_from_checkpoint(ckpt, split=split, device="cpu")
    with open(os.path.join(ckpt, "config.json")) as f:
        cfg = Config.from_json(f.read())
    datasets = build_all_splits(get_data(cfg)[0], cfg, device="cpu")
    x = datasets["train"].x
    trainer = run.build_trainer(cfg, datasets,
                                None if x is None else x.shape[-1], "cpu")
    trained = trainer.init_model(0)
    checkpoint.restore_into(ckpt, trained)
    want, _ = trainer.predict(trained, split)
    links = datasets[split].links
    np.testing.assert_allclose(scorer.score(links), want, rtol=1e-5,
                               atol=1e-5)
    if not cli:
        return scorer
    q = os.path.join(ckpt, "q.npy")
    np.save(q, links[:300])
    got = serve.main(["--checkpoint_dir", ckpt, "--links", q, "--split",
                      split, "--device", "cpu"])
    np.testing.assert_allclose(got, want[:300], rtol=1e-5, atol=1e-5)
    return scorer


def test_ppa_RA_command_trains_and_serves(tmp_path):
    """The reference's ogbl-ppa command (--use_RA 1) on the ppa_RA fixture
    trains one epoch and serves: scorer_from_checkpoint and the serve CLI
    score RA per query from the message graph's CSR and equal predict."""
    from test_torch_preprocess import _write
    _write(tmp_path, "ppa_RA")
    _, cmd, extra, _ = DATASET_COMMANDS["ogbl-ppa"]
    ckpt = str(tmp_path / "run")
    run.main(shlex.split(cmd) + extra + [
        "--epochs", "1", "--device", "cpu", "--data_root", str(tmp_path),
        "--cache_dir", str(tmp_path / "cache"), "--checkpoint_dir", ckpt,
        "--save_model"])
    scorer = _served_equals_predict(ckpt)
    assert scorer.cfg.use_RA and scorer.ra_csr is not None


def test_elph_RA_run_serves(tmp_path):
    """An ELPH run with --use_RA 1 serves as the JAX package serves it:
    ELPH's model reads no RA column, and the scorer equals predict (the
    serve CLI's path is the BUDDY test's)."""
    ckpt = str(tmp_path / "run")
    run.main(SMALL_ELPH + ["--use_RA", "1", "--epochs", "1", "--device",
                           "cpu", "--checkpoint_dir", ckpt, "--save_model"])
    scorer = _served_equals_predict(ckpt, cli=False)
    assert scorer.cfg.use_RA and type(scorer).__name__ == "ElphLinkScorer"
