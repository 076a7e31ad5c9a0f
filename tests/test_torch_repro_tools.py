"""The port's quality tools (``subgraph_sketching_tpu_torch/tools/
repro_baseline.py`` and ``run_protocol.py``) against the JAX repository's
``tools/repro_baseline.py`` and ``tools/run_protocol.py``, on the CPU.

The JAX tools are scripts, loaded by path under their own names.  Their
``CONFIGS`` tables and the dataset detection must be equal; the port's
rows carry the JAX rows' keys, name the port's runner and go to the
port's artifact (``QUALITY_torch_r<NN>.json`` in the working directory,
or ``--out``), never the JAX package's ``QUALITY_r<NN>.json``.  The
tests write only under ``tmp_path``.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from subgraph_sketching_tpu_torch.tools import repro_baseline, run_protocol
from tests.ogb_fixture import write_collab_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = {"repro_baseline": repro_baseline, "run_protocol": run_protocol}
# the keys of a row of the JAX tool (tools/repro_baseline.py, ``out[name]``)
ROW_KEYS = {"metric", "test_mean", "test_std", "val_mean", "val_std", "reps",
            "reference_paper_target", "wall_s", "command"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tier-1 run shares the cores between its
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(root) -> set:
    return {os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs}


@pytest.mark.parametrize("name", sorted(PORT))
def test_configs_equal_the_jax_tools(name):
    assert PORT[name].CONFIGS == _jax_tool(name).CONFIGS


@pytest.mark.parametrize("tree", ["empty", "collab"])
def test_dataset_status_agrees_with_jax(tmp_path, tree):
    if tree == "collab":
        write_collab_fixture(str(tmp_path))
    jax_tool = _jax_tool("repro_baseline")
    names = {s["args"][s["args"].index("--dataset_name") + 1]
             for s in repro_baseline.CONFIGS.values()}
    for ds in sorted(names):
        got = repro_baseline.dataset_status(ds, str(tmp_path))
        want = jax_tool.dataset_status(ds, str(tmp_path))
        assert got[0] == want[0], ds
        assert got[0] == (tree == "collab" and ds == "ogbl-collab"), ds
        assert bool(got[1]) == (not got[0])


def test_repro_baseline_writes_a_row_under_tmp_path(tmp_path, monkeypatch):
    write_collab_fixture(str(tmp_path))
    work = tmp_path / "cwd"
    work.mkdir()
    monkeypatch.chdir(work)
    art = str(tmp_path / "Q.json")
    repro_baseline.main(["--only", "collab-buddy", "--reps", "1", "--epochs",
                         "1", "--data_root", str(tmp_path), "--out", art,
                         "--device", "cpu"])
    with open(art) as f:
        row = json.load(f)["collab-buddy"]
    assert set(row) == ROW_KEYS
    assert row["metric"] == "Hits@50" and row["reps"] == 1
    assert np.isfinite(row["test_mean"])
    assert row["command"].startswith(
        "python -m subgraph_sketching_tpu_torch.runners.run --dataset_name "
        "ogbl-collab")
    assert not os.listdir(work)


def test_repro_baseline_check_writes_nothing(tmp_path, monkeypatch, capsys):
    write_collab_fixture(str(tmp_path))
    before = _files(tmp_path)
    monkeypatch.chdir(tmp_path)
    repro_baseline.main(["--check", "--data_root", str(tmp_path),
                         "--device", "cpu"])
    assert _files(tmp_path) == before
    out = capsys.readouterr().out
    assert "[collab-buddy] ogbl-collab: available" in out
    assert "[cora-buddy] Cora: NOT AVAILABLE" in out


def test_default_artifacts_name_the_port():
    assert repro_baseline.artifact_path(3) == "QUALITY_torch_r03.json"


def test_run_protocol_merges_and_keeps_opt_in_rows_out(tmp_path,
                                                       monkeypatch):
    """A default run writes every row but the opt-in ones into the port's
    artifact in the working directory and keeps the rows already there;
    ``--only`` runs the rows named, heuristics by run_heuristics."""
    monkeypatch.chdir(tmp_path)
    calls = []
    monkeypatch.setattr(run_protocol, "model_row",
                        lambda name, kw, reps, dev: calls.append(
                            (name, reps, str(dev))) or {"reps": reps})
    monkeypatch.setattr(run_protocol, "heuristics_row",
                        lambda dev: calls.append(("heuristics", str(dev)))
                        or {"reps": 1})
    with open("QUALITY_torch_r02.json", "w") as f:
        json.dump({"kept-row": {"reps": 7}}, f)
    run_protocol.main(["--reps", "2", "--device", "cpu"])
    with open("QUALITY_torch_r02.json") as f:
        out = json.load(f)
    rows = set(run_protocol.CONFIGS) - set(run_protocol.OPT_IN)
    assert set(out) == rows | {"kept-row", "protocol"}
    assert out["kept-row"] == {"reps": 7}
    assert ("heuristics", "cpu") in calls
    assert ("buddy-synth-ws", 2, "cpu") in calls
    assert os.listdir(tmp_path) == ["QUALITY_torch_r02.json"]
    calls.clear()
    run_protocol.main(["--only", "seal-dgcnn-synth-ba", "--reps", "1",
                       "--device", "cpu"])
    assert calls == [("seal-dgcnn-synth-ba", 1, "cpu")]
    with pytest.raises(SystemExit):
        run_protocol.main(["--only", "no-such-row", "--device", "cpu"])


def test_run_protocol_model_row_runs_the_port_runner(monkeypatch):
    """A model row through runners.run at a small size: the row's keys,
    reps and command."""
    kw = dict(dataset_name="synth-ba", model="BUDDY", epochs=1, K=50,
              hidden_channels=8, batch_size=256)
    row = run_protocol.model_row("buddy-synth-ba", kw, 1, "cpu")
    assert set(row) == ROW_KEYS - {"reference_paper_target"}
    assert row["reps"] == 1 and np.isfinite(row["test_mean"])
    assert row["command"] == (
        "python -m subgraph_sketching_tpu_torch.runners.run --dataset_name "
        "synth-ba --model BUDDY --epochs 1 --K 50 --hidden_channels 8 "
        "--batch_size 256 --reps 1")


@pytest.mark.parametrize("argv", [
    ("repro_baseline", ["--check"]),
    ("run_protocol", ["--only", "buddy-synth-ws"])],
    ids=["repro_baseline", "run_protocol"])
def test_tools_need_cuda_without_a_device(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    name, args = argv
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PORT[name].main(args)
