"""The harness finds every piece of a cell by name, refuses an unknown
name, and ``BENCHMARK.json`` keeps to the shape the harness reads."""

import re

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_every_cell_resolves(bench):
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"])
        assert cell.chips == w["chips"] == 1
        assert cell.config["name"] == w["config"]
        assert cell.mix["kind"] == "train"
        assert spec.load_driver(cell.mix["kind"]).Driver.kind == \
            cell.mix["kind"]
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in names
            assert hasattr(spec.load_metric(m["name"]), "read")


@pytest.mark.parametrize("name", ["nope", "elph-collab.nope",
                                  "elph-collab", ""])
def test_unknown_cell_refused(name):
    with pytest.raises(KeyError):
        spec.find_cell(name)


def test_unknown_pieces_refused():
    with pytest.raises(KeyError):
        spec.load_metric("no_such_metric")
    with pytest.raises(KeyError):
        spec.load_driver("no_such_kind")
    with pytest.raises(KeyError):
        spec.load_model("no_such_model")


def test_every_configured_model_has_its_files(bench):
    """Each configuration's model is found by name on both sides: the
    program's (``models/<model>.py``) and the reference's."""
    from benchmark.reference import check
    for w in bench["workloads"]:
        name = spec.find_cell(w["name"]).config["config"]["model"]
        prog = spec.load_model(name)
        assert all(hasattr(prog, f) for f in ("trainer", "shape", "flops"))
        ref = check.model(name)
        assert hasattr(ref, "node_state") and hasattr(ref, "logits")


def test_benchmark_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in bench[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        conf = spec.find_cell(next(
            w["name"] for w in bench["workloads"]
            if w["config"] == c["name"])).config
        assert sorted(c["reduced"]) == sorted(conf["reduced"])
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["unit"] == "%" and m["better"] in ("lower", "higher")
        for w in m["workloads"]:
            spec.find_cell(w)


def test_layer_names_agree(bench):
    """Metrics of one layer give the layer letter for letter."""
    by_prefix = {}
    for m in bench["per_layer"]:
        by_prefix.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values()), by_prefix
