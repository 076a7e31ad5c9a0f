"""The readers of the program's own spans and stages (``benchmark/spans.py``
and the metrics that use it): each reads a number in a tiny traced run on
the CPU (``setup_kernels_s`` where a native library loads, which the
CPU's set-up does not), and None where the spans or stages it needs are
missing, as in a program without the recorder."""

import importlib
import math

import pytest
import torch

from benchmark import run as bench_run
from benchmark import spans as bench_spans
from benchmark import spec
from benchmark.tests.tiny import tiny_cell

CELLS = ["elph-collab.train", "buddy-citation2.train"]
_RUNS = {}


def _span_metrics(cell: str) -> list:
    return [m["name"] for m in spec.find_cell(cell).per_layer
            if m["source"] == "program_span"]


def _traced(cell: str) -> dict:
    if cell not in _RUNS:
        from subgraph_sketching_tpu_torch import spans
        spans.reset()       # the run's process holds only its own set-up
        old = torch.get_num_threads()
        torch.set_num_threads(2)
        try:
            _RUNS[cell] = bench_run.run(cell, 2 ** 32 + 19, 0.3, True,
                                        device="cpu", cell=tiny_cell(cell))
        finally:
            torch.set_num_threads(old)
    return _RUNS[cell]


@pytest.mark.parametrize("cell", CELLS)
def test_each_span_reader_reads_a_number(cell):
    names = _span_metrics(cell)
    assert len(names) == 10
    res = _traced(cell)
    assert res["correct"], res["checks"]
    # the CPU builds its plan tables by numpy: no native library loads
    assert "setup_kernels_s" not in res["metrics"]
    for name in set(names) - {"setup_kernels_s"}:
        v = res["metrics"][name]["value"]
        assert isinstance(v, float) and math.isfinite(v) and v > 0, name
    assert ("spmm_step_roofline" in res["metrics"]) == \
        cell.startswith("elph")


@pytest.mark.parametrize("cell", CELLS)
def test_span_readers_read_none_without_their_spans(cell, monkeypatch):
    real = importlib.import_module

    def no_recorder(name, *a, **k):
        if name == "subgraph_sketching_tpu_torch.spans":
            raise ModuleNotFoundError(name=name)
        return real(name, *a, **k)

    monkeypatch.setattr(importlib, "import_module", no_recorder)
    assert bench_spans.measure({}) == {}
    shape = {"nodes": 10, "nnz": 30, "hidden": 8}
    for name in _span_metrics(cell):
        reader = spec.load_metric(name)
        assert reader.read({}) is None, name
        assert reader.read({"program_spans": {}, "program_stages": {},
                            "shape": shape}) is None, name


def test_kernel_reader_reads_the_library_loads(monkeypatch):
    """``setup_kernels_s``: the seconds of the native libraries' builds
    and loads (here the C++ plan builder's, loaded afresh)."""
    from subgraph_sketching_tpu_torch import spans
    from subgraph_sketching_tpu_torch.ops import cuda_build
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    spans.reset()
    cuda_build.load("plan_build")
    got = spec.load_metric("setup_kernels_s").read(bench_spans.measure({}))
    assert got == spans.stage_totals()["setup.kernels"] > 0
    spans.reset()


def test_step_readers_need_the_step_span():
    """A phase without ``train.step`` has no per-step figure; with it,
    the phase's device ms over the steps."""
    phase = {"count": 4, "device_s": 0.2}
    assert bench_spans.step_ms({"program_spans": {"train.forward": phase}},
                               "train.forward") is None
    got = bench_spans.step_ms({"program_spans": {
        "train.forward": phase, "train.step": dict(phase, count=4)}},
        "train.forward")
    assert got == pytest.approx(50.0)
