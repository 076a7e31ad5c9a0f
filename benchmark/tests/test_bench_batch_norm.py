"""The reader of ``batch_norm_ms.train``: None without the program's
spans ``bn.forward`` / ``bn.backward`` (as in a program before the
BatchNorm kernel) or without ``train.step``; with them, their device ms
per recorded step; and a number from a real run of the program's
BatchNorm under the profiler, on the CPU (whose plain version records
its forward pass only)."""

import pytest
import torch

from benchmark import spans as bench_spans
from benchmark import spec

NAME = "batch_norm_ms.train"


def _reader():
    return spec.load_metric(NAME)


def test_the_metric_is_declared_for_both_training_cells():
    entry = next(m for m in spec.load_benchmark()["per_layer"]
                 if m["name"] == NAME)
    assert entry["source"] == "program_span"
    assert entry["moves"] == "train_links_per_s"
    for cell in entry["workloads"]:
        assert NAME in {m["name"] for m in spec.find_cell(cell).per_layer}


@pytest.mark.parametrize("got", [
    {}, {"program_spans": {}},
    {"program_spans": {"train.step": {"count": 3, "device_s": 0.3}}},
    {"program_spans": {"bn.forward": {"count": 8, "device_s": 0.1}}}])
def test_reads_none_without_its_spans(got):
    assert _reader().read(got) is None


def test_reads_both_passes_per_step():
    step = {"count": 4, "device_s": 0.8}
    fwd = {"count": 32, "device_s": 0.02}
    bwd = {"count": 32, "device_s": 0.06}
    read = _reader().read
    assert read({"program_spans": {"train.step": step, "bn.forward": fwd,
                                   "bn.backward": bwd}}) \
        == pytest.approx(20.0)
    assert read({"program_spans": {"train.step": step,
                                   "bn.forward": fwd}}) \
        == pytest.approx(5.0)


def test_reads_the_program_under_the_profiler():
    from subgraph_sketching_tpu_torch import spans
    from subgraph_sketching_tpu_torch.models.gnn import batch_norm
    spans.reset_spans()
    bn = batch_norm(8).train()
    x = torch.randn(64, 2, 8, requires_grad=True)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            with spans.span("train.step"):
                bn(x).sum().backward()
    got = _reader().read(bench_spans.measure({}))
    spans.reset_spans()
    assert isinstance(got, float) and got > 0
