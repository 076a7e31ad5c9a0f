"""Find a cell's pieces by name: the entry of ``BENCHMARK.json``, its
configuration file, its traffic mix, its correctness limits and the
readers of its per-layer metrics.

Everything that belongs to one configuration, mix or metric lives in a
file of its own, found here by the name ``BENCHMARK.json`` gives it, so a
later change adds files and entries and edits none:

  configs/<config>.json    the configuration as it is run
  mixes/<traffic>.json     the traffic mix's parameters; its ``kind``
                           names the general driver in ``drivers/``
  limits/<cell>.json       the limit of each number ``correct`` compares
  metrics/<metric>.py      the reader of one per-layer metric
  models/<model>.py        a model's program side: trainer, widths, FLOPs
  reference/<model>.py     a model's plain reference: node state, logits
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(*parts: str) -> dict:
    path = os.path.join(BENCH_DIR, *parts)
    if not os.path.exists(path):
        raise KeyError(f"no file {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    chips: int
    config: dict          # configs/<config>.json
    mix: dict             # mixes/<traffic>.json
    limits: dict          # limits/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """A metric with ``workloads`` is the listed cells'; one without is
    every cell's that reports the end-to-end metric it ``moves`` (or,
    for an end-to-end metric, every cell's)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def find_cell(name: str, bench: dict = None) -> Cell:
    """The cell called ``name``; KeyError for a name the benchmark does
    not have or whose files are missing."""
    bench = bench if bench is not None else load_benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next((c for c in bench["configs"] if c["name"] == entry["config"]),
                None)
    if conf is None:
        raise KeyError(f"workload {name!r} names no configuration of "
                       f"BENCHMARK.json: {entry['config']!r}")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name=name, chips=int(entry["chips"]),
                config=_load_json(os.path.relpath(
                    os.path.join(ROOT, conf["file"]), BENCH_DIR)),
                mix=_load_json("mixes", f"{entry['traffic']}.json"),
                limits=_load_json("limits", f"{name}.json"),
                end_to_end=e2e, per_layer=layer)


def load_metric(name: str):
    """The module ``metrics/<name>.py``: ``read(summary)`` gives the
    metric's value or None, and an optional ``measure(ctx)`` adds to the
    traced run's summary what ``read`` needs beyond the trace."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    if not os.path.exists(path):
        raise KeyError(f"no reader benchmark/metrics/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(kind: str):
    """The general driver of a mix's ``kind`` (``drivers/<kind>.py``)."""
    if not os.path.exists(os.path.join(BENCH_DIR, "drivers", f"{kind}.py")):
        raise KeyError(f"no driver benchmark/drivers/{kind}.py")
    return importlib.import_module(f"benchmark.drivers.{kind}")


def load_model(name: str):
    """The harness's file of the model a configuration names
    (``models/<model>.py``, the name in lower case)."""
    mod = name.lower()
    if not os.path.exists(os.path.join(BENCH_DIR, "models", f"{mod}.py")):
        raise KeyError(f"no model file benchmark/models/{mod}.py")
    return importlib.import_module(f"benchmark.models.{mod}")


def metric_units(cell: Cell) -> Dict[str, str]:
    return {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
