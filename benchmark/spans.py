"""What the per-layer readers of the program's own spans and stages share
(``subgraph_sketching_tpu_torch/spans.py``).

``measure(ctx)`` hands the traced run's summary the program's span totals
(``program_spans``: name -> count and device seconds) and stage totals
(``program_stages``: name -> self seconds, less the stages nested in it).
A program without the recorder gives nothing, and its readers read
None.

Spans record while the profiler runs: the warm call and the traced slice,
so a span's per-step figure is a mean over the steps recorded, not a sum
over the slice.  Stages record the run's set-up, the same set-up an
untraced run times as ``setup_s``.
"""

import importlib


def measure(ctx: dict) -> dict:
    try:
        spans = importlib.import_module("subgraph_sketching_tpu_torch.spans")
    except ModuleNotFoundError as exc:
        if exc.name != "subgraph_sketching_tpu_torch.spans":
            raise
        return {}
    return {"program_spans": spans.totals(),
            "program_stages": spans.stage_totals()}


def step_ms(s: dict, name: str):
    """The span ``name``'s device ms per recorded ``train.step``."""
    got = s.get("program_spans") or {}
    step, phase = got.get("train.step"), got.get(name)
    if not step or not phase or not step["count"]:
        return None
    return 1e3 * phase["device_s"] / step["count"]


def stage_s(s: dict, name: str):
    """The stage ``name``'s self seconds, summed over its records."""
    return (s.get("program_stages") or {}).get(name)
