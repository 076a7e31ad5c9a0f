"""setup_plans_s: the program's stage ``setup.plans`` (every set-up
construction of plan tables and their staged weights), its self seconds
in the run's set-up: less the builder's load, ``setup.kernels``
(``benchmark/spans.py``)."""

from benchmark import spans

measure = spans.measure


def read(s: dict):
    return spans.stage_s(s, "setup.plans")
