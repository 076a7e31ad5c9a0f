"""setup_features_s: the program's stage ``setup.features`` (the per-link
subgraph features of the set-up, with their copy to the host), its self
seconds in the run's set-up (``benchmark/spans.py``)."""

from benchmark import spans

measure = spans.measure


def read(s: dict):
    return spans.stage_s(s, "setup.features")
