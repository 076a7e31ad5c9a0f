"""setup_sketches_s: the program's stage ``setup.sketches`` (the sketch
tables' build), its self seconds in the run's set-up
(``benchmark/spans.py``)."""

from benchmark import spans

measure = spans.measure


def read(s: dict):
    return spans.stage_s(s, "setup.sketches")
