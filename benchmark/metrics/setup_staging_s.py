"""setup_staging_s: the program's stage ``setup.staging`` (the trainer's
staging of a split: host-to-device copies and ``gcn_norm``, less the
stages inside it), its self seconds in the run's set-up
(``benchmark/spans.py``)."""

from benchmark import spans

measure = spans.measure


def read(s: dict):
    return spans.stage_s(s, "setup.staging")
