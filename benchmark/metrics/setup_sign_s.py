"""setup_sign_s: the program's stage ``setup.sign`` (the SIGN features in
``build_link_dataset``, less their plan tables), its self seconds in the
run's set-up (``benchmark/spans.py``)."""

from benchmark import spans

measure = spans.measure


def read(s: dict):
    return spans.stage_s(s, "setup.sign")
