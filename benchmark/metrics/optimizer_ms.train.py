"""optimizer_ms.train: the program's span ``train.optimizer`` (Adam's
step), its device ms per recorded training step (``benchmark/spans.py``)."""

from benchmark import spans

measure = spans.measure


def read(s: dict):
    return spans.step_ms(s, "train.optimizer")
