"""backward_ms.train: the program's span ``train.backward`` (``zero_grad``
and the backward, a mesh's all-reduce inside), its device ms per recorded
training step (``benchmark/spans.py``)."""

from benchmark import spans

measure = spans.measure


def read(s: dict):
    return spans.step_ms(s, "train.backward")
