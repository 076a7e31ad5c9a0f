"""forward_ms.train: the program's span ``train.forward`` (the batch
gather, the node features or the GCN, embedding rows, the head and the
loss), its device ms per recorded training step (``benchmark/spans.py``)."""

from benchmark import spans

measure = spans.measure


def read(s: dict):
    return spans.step_ms(s, "train.forward")
