"""batch_norm_ms.train: the program's spans ``bn.forward`` and
``bn.backward`` (the training-mode BatchNorms over the link batch,
``ops/batch_norm.py``: each kernel pass whole, its three kernels on the
device's clock), their device ms per recorded training step
(``benchmark/spans.py``).  Nothing to read where the program records
neither span, as before the kernel."""

from benchmark import spans

measure = spans.measure


def read(s: dict):
    got = [spans.step_ms(s, n) for n in ("bn.forward", "bn.backward")]
    got = [ms for ms in got if ms is not None]
    return sum(got) if got else None
