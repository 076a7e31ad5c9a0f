"""A run whose timed path is broken underneath comes out not correct: a
step that leaves the state unchanged, half of each batch left out of the
loss.  (One card: no exchange
between chips to leave out; no answer a training cell gives is checked
apart from its state, which the first two faults alter.)"""

import pytest
import torch

from benchmark import run as bench_run
from benchmark.tests.tiny import tiny_cell


@pytest.fixture(autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _run(cell):
    return bench_run.run(cell, 4242, 0.3, False, device="cpu",
                         cell=tiny_cell(cell))


@pytest.mark.parametrize("cell", ["elph-collab.train",
                                  "buddy-citation2.train"])
def test_unchanged_state_is_caught(cell, monkeypatch):
    from subgraph_sketching_tpu_torch.train import loops
    monkeypatch.setattr(loops._Trainer, "_update",
                        lambda self, model, optimizer, loss: None)
    res = _run(cell)
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] > 0.5


@pytest.mark.parametrize("cell", ["elph-collab.train",
                                  "buddy-citation2.train"])
def test_half_batch_is_caught(cell, monkeypatch):
    from subgraph_sketching_tpu_torch.train import loops
    from subgraph_sketching_tpu_torch.train.losses import bce_loss

    def half(logits, labels, mask=None):
        b = logits.shape[0] // 2
        return bce_loss(logits[:b], labels[:b], mask[:b])
    monkeypatch.setattr(loops, "get_loss", lambda name: half)
    res = _run(cell)
    assert not res["correct"]
