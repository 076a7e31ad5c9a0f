"""The generators repeat exactly from a seed, and every seed makes the
same amount of work."""

import pytest
import torch

from benchmark.inputs import graphs
from benchmark.inputs.weights import seeded_state_dict
from benchmark.tests.tiny import tiny_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345   # more than 32 signed bits hold


@pytest.mark.parametrize("cell", ["elph-collab.train",
                                  "buddy-citation2.train"])
def test_graph_repeats(cell):
    spec_ = tiny_cell(cell).config["graph"]
    a = graphs.make_graph(spec_, SEED, CPU)
    b = graphs.make_graph(spec_, SEED, CPU)
    c = graphs.make_graph(spec_, SEED + 1, CPU)
    assert torch.equal(a["edges"], b["edges"]) and torch.equal(a["x"], b["x"])
    assert a["edges"].shape == c["edges"].shape == (2, spec_["edges"])
    assert not torch.equal(a["edges"], c["edges"])
    e = a["edges"]
    assert int(e.min()) >= 0 and int(e.max()) < spec_["nodes"]
    assert not bool((e[0] == e[1]).any())


def test_simple_graph_has_distinct_unordered_pairs():
    spec_ = tiny_cell("buddy-citation2.train").config["graph"]
    e = graphs.make_graph(spec_, SEED, CPU)["edges"]
    n = spec_["nodes"]
    keys = torch.minimum(e[0], e[1]) * n + torch.maximum(e[0], e[1])
    assert keys.unique().numel() == keys.numel()


def test_supervision_layout():
    cell = tiny_cell("buddy-citation2.train")
    g = graphs.make_graph(cell.config["graph"], SEED, CPU)
    sup = cell.config["supervision"]
    pos, neg = graphs.supervision(sup, g["edges"], 400, SEED, CPU)
    assert len(pos) == sup["count"]
    assert len(neg) == sup["count"] * sup["per_positive"]
    assert torch.equal(neg[:, 0], pos[:, 0].repeat_interleave(5))
    pos2, neg2 = graphs.supervision(sup, g["edges"], 400, SEED, CPU)
    assert torch.equal(pos, pos2) and torch.equal(neg, neg2)


def test_weights_repeat():
    lin = torch.nn.Sequential(torch.nn.Linear(6, 4),
                              torch.nn.BatchNorm1d(4))
    a = seeded_state_dict(lin, SEED, CPU)
    b = seeded_state_dict(lin, SEED, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    bound = (6.0 / 10) ** 0.5
    assert float(a["0.weight"].abs().max()) <= bound
    assert torch.equal(a["1.weight"], torch.ones(4))
    assert torch.equal(a["1.running_var"], torch.ones(4))
    assert torch.equal(a["0.bias"], torch.zeros(4))
