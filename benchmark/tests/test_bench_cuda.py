"""On the card: the control of ``correct`` (the reference in the
program's place at float32 with TF32 products) and the fault of half a
batch fail their cell's limits at the published widths and a reduced
graph, and the program's readings there pass them.  Skips without a
card; run on the card with

    python -m pytest benchmark/tests -m cuda
"""

import pytest
import torch

from benchmark import control, spec


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (TF32 and the kernels)")
    return torch.device("cuda")


def _reduced(name: str):
    """The cell at its published widths on a graph of 20,000 nodes."""
    cell = spec.find_cell(name)
    cell.config["graph"] = dict(cell.config["graph"], nodes=20000,
                                edges=200000)
    if cell.config["supervision"]["count"] != "all":
        # three full batches of the published 261,424 links
        cell.config["supervision"] = dict(cell.config["supervision"],
                                          count=140000)
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["elph-collab.train",
                                  "buddy-citation2.train"])
def test_control_fails_and_program_passes(name):
    dev = _card()
    out = control.train_readings(_reduced(name), 9001, dev)
    assert out["program"]["correct"], out["program"]["checks"]
    assert not out["control_tf32"]["correct"], out["control_tf32"]["checks"]
    assert not out["fault_half_batch"]["correct"]
