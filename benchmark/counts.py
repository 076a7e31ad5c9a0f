"""Operations and bytes a cell's work needs, from its shapes.

FLOPs count the dense layers' multiply-adds as 2 each (forward; in a
training step also the weight gradient, and the input gradient where the
input itself needs one) and the SpMMs' multiply-adds, 2 per stored entry
and column; element-wise work is not counted.  Bytes count each input
read once and each output written once, whatever a kernel reads again.
"""

from __future__ import annotations

from typing import List, Tuple

from benchmark import spec

# (rows per link or per node, fan_in, fan_out, the input needs a gradient)
Layer = Tuple[int, int, int, bool]


def dense_flops(layers: List[Layer], train: bool) -> int:
    total = 0
    for rows, fan_in, fan_out, grad_in in layers:
        fwd = 2 * rows * fan_in * fan_out
        total += fwd * (1 + (1 + int(grad_in) if train else 0))
    return total


def model_flops(shape: dict, links: int, train: bool) -> int:
    """FLOPs of ``links`` links of a cell's model (``shape`` from the
    driver: the model's name and widths), by the model's own file
    (``models/<model>.py``)."""
    return spec.load_model(shape["model"]).flops(shape, links, train)


def k1_add_bytes(subruns: int, rows: int, width: int, elem: int = 4) -> int:
    """K1's add: the [S, W] sub-run results read, the [N, W] output
    written and the [N + 1] int64 pointer read (PERF.md, kernel table)."""
    return subruns * width * elem + rows * width * elem + 8 * (rows + 1)


def spmm_pass_bytes(nodes: int, nnz: int, width: int, elem: int = 4) -> int:
    """One SpMM pass at least: x read once, the output written once, and
    the edge list (two int32 ids) with its float32 weights read once."""
    return 2 * nodes * width * elem + nnz * (4 + 4 + 4)
