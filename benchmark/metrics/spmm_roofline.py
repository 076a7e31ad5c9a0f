"""spmm_roofline: the GCN's staged ``PlanSpmm`` at the cell's graph and
hidden width, one forward and one backward timed by CUDA events after
warm-up, against the least time the card could take: per pass x read
once, the output written once, the normalised edge list and its weights
read once (``counts.spmm_pass_bytes``), at the HBM rate.  Nothing to
read where the cell stages no plan."""

import torch

from benchmark import counts, peaks
from benchmark.trace import cuda_ms


def measure(ctx: dict) -> dict:
    plan, shape = ctx.get("plan"), ctx["shape"]
    if (ctx["device"].type != "cuda" or plan is None
            or not hasattr(plan, "fwd") or "nnz" not in shape):
        return {}
    g = torch.Generator(device=ctx["device"]).manual_seed(1)
    x = torch.randn(shape["nodes"], shape["hidden"], generator=g,
                    device=ctx["device"], requires_grad=True)
    grad = torch.randn(shape["nodes"], shape["hidden"], generator=g,
                       device=ctx["device"])

    def step():
        plan(x).backward(grad)

    ms = cuda_ms(step)
    nbytes = 2 * counts.spmm_pass_bytes(shape["nodes"], shape["nnz"],
                                        shape["hidden"])
    return {"spmm_ms": ms, "spmm_bytes": nbytes}


def read(s: dict):
    if not s.get("spmm_ms"):
        return None
    return 100.0 * s["spmm_bytes"] / peaks.HBM_BYTES_PER_S \
        / (s["spmm_ms"] / 1e3)
