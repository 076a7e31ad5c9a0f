"""Card-only tests of the port: the CUDA kernel K1 (csrc/segscan.cu)
against its plain torch version, and the serving slice on the card against
the same slice on the CPU.  They skip without a CUDA device.

This file imports no jax, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from subgraph_sketching_tpu_torch.ops import segscan
from subgraph_sketching_tpu_torch.ops.segment_scan import SortedSegmentPlan

pytestmark = pytest.mark.cuda

INSTANCES = [("min", torch.int32, 128), ("max", torch.int8, 256),
             ("max", torch.int32, 128), ("add", torch.float32, 128)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _plan(n=3000, deg=12, seed=9):
    """Random in-edges, nodes 0-9 without any, and a hub (node 17) whose
    run spans hundreds of sub-runs."""
    rng = np.random.default_rng(seed)
    e = n * deg
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    ei[1] = np.where(ei[1] < 10, 10, ei[1])
    ei[1, : e // 4] = 17
    return ei.astype(np.int32), n


def _input(n, dtype, width, g):
    if dtype == torch.float32:
        return torch.randn((n, width), generator=g, device="cuda")
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max, (n, width), generator=g,
                         device="cuda", dtype=dtype)


@pytest.mark.parametrize("op,dtype,width", INSTANCES)
def test_kernel_matches_plain(cuda, op, dtype, width):
    ei, n = _plan()
    plan = SortedSegmentPlan(ei, n, device=cuda)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = _input(n, dtype, width, g)
    w = (plan.stage_edge_data(np.random.default_rng(1).random(ei.shape[1])
                              .astype(np.float32)) if op == "add" else None)
    v = plan.reduce_subruns(x, op, w).contiguous()
    before = segscan.launches[segscan._ENTRY[(op, dtype)][0]]
    got = segscan.segment_combine(v, x, op, plan.sub_ptr)
    want = segscan.segment_combine_plain(v, x, op, plan.sub_ptr)
    torch.cuda.synchronize()
    assert segscan.launches[segscan._ENTRY[(op, dtype)][0]] == before + 1
    if op == "add":
        # float32 sums in another order (atomics in the plain version)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
        assert torch.all(got[:10] == 0)
    else:
        assert torch.equal(got, want)
        assert torch.equal(got[:10], x[:10])   # empty: the node's own row


def test_kernel_refuses_what_it_does_not_take(cuda):
    ei, n = _plan(n=200, deg=4)
    plan = SortedSegmentPlan(ei, n, device=cuda)
    x = torch.zeros((n, 8), dtype=torch.int16, device=cuda)
    v = torch.zeros((plan.num_subruns, 8), dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError, match="no kernel"):
        segscan.segment_combine(v, x, "max", plan.sub_ptr)
    x = torch.zeros((n, 16), dtype=torch.int32, device=cuda)
    v = plan.reduce_subruns(x, "min")
    with pytest.raises(ValueError, match="contiguous"):
        segscan.segment_combine(v[:, ::2], x[:, ::2], "min", plan.sub_ptr)


def test_scorer_on_card_matches_cpu(cuda, tmp_path):
    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.models import BUDDY
    from subgraph_sketching_tpu_torch.serving import (
        save_buddy_checkpoint, scorer_from_checkpoint,
    )
    cfg = Config(dataset_name="synth-ws", hidden_channels=32)
    torch.manual_seed(0)
    save_buddy_checkpoint(str(tmp_path), cfg, BUDDY.from_config(cfg, 128))
    on_card = scorer_from_checkpoint(str(tmp_path), device=cuda)
    on_cpu = scorer_from_checkpoint(str(tmp_path), device="cpu")
    assert torch.equal(on_card.sk.minhash.cpu(), on_cpu.sk.minhash)
    assert torch.equal(on_card.sk.hll.cpu(), on_cpu.sk.hll)
    links = np.random.default_rng(0).integers(0, on_cpu.num_nodes, (2000, 2))
    np.testing.assert_allclose(on_card.score(links), on_cpu.score(links),
                               rtol=1e-4, atol=1e-4)
