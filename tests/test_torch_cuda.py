"""Card-only tests of the port: the CUDA kernels K1 (csrc/segscan.cu), K3
(csrc/gather_reduce.cu), K2 (csrc/block_prop.cu) and K4
(csrc/dma_gather.cu) against their plain torch versions, bit-equal, and
the serving slice on the card against the same slice on the CPU.  K1 and
K3 split their work by a merge-path partition (csrc/merge_path.cuh), so
they are also run on degree profiles that hit each edge of it (rows of one
share, one share +- 1 and three shares, empty rows at a share boundary, a
star, a long last row, one row, no items), at widths of 16-byte units and
of 32-bit words, and their float32 add is held equal to itself across
calls.  They skip without a CUDA device.

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
    w = None
    if op == "add":
        # multiples of 1/4 in [-8, 8) and weights in {1/4 .. 1}: every
        # product is a multiple of 1/16 and every partial sum, the hub's
        # included, is exact in float32, so the kernel's in-order sum and
        # the plain version's atomics agree bit for bit in any order
        x = torch.randint(-32, 32, (n, width), generator=g,
                          device="cuda").float() / 4
        w = plan.stage_edge_data(np.random.default_rng(1).integers(
            1, 5, ei.shape[1]).astype(np.float32) / 4)
    else:
        x = _input(n, dtype, width, g)
    v = plan.reduce_subruns(x, op, w).contiguous()
    before = segscan.launches[segscan._ENTRY[(op, dtype)][0]]
    got = segscan.segment_combine(v, x, op, plan.sub_ptr)
    want = segscan.segment_combine_plain(v, x, op, plan.sub_ptr)
    torch.cuda.synchronize()
    assert segscan.launches[segscan._ENTRY[(op, dtype)][0]] == before + 1
    assert torch.equal(got, want)
    if op == "add":
        assert torch.all(got[:10] == 0)
    else:
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


# (op, dtype, width): the two sketch instances at their served widths, an
# int8 row of two words and an int32 row of 40 (neither a multiple of 32)
HOP_INSTANCES = [("min", torch.int32, 128), ("max", torch.int8, 256),
                 ("max", torch.int8, 8), ("min", torch.int32, 40)]


def _hop_input(n, dtype, width, g):
    if dtype == torch.int8:
        return torch.randint(0, 56, (n, width), generator=g, device="cuda",
                             dtype=dtype)
    return _input(n, dtype, width, g)


@pytest.mark.parametrize("op,dtype,width", HOP_INSTANCES)
def test_hop_kernels_match_plain(cuda, op, dtype, width):
    """K3 and K2 against their plain versions and the scatter route, on a
    graph with isolated nodes and a hub of ~9000 in-edges."""
    from subgraph_sketching_tpu_torch.sketch import elph
    from subgraph_sketching_tpu_torch.studies import gather_reduce as gr
    from subgraph_sketching_tpu_torch.studies import sketch_prop as sp
    ei, n = _plan()
    is_min = op == "min"
    g = torch.Generator(device="cuda").manual_seed(2)
    x = _hop_input(n, dtype, width, g)
    src, dst = (torch.from_numpy(a).to(cuda) for a in ei)
    scatter = (elph.propagate_minhash if is_min else elph.propagate_hll)(
        x, src, dst, n)

    s, d, ptr = (torch.from_numpy(a).to(cuda)
                 for a in gr.prepare_csr_edges(ei, n))
    rows = gr.append_identity_row(x, is_min=is_min)
    name = gr._ENTRY[(op, dtype)][0]
    before = gr.launches[name]
    got = gr.gather_reduce(rows, s, d, ptr, is_min=is_min)
    want = gr.gather_reduce_plain(rows, s, d, is_min=is_min)
    torch.cuda.synchronize()
    assert gr.launches[name] == before + 1
    assert torch.equal(got, want) and torch.equal(got[:-1], scatter)
    assert torch.equal(got[:10], x[:10])   # no in-edges: the node's own row

    plan = sp.BlockPropPlan(ei, n, device=cuda)
    name = sp._ENTRY[(op, dtype)][0]
    before = sp.launches[name]
    got = (plan.propagate_minhash if is_min else plan.propagate_hll)(x)
    want = sp.block_prop_plain(x, plan.src, plan.dstl, plan.blk_ptr,
                               is_min=is_min)
    torch.cuda.synchronize()
    assert sp.launches[name] == before + 1
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(got, scatter)


@pytest.mark.parametrize("width", [128, 40])
def test_dma_gather_matches_plain(cuda, width):
    from subgraph_sketching_tpu_torch.studies import dma_gather_rate as dg
    g = torch.Generator(device="cuda").manual_seed(3)
    rows = torch.randint(0, 2 ** 31 - 1, (5000, width), generator=g,
                         device="cuda", dtype=torch.int32)
    idx = torch.randint(0, 5000, (7 * dg.BLOCK + 100,), generator=g,
                        device="cuda", dtype=torch.int32)
    before = dg.launches["dma_gather"]
    got = dg.block_mins(rows, idx, 7)
    torch.cuda.synchronize()
    assert dg.launches["dma_gather"] == before + 1
    assert torch.equal(got, dg.block_mins_plain(rows, idx, 7))
    assert torch.equal(dg.dma_gather(rows, idx, 7),
                       dg.dma_gather_plain(rows, idx, 7))


def test_hop_kernels_refuse_what_they_do_not_take(cuda):
    from subgraph_sketching_tpu_torch.studies import dma_gather_rate as dg
    from subgraph_sketching_tpu_torch.studies import gather_reduce as gr
    from subgraph_sketching_tpu_torch.studies import sketch_prop as sp
    ei, n = _plan(n=200, deg=4)
    s, d, ptr = (torch.from_numpy(a).to(cuda)
                 for a in gr.prepare_csr_edges(ei, n))
    plan = sp.BlockPropPlan(ei, n, device=cuda)
    for dtype, width, is_min, match in (
            (torch.int16, 8, False, "no kernel"),
            (torch.int8, 6, False, "multiple of 4"),
            (torch.int32, 130, True, "32-bit words")):
        x = torch.zeros((n, width), dtype=dtype, device=cuda)
        with pytest.raises(ValueError, match=match):
            (gr.propagate_min if is_min else gr.propagate_max)(x, s, d, ptr)
        with pytest.raises(ValueError, match=match):
            (plan.propagate_minhash if is_min else plan.propagate_hll)(x)
    x = torch.zeros((n + 1, 16), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        gr.gather_reduce(x[:, ::2], s, d, ptr, is_min=True)
    with pytest.raises(ValueError, match="contiguous"):
        plan.propagate_minhash(x[:n, ::2])
    buf = torch.zeros(n * 32 + 1, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        plan.propagate_hll(buf[1:].view(n, 32))
    with pytest.raises(ValueError, match="src must be int32"):
        gr.gather_reduce(x, s.long(), d, ptr, is_min=True)
    rows = torch.zeros((100, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        dg.block_mins(rows, torch.zeros(dg.BLOCK, dtype=torch.int64,
                                        device=cuda), 1)
    with pytest.raises(ValueError, match="indices"):
        dg.block_mins(rows, torch.zeros(10, dtype=torch.int32, device=cuda),
                      1)


# Degree profiles that hit each edge of the merge-path partition, as item
# counts per row in terms of P, the steps of one share (a row of k items
# takes k + 1 steps).  The first rows of "one_share" each fill one share.
PROFILES = {
    "one_share": lambda p: [p - 1, p - 1, p - 1, 3],
    "share_plus_minus_1": lambda p: [p, 1, p - 2, 5, p + 1, 0, p - 1, 2],
    "spans_3_shares": lambda p: [2, 3 * p + 7, 1, 4],
    "empty_rows_at_boundary": lambda p: [p - 1] + [0] * (p + 3) + [4] + [0] * 5,
    "star": lambda p: [0] * 7 + [4 * p + 9] + [0] * 9,
    "long_last_row": lambda p: [3, 1, 0, 2, 6 * p + 5],
    "n1": lambda p: [3 * p + 2],
    "no_items": lambda p: [0] * (2 * p + 3),
    "random_hub": lambda p: list(np.random.default_rng(5).integers(0, 12, 500))
    + [20 * p + 3] + list(np.random.default_rng(6).integers(0, 3, 300)),
}

# (op, dtype, widths): every instance at a width of 16-byte units and at
# widths of 32-bit words only
K1_CASES = [("min", torch.int32, (128, 40, 1)), ("max", torch.int32, (128, 40, 1)),
            ("add", torch.float32, (128, 40, 1)), ("max", torch.int8, (256, 8, 4))]
K3_CASES = [("min", torch.int32, (128, 40, 1)), ("max", torch.int8, (256, 8, 4))]


def _profile_ptr(profile, steps):
    counts = np.asarray(PROFILES[profile](steps), dtype=np.int64)
    return np.concatenate([[0], np.cumsum(counts)]), counts


def _rows(n, dtype, width, g, dyadic=False):
    """Random rows; float32 as multiples of 1/4 in [-8, 8) when ``dyadic``
    (every partial sum of a few thousand is exact, so any order agrees)."""
    if dtype == torch.float32:
        if dyadic:
            return torch.randint(-32, 32, (n, width), generator=g,
                                 device="cuda").float() / 4
        return torch.randn((n, width), generator=g, device="cuda")
    return _hop_input(n, dtype, width, g)


@pytest.mark.parametrize("profile", list(PROFILES))
@pytest.mark.parametrize("op,dtype,width", [
    (op, dtype, w) for op, dtype, widths in K1_CASES for w in widths])
def test_segscan_partition_edges(cuda, profile, op, dtype, width):
    """K1 bit-equal to its plain version on every partition edge (float32
    add on dyadic inputs), at 16-byte and word widths."""
    from subgraph_sketching_tpu_torch.ops import cuda_build
    ptr_np, counts = _profile_ptr(profile, cuda_build.share_steps("segscan"))
    n, s = len(counts), int(ptr_np[-1])
    g = torch.Generator(device="cuda").manual_seed(11)
    v = _rows(s, dtype, width, g, dyadic=True)
    x = _rows(n, dtype, width, g, dyadic=True)
    ptr = torch.from_numpy(ptr_np).to(cuda)
    name = segscan._ENTRY[(op, dtype)][0]
    before = segscan.launches[name]
    got = segscan.segment_combine(v, x, op, ptr)
    want = segscan.segment_combine_plain(v, x, op, ptr)
    torch.cuda.synchronize()
    assert segscan.launches[name] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("profile", ["spans_3_shares", "star", "random_hub"])
def test_segscan_add_is_deterministic(cuda, profile):
    """float32 add on non-dyadic inputs with a hub: bit-equal to itself
    across calls (its order depends on ptr and the grid only), and within
    float32 reassociation of the plain version."""
    from subgraph_sketching_tpu_torch.ops import cuda_build
    ptr_np, counts = _profile_ptr(profile, cuda_build.share_steps("segscan"))
    n, s = len(counts), int(ptr_np[-1])
    g = torch.Generator(device="cuda").manual_seed(12)
    v = torch.randn((s, 128), generator=g, device="cuda")
    x = torch.randn((n, 128), generator=g, device="cuda")
    ptr = torch.from_numpy(ptr_np).to(cuda)
    first = segscan.segment_combine(v, x, "add", ptr)
    second = segscan.segment_combine(v, x, "add", ptr)
    ids = segscan.segment_ids(ptr)
    zeros = torch.zeros((n, 128), dtype=torch.float64, device=cuda)
    want = zeros.index_add(0, ids, v.double())
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    # |err| of a float32 sum of k terms, in any order, <= k * eps * sum |v|
    scale = zeros.index_add(0, ids, v.abs().double())
    k = torch.from_numpy(counts).to(cuda).double()[:, None]
    assert bool(((first.double() - want).abs()
                 <= k * 2.0 ** -23 * scale).all())


@pytest.mark.parametrize("profile", list(PROFILES))
@pytest.mark.parametrize("op,dtype,width", [
    (op, dtype, w) for op, dtype, widths in K3_CASES for w in widths])
def test_gather_reduce_partition_edges(cuda, profile, op, dtype, width):
    """K3 bit-equal to its plain version, and to itself across two calls,
    on every partition edge at 16-byte and word widths."""
    from subgraph_sketching_tpu_torch.ops import cuda_build
    from subgraph_sketching_tpu_torch.studies import gather_reduce as gr
    _, counts = _profile_ptr(profile, cuda_build.share_steps("gather_reduce"))
    n = len(counts)
    rng = np.random.default_rng(13)
    dst = np.repeat(np.arange(n), counts)
    ei = np.stack([rng.integers(0, n, len(dst)), dst]).astype(np.int32)
    s, d, ptr = (torch.from_numpy(a).to(cuda)
                 for a in gr.prepare_csr_edges(ei, n))
    g = torch.Generator(device="cuda").manual_seed(14)
    is_min = op == "min"
    rows = gr.append_identity_row(_rows(n, dtype, width, g), is_min=is_min)
    name = gr._ENTRY[(op, dtype)][0]
    before = gr.launches[name]
    got = gr.gather_reduce(rows, s, d, ptr, is_min=is_min)
    again = gr.gather_reduce(rows, s, d, ptr, is_min=is_min)
    want = gr.gather_reduce_plain(rows, s, d, is_min=is_min)
    torch.cuda.synchronize()
    assert gr.launches[name] == before + 2
    assert torch.equal(got, want) and torch.equal(again, got)


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
