"""Card-only tests of the port: the CUDA kernels K1 (csrc/segscan.cu), K3
(csrc/gather_reduce.cu), K2 (csrc/block_prop.cu) and K4
(csrc/dma_gather.cu) against their plain torch versions, bit-equal, and
the serving slice on the card against the same slice on the CPU.  K1 and
K3 split their work by a merge-path partition (csrc/merge_path.cuh), so
they are also run on degree profiles that hit each edge of it (rows of one
share, one share +- 1 and three shares, empty rows at a share boundary, a
star, a long last row, one row, no items), at widths of 16-byte units and
of 32-bit words, and their float32 add is held equal to itself across
calls.  K2 cuts each destination block's edges into pieces, so it is run
on blocks of exactly one piece, one piece +- 1 and three pieces, on empty
blocks, a short last block and a star whose hub spans many pieces; K4
sorts each block's indices, so it is run on indices in random, sorted and
reverse order, all one index and many repeats.  ELPH's uses of K1 are
held at its widths (float32 add at W = 1024 and 32, the float64 add of
the reference runs, the bfloat16 and float16 adds of ``--dtype
bfloat16`` and ``--dtype float16`` at 16-byte and 16-bit widths, W = 1
included, the float16 one's overflow to inf): ``PlanSpmm`` forward and
backward, one launch each way, ``gather_rows``' backward and the scatter ``spmm`` (K1's add each
way), the same bit for bit on two runs, and two ELPH epochs by the
scatter route trained twice bit for bit.  The node embeddings' ddi
diffusion holds K1's add at W = 256 on a dense graph (hundreds of
sub-runs a row), its PlanSpmm each way, and two embedding epochs of BUDDY
and ELPH trained twice bit for bit.  The streaming updates' merges
(int8 amax and biased-int32 amin by ``scatter_reduce_``) equal the CPU's;
weighted inserts and deletes with RA leave the stacks bit-equal to a
rebuild on the card and to the CPU's updates; ``DeviceHeuristics`` on
the card agrees with the host functions.
They skip without a CUDA device.

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


@pytest.mark.parametrize("op,dtype,width", INSTANCES)
def test_chunked_plan_merges_each_chunk_by_the_kernel(cuda, op, dtype,
                                                      width):
    """The chunk-streamed plan on the card: one K1 launch a chunk, each on
    the chunk's window of the output, bit-equal to the one-shot plan and
    to the same chunks merged by the plain version (the add on dyadic
    inputs, whose every partial sum is exact)."""
    from subgraph_sketching_tpu_torch.ops.segment_scan import make_auto_plan
    ei, n = _plan()
    one = SortedSegmentPlan(ei, n, device=cuda)
    chunked = make_auto_plan(ei, n, max_slots=4096, device=cuda)
    assert chunked.num_chunks > 2 and chunked.base.native
    g = torch.Generator(device="cuda").manual_seed(2)
    w = w_one = None
    if op == "add":
        x = torch.randint(-32, 32, (n, width), generator=g,
                          device="cuda").float() / 4
        weights = np.random.default_rng(3).integers(
            1, 5, ei.shape[1]).astype(np.float32) / 4
        w, w_one = chunked.stage_edge_data(weights), \
            one.stage_edge_data(weights)
    else:
        x = _input(n, dtype, width, g)
    name = segscan._ENTRY[(op, dtype)][0]
    before = segscan.launches[name]
    got = chunked.reduce(x, op, edge_data_slots=w)
    torch.cuda.synchronize()
    assert segscan.launches[name] == before + chunked.num_chunks
    assert torch.equal(got, one.reduce(x, op, edge_data_slots=w_one))
    assert torch.equal(got, chunked.reduce(
        x, op, edge_data_slots=w, merge=segscan.segment_combine_plain))


def test_plan_on_the_card_takes_the_native_tables(cuda):
    from subgraph_sketching_tpu_torch.ops.segment_scan import (
        plan_tables_plain,
    )
    ei, n = _plan()
    plan = SortedSegmentPlan(ei, n, device=cuda)
    assert plan.native
    want = plan_tables_plain(ei[0], ei[1], n, plan.sub_len)
    got = (plan.order, plan._gather_idx_np, plan._sub_dst_np,
           plan._run_starts, plan.sub_starts)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


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
            ("add", torch.float32, (128, 40, 1)), ("max", torch.int8, (256, 8, 4)),
            ("add", torch.bfloat16, (128, 6, 1)),
            ("add", torch.float16, (128, 6, 1))]
K3_CASES = [("min", torch.int32, (128, 40, 1)), ("max", torch.int8, (256, 8, 4))]


def _profile_ptr(profile, steps):
    counts = np.asarray(PROFILES[profile](steps), dtype=np.int64)
    return np.concatenate([[0], np.cumsum(counts)]), counts


def _rows(n, dtype, width, g, dyadic=False):
    """Random rows; float32, bfloat16 and float16 as multiples of 1/4 in
    [-8, 8) when ``dyadic`` (every partial sum of a few thousand is exact
    in float32, so any order agrees, and the 16-bit adds round the same
    exact sum once)."""
    if dtype in (torch.float32, torch.bfloat16, torch.float16):
        if dyadic:
            return (torch.randint(-32, 32, (n, width), generator=g,
                                  device="cuda").float() / 4).to(dtype)
        return torch.randn((n, width), generator=g, device="cuda").to(dtype)
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


@pytest.mark.parametrize("width", [1024, 128, 6, 1])
@pytest.mark.parametrize("profile", ["spans_3_shares", "star", "random_hub"])
def test_segscan_bf16_add_within_its_bound_and_repeats(cuda, profile, width):
    """K1's bfloat16 add (summed in float32, rounded once a row) on random
    inputs with a hub, at 16-byte-unit widths and at 16-bit-element ones
    (W = 1, DGCNN's last layer): bit-equal to itself across calls, and
    within half a bfloat16 ulp of the float64 sum plus the float32
    accumulation's 2·k·2^-24·Σ|v| over a row's k terms."""
    _half_add_within_its_bound(cuda, profile, width, torch.bfloat16, 2.0 ** -8)


@pytest.mark.parametrize("width", [1024, 128, 6, 1])
@pytest.mark.parametrize("profile", ["spans_3_shares", "star", "random_hub"])
def test_segscan_f16_add_within_its_bound_and_repeats(cuda, profile, width):
    """K1's float16 add, the same kernel with float16 conversions: the
    same checks within half a float16 ulp (2^-11 of the sum)."""
    _half_add_within_its_bound(cuda, profile, width, torch.float16, 2.0 ** -11)


def _half_add_within_its_bound(cuda, profile, width, dtype, half_ulp):
    from subgraph_sketching_tpu_torch.ops import cuda_build
    ptr_np, counts = _profile_ptr(profile, cuda_build.share_steps("segscan"))
    n, s = len(counts), int(ptr_np[-1])
    g = torch.Generator(device="cuda").manual_seed(13)
    v = torch.randn((s, width), generator=g, device="cuda").to(dtype)
    x = torch.empty((n, width), dtype=dtype, device=cuda)
    ptr = torch.from_numpy(ptr_np).to(cuda)
    first = segscan.segment_combine(v, x, "add", ptr)
    second = segscan.segment_combine(v, x, "add", ptr)
    ids = segscan.segment_ids(ptr)
    zeros = torch.zeros((n, width), dtype=torch.float64, device=cuda)
    want = zeros.index_add(0, ids, v.double())
    scale = zeros.index_add(0, ids, v.abs().double())
    torch.cuda.synchronize()
    assert first.dtype == dtype
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))
    k = torch.from_numpy(counts).to(cuda).double()[:, None]
    bound = half_ulp * want.abs() + 2 * k * 2.0 ** -24 * scale
    assert bool(((first.double() - want).abs() <= bound).all())


def test_segscan_f16_add_overflows_to_inf_on_its_rounding(cuda):
    """A float16 row whose sum passes 65,504 is inf, as the plain version
    rounds it, though no float32 partial sum overflows; inf − inf is
    nan; sums in range stay finite (the rows of
    tests/test_torch_float16.py's comparison with JAX)."""
    rows = [[30000.0] * 3, [-30000.0] * 3, [60000.0, 5000.0, -1000.0],
            [65504.0, 8.0, 0.0], [float("inf"), -float("inf"), 1.0]]
    v = torch.tensor(rows, dtype=torch.float16).reshape(-1, 1)
    ptr = torch.arange(0, 3 * len(rows) + 1, 3)
    x = torch.empty((len(rows), 1), dtype=torch.float16)
    want = segscan.segment_combine_plain(v, x, "add", ptr)
    got = segscan.segment_combine(v.to(cuda), x.to(cuda), "add",
                                  ptr.to(cuda)).cpu()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got[~got.isnan()], want[~want.isnan()])
    assert got[:, 0].isinf().tolist() == [True, True, False, False, False]


def test_segscan_f16_refuses_a_layout_it_does_not_take(cuda):
    """A float16 CUDA tensor the kernel cannot take (strided, or x of
    another dtype) raises and launches nothing: no fallback to the plain
    version."""
    v = torch.zeros((4, 16), dtype=torch.float16, device=cuda)
    x = torch.zeros((2, 8), dtype=torch.float16, device=cuda)
    ptr = torch.tensor([0, 2, 4], device=cuda)
    before = dict(segscan.launches)
    with pytest.raises(ValueError, match="not contiguous"):
        segscan.segment_combine(v[:, ::2], x, "add", ptr)
    with pytest.raises(ValueError, match="differ in dtype"):
        segscan.segment_combine(v[:, :8].contiguous(), x.float(), "add",
                                ptr)
    assert segscan.launches == before


@pytest.mark.parametrize("dtype", [torch.int32, torch.int8, torch.int16])
def test_segscan_refuses_what_it_does_not_take_on_cuda(cuda, dtype):
    """An add of a dtype that K1 has no instance for raises on a CUDA
    tensor, and launches nothing: no fallback to the plain version."""
    v = torch.zeros((4, 8), dtype=dtype, device=cuda)
    ptr = torch.tensor([0, 2, 4], device=cuda)
    before = dict(segscan.launches)
    with pytest.raises(ValueError, match="no kernel"):
        segscan.segment_combine(v, v.new_zeros((2, 8)), "add", ptr)
    assert segscan.launches == before


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


# Edges per K2 destination block, in terms of P, the edges of one piece,
# and the rows of the last block (None: a whole block)
K2_PROFILES = {
    "one_piece_each": lambda p: ([p, p, p], None),
    "piece_plus_minus_1": lambda p: ([p - 1, p + 1, p, 1, p + 2], None),
    "spans_3_pieces": lambda p: ([2, 3 * p + 7, 5], None),
    "empty_blocks": lambda p: ([0, 7, 0, 0, p + 3, 0], None),
    "short_last_block": lambda p: ([40, 5, 2 * p + 1], 9),
}

# (op, dtype, width): the sketch instances at 16-byte-unit and word widths
K2_CASES = [("min", torch.int32, 128), ("min", torch.int32, 40),
            ("max", torch.int8, 256), ("max", torch.int8, 8)]


def _k2_layout(profile, steps, seed=15):
    """src sorted within each block, dstl random in the block's rows, and
    the block pointer, for a K2_PROFILES entry."""
    from subgraph_sketching_tpu_torch.studies import sketch_prop as sp
    counts, last_rows = K2_PROFILES[profile](steps)
    rows_of = [sp.BLOCK_ROWS] * len(counts)
    if last_rows is not None:
        rows_of[-1] = last_rows
    n = sum(rows_of)
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.sort(rng.integers(0, n, c)) for c in counts])
    dstl = np.concatenate([rng.integers(0, r, c)
                           for c, r in zip(counts, rows_of)])
    blk_ptr = np.concatenate([[0], np.cumsum(counts)])
    return src.astype(np.int32), dstl.astype(np.int32), blk_ptr, n


def _k2_run_twice(x, src, dstl, blk_ptr, pieces, is_min):
    """K2 twice, its plain version, and the launches each entry point
    counted over the two calls."""
    from subgraph_sketching_tpu_torch.studies import sketch_prop as sp
    name, fold_name, _ = sp._ENTRY[("min" if is_min else "max", x.dtype)]
    before = {k: sp.launches[k] for k in (name, fold_name)}
    got = sp.block_prop(x, src, dstl, blk_ptr, is_min=is_min, pieces=pieces)
    again = sp.block_prop(x, src, dstl, blk_ptr, is_min=is_min, pieces=pieces)
    want = sp.block_prop_plain(x, src, dstl, blk_ptr, is_min=is_min)
    torch.cuda.synchronize()
    return got, again, want, (sp.launches[name] - before[name],
                              sp.launches[fold_name] - before[fold_name])


@pytest.mark.parametrize("profile", list(K2_PROFILES))
@pytest.mark.parametrize("op,dtype,width", K2_CASES)
def test_block_prop_piece_edges(cuda, profile, op, dtype, width):
    """K2 bit-equal to its plain version, and to itself across two calls,
    on every edge of the piece cut, at 16-byte and word widths."""
    from subgraph_sketching_tpu_torch.ops import cuda_build
    from subgraph_sketching_tpu_torch.studies import sketch_prop as sp
    steps = cuda_build.share_steps("block_prop")
    src, dstl, blk_ptr, n = _k2_layout(profile, steps)
    pieces = sp.block_pieces(blk_ptr, steps, cuda)
    g = torch.Generator(device="cuda").manual_seed(16)
    x = _hop_input(n, dtype, width, g)
    got, again, want, (main, folds) = _k2_run_twice(
        x, *(torch.from_numpy(a).to(cuda) for a in (src, dstl, blk_ptr)),
        pieces, op == "min")
    assert main == 2 and folds == (2 if pieces.num_folds else 0)
    assert torch.equal(got, want) and torch.equal(again, got)


@pytest.mark.parametrize("op,dtype,width", K2_CASES)
def test_block_prop_star_spans_many_pieces(cuda, op, dtype, width):
    """A star whose hub's block spans many pieces (folded from scratch),
    through BlockPropPlan: bit-equal to the plain version, to itself and
    to the scatter route; a short last block."""
    from subgraph_sketching_tpu_torch.ops import cuda_build
    from subgraph_sketching_tpu_torch.sketch import elph
    from subgraph_sketching_tpu_torch.studies import sketch_prop as sp
    steps = cuda_build.share_steps("block_prop")
    n, hub, deg = 3 * sp.BLOCK_ROWS + 17, sp.BLOCK_ROWS + 3, 20 * steps + 5
    rng = np.random.default_rng(17)
    ei = np.concatenate([
        np.stack([rng.integers(0, n, deg), np.full(deg, hub)]),
        rng.integers(0, n, (2, 500))], axis=1).astype(np.int32)
    plan = sp.BlockPropPlan(ei, n, device=cuda)
    assert plan.pieces.num_folds == 1 and plan.pieces.num_slots > 20
    g = torch.Generator(device="cuda").manual_seed(18)
    x = _hop_input(n, dtype, width, g)
    is_min = op == "min"
    got, again, want, (main, folds) = _k2_run_twice(
        x, plan.src, plan.dstl, plan.blk_ptr, plan.pieces, is_min)
    assert main == 2 and folds == 2
    assert torch.equal(got, want) and torch.equal(again, got)
    src, dst = (torch.from_numpy(a).to(cuda) for a in ei)
    scatter = (elph.propagate_minhash if is_min else elph.propagate_hll)(
        x, src, dst, n)
    assert torch.equal(got, scatter)


# K4 index orders: each block's indices sorted, reversed, all one row, or
# a handful of rows repeated
K4_ORDERS = {
    "random": lambda rng, m, n: rng.integers(0, n, m),
    "sorted": lambda rng, m, n: np.sort(rng.integers(0, n, m)),
    "reverse": lambda rng, m, n: np.sort(rng.integers(0, n, m))[::-1],
    "one_index": lambda rng, m, n: np.full(m, n // 3),
    "many_repeats": lambda rng, m, n: rng.integers(0, 5, m) * (n // 7),
}


@pytest.mark.parametrize("order", list(K4_ORDERS))
@pytest.mark.parametrize("width", [128, 40, 1])
@pytest.mark.parametrize("n_blocks", [1, 512])
def test_dma_gather_orders(cuda, order, width, n_blocks):
    """K4 bit-equal to its plain version, and to itself across two calls,
    whatever the order of the indices, at 16-byte and word widths."""
    from subgraph_sketching_tpu_torch.studies import dma_gather_rate as dg
    n = 5000
    rng = np.random.default_rng(19)
    g = torch.Generator(device="cuda").manual_seed(20)
    rows = torch.randint(0, 2 ** 31 - 1, (n, width), generator=g,
                         device="cuda", dtype=torch.int32)
    idx = torch.from_numpy(np.ascontiguousarray(K4_ORDERS[order](
        rng, n_blocks * dg.BLOCK + 37, n)).astype(np.int32)).to(cuda)
    before = dg.launches["dma_gather"]
    got = dg.block_mins(rows, idx, n_blocks)
    again = dg.block_mins(rows, idx, n_blocks)
    torch.cuda.synchronize()
    assert dg.launches["dma_gather"] == before + 2
    assert torch.equal(got, dg.block_mins_plain(rows, idx, n_blocks))
    assert torch.equal(again, got)


# ---- ELPH: K1's add at the GCN's widths, PlanSpmm and gather_rows --------

@pytest.mark.parametrize("profile", ["spans_3_shares", "star", "random_hub"])
@pytest.mark.parametrize("dtype,width", [(torch.float32, 1024),
                                         (torch.float32, 32),
                                         (torch.float64, 32)])
def test_segscan_add_at_gcn_widths(cuda, profile, dtype, width):
    """K1's add at ELPH's widths (1024 float32 lanes, a 4 KiB row of 256
    units; 32 lanes; float64 of the float64 reference runs) on dyadic
    inputs with a hub whose row spans many shares: bit-equal to the plain
    version and to itself across two calls, one launch each."""
    from subgraph_sketching_tpu_torch.ops import cuda_build
    ptr_np, counts = _profile_ptr(profile, cuda_build.share_steps("segscan"))
    n, s = len(counts), int(ptr_np[-1])
    g = torch.Generator(device="cuda").manual_seed(13)
    v = (torch.randint(-32, 32, (s, width), generator=g, device="cuda")
         .to(dtype) / 4)
    x = torch.empty((n, width), dtype=dtype, device=cuda)
    ptr = torch.from_numpy(ptr_np).to(cuda)
    name = segscan._ENTRY[("add", dtype)][0]
    before = segscan.launches[name]
    first = segscan.segment_combine(v, x, "add", ptr)
    second = segscan.segment_combine(v, x, "add", ptr)
    torch.cuda.synchronize()
    assert segscan.launches[name] == before + 2
    assert torch.equal(first, second)
    assert torch.equal(first, segscan.segment_combine_plain(v, x, "add", ptr))


def test_segscan_add_f64_refuses_odd_widths(cuda):
    """float64 rows are read as whole 16-byte units only."""
    ptr = torch.tensor([0, 2, 3], dtype=torch.int64, device=cuda)
    v = torch.zeros((3, 5), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="multiple of 2"):
        segscan.segment_combine(v, v[:2].clone(), "add", ptr)


def _gcn_plan_spmm(n=3000, seed=9):
    """A PlanSpmm over the gcn_norm'd edges of ``_plan`` (its hub's run
    spans hundreds of sub-runs forward; its transpose is another plan)."""
    from subgraph_sketching_tpu_torch.ops.graph_ops import gcn_norm
    from subgraph_sketching_tpu_torch.ops.segment_scan import PlanSpmm
    ei, n = _plan(n, seed=seed)
    nei, nw = gcn_norm(torch.from_numpy(ei.astype(np.int64)).cuda(), None, n)
    return PlanSpmm(nei.cpu().numpy(), nw.cpu().numpy(), n,
                    device="cuda"), nei, nw, n


@pytest.mark.parametrize("width", [1024, 32])
def test_plan_spmm_runs_forward_and_backward_on_the_kernel(cuda, width):
    """PlanSpmm on the card: one K1 add launch forward and one backward,
    each against the plain merge of the same sub-run results, and the
    whole against autograd through the scatter spmm."""
    from subgraph_sketching_tpu_torch.ops.graph_ops import spmm
    ps, nei, nw, n = _gcn_plan_spmm()
    g = torch.Generator(device="cuda").manual_seed(14)
    x = torch.randn((n, width), generator=g, device="cuda",
                    requires_grad=True)
    t = torch.randn((n, width), generator=g, device="cuda")
    before = segscan.launches["segscan_add_f32"]
    out = ps(x)
    torch.cuda.synchronize()
    assert segscan.launches["segscan_add_f32"] == before + 1
    (grad,) = torch.autograd.grad((out * t).sum(), x)
    torch.cuda.synchronize()
    assert segscan.launches["segscan_add_f32"] == before + 2
    with torch.no_grad():
        for plan, w, inp, got in ((ps.fwd, ps._w_fwd, x, out),
                                  (ps.bwd, ps._w_bwd, t, grad)):
            v = plan.reduce_subruns(inp, "add", w).contiguous()
            want = segscan.segment_combine_plain(v, inp, "add", plan.sub_ptr)
            scale = segscan.segment_combine_plain(v.abs(), inp, "add",
                                                  plan.sub_ptr)
            assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())
    ref = spmm(nei, nw, x, n)
    (ref_grad,) = torch.autograd.grad((ref * t).sum(), x)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(grad, ref_grad, rtol=1e-4, atol=1e-5)


def test_gather_rows_backward_is_deterministic_on_the_card(cuda):
    """gather_rows' backward (a stable sort, then K1's add) is the same
    bit for bit on two runs and equal to indexing's backward on dyadic
    inputs, with one K1 add launch."""
    from subgraph_sketching_tpu_torch.ops.segment_scan import gather_rows
    g = torch.Generator(device="cuda").manual_seed(15)
    table = torch.randn((5000, 1024), generator=g, device="cuda",
                        requires_grad=True)
    idx = torch.randint(0, 5000, (1024, 2), generator=g, device="cuda")
    idx[:300] = 17                              # one row gathered 600 times
    cot = torch.randint(-32, 32, (1024, 2, 1024), generator=g,
                        device="cuda").float() / 4
    before = segscan.launches["segscan_add_f32"]
    grads = [torch.autograd.grad((gather_rows(table, idx) * cot).sum(),
                                 table)[0] for _ in range(2)]
    torch.cuda.synchronize()
    assert segscan.launches["segscan_add_f32"] == before + 2
    assert torch.equal(grads[0], grads[1])
    (want,) = torch.autograd.grad((table[idx] * cot).sum(), table)
    assert torch.equal(grads[0], want)


def test_scatter_spmm_is_deterministic_on_the_card(cuda):
    """The scatter spmm (``--use_plan false``, or a plan past
    max_gather_slots) sums by a stable sort and K1's add each way: one add
    launch forward and one backward, the same bit for bit on two runs,
    and on dyadic inputs equal to the atomic index_add route."""
    from subgraph_sketching_tpu_torch.ops.graph_ops import spmm
    ei, n = _plan()
    ei = torch.from_numpy(ei.astype(np.int64)).cuda()
    g = torch.Generator(device="cuda").manual_seed(16)
    w = torch.randint(1, 5, (ei.shape[1],), generator=g,
                      device="cuda").float() / 4
    x = (torch.randint(-32, 32, (n, 64), generator=g, device="cuda").float()
         / 4).requires_grad_()
    t = torch.randint(-32, 32, (n, 64), generator=g, device="cuda").float()
    before = segscan.launches["segscan_add_f32"]
    runs = []
    for _ in range(2):
        out = spmm(ei, w, x, n)
        (grad,) = torch.autograd.grad((out * t).sum(), x)
        runs.append((out.detach(), grad))
    torch.cuda.synchronize()
    assert segscan.launches["segscan_add_f32"] == before + 4
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    with torch.no_grad():
        src, dst = ei
        want = torch.zeros_like(x).index_add_(0, dst, x[src] * w[:, None])
        want_grad = torch.zeros_like(x).index_add_(0, src,
                                                   t[dst] * w[:, None])
    assert torch.equal(runs[0][0], want)
    assert torch.equal(runs[0][1], want_grad)


def test_elph_scatter_route_trains_the_same_twice_on_the_card(cuda):
    """Two epochs of ELPH by the scatter SpMM (--use_plan false) from one
    init and one seed give the same losses and parameters bit for bit, as
    the runner's --check_determinism asks on that route too."""
    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.graph.datasets import get_data
    from subgraph_sketching_tpu_torch.graph.preprocess import build_all_splits
    from subgraph_sketching_tpu_torch.train.loops import (
        ElphTrainer, make_optimizer,
    )
    cfg = Config(dataset_name="synth-ws", model="ELPH", hidden_channels=32,
                 use_plan=False)
    splits, directed, _ = get_data(cfg)
    ds = build_all_splits(splits, cfg, directed=directed, device=cuda)
    tr = ElphTrainer(cfg, ds["train"], ds["train"].x.shape[-1], device=cuda)
    assert "plan" not in tr._data["train"]
    runs = []
    for _ in range(2):
        model = tr.init_model(0)
        opt = make_optimizer(cfg, model.parameters())
        losses = [tr.run_epoch(model, opt, seed) for seed in (3, 4)]
        runs.append((torch.cat(losses), model.state_dict()))
    assert torch.equal(runs[0][0], runs[1][0])
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


def test_plan_spmm_bf16_runs_forward_and_backward_on_the_kernel(cuda):
    """PlanSpmm at bfloat16 (``--dtype bfloat16``'s GCN): one bfloat16 K1
    launch each way, each within a bfloat16 ulp (2^-7 of the value, plus
    the float32 sums' 2^-16 of the terms' sum) of the plain merge of the
    same sub-run results, and both the same on a second call."""
    _plan_spmm_half(torch.bfloat16, 2.0 ** -7)


def test_plan_spmm_f16_runs_forward_and_backward_on_the_kernel(cuda):
    """The same at float16 (``--dtype float16``): one float16 K1 launch
    each way, within a float16 ulp (2^-10 of the value, plus 2^-16 of the
    terms' sum)."""
    _plan_spmm_half(torch.float16, 2.0 ** -10)


def _plan_spmm_half(dtype, ulp):
    ps, _, _, n = _gcn_plan_spmm()
    name = segscan._ENTRY[("add", dtype)][0]
    g = torch.Generator(device="cuda").manual_seed(17)
    x = torch.randn((n, 1024), generator=g, device="cuda").to(
        dtype).requires_grad_()
    t = torch.randn((n, 1024), generator=g, device="cuda").to(dtype)
    before = segscan.launches[name]
    runs = []
    for _ in range(2):
        out = ps(x)
        (grad,) = torch.autograd.grad(out, x, t)
        runs.append((out.detach(), grad))
    torch.cuda.synchronize()
    assert segscan.launches[name] == before + 4
    assert runs[0][0].dtype == runs[0][1].dtype == dtype
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    with torch.no_grad():
        for plan, w, inp, got in ((ps.fwd, ps._w_fwd, x, runs[0][0]),
                                  (ps.bwd, ps._w_bwd, t, runs[0][1])):
            v = plan.reduce_subruns(inp, "add", w).contiguous()
            want = segscan.segment_combine_plain(v, inp, "add",
                                                 plan.sub_ptr).float()
            scale = segscan.segment_combine_plain(
                v.float().abs(), inp.float(), "add", plan.sub_ptr)
            assert bool(((got.float() - want).abs()
                         <= ulp * want.abs() + 2.0 ** -16 * scale).all())


@pytest.mark.parametrize("model", ["ELPH", "ELPH_scatter", "SEALDGCNN"])
def test_bf16_training_is_the_same_twice_on_the_card(cuda, model):
    """Two bfloat16 epochs (``--dtype bfloat16``) from one init and one
    seed give the same losses and parameters bit for bit (every sum of
    the step is K1's fixed order, its bfloat16 add included), the
    bfloat16 instance is launched, and the state stays float32."""
    _half_training_twice(cuda, model, "bfloat16")


@pytest.mark.parametrize("model", ["ELPH", "ELPH_scatter", "SEALDGCNN"])
def test_f16_training_is_the_same_twice_on_the_card(cuda, model):
    """The same at float16 (``--dtype float16``), through K1's float16
    add."""
    _half_training_twice(cuda, model, "float16")


def _half_training_twice(cuda, model, dtype):
    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.graph.datasets import get_data
    from subgraph_sketching_tpu_torch.graph.preprocess import build_all_splits
    from subgraph_sketching_tpu_torch.train.loops import (
        ElphTrainer, make_optimizer,
    )
    from subgraph_sketching_tpu_torch.train.seal_loop import (
        build_seal_trainer,
    )
    cfg = Config(dataset_name="synth-ws", model=model.split("_")[0],
                 hidden_channels=32, dtype=dtype,
                 use_plan=model != "ELPH_scatter", train_samples=2048,
                 dynamic_train=True)
    name = segscan._ENTRY[("add", getattr(torch, dtype))][0]
    splits, directed, _ = get_data(cfg)
    if model == "SEALDGCNN":
        tr = build_seal_trainer(cfg, splits, cuda)
    else:
        ds = build_all_splits(splits, cfg, directed=directed, device=cuda)
        tr = ElphTrainer(cfg, ds["train"], ds["train"].x.shape[-1],
                         device=cuda)
    before = segscan.launches[name]
    runs = []
    for _ in range(2):
        model_ = tr.init_model(0)
        opt = make_optimizer(cfg, model_.parameters())
        losses = [tr.train_epoch(model_, opt, seed) for seed in (3, 4)]
        runs.append((losses, model_.state_dict(), opt))
    torch.cuda.synchronize()
    assert segscan.launches[name] > before
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert v.dtype in (torch.float32, torch.int64), k
        assert torch.equal(v, runs[1][1][k]), k
    assert all(t.dtype == torch.float32 for st in runs[0][2].state.values()
               for k, t in st.items() if k != "step")


# ---- node embeddings: the ddi diffusion at W = 256 ------------------------

def _dense_graph(n=3000, mean_degree=400, seed=21):
    """A dense graph of the ddi kind: distinct unordered pairs with skewed
    degrees, both directions (hundreds of sub-runs a row)."""
    rng = np.random.default_rng(seed)
    p = np.arange(1, n + 1, dtype=np.float64) ** -0.45
    p = p[rng.permutation(n)] / p.sum()
    k = n * mean_degree // 2
    a, b = rng.choice(n, k, p=p), rng.choice(n, k, p=p)
    keep = a != b
    key = np.unique(np.minimum(a, b)[keep] * n + np.maximum(a, b)[keep])
    lo, hi = key // n, key % n
    ei = np.stack([np.concatenate([lo, hi]), np.concatenate([hi, lo])])
    return ei.astype(np.int32), n


def _diffusion_plan():
    """The ddi diffusion's PlanSpmm: unweighted gcn_norm'd edges of
    ``_dense_graph``."""
    from subgraph_sketching_tpu_torch.ops.graph_ops import gcn_norm
    from subgraph_sketching_tpu_torch.ops.segment_scan import PlanSpmm
    ei, n = _dense_graph()
    nei, nw = gcn_norm(torch.from_numpy(ei.astype(np.int64)).cuda(), None, n)
    return PlanSpmm(nei.cpu().numpy(), nw.cpu().numpy(), n,
                    device="cuda"), n


def test_segscan_add_at_the_ddi_diffusion_shape(cuda):
    """K1's float32 add at W = 256 on the diffusion plan of a dense graph
    (a few thousand rows, hundreds of sub-runs each): dyadic inputs,
    bit-equal to the plain version and to itself across two calls."""
    ps, n = _diffusion_plan()
    ptr = ps.fwd.sub_ptr
    assert int(ptr.diff().max()) >= 100
    g = torch.Generator(device="cuda").manual_seed(22)
    v = torch.randint(-32, 32, (int(ptr[-1]), 256), generator=g,
                      device="cuda").float() / 4
    x = torch.empty((n, 256), device=cuda)
    first = segscan.segment_combine(v, x, "add", ptr)
    second = segscan.segment_combine(v, x, "add", ptr)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, segscan.segment_combine_plain(v, x, "add", ptr))


def test_diffusion_plan_spmm_on_the_kernel(cuda):
    """The diffusion's PlanSpmm at W = 256: one K1 add launch each way,
    each against the plain merge of the same sub-run results."""
    ps, n = _diffusion_plan()
    g = torch.Generator(device="cuda").manual_seed(23)
    x = torch.randn((n, 256), generator=g, device="cuda", requires_grad=True)
    t = torch.randn((n, 256), generator=g, device="cuda")
    before = segscan.launches["segscan_add_f32"]
    out = ps(x)
    (grad,) = torch.autograd.grad((out * t).sum(), x)
    torch.cuda.synchronize()
    assert segscan.launches["segscan_add_f32"] == before + 2
    with torch.no_grad():
        for plan, w, inp, got in ((ps.fwd, ps._w_fwd, x, out),
                                  (ps.bwd, ps._w_bwd, t, grad)):
            v = plan.reduce_subruns(inp, "add", w).contiguous()
            want = segscan.segment_combine_plain(v, inp, "add", plan.sub_ptr)
            scale = segscan.segment_combine_plain(v.abs(), inp, "add",
                                                  plan.sub_ptr)
            assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.parametrize("model_name", ["BUDDY", "ELPH"])
def test_embedding_epochs_train_the_same_twice_on_the_card(cuda, model_name):
    """Two epochs with a trainable table diffused in every step (the ddi
    shape, dropouts on) from one init and one seed give the same losses
    and parameters bit for bit, with 5 K1 add launches a step."""
    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.graph.datasets import get_data
    from subgraph_sketching_tpu_torch.graph.preprocess import build_all_splits
    from subgraph_sketching_tpu_torch.train import loops
    cfg = Config(dataset_name="synth-ws", model=model_name,
                 hidden_channels=32, use_feature=False,
                 train_node_embedding=True, propagate_embeddings=True,
                 sign_k=2)
    splits, directed, _ = get_data(cfg)
    ds = build_all_splits(splits, cfg, directed=directed, device=cuda)
    trainer = {"BUDDY": loops.BuddyTrainer, "ELPH": loops.ElphTrainer}
    tr = trainer[model_name](cfg, ds["train"], None, device=cuda)
    assert "emb_plan" in tr._data["train"]
    steps = -(-tr.num_links("train") // cfg.batch_size)
    runs = []
    for _ in range(2):
        model = tr.init_model(0)
        opt = loops.make_optimizer(cfg, model.parameters())
        before = segscan.launches["segscan_add_f32"]
        losses = [tr.run_epoch(model, opt, seed) for seed in (3, 4)]
        torch.cuda.synchronize()
        assert segscan.launches["segscan_add_f32"] - before == 5 * 2 * steps
        runs.append((torch.cat(losses), model.state_dict()))
    assert torch.equal(runs[0][0], runs[1][0])
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


def _streaming_scorer(device, n, ei, w=None, use_RA=False,
                      hops_only=False):
    """A small LinkScorer (no node features) over ``ei`` on ``device``."""
    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.graph.container import Graph
    from subgraph_sketching_tpu_torch.graph.preprocess import (
        build_link_dataset,
    )
    from subgraph_sketching_tpu_torch.graph.splits import SplitData
    from subgraph_sketching_tpu_torch.serving import LinkScorer
    from subgraph_sketching_tpu_torch.train.loops import BuddyTrainer
    cfg = Config(dataset_name="synth-ws", hidden_channels=16,
                 use_feature=False, use_RA=use_RA,
                 hops_only_sketches=hops_only)
    links = np.random.default_rng(0).integers(0, n, (64, 2))
    sd = SplitData(graph=Graph(ei, n, w), pos_edges=links[:32],
                   neg_edges=links[32:])
    ds = build_link_dataset(sd, cfg, "train", device=device)
    model = BuddyTrainer(cfg, ds, None, device=device).init_model(0)
    return LinkScorer(cfg, model, ds, device=device)


def test_scatter_reduce_merges_run_on_the_card(cuda):
    """The streaming merge's in-place ops on the card: int8 amax and
    biased-int32 amin by scatter_reduce_, with duplicate destinations,
    equal to the CPU's."""
    g = torch.Generator().manual_seed(3)
    for dtype, op, hi in ((torch.int8, "amax", 60),
                          (torch.int32, "amin", 1 << 30)):
        base = torch.randint(0, hi, (500, 64), generator=g, dtype=dtype)
        src = torch.randint(0, hi, (3000, 64), generator=g, dtype=dtype)
        idx = torch.randint(0, 500, (3000, 1), generator=g).expand_as(src)
        want = base.clone().scatter_reduce_(0, idx, src, op,
                                            include_self=True)
        got = base.to(cuda).scatter_reduce_(0, idx.to(cuda), src.to(cuda),
                                            op, include_self=True)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("hops_only", [False, True])
def test_streaming_updates_on_the_card_are_exact(cuda, hops_only):
    """Weighted inserts and deletes with use_RA on the card: the stacks
    bit-equal to a rebuild on the card and to the same updates on the
    CPU, degrees and the RA CSR equal, scores within 1e-5."""
    from subgraph_sketching_tpu_torch.graph.synthetic import (
        watts_strogatz_graph,
    )
    n = 400
    ei = watts_strogatz_graph(n, 8, 0.1, seed=5)
    und = ei[:, ei[0] < ei[1]]
    rng = np.random.default_rng(1)
    w_und = rng.integers(1, 4, und.shape[1]).astype(np.float32)
    drop = rng.choice(und.shape[1], 40, replace=False)
    keep = np.ones(und.shape[1], bool)
    keep[drop] = False

    def graph(mask):
        e = und[:, mask]
        return (np.concatenate([e, e[::-1]], axis=1),
                np.concatenate([w_und[mask], w_und[mask]]))

    kw = dict(use_RA=True, hops_only=hops_only)
    card = _streaming_scorer(cuda, n, *graph(keep), **kw)
    cpu = _streaming_scorer("cpu", n, *graph(keep), **kw)
    full = _streaming_scorer(cuda, n, *graph(np.ones_like(keep)), **kw)
    small = _streaming_scorer(cuda, n, *graph(keep), **kw)
    q = rng.integers(0, n, (500, 2))
    for op, goal in (("insert", full), ("delete", small)):
        for s in (card, cpu):
            for batch in (drop[:1], drop[1:15], drop[15:]):
                getattr(s, f"{op}_edges")(und[:, batch].T,
                                          weights=w_und[batch])
        for a, b in zip(card.sk, goal.sk):
            if a.dtype == torch.float32:
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-4)
            else:
                assert torch.equal(a, b), op
        for a, b in zip(card.sk, cpu.sk):
            if a.dtype != torch.float32:
                assert torch.equal(a.cpu(), b), op
        assert torch.equal(card.deg, goal.deg)
        assert abs(card.ra_csr - goal.ra_csr).sum() == 0
        np.testing.assert_allclose(card.score(q), goal.score(q), rtol=1e-5,
                                   atol=1e-5)


def test_device_heuristics_on_the_card_match_the_host(cuda):
    """CN/AA/RA by DeviceHeuristics on the card within rtol 1e-4 /
    atol 1e-5 of the host functions, on a weighted graph with a hub
    (several buckets, partial chunks)."""
    import scipy.sparse as ssp

    from subgraph_sketching_tpu_torch.graph.synthetic import (
        barabasi_albert_graph,
    )
    from subgraph_sketching_tpu_torch.heuristics import (
        DeviceHeuristics, adamic_adar, common_neighbours, resource_allocation,
    )
    n = 3000
    ei = barabasi_albert_graph(n, 8, seed=4)
    rng = np.random.default_rng(2)
    key = np.minimum(ei[0], ei[1]) * n + np.maximum(ei[0], ei[1])
    uniq, inv = np.unique(key, return_inverse=True)
    w = rng.integers(1, 5, len(uniq)).astype(np.float32)[inv]
    A = ssp.csr_matrix((w, (ei[0], ei[1])), shape=(n, n))
    links = rng.integers(0, n, (20000, 2))
    links[:300, 0] = 0
    dev = DeviceHeuristics(A, chunk_elems=1 << 20, device=cuda)
    assert len(dev.buckets) > 1
    for kind, fn in (("CN", common_neighbours), ("AA", adamic_adar),
                     ("RA", resource_allocation)):
        np.testing.assert_allclose(dev.scores(links, kind), fn(A, links),
                                   rtol=1e-4, atol=1e-5, err_msg=kind)


# ---- the SEAL and KGE tiers ------------------------------------------------

def _seal_trainer(model_name, device):
    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.graph.datasets import get_data
    from subgraph_sketching_tpu_torch.train.seal_loop import (
        build_seal_trainer,
    )
    cfg = Config(dataset_name="synth-ba", model=model_name,
                 hidden_channels=32, num_seal_layers=2, dropout=0.0,
                 batch_size=64, sortpool_k=20)
    return build_seal_trainer(cfg, get_data(cfg)[0], device=device)


@pytest.mark.parametrize("model_name", ["SEALGCN", "SEALSAGE", "SEALGIN",
                                        "SEALDGCNN", "SEALMLP"])
def test_seal_steps_on_the_card_match_the_cpu(cuda, model_name):
    """One batch's gradients, then two SEAL steps (96 links at batch 64:
    a padded second batch), dropout off, from one init on the card and
    on the CPU: gradients rtol 1e-4 / atol 1e-6 of each parameter's
    largest (Adam's update would hide a wrong size), the epoch loss rtol
    1e-5, parameters rtol 1e-4 / atol 1e-5; and two runs on the card bit
    for bit, each step's sums on K1's add."""
    from subgraph_sketching_tpu_torch.train.loops import make_optimizer
    order = np.random.default_rng(0).permutation(500)[:96]
    runs = []
    for device in ("cpu", cuda, cuda):
        tr = _seal_trainer(model_name, device)
        probe = tr.init_model(0)
        model = tr.init_model(0)
        for m in (probe, model):
            if hasattr(m, "drop"):
                m.drop.p = 0.0
        batch, y = tr.to_device(tr.datasets["train"].batch(order[:64]))
        tr.loss_fn(probe(batch), y, torch.ones(64, dtype=torch.bool,
                                               device=device)).backward()
        grads = {k: p.grad.cpu() for k, p in probe.named_parameters()}
        opt = make_optimizer(tr.cfg, model.parameters())
        segscan.launches["segscan_add_f32"] = 0
        loss = tr.train_epoch(model, opt, 1, order=order)
        adds = segscan.launches["segscan_add_f32"]
        runs.append((loss, {k: v.detach().cpu()
                            for k, v in model.state_dict().items()}, adds,
                     grads))
    (l_cpu, s_cpu, _, g_cpu), (l1, s1, adds, g1), (l2, s2, _, g2) = runs
    if model_name != "SEALMLP":
        assert adds > 0
    for k, v in g_cpu.items():
        assert torch.equal(g1[k], g2[k]), k
        torch.testing.assert_close(g1[k], v, rtol=1e-4,
                                   atol=1e-6 * float(v.abs().max()))
    assert l1 == l2
    np.testing.assert_allclose(l1, l_cpu, rtol=1e-5)
    for k, v in s_cpu.items():
        assert torch.equal(s1[k], s2[k]), k
        if v.is_floating_point():
            torch.testing.assert_close(s1[k], v, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("model_name", ["transE", "distmult", "complEx",
                                        "rotatE"])
def test_kge_steps_on_the_card_match_the_cpu(cuda, model_name):
    """A head- and a tail-corruption KGE step from one init, with the same
    positives and negatives, on the card and on the CPU, and twice on the
    card bit for bit (the entity rows' gradient summed by K1's add).
    The first step's gradients rtol 1e-4 / atol 1e-6 of each table's
    largest (Adam's update would hide a wrong size); losses rtol 1e-5;
    tables rtol 1e-4 / atol 1e-6 on all but 0.1% of
    their elements, and every element within 2 lr a step: Adam's first
    steps move an element by about lr whatever its gradient's size, so a
    gradient within float32 rounding of 0 (transE's L1 sign where a
    difference is within rounding of 0) moves it by up to lr either way
    on either device."""
    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.graph.datasets import get_data
    from subgraph_sketching_tpu_torch.train.kge_loop import KgeTrainer
    from subgraph_sketching_tpu_torch.train.loops import make_optimizer
    cfg = Config(dataset_name="synth-ba", model=model_name,
                 hidden_channels=32, batch_size=256, lr=0.01)
    splits = get_data(cfg)[0]
    rng = np.random.default_rng(1)
    pos = torch.from_numpy(rng.integers(0, 1000, (256, 2)))
    negs = torch.from_numpy(rng.integers(0, 1000, (2, 256, 64)))
    runs = []
    for device in ("cpu", cuda, cuda):
        tr = KgeTrainer(cfg, splits, device=device)
        model = tr.init_model(0)
        opt = make_optimizer(cfg, model.parameters())
        segscan.launches["segscan_add_f32"] = 0
        losses, grads = [], None
        for i, mode in enumerate(("head-batch", "tail-batch")):
            losses.append(float(tr.step(model, opt, pos.to(device),
                                        negs[i].to(device), mode)))
            grads = grads or {k: p.grad.cpu()
                              for k, p in model.named_parameters()}
        assert device == "cpu" or segscan.launches["segscan_add_f32"] == 4
        runs.append((losses, {k: v.detach().cpu()
                              for k, v in model.state_dict().items()},
                     grads))
    (l_cpu, s_cpu, g_cpu), (l1, s1, g1), (l2, s2, g2) = runs
    for k, v in g_cpu.items():
        assert torch.equal(g1[k], g2[k]), k
        torch.testing.assert_close(g1[k], v, rtol=1e-4,
                                   atol=1e-6 * float(v.abs().max()))
    assert l1 == l2
    np.testing.assert_allclose(l1, l_cpu, rtol=1e-5)
    for k, v in s_cpu.items():
        assert torch.equal(s1[k], s2[k]), k
        d = (s1[k] - v).abs()
        assert int((d > 1e-6 + 1e-4 * v.abs()).sum()) <= 1e-3 * v.numel(), k
        assert float(d.max()) <= 2 * cfg.lr * 2, k


def test_citation2_stages_on_the_card_match_the_cpu(cuda):
    """tools/citation2_train.py's stages at a small size on the card and
    on the CPU from the same hop-0 tables and node features: the chunk
    count equal, both hops' sketches bit-equal with K1 launched once a
    chunk of every reduce, cards rtol 1e-5, features rtol 1e-5 / atol
    1e-4, SIGN(k=0) rtol 1e-5 / atol 1e-5, and ``main`` end to end on
    the card."""
    import dataclasses

    from subgraph_sketching_tpu_torch.tools import citation2_train as c2

    sizes = c2.Sizes(nodes=3000, n_pos=8000, n_val=2000, mrr_pos=50,
                     batch=512, feat_batch=1024, epochs=2, num_perm=32,
                     hidden=16, features=16, max_slots=8192)
    params = c2.SketchParams(max_hops=c2.MAX_HOPS, num_perm=sizes.num_perm,
                             hll_p=c2.HLL_P)
    rng = np.random.default_rng(3)
    src, dst, deg = c2.ws_graph(sizes.nodes, rng)
    lk = c2.make_links(src, dst, sizes, rng)
    gen = torch.Generator().manual_seed(3)
    mh0, hll0 = c2.hop0_tables(sizes.nodes, sizes.num_perm, c2.HLL_P, gen)
    x = torch.randn((sizes.nodes, sizes.features), generator=gen)
    links = torch.from_numpy(c2.pad_rows(lk.links, sizes.feat_batch)).long()
    out = {}
    for dev in ("cpu", cuda):
        plan = c2.make_plan(src, dst, sizes.nodes, sizes.max_slots, dev)
        for k in segscan.launches:
            segscan.launches[k] = 0
        sk = c2.build_sketches(plan, mh0.to(dev), hll0.to(dev), params)
        x_sign = c2.sign0(plan, x.to(dev), torch.from_numpy(deg).to(dev),
                          c2.gcn_slots(plan, src, dst, deg))
        out[str(dev)] = (plan.num_chunks, dict(segscan.launches),
                         [t.cpu() for t in sk],
                         c2.features_all(links.to(dev), sk, params,
                                         sizes.feat_batch).cpu(),
                         x_sign.cpu())
    (c_cpu, _, sk_cpu, sf_cpu, xs_cpu), (c, launches, sk, sf, xs) = \
        out["cpu"], out["cuda"]
    assert c == c_cpu >= 3
    assert launches["segscan_min_i32"] == launches["segscan_max_i8"] \
        == c2.MAX_HOPS * c and launches["segscan_add_f32"] == c
    assert torch.equal(sk[0], sk_cpu[0]) and torch.equal(sk[1], sk_cpu[1])
    torch.testing.assert_close(sk[2], sk_cpu[2], rtol=1e-5, atol=0)
    torch.testing.assert_close(sf, sf_cpu, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(xs, xs_cpu, rtol=1e-5, atol=1e-5)
    metrics = c2.main([f"--{k}={v}" for k, v in
                       dataclasses.asdict(sizes).items()])
    assert all(np.isfinite(metrics["epoch_loss"]))
