"""The sketch hop by every route of the port, against the JAX package and
the JAX kernel studies, on the CPU.

The port's K3 (``studies/gather_reduce.py``), K2 (``studies/sketch_prop.py``)
and K4 (``studies/dma_gather_rate.py``) run their plain versions here; the
JAX studies (``studies/pallas_*.py``, loaded by path: ``studies/`` is not a
package) run their Pallas kernels under ``pltpu.force_tpu_interpret_mode``.
The scatter route (``ops/segment.py``, ``sketch/elph.py``) is held against
the JAX package's.  Every comparison is bit-equal: min/max and integer sums
have one answer whatever the order (MinHash compared after un-biasing).

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py.
"""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from subgraph_sketching_tpu.ops import segment as jsegment
from subgraph_sketching_tpu.sketch import elph as jelph
from subgraph_sketching_tpu_torch.graph.synthetic import watts_strogatz_graph
from subgraph_sketching_tpu_torch.ops import segment
from subgraph_sketching_tpu_torch.ops.segment_scan import SortedSegmentPlan
from subgraph_sketching_tpu_torch.sketch import elph
from subgraph_sketching_tpu_torch.sketch.minhash import from_biased, to_biased
from subgraph_sketching_tpu_torch.studies import dma_gather_rate as dg
from subgraph_sketching_tpu_torch.studies import gather_reduce as gr
from subgraph_sketching_tpu_torch.studies import sketch_prop as sp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _study(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_study_{name}", os.path.join(REPO, "studies", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jgr():
    return _study("pallas_gather_reduce")


@pytest.fixture(scope="module")
def jsp():
    return _study("pallas_sketch_prop")


def _graph(kind, n=300, e=2000, seed=0):
    """``mixed``: random edges with node 5 isolated, 100 duplicated edges
    and a hub (node 17, a quarter of the in-edges); ``empty``: no edges."""
    if kind == "empty":
        return np.zeros((2, 0), np.int32), n
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, (2, e)).astype(np.int32)
    ei[ei == 5] = 6
    ei[1, : e // 4] = 17
    return np.concatenate([ei, ei[:, :100]], axis=1), n


def _rows(op, n, seed=1):
    """(JAX input, port input): uint32 and its biased int32 for min, int8
    HLL registers for max."""
    rng = np.random.default_rng(seed)
    if op == "min":
        x = rng.integers(0, 2 ** 32 - 1, (n, 128), dtype=np.uint32)
        return x, torch.from_numpy(to_biased(x))
    x = rng.integers(0, 40, (n, 256)).astype(np.int8)
    return x, torch.from_numpy(x)


def _to_numpy(op, t):
    return from_biased(t) if op == "min" else t.numpy()


def _scatter_route(op, x, ei, n):
    src, dst = torch.from_numpy(ei[0]), torch.from_numpy(ei[1])
    fn = elph.propagate_minhash if op == "min" else elph.propagate_hll
    return fn(x, src, dst, n)


# ------------------------------------------------------ the scatter route --

@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.int32, np.int8, np.float32])
def test_segment_reductions_match_jax(op, dtype):
    rng = np.random.default_rng(2)
    n, e = 40, 500
    data = (rng.integers(-100, 100, (e, 6)).astype(dtype))
    ids = rng.integers(0, n, e).astype(np.int32)
    ids[:5] = 0
    ids[-20:] = n          # out of range: dropped, as the pads of JAX's
    ids[ids == 3] = 4      # segment 3 stays empty: the identity
    mask = rng.random(e) < 0.8
    jfn = getattr(jsegment, f"segment_{op}")
    tfn = getattr(segment, f"segment_{op}")
    for m in (None, mask):
        want = np.asarray(jfn(jnp.asarray(data), jnp.asarray(ids), n,
                              mask=None if m is None else jnp.asarray(m)))
        got = tfn(torch.from_numpy(data), torch.from_numpy(ids), n,
                  mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", ["min", "max"])
def test_propagate_with_mask_matches_jax(op):
    ei, n = _graph("mixed")
    x_j, x_t = _rows(op, n)
    mask = np.random.default_rng(3).random(ei.shape[1]) < 0.7
    jfn = jelph.propagate_minhash if op == "min" else jelph.propagate_hll
    tfn = elph.propagate_minhash if op == "min" else elph.propagate_hll
    for m in (None, mask):
        want = np.asarray(jfn(jnp.asarray(x_j), jnp.asarray(ei[0]),
                              jnp.asarray(ei[1]), n,
                              mask=None if m is None else jnp.asarray(m)))
        got = tfn(x_t, torch.from_numpy(ei[0]), torch.from_numpy(ei[1]), n,
                  mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(_to_numpy(op, got), want)


# -------------------------------------------------------------------- K3 --

@pytest.mark.parametrize("kind", ["mixed", "empty"])
def test_prepare_csr_edges_equals_jax(jgr, kind):
    ei, n = _graph(kind)
    src, dst, ptr = gr.prepare_csr_edges(ei, n)
    want_src, want_dst = jgr.prepare_csr_edges(ei, n)
    np.testing.assert_array_equal(src, want_src)
    np.testing.assert_array_equal(dst, want_dst)
    assert src.dtype == dst.dtype == np.int32 and len(src) % 4096 == 0
    # the pointer covers the real edges; row n (the pads' row) has none
    e = ei.shape[1]
    assert ptr.shape == (n + 2,) and ptr[n] == ptr[n + 1] == e
    np.testing.assert_array_equal(np.diff(ptr[:n + 1]),
                                  np.bincount(ei[1], minlength=n))
    np.testing.assert_array_equal(
        dst[:e], np.repeat(np.arange(n), np.diff(ptr[:n + 1])))


@pytest.mark.parametrize("kind,op", [("mixed", "min"), ("mixed", "max"),
                                     ("empty", "min")])
def test_gather_reduce_bit_equal_to_pallas(jgr, kind, op):
    """min: the study's uint32 entry point (it biases inside) against the
    port on biased lanes; max: the kernel's whole [n + 1, W] output."""
    ei, n = _graph(kind)
    x_j, x_t = _rows(op, n)
    is_min = op == "min"
    src, dst, ptr = map(torch.from_numpy, gr.prepare_csr_edges(ei, n))
    js, jd = map(jnp.asarray, jgr.prepare_csr_edges(ei, n))
    rows_j = jgr.append_identity_row(jnp.asarray(x_j), is_min=is_min)
    with pltpu.force_tpu_interpret_mode():
        if is_min:
            want = np.asarray(jgr.propagate_min_pallas(jnp.asarray(x_j), js,
                                                       jd))
        else:
            full = np.asarray(jgr.gather_reduce(rows_j, js, jd,
                                                is_min=False))
            want = full[:-1]
    prop = gr.propagate_min if is_min else gr.propagate_max
    hop = prop(x_t, src, dst, ptr)
    np.testing.assert_array_equal(_to_numpy(op, hop), want)
    assert torch.equal(hop, _scatter_route(op, x_t, ei, n))
    rows_t = gr.append_identity_row(x_t, is_min=is_min)
    got = gr.gather_reduce(rows_t, src, dst, ptr, is_min=is_min)
    if is_min:
        np.testing.assert_array_equal(from_biased(got[-1]),
                                      np.full(128, 2 ** 32 - 1, np.uint32))
    else:
        np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
        np.testing.assert_array_equal(got.numpy(), full)


# -------------------------------------------------------------------- K2 --

@pytest.mark.parametrize("kind", ["mixed", "empty"])
def test_block_layout_matches_jax_at_its_block(jsp, kind):
    """At the TPU's 4096-row block the port's layout is the JAX layout with
    the tile padding taken out."""
    ei, n = _graph(kind)
    src, dstl, blk_ptr, nb = sp.prepare_block_edges(ei, n,
                                                    block_rows=jsp.NB)
    src_t, dstl_t, blk_t, nb_j = jsp.prepare_block_edges(ei, n)
    assert nb == nb_j
    real = src_t >= 0
    np.testing.assert_array_equal(src, src_t[real])
    np.testing.assert_array_equal(dstl, dstl_t[real])
    edge_blk = np.repeat(blk_t, jsp.TE)[real]
    np.testing.assert_array_equal(np.diff(blk_ptr),
                                  np.bincount(edge_blk, minlength=nb))
    # the port's own block: every edge plus one self-loop, in its block
    src, dstl, blk_ptr, nb = sp.prepare_block_edges(ei, n)
    assert nb == -(-n // sp.BLOCK_ROWS) and blk_ptr[-1] == ei.shape[1] + n
    assert dstl.min() >= 0 and dstl.max() < sp.BLOCK_ROWS


_JAX_BLOCK_PROP = {}


def _jax_block_prop(jsp, kind, op):
    """The JAX K2 study kernel in interpret mode on ``_graph(kind)`` and
    ``_rows(op)``, run once per (kind, op) in this module."""
    if (kind, op) not in _JAX_BLOCK_PROP:
        ei, n = _graph(kind)
        jplan = jsp.BlockPropPlan(ei, n)
        with pltpu.force_tpu_interpret_mode():
            fn = jplan.propagate_minhash if op == "min" \
                else jplan.propagate_hll
            _JAX_BLOCK_PROP[(kind, op)] = np.asarray(
                fn(jnp.asarray(_rows(op, n)[0])))
    return _JAX_BLOCK_PROP[(kind, op)]


@pytest.mark.parametrize("kind,op", [("mixed", "min"), ("mixed", "max"),
                                     ("empty", "max")])
def test_block_prop_bit_equal_to_pallas(jsp, kind, op):
    ei, n = _graph(kind)
    x_j, x_t = _rows(op, n)
    want = _jax_block_prop(jsp, kind, op)
    tplan = sp.BlockPropPlan(ei, n, device="cpu")
    fn = tplan.propagate_minhash if op == "min" else tplan.propagate_hll
    got = fn(x_t)
    np.testing.assert_array_equal(_to_numpy(op, got), want)
    assert torch.equal(got, _scatter_route(op, x_t, ei, n))


# Edges per block, in terms of the piece size P: blocks of exactly P, of
# P +- 1, one of 3P + 7, empty blocks, and a layout with no edges at all
PIECE_PROFILES = {
    "exact": lambda p: [p, p, p],
    "plus_minus_1": lambda p: [p - 1, p + 1, p, 1, p + 2],
    "spans_3_pieces": lambda p: [2, 3 * p + 7, 5],
    "empty_blocks": lambda p: [0, 7, 0, 0, p + 3, 0],
    "no_edges": lambda p: [0, 0],
}


@pytest.mark.parametrize("profile", list(PIECE_PROFILES))
@pytest.mark.parametrize("steps", [1, 4, 64])
def test_block_pieces_cut_each_block_in_order(profile, steps):
    counts = np.asarray(PIECE_PROFILES[profile](steps), dtype=np.int64)
    blk_ptr = np.concatenate([[0], np.cumsum(counts)])
    pieces = sp.block_pieces(blk_ptr, steps)
    ptr, blk, slot = (t.numpy() for t in (pieces.ptr, pieces.blk, pieces.slot))
    fold_ptr, fold_blk = pieces.fold_ptr.numpy(), pieces.fold_blk.numpy()
    assert ptr[0] == 0 and ptr[-1] == blk_ptr[-1]
    assert np.all(np.diff(ptr) >= 0) and np.all(np.diff(ptr) <= steps)
    next_slot = 0
    for b, c in enumerate(counts):
        mine = np.flatnonzero(blk == b)
        # consecutive pieces, ceil(c / steps) of them (one when empty),
        # covering the block's edges in order
        assert len(mine) == max(1, -(-c // steps))
        assert np.array_equal(mine, np.arange(mine[0], mine[0] + len(mine)))
        assert ptr[mine[0]] == blk_ptr[b] and ptr[mine[-1] + 1] == blk_ptr[b + 1]
        if len(mine) == 1:
            assert slot[mine[0]] == -1 and b not in fold_blk
        else:
            want = np.arange(next_slot, next_slot + len(mine))
            assert np.array_equal(slot[mine], want)
            m = int(np.flatnonzero(fold_blk == b)[0])
            assert (fold_ptr[m], fold_ptr[m + 1]) == (want[0], want[-1] + 1)
            next_slot += len(mine)
    assert pieces.num_slots == next_slot
    assert pieces.num_pieces == len(blk) and pieces.num_folds == len(fold_blk)


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("steps", [1, 7, 300])
def test_block_prop_by_pieces_bit_equal_to_pallas(jsp, op, steps):
    """The kernel's piece-by-piece way in plain torch (pieces of ``steps``
    edges, the hub's block folded from scratch tiles) against the JAX
    kernel in interpret mode; the last block is shorter than BLOCK_ROWS."""
    ei, n = _graph("mixed")
    assert n % sp.BLOCK_ROWS
    x_t = _rows(op, n)[1]
    want = _jax_block_prop(jsp, "mixed", op)
    tplan = sp.BlockPropPlan(ei, n, device="cpu")
    pieces = sp.block_pieces(tplan.blk_ptr.numpy(), steps)
    assert pieces.num_folds > 0
    got = sp.block_prop_pieces_plain(x_t, tplan.src, tplan.dstl, pieces,
                                     is_min=op == "min")
    np.testing.assert_array_equal(_to_numpy(op, got), want)


# ------------------------------------------------------------ all routes --

def test_every_route_equals_the_plan_route():
    """Two hops of MinHash and HLL on a small Watts-Strogatz graph by the
    plan (K1), scatter, K3 and K2 routes: every hop bit-equal."""
    n = 500
    ei = watts_strogatz_graph(n, 6, 0.2, seed=4)
    plan = SortedSegmentPlan(ei, n, device="cpu")
    csr = tuple(map(torch.from_numpy, gr.prepare_csr_edges(ei, n)))
    block = sp.BlockPropPlan(ei, n, device="cpu")
    src, dst = torch.from_numpy(ei[0]), torch.from_numpy(ei[1])
    routes = {
        "scatter": (lambda m: elph.propagate_minhash(m, src, dst, n),
                    lambda h: elph.propagate_hll(h, src, dst, n)),
        "K3": (lambda m: gr.propagate_min(m, *csr),
               lambda h: gr.propagate_max(h, *csr)),
        "K2": (block.propagate_minhash, block.propagate_hll),
    }
    mh, hl = _rows("min", n, seed=5)[1], _rows("max", n, seed=6)[1]
    state = {name: (mh, hl) for name in routes}
    for _ in range(2):
        mh, hl = plan.reduce(mh, "min"), plan.reduce(hl, "max")
        for name, (fm, fh) in routes.items():
            state[name] = (fm(state[name][0]), fh(state[name][1]))
            assert torch.equal(state[name][0], mh), name
            assert torch.equal(state[name][1], hl), name


# -------------------------------------------------------------------- K4 --

def test_dma_gather_bit_equal_to_pallas_last_block_only():
    """The JAX kernel overwrites its one output row at every block: the
    result is the last block's min.  Row 0 is all zeros and only the first
    block gathers it, so the global min differs."""
    jdg = _study("pallas_dma_gather_rate")
    rng = np.random.default_rng(7)
    N, S = 1000, 4096
    rows = rng.integers(1, 2 ** 31 - 1, (N, 128)).astype(np.int32)
    rows[0] = 0
    idx = rng.integers(1, N, S).astype(np.int32)
    idx[:10] = 0
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jdg.dma_gather(jnp.asarray(rows), jnp.asarray(idx),
                                         S // dg.BLOCK))
    got = dg.dma_gather(torch.from_numpy(rows), torch.from_numpy(idx),
                        S // dg.BLOCK)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want[0], rows[idx].min(0))
    mins = dg.block_mins(torch.from_numpy(rows), torch.from_numpy(idx), 2)
    np.testing.assert_array_equal(mins[0].numpy(), 0)
    np.testing.assert_array_equal(mins[1:].numpy(), want)


def test_dma_gather_cli_runs_on_the_cpu(capsys):
    dg.main(["--rows", "1000", "--indices", "4096", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "device=cpu" and "plain version (CPU)" in out[1]
    record = json.loads(out[-1])
    assert record["blocks"] == 2 and record["indices"] == 4096


# ------------------------------------------- what the CUDA wrappers refuse --

def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """The argument checks run before any launch; they are plain Python
    and are exercised here on CPU tensors."""
    n = 10
    src = torch.zeros(4, dtype=torch.int32)
    ptr = torch.zeros(n + 2, dtype=torch.int64)
    with pytest.raises(ValueError, match="no kernel"):
        gr._check_cuda_args(torch.zeros((n + 1, 8), dtype=torch.int16), src,
                            src, ptr, True)
    with pytest.raises(ValueError, match="multiple of 4"):
        gr._check_cuda_args(torch.zeros((n + 1, 6), dtype=torch.int8), src,
                            src, ptr, False)
    with pytest.raises(ValueError, match="32-bit words"):
        gr._check_cuda_args(torch.zeros((n + 1, 129), dtype=torch.int32),
                            src, src, ptr, True)
    with pytest.raises(ValueError, match="ptr"):
        gr._check_cuda_args(torch.zeros((n, 8), dtype=torch.int32), src, src,
                            ptr, True)
    with pytest.raises(ValueError, match="src must be int32"):
        gr._check_cuda_args(torch.zeros((n + 1, 8), dtype=torch.int32),
                            src.long(), src, ptr, True)
    with pytest.raises(ValueError, match="contiguous"):
        gr._check_cuda_args(torch.zeros((n + 1, 16), dtype=torch.int32)
                            [:, ::2], src, src, ptr, True)
    unaligned = torch.zeros(4 * (n + 1) * 8 + 1, dtype=torch.int8)[1:] \
        .view(n + 1, 32)
    with pytest.raises(ValueError, match="aligned"):
        gr._check_cuda_args(unaligned, src, src, ptr, False)

    blk_ptr = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="no kernel"):
        sp._check_cuda_args(torch.zeros((n, 8), dtype=torch.int32), src, src,
                            blk_ptr, False)
    with pytest.raises(ValueError, match="multiple of 4"):
        sp._check_cuda_args(torch.zeros((n, 10), dtype=torch.int8), src, src,
                            blk_ptr, False)
    with pytest.raises(ValueError, match="32-bit words"):
        sp._check_cuda_args(torch.zeros((n, 132), dtype=torch.int32), src,
                            src, blk_ptr, True)
    with pytest.raises(ValueError, match="blk_ptr"):
        sp._check_cuda_args(torch.zeros((n, 8), dtype=torch.int32), src, src,
                            torch.zeros(3, dtype=torch.int64), True)
    with pytest.raises(ValueError, match="dstl"):
        sp._check_cuda_args(torch.zeros((n, 8), dtype=torch.int32), src,
                            src[:2], blk_ptr, True)

    rows = torch.zeros((n, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="indices"):
        dg.block_mins(rows, torch.zeros(100, dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="indices"):
        dg.block_mins(rows, torch.zeros(4096, dtype=torch.int32), 0)
