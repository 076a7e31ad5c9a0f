"""The port's differentiable SpMM (ops/segment_scan.py ``PlanSpmm``, the
scatter ``spmm`` of ops/graph_ops.py, and ``gather_rows``) against the
JAX package's, on the CPU.

Both sides get the same seeded numpy graph, gcn_norm'd by each package,
and the same numpy features and output cotangent.  JAX runs its
``PlanSpmm`` as its own tests run it on the CPU (the plan reduce with the
XLA merge; the custom VJP through the transposed plan) under ``jax.grad``.

Tolerances: forward and x-gradient rtol 1e-5 / atol 1e-5 (float32 sums in
another order: K1's plain version and XLA's segment_sum; a 2k-in-edge hub
sums 2000 terms); gcn_norm weights rtol 1e-6; ``try_build`` returns None
at exactly the same ``max_slots``; gradcheck in float64 at its defaults.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subgraph_sketching_tpu.ops.graph_ops import gcn_norm as jgcn_norm
from subgraph_sketching_tpu.ops.graph_ops import spmm as jspmm
from subgraph_sketching_tpu.ops.segment_scan import PlanSpmm as JPlanSpmm
from subgraph_sketching_tpu_torch.graph.synthetic import watts_strogatz_graph
from subgraph_sketching_tpu_torch.ops.graph_ops import (
    edge_orders, gcn_norm, spmm,
)
from subgraph_sketching_tpu_torch.ops.segment_scan import (
    SUB_LEN, PlanSpmm, gather_rows, segment_order,
)


def _graph(kind: str):
    """(edge_index [2, E] int32, num_nodes) of one test graph."""
    rng = np.random.default_rng(0)
    if kind == "ws":
        return watts_strogatz_graph(300, 6, 0.2, seed=1).astype(np.int32), 300
    if kind == "isolated":
        # nodes 180-199 have no edge at all
        return rng.integers(0, 180, (2, 1500)).astype(np.int32), 200
    if kind == "hub":
        # node 3 has 2000 in-edges (250 sub-runs) and few out-edges
        ei = rng.integers(0, 400, (2, 3000))
        ei[1, :2000] = 3
        ei[0, :2000] = np.where(ei[0, :2000] == 3, 4, ei[0, :2000])
        return ei.astype(np.int32), 400
    assert kind == "empty"
    return np.zeros((2, 0), np.int32), 40


def _normed(ei: np.ndarray, n: int):
    """Both packages' gcn_norm of ``ei`` (self-loops added): (port edges,
    port weights, JAX edges, JAX weights)."""
    nei, nw = gcn_norm(torch.from_numpy(ei.astype(np.int64)), None, n)
    jei, jw, _ = jgcn_norm(jnp.asarray(ei), None, n)
    return nei, nw, np.asarray(jei), np.asarray(jw)


@pytest.mark.parametrize("kind", ["ws", "isolated", "hub", "empty"])
def test_plan_spmm_forward_and_gradient_match_jax(kind):
    ei, n = _graph(kind)
    nei, nw, jei, jw = _normed(ei, n)
    np.testing.assert_array_equal(nei.numpy(), jei)
    np.testing.assert_allclose(nw.numpy(), jw, rtol=1e-6)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(n, 24)).astype(np.float32)
    t = rng.normal(size=(n, 24)).astype(np.float32)

    jps = JPlanSpmm(jei, jw, n)
    want = np.asarray(jps(jnp.asarray(x)))
    want_grad = np.asarray(jax.grad(
        lambda v: (jps(v) * jnp.asarray(t)).sum())(jnp.asarray(x)))

    ps = PlanSpmm.try_build(nei.numpy(), nw.numpy(), n, device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    got = ps(xt)
    (got * torch.from_numpy(t)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), want_grad, rtol=1e-5,
                               atol=1e-5)


def test_plan_spmm_equals_the_scatter_route_and_keeps_no_gather():
    """Forward and x-gradient equal to autograd through the scatter spmm;
    the graph of the output holds only the Function's node (no [S*L, W]
    gather is saved for the backward)."""
    ei, n = _graph("hub")
    nei, nw, _, _ = _normed(ei, n)
    ps = PlanSpmm(nei.numpy(), nw.numpy(), n, device="cpu")
    x = torch.randn(n, 16, generator=torch.Generator().manual_seed(3),
                    requires_grad=True)
    got = ps(x)
    assert got.grad_fn.next_functions[0][0].variable is x
    assert not got.grad_fn.saved_tensors
    (g_plan,) = torch.autograd.grad(got.square().sum(), x)
    ref = spmm(nei, nw, x, n)
    (g_ref,) = torch.autograd.grad(ref.square().sum(), x)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(g_plan, g_ref, rtol=1e-5, atol=1e-5)


def test_try_build_refuses_at_the_same_max_slots_as_jax():
    """The hub's in-edges need many more slots one way than the other:
    each threshold between the two refuses in both packages alike."""
    ei, n = _graph("hub")
    nei, nw, jei, jw = _normed(ei, n)
    slots = [int(((np.bincount(a, minlength=n) + SUB_LEN - 1)
                  // SUB_LEN).sum()) * SUB_LEN for a in (jei[1], jei[0])]
    assert slots[0] != slots[1]
    for max_slots in sorted({*slots, *(s - 1 for s in slots), None} - {0},
                            key=lambda m: m or 0):
        got = PlanSpmm.try_build(nei.numpy(), nw.numpy(), n,
                                 max_slots=max_slots, device="cpu")
        want = JPlanSpmm.try_build(jei, jw, n, max_slots=max_slots)
        assert (got is None) == (want is None), max_slots
        assert (got is None) == (max_slots is not None
                                 and max_slots < max(slots))


def test_tables_are_both_directions_on_the_device():
    ei, n = _graph("ws")
    nei, nw, _, _ = _normed(ei, n)
    ps = PlanSpmm(nei.numpy(), nw.numpy(), n, device="cpu")
    gf, pf, wf, gb, pb, wb = ps.tables
    assert gf.shape == wf.shape == (ps.fwd.num_subruns * SUB_LEN,)
    assert gb.shape == wb.shape == (ps.bwd.num_subruns * SUB_LEN,)
    assert pf.shape == pb.shape == (n + 1,)
    assert all(t.device.type == "cpu" for t in ps.tables)


@pytest.mark.parametrize("kind", ["ws", "hub", "empty"])
def test_spmm_matches_jax(kind):
    """The scatter spmm (sorted by target, summed by K1's add each way):
    forward and x-gradient against JAX's spmm under ``jax.grad``; the
    unnormalised empty graph has no edge to sum."""
    ei, n = _graph(kind)
    if kind == "empty":
        nei, jei = torch.from_numpy(ei.astype(np.int64)), ei
        nw = torch.zeros(0)
        jw = np.zeros(0, np.float32)
    else:
        nei, nw, jei, jw = _normed(ei, n)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    t = rng.normal(size=(n, 8)).astype(np.float32)

    def jf(v):
        return jspmm(jnp.asarray(jei), jnp.asarray(jw), v, n)

    want = np.asarray(jf(jnp.asarray(x)))
    want_grad = np.asarray(jax.grad(
        lambda v: (jf(v) * jnp.asarray(t)).sum())(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    got = spmm(nei, nw, xt, n)
    (got * torch.from_numpy(t)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), want_grad, rtol=1e-5,
                               atol=1e-5)
    # the sorts made once (edge_orders) give the same sums bit for bit
    xo = torch.from_numpy(x).requires_grad_()
    got_o = spmm(nei, nw, xo, n, edge_orders(nei, n))
    (got_o * torch.from_numpy(t)).sum().backward()
    assert torch.equal(got_o, got) and torch.equal(xo.grad, xt.grad)


def test_spmm_gradcheck_float64():
    rng = np.random.default_rng(7)
    n = 12
    ei = torch.from_numpy(rng.integers(0, n, (2, 40)))
    w = torch.from_numpy(rng.random(40))
    x = torch.randn(n, 3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda v: spmm(ei, w, v, n), (x,))


def test_plan_spmm_gradcheck_float64():
    rng = np.random.default_rng(5)
    n = 12
    ei = rng.integers(0, n, (2, 40))
    w = rng.random(40)
    ps = PlanSpmm(ei, w, n, device="cpu")
    x = torch.randn(n, 3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(ps, (x,))


def test_gather_rows_matches_indexing():
    """Forward equal to ``table[idx]``; the backward (a stable sort and
    K1's add) equal to indexing's backward, and gradcheck in float64."""
    g = torch.Generator().manual_seed(6)
    table = torch.randn(50, 7, generator=g, requires_grad=True)
    idx = torch.randint(0, 50, (64, 2), generator=g)
    idx[:9] = 11                                  # a row gathered 18 times
    got = gather_rows(table, idx)
    torch.testing.assert_close(got, table[idx], rtol=0, atol=0)
    cot = torch.randn(got.shape, generator=g)
    (g_got,) = torch.autograd.grad((got * cot).sum(), table)
    (g_ref,) = torch.autograd.grad((table[idx] * cot).sum(), table)
    torch.testing.assert_close(g_got, g_ref, rtol=1e-6, atol=1e-6)
    t64 = table.detach().double().requires_grad_()
    assert torch.autograd.gradcheck(lambda t: gather_rows(t, idx), (t64,))


@pytest.mark.parametrize("bad", [-1, 50])
def test_segment_order_refuses_ids_out_of_range(bad):
    """The pointer is a search of the sorted ids, which would drop an id
    outside [0, n) silently: the device-side assert refuses it."""
    seg = torch.tensor([3, 0, bad, 7])
    with pytest.raises(RuntimeError):
        segment_order(seg, 50)
    perm, ptr = segment_order(torch.tensor([3, 0, 3, 49]), 50)
    assert perm.tolist() == [1, 0, 2, 3]
    assert ptr[[0, 1, 3, 4, 49, 50]].tolist() == [0, 1, 1, 3, 3, 4]


def test_gcn_norm_degrees_are_ordered_k1_sums(monkeypatch):
    """``degrees_from_edges`` (gcn_norm's degrees) sums each node's
    weights in edge order through K1's add (here its plain version), so
    that every process gets the same bits: with non-integer weights it
    equals ``index_add_`` within chip_smoke.py's ADD_TOLERANCE
    (|err| <= 1e-4 * sum|w| + 1e-6) and itself across two calls."""
    from subgraph_sketching_tpu_torch.ops import segscan
    from subgraph_sketching_tpu_torch.ops.graph_ops import degrees_from_edges
    rng = np.random.default_rng(3)
    n, e = 500, 6000
    ei = torch.from_numpy(rng.integers(0, n, (2, e)))
    w = torch.from_numpy((rng.random(e) * 3 - 0.5).astype(np.float32))
    ops = []
    plain = segscan.segment_combine_plain

    def counted(v, x, op, ptr):
        ops.append(op)
        return plain(v, x, op, ptr)

    monkeypatch.setattr(segscan, "segment_combine_plain", counted)
    got = degrees_from_edges(ei, w, n)
    assert ops == ["add"]
    want = torch.zeros(n).index_add_(0, ei[1], w)
    scale = torch.zeros(n).index_add_(0, ei[1], w.abs())
    assert bool(((got - want).abs() <= 1e-4 * scale + 1e-6).all())
    assert torch.equal(got, degrees_from_edges(ei, w, n))
    assert torch.equal(degrees_from_edges(ei, None, n),
                       torch.bincount(ei[1], minlength=n).float())
