"""The port's bfloat16 compute dtype (``--dtype bfloat16``: models/gnn.py
``Dense``, ``BatchNorm``, ``Dropout``; every model's ``dtype``; K1's
bfloat16 add in ops/segscan.py; the SpMM routes) and the classes and
flags ported with it (``SAGEConv``, ``GCN``, ``SAGE``,
``MLPLinkPredictor``, ``utils.get_num_samples`` /
``get_src_dst_degree``, ``--profile_dir``, ``--compilation_cache_dir``)
against the JAX package's, on the CPU.

Both packages get the same seeded numpy inputs and the same weights
(flax initialises them, ``models/convert.py`` carries them over).  JAX
runs its bfloat16 models as its own tests/test_dtype.py runs them: on the
CPU, where its SpMM merge takes XLA (the Pallas merge takes float32 add
only).  Rounding sits in other places in the two packages (XLA rounds a
bfloat16 segment sum at every add and a Dense's bias add apart from its
product; K1 sums in float32 and rounds a row once), so the algorithm is
held in float32 elsewhere (tests/test_torch_elph.py, test_torch_seal.py,
...) and the dtype plumbing here, with these tolerances:

  * K1's plain bfloat16 add against a float64 sum: at most half a
    bfloat16 ulp of the sum (2^-8 of it) plus 2·n·2^-24·Σ|v| (float32
    accumulation over a row's n terms);
  * ``PlanSpmm`` and ``spmm`` at bfloat16, forward and x-gradient, against
    JAX's at bfloat16: rtol = atol = 2^-5 (bfloat16 products and sums of
    at most 8 terms, each rounding at most 2^-8);
  * each model's bfloat16 output against JAX's at bfloat16, and against
    the port's own float32 output: rtol = atol = 0.05, ELPH's node
    features 0.1 (JAX's own tests/test_dtype.py); DGCNN's sort keys
    atol 2^-7 (see ``test_models_bf16_match_jax``);
  * one step's gradients against ``jax.grad``: each tensor within 0.1 of
    JAX's by norm (||g - g_jax|| <= 0.1 ||g_jax||);
  * the classes of models/gnn.py in float32: rtol 1e-5, atol 1e-5
    (float32 sums in another order), the helpers exactly.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subgraph_sketching_tpu import utils as jutils
from subgraph_sketching_tpu.models import buddy as jbuddy
from subgraph_sketching_tpu.models import elph as jelph
from subgraph_sketching_tpu.models import gnn as jgnn
from subgraph_sketching_tpu.models import predictor as jpredictor
from subgraph_sketching_tpu.models import seal as jseal
from subgraph_sketching_tpu.ops.graph_ops import gcn_norm as jgcn_norm
from subgraph_sketching_tpu.ops.graph_ops import spmm as jspmm
from subgraph_sketching_tpu.ops.segment_scan import PlanSpmm as JPlanSpmm
from subgraph_sketching_tpu.sketch.params import SketchParams as JParams
from subgraph_sketching_tpu_torch import utils
from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.graph.container import Graph
from subgraph_sketching_tpu_torch.graph.seal import SEALDataset
from subgraph_sketching_tpu_torch.graph.synthetic import (
    barabasi_albert_graph, watts_strogatz_graph,
)
from subgraph_sketching_tpu_torch.models import convert, gnn
from subgraph_sketching_tpu_torch.models import seal as pseal
from subgraph_sketching_tpu_torch.models.buddy import BUDDY
from subgraph_sketching_tpu_torch.models.elph import ELPH
from subgraph_sketching_tpu_torch.models.predictor import LinkPredictor
from subgraph_sketching_tpu_torch.ops import cuda_build, segscan
from subgraph_sketching_tpu_torch.ops import segment_scan as ss
from subgraph_sketching_tpu_torch.ops.graph_ops import gcn_norm, spmm
from subgraph_sketching_tpu_torch.runners import run
from subgraph_sketching_tpu_torch.serving import scorer_from_checkpoint
from subgraph_sketching_tpu_torch.sketch.params import SketchParams
from subgraph_sketching_tpu_torch.train.loops import make_optimizer

BF = torch.bfloat16
TOL = dict(rtol=0.05, atol=0.05)        # JAX's tests/test_dtype.py
TOL_ELPH = dict(rtol=0.1, atol=0.1)     # ... for ELPH's node features
SPMM_TOL = dict(rtol=2 ** -5, atol=2 ** -5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's small tensors: the tier-1 run
    shares the machine's cores between its workers, where torch's own
    pool of one thread a core oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


# ------------------------------------------------------ K1's plain add --

@pytest.mark.parametrize("width", [1, 3, 8, 24])
def test_plain_bf16_add_against_float64(width):
    """The plain version (what the kernel computes: upcast, sum in
    float32, round once) within its bound of the float64 sum, a 600-term
    hub row included; bfloat16 in, bfloat16 out; dyadic rows exact."""
    plain_half_add_against_float64(width, BF, 2.0 ** -8)


def plain_half_add_against_float64(width, dtype, half_ulp):
    """K1's plain 16-bit add within half an ulp (``half_ulp`` of the sum)
    plus 2·n·2^-24·Σ|v| of the float64 sum; dyadic rows exact."""
    g = torch.Generator().manual_seed(width)
    cnt = torch.randint(0, 6, (50,), generator=g)
    cnt[7] = 600
    ptr = torch.cat([torch.zeros(1, dtype=torch.int64), cnt.cumsum(0)])
    s = int(ptr[-1])
    v = torch.randn(s, width, generator=g).to(dtype)
    out = segscan.segment_combine(v, torch.empty(50, width, dtype=dtype),
                                  "add", ptr)
    assert out.dtype == dtype
    ids = segscan.segment_ids(ptr)
    ref = torch.zeros(50, width, dtype=torch.float64).index_add_(
        0, ids, v.double())
    absum = torch.zeros(50, width, dtype=torch.float64).index_add_(
        0, ids, v.double().abs())
    bound = half_ulp * ref.abs() + 2 * cnt.double()[:, None] * 2.0 ** -24 \
        * absum
    assert bool(((out.double() - ref).abs() <= bound).all())
    dyadic = (torch.randint(-64, 64, (s, width), generator=g) / 8).to(dtype)
    got = segscan.segment_combine(dyadic,
                                  torch.empty(50, width, dtype=dtype), "add",
                                  ptr)
    exact = torch.zeros(50, width, dtype=torch.float64).index_add_(
        0, ids, dyadic.double())
    assert torch.equal(got, exact.to(dtype))


# ------------------------------------------------------------- the SpMM --

@pytest.mark.parametrize("route", ["plan", "scatter"])
def test_spmm_bf16_matches_jax(route):
    """The gcn_norm'd SpMM at bfloat16 by either route, forward and
    x-gradient, against JAX's at bfloat16; both stay bfloat16."""
    spmm_half_matches_jax(route, BF, SPMM_TOL)


def spmm_half_matches_jax(route, dtype, tol):
    """The gcn_norm'd SpMM at a 16-bit ``dtype`` by ``route``, forward
    and x-gradient, against JAX's at that dtype, within ``tol``."""
    n = 200
    ei = watts_strogatz_graph(n, 6, 0.2, seed=1).astype(np.int32)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    t = rng.normal(size=(n, 16)).astype(np.float32)
    nei, nw = gcn_norm(torch.from_numpy(ei.astype(np.int64)), None, n)
    jei, jw, _ = jgcn_norm(jnp.asarray(ei), None, n)
    if route == "plan":
        jop = JPlanSpmm(np.asarray(jei), np.asarray(jw), n)
        op = ss.PlanSpmm(nei.numpy(), nw.numpy(), n, device="cpu")
    else:
        jop = lambda v: jspmm(jei, jw, v, n)   # noqa: E731
        op = lambda v: spmm(nei, nw, v, n)     # noqa: E731
    jdt = _jax_dtype(dtype)
    jx, jt = jnp.asarray(x, jdt), jnp.asarray(t, jdt)
    want, want_grad = jax.jit(lambda v: _value_and_vjp(jop, v, jt))(jx)
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    got = op(xt)
    (got * torch.from_numpy(t).to(dtype)).float().sum().backward()
    assert got.dtype == xt.grad.dtype == dtype
    assert want.dtype == want_grad.dtype == jdt
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    np.testing.assert_allclose(_f32(xt.grad), _f32(want_grad), **tol)


def _value_and_vjp(fn, x, cotangent):
    out, vjp = jax.vjp(fn, x)
    return out, vjp(cotangent.astype(out.dtype))[0]


def test_gather_rows_backward_sums_bf16_rows_once():
    """A bfloat16 table's row-gather gradient: K1's bfloat16 add, summed
    in float32 and rounded once per row (the hot row of 300 picks too)."""
    gather_rows_backward_sums_once(BF)


def gather_rows_backward_sums_once(dtype):
    idx = torch.cat([torch.zeros(300, dtype=torch.int64),
                     torch.arange(40)])
    table = torch.zeros(40, 8, dtype=dtype, requires_grad=True)
    g = torch.randn(len(idx), 8, generator=torch.Generator().manual_seed(4))
    ss.gather_rows(table, idx).backward(g.to(dtype))
    want = torch.zeros(40, 8, dtype=torch.float32).index_add_(
        0, idx, g.to(dtype).float())
    assert table.grad.dtype == dtype
    assert torch.equal(table.grad, want.to(dtype))


# ------------------------------------------------------------- the models --

@pytest.fixture(scope="module")
def seal_batch():
    """Both packages' inputs for one batch of 24 links' 2-hop DRNL
    subgraphs (max 16 nodes) of a 60-node BA graph with features."""
    rng = np.random.default_rng(0)
    ei = barabasi_albert_graph(60, 3, seed=1)
    x = rng.standard_normal((60, 5)).astype(np.float32)
    pos = ei[:, rng.choice(ei.shape[1], 12, replace=False)].T.astype(np.int64)
    neg = rng.integers(0, 60, (12, 2)).astype(np.int64)
    ds = SEALDataset(Graph(ei, 60, x=x), pos, neg, num_hops=2, max_nodes=16,
                     max_edges=40)
    raw = ds.extract_batch(np.arange(len(ds)))
    w = raw.edge_mask.astype(np.float32)
    jb = {"z": jnp.asarray(raw.z), "node_mask": jnp.asarray(raw.node_mask),
          "edge_index": jnp.asarray(raw.edge_index),
          "edge_weight": jnp.asarray(w), "edge_mask": jnp.asarray(raw.edge_mask),
          "x": jnp.asarray(raw.x)}
    pb = {"z": torch.from_numpy(raw.z.astype(np.int64)),
          "node_mask": torch.from_numpy(raw.node_mask),
          "graph": pseal.UnionGraph.from_padded(
              raw.edge_index, w, raw.edge_mask, raw.z.shape[1], "cpu"),
          "x": torch.from_numpy(raw.x)}
    return jb, pb


def _link_inputs(rng, b=48, sf_dim=8, d=12, k=0):
    sf = rng.normal(size=(b, sf_dim)).astype(np.float32)
    nf = rng.normal(size=(b, 2, d * (k + 1))).astype(np.float32)
    deg = rng.integers(1, 9, b).astype(np.float32)
    ra = rng.random(b).astype(np.float32)
    emb = rng.normal(size=(b, 2, 16)).astype(np.float32)
    return sf, nf, deg, ra, emb


def _generic(params, stats, model):
    return {**convert._parameters_from_flax(params),
            **convert._batch_stats_from_flax(stats)}


def _seal_convert(params, stats, model):
    return convert.seal_state_dict_from_flax(params, stats)


def _case(name, seal_batch):
    """(JAX module factory of dtype, JAX positional args, port module
    factory of dtype, port positional args, converter, tolerance)."""
    rng = np.random.default_rng(len(name))
    t = torch.from_numpy
    if name in ("buddy", "buddy_sign"):
        k = 2 if name == "buddy_sign" else 0
        sf, nf, deg, ra, _ = _link_inputs(rng, k=k)
        return (lambda dt: jbuddy.BUDDY(8, 16, sign_k=k, use_RA=True,
                                        append_normalised=True, dtype=dt),
                (sf, nf, deg, deg[::-1].copy(), ra),
                lambda dt: BUDDY(8, 16, num_features=12, sign_k=k,
                                 use_RA=True, append_normalised=True,
                                 dtype=dt),
                (t(sf), t(nf), t(deg), t(deg[::-1].copy()), t(ra)),
                lambda p, s, m: convert.buddy_state_dict_from_flax(p, s, m),
                TOL)
    if name == "link_predictor":
        sf, _, _, _, emb = _link_inputs(rng)
        nf = rng.normal(size=(48, 2, 16)).astype(np.float32)
        return (lambda dt: jpredictor.LinkPredictor(8, 16, use_embedding=True,
                                                    dtype=dt),
                (sf, nf, emb),
                lambda dt: LinkPredictor(8, 16, use_embedding=True, dtype=dt),
                (t(sf), t(nf), t(emb)), _generic, TOL)
    if name == "sign":
        _, nf, _, _, _ = _link_inputs(rng, k=2)
        return (lambda dt: jgnn.SIGN(16, 8, 2, 0.5, dtype=dt), (nf,),
                lambda dt: gnn.SIGN(12, 16, 8, 2, 0.5, dtype=dt), (t(nf),),
                _generic, TOL)
    n = 120
    ei = watts_strogatz_graph(n, 6, 0.2, seed=3).astype(np.int64)
    x = rng.normal(size=(n, 12)).astype(np.float32)
    if name == "sign_embedding":
        return (lambda dt: jgnn.SIGNEmbedding(16, 16, 2, 0.5, dtype=dt),
                (x, ei.astype(np.int32), n),
                lambda dt: gnn.SIGNEmbedding(12, 16, 16, 2, 0.5, dtype=dt),
                (t(x), t(ei), n), _generic, TOL)
    if name.startswith("elph"):
        prop = name.split("_")[1]
        plan = None
        if prop == "gcn":   # the plan route (the residual case: scatter)
            nei, nw = gcn_norm(t(ei), None, n)
            plan = ss.PlanSpmm(nei.numpy(), nw.numpy(), n, device="cpu")
        return (lambda dt: jelph.ELPH(JParams(max_hops=2), 16,
                                      feature_prop=prop, dtype=dt),
                (x, ei.astype(np.int32), n),
                lambda dt: _ElphFeatures(ELPH(SketchParams(max_hops=2), 12, 16,
                                              feature_prop=prop, dtype=dt),
                                         plan),
                (t(x), t(ei), n), lambda p, s, m: {
                    "gnn." + k: v for k, v in _generic(p, s, m).items()},
                TOL_ELPH)
    jb, pb = seal_batch
    model = {"seal_dgcnn": "SEALDGCNN", "seal_gcn": "SEALGCN",
             "seal_sage": "SEALSAGE", "seal_gin": "SEALGIN"}.get(name)
    if model is None:
        assert name == "seal_mlp"
        return (lambda dt: jseal.SEALMLP(emb_dim=12, pooling="mean", dtype=dt),
                (jb,), lambda dt: pseal.SEALMLP(12, pooling="mean", dtype=dt),
                (pb,), _seal_convert, TOL)
    kw = {"k": 10} if model == "SEALDGCNN" else {}
    return (lambda dt: getattr(jseal, model)(
                hidden_channels=8, num_layers=2, max_z=20, use_feature=True,
                dtype=dt, **kw), (jb,),
            lambda dt: getattr(pseal, model)(
                hidden_channels=8, num_layers=2, max_z=20, use_feature=True,
                num_features=5, dtype=dt, **kw), (pb,), _seal_convert, TOL)


class _ElphFeatures(torch.nn.Module):
    """ELPH's node features (its forward's first output), over ``plan``
    when one is given; the child is ``gnn``, as in ``ELPHPredictor``."""

    def __init__(self, elph, plan):
        super().__init__()
        self.gnn, self.plan = elph, plan

    def forward(self, x, ei, n):
        return self.gnn(x, ei, n, plan=self.plan)[0]


def _flax_pair(name, seal_batch, dtype=BF):
    """Both packages' module pair at ``dtype`` (bfloat16 unless given) and
    the port's at float32, from one set of flax weights, with each
    package's inputs."""
    jmake, jargs, pmake, pargs, conv, tol = _case(name, seal_batch)
    jargs = tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                  for a in jargs)
    key = jax.random.PRNGKey(0)
    static = tuple(i for i, a in enumerate(jargs) if isinstance(a, int))
    variables = jax.jit(lambda *a: jmake(None).init(
        {"params": key, "dropout": key}, *a, training=False),
        static_argnums=static)(*jargs)
    params = _np(variables["params"])
    stats = _np(variables.get("batch_stats", {}))
    models = {}
    for dt in (None, dtype):
        m = pmake(dt)
        m.load_state_dict(conv(params, stats, m))
        models[dt] = m.eval()
    return jmake, jargs, static, variables, models, pargs, tol


MODELS = ["buddy", "link_predictor", "sign", "sign_embedding",
          "elph_gcn", "elph_residual", "seal_dgcnn", "seal_gcn", "seal_sage",
          "seal_gin", "seal_mlp"]


@pytest.mark.parametrize("name", MODELS)
def test_models_bf16_match_jax(name, seal_batch):
    """Each model's eval forward at bfloat16 from the same weights:
    against JAX's at bfloat16, and against the port's own float32 output.
    The logits (and ELPH's node features, from its float32-biased GCN)
    are float32, as in JAX; SIGN's and SIGNEmbedding's outputs bfloat16.

    DGCNN sorts its nodes on a bfloat16 key, and one ulp between the
    packages can swap two nodes whose keys are that close, which moves
    whole rows of the pooled input: a legitimate difference, not a
    defect.  So its keys are held within 2^-7 (two ulps at 1; the
    measured distance is one), and its logits on the links whose k picks
    come in the same order in both packages; every link left out must
    have two keys within twice that tolerance (a near-tie that the
    rounding can swap), and at least half the batch must be held."""
    models_half_match_jax(name, seal_batch, BF, None, 2 ** -7)


def models_half_match_jax(name, seal_batch, dtype, tol, key_tol):
    """One model's eval forward at a 16-bit ``dtype`` against JAX's and
    against the port's float32 output, within ``tol`` (None: the case's
    own); DGCNN's sort keys within ``key_tol``."""
    jmake, jargs, static, variables, models, pargs, case_tol = _flax_pair(
        name, seal_batch, dtype)
    tol = tol or case_tol
    want, inter = jax.jit(lambda v, *a: jmake(_jax_dtype(dtype)).apply(
        v, *a, training=False, capture_intermediates=True,
        mutable=["intermediates"]), static_argnums=tuple(
            i + 1 for i in static))(variables, *jargs)
    want = want[0] if isinstance(want, tuple) else want
    with torch.no_grad():
        got = models[dtype](*pargs)
        f32 = models[None](*pargs)
    assert got.dtype == _torch_dtype(want.dtype)
    assert f32.dtype == torch.float32
    assert np.isfinite(_f32(got)).all()
    sel = slice(None)
    if name == "seal_dgcnn":
        sel = _separated_links(inter["intermediates"], jargs, models[dtype],
                               pargs, key_tol)
    np.testing.assert_allclose(_f32(got)[sel], _f32(want)[sel], **tol)
    np.testing.assert_allclose(_f32(got)[sel], _f32(f32)[sel], **tol)


def _jax_dtype(dtype):
    return {BF: jnp.bfloat16, torch.float16: jnp.float16}[dtype]


def _torch_dtype(jdt):
    return {jnp.dtype(jnp.bfloat16): BF,
            jnp.dtype(jnp.float16): torch.float16,
            jnp.dtype(jnp.float32): torch.float32}[jnp.dtype(jdt)]


def _separated_links(inter, jargs, pmodel, pargs, tol=2 ** -7):
    """The links of the DGCNN batch whose sort picks agree between the
    packages, after holding the sort keys (the last channel of the
    concatenated tanh stack; JAX's from its captured intermediates)
    within ``tol`` (2^-7 at bfloat16); a link left out must hold a
    near-tie."""
    (jb,) = jargs
    (pb,) = pargs
    last = inter["conv_dense_2"]["__call__"][0]
    jkey = _f32(jnp.tanh(jseal.batched_gcn_prop(
        last, jb["edge_index"], jb["edge_weight"], jb["edge_mask"],
        jb["node_mask"]))[..., 0])
    with torch.no_grad():
        x = pmodel.embed_inputs(pb)
        for li in range(pmodel.num_convs):
            x = torch.tanh(pseal.gcn_prop(
                getattr(pmodel, f"conv_dense_{li}")(x), pb["graph"],
                pb["node_mask"]))
    pkey = _f32(x[..., 0])
    mask = np.asarray(jb["node_mask"])
    np.testing.assert_allclose(pkey[mask], jkey[mask], rtol=0, atol=tol)
    keep = []
    for b in range(len(mask)):
        jk, pk = jkey[b][mask[b]], pkey[b][mask[b]]
        picks = np.argsort(-jk, kind="stable")[:pmodel.k]
        if np.array_equal(picks, np.argsort(-pk, kind="stable")[:pmodel.k]):
            keep.append(b)
        else:
            assert np.abs(np.diff(np.sort(jk))).min() <= 2 * tol, b
    assert len(keep) >= len(mask) // 2, keep
    return np.asarray(keep)


# ----------------------------------------------------- gradients, step --

PRE_BN = ("label_lin_layer.bias", "lin_out.bias", "sign.lin_0.bias",
          "sign.lin_1.bias", "sign.lin_2.bias")


@pytest.mark.parametrize("name", ["buddy_sign", "elph_gcn", "seal_gcn"])
def test_one_step_gradients_match_jax_grad(name, seal_batch):
    """The gradients of one training-mode step (dropout 0; BatchNorm on
    the batch's statistics) at bfloat16 against ``jax.grad`` at
    bfloat16: ELPH through the plan route's bfloat16 backward, SEAL
    through the label table's, whose row 0 takes most of the batch's
    nodes (the hot row: K1 sums it in float32 and rounds once, XLA
    rounds at every add).  The biases that feed a BatchNorm have a true
    gradient of zero (each package steps them by its own rounding
    noise) and are left out."""
    dist = one_step_gradients_match_jax_grad(name, seal_batch, BF, 0.1)
    if name == "seal_gcn":
        assert dist["z_embedding.weight"] < 0.1


def one_step_gradients_match_jax_grad(name, seal_batch, dtype, tol):
    """Each gradient of one training-mode step at a 16-bit ``dtype``
    within ``tol`` of ``jax.grad``'s by norm, the pre-BN biases left
    out; returns the distances.  DGCNN is held on the links whose sort
    picks agree between the packages (``_separated_links`` at ``dtype``'s
    machine epsilon), its step in eval mode: JAX's DGCNN drops half its pooled
    features in training mode whatever its dropout field says
    (models/seal.py, SEALDGCNN), and it has no BatchNorm, so its step
    without dropout is its eval forward."""
    jmake, jargs, static, variables, models, pargs, _ = _flax_pair(
        name, seal_batch, dtype)
    jdt = _jax_dtype(dtype)
    rng = np.random.default_rng(5)
    model = models[dtype].train()
    for m in model.modules():
        if isinstance(m, gnn.Dropout):
            m.p = 0.0
    out = model(*pargs)
    assert out.dtype == torch.float32
    t = rng.normal(size=tuple(out.shape)).astype(np.float32)
    if name == "seal_dgcnn":
        _, inter = jax.jit(lambda v, *a: jmake(jdt).apply(
            v, *a, training=False, capture_intermediates=True,
            mutable=["intermediates"]))(variables, *jargs)
        with torch.no_grad():
            sel = _separated_links(inter["intermediates"], jargs,
                                   model.eval(), pargs,
                                   float(jnp.finfo(jdt).eps))
        model.train()
        keep = np.zeros(len(t), bool)
        keep[sel] = True
        t[~keep] = 0.0
    (out * torch.from_numpy(t)).sum().backward()
    training = name != "seal_dgcnn"

    def loss(params):
        o, _ = jmake(jdt).clone(**_no_dropout(name)).apply(
            {**variables, "params": params}, *jargs, training=training,
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(1)})
        o = o[0] if isinstance(o, tuple) else o
        return (o.astype(jnp.float32) * t).sum()

    grads = jax.jit(jax.grad(loss))(variables["params"])
    want = _case(name, seal_batch)[4](_np(grads), {}, model)
    dist = {}
    for k, p in model.named_parameters():
        if k in PRE_BN or k not in want:
            continue
        w = want[k].double()
        assert p.grad.dtype == torch.float32
        d = float((p.grad.double() - w).norm())
        dist[k] = d / max(float(w.norm()), 1e-30)
        assert d <= tol * float(w.norm()), (k, dist[k])
    assert len(dist) >= 3
    return dist


def _no_dropout(name):
    if name.startswith("seal"):
        return {"dropout": 0.0}
    if name.startswith("elph"):
        return {"feature_dropout": 0.0}
    return {"label_dropout": 0.0, "feature_dropout": 0.0,
            "sign_dropout": 0.0}


@pytest.mark.parametrize("name", ["buddy_sign", "elph_gcn", "seal_gin"])
def test_float32_state_after_a_bf16_step(name, seal_batch):
    """After an Adam step at bfloat16 the parameters, the BatchNorm
    statistics and Adam's moments are float32 and the logits were; the
    state_dict has the float32 model's keys and dtypes, and each model
    loads the other's."""
    float32_state_after_a_step(name, seal_batch, BF)


def float32_state_after_a_step(name, seal_batch, dtype):
    _, _, make, pargs, _, _ = _case(name, seal_batch)
    models = {dt: make(dt) for dt in (None, dtype)}
    model = models[dtype].train()
    opt = make_optimizer(Config(), model.parameters())
    out = model(*pargs)
    assert out.dtype == torch.float32
    out.square().mean().backward()
    opt.step()
    sd32, sd16 = models[None].state_dict(), model.state_dict()
    assert {k: v.dtype for k, v in sd16.items()} == \
        {k: v.dtype for k, v in sd32.items()}
    assert all(v.dtype in (torch.float32, torch.int64) for v in sd16.values())
    assert all(bool(torch.isfinite(v.float()).all()) for v in sd16.values())
    assert all(t.dtype == torch.float32 for st in opt.state.values()
               for k, t in st.items() if k != "step")
    models[None].load_state_dict(sd16)
    model.load_state_dict(sd32)


# ------------------------------------------------------------ the runner --

SMALL = ["--dataset_name", "synth-ba", "--hidden_channels", "8",
         "--batch_size", "256", "--train_samples", "1024",
         "--val_samples", "512", "--test_samples", "512", "--device", "cpu"]


def _main(extra):
    return run.main(SMALL + extra)


def test_runner_bf16_buddy_trains_profiles_and_serves(tmp_path):
    """BUDDY at bfloat16 over two reps of two epochs: one trace, of epoch
    1 of rep 0; the checkpoint serves in bfloat16 (its config says so),
    within 0.05 of the same weights served in float32."""
    ck, prof = str(tmp_path / "ck"), str(tmp_path / "prof")
    res = _main(["--model", "BUDDY", "--dtype", "bfloat16", "--epochs", "2",
                 "--reps", "2", "--profile_dir", prof, "--save_model",
                 "--checkpoint_dir", ck])
    assert np.all(np.isfinite(res))
    assert os.listdir(prof) == ["epoch1_rank0.pt.trace.json"]
    scorer = scorer_from_checkpoint(ck, device="cpu")
    assert scorer.model.lin.dtype == BF
    links = np.array([[0, 1], [3, 40], [7, 7], [99, 2]])
    got = scorer.score(links)
    f32 = scorer_from_checkpoint(ck, cfg=_f32_config(ck), device="cpu")
    np.testing.assert_allclose(got, f32.score(links), atol=0.05)


def _f32_config(ck):
    import dataclasses
    with open(os.path.join(ck, "config.json")) as f:
        cfg = Config.from_json(f.read())
    return dataclasses.replace(cfg, dtype="float32")


def test_runner_bf16_elph_serves_and_one_epoch_traces_nothing(tmp_path):
    """ELPH at bfloat16 with determinism checked; one epoch, so
    ``--profile_dir`` traces nothing (as in JAX); the checkpoint
    serves."""
    ck, prof = str(tmp_path / "ck"), str(tmp_path / "prof")
    _main(["--model", "ELPH", "--dtype", "bfloat16", "--epochs", "1",
           "--check_determinism", "--profile_dir", prof, "--save_model",
           "--checkpoint_dir", ck])
    assert not os.path.exists(prof)
    scorer = scorer_from_checkpoint(ck, device="cpu")
    assert np.all(np.isfinite(scorer.score(np.array([[0, 1], [5, 9]]))))


def test_runner_bf16_seal_builds_into_the_cache_dir(tmp_path):
    """SEALGCN at bfloat16 with ``--compilation_cache_dir``: the SEAL
    extractor the run uses, and then the C++ plan builder, are built
    into that directory and loaded from it."""
    cache = tmp_path / "cache"
    before = cuda_build.BUILD_DIR
    try:
        res = _main(["--model", "SEALGCN", "--dtype", "bfloat16",
                     "--epochs", "1", "--compilation_cache_dir", str(cache),
                     "--num_seal_layers", "2", "--dynamic_train", "1",
                     "--train_samples", "200", "--val_samples", "100",
                     "--test_samples", "100"])
        assert np.all(np.isfinite(res))
        ss.plan_tables_native(np.array([0, 1], np.int32),
                              np.array([1, 2], np.int32), 3, 8)
        built = sorted(os.path.basename(p).split("_")[0]
                       for p in glob.glob(str(cache / "*.so")))
        assert built == ["plan", "seal"]
    finally:
        cuda_build.set_build_dir(before)


def test_kge_bf16_trains_in_float32():
    """A KGE run with --dtype bfloat16 is the float32 run, bit for bit
    (the JAX package's kge_loop never reads the dtype)."""
    a = _main(["--model", "distmult", "--epochs", "1", "--dtype", "bfloat16"])
    b = _main(["--model", "distmult", "--epochs", "1"])
    assert a == b


# ---------------------------------------- the last classes and helpers --

def _gnn_case(name, rng):
    n = 50
    ei = watts_strogatz_graph(n, 4, 0.3, seed=2).astype(np.int64)
    mask = rng.random(ei.shape[1]) < 0.8
    x = rng.normal(size=(n, 6)).astype(np.float32)
    if name == "sage_conv":
        return (jgnn.SAGEConv(5), (x, ei, n, mask),
                gnn.SAGEConv(6, 5), (x, ei, n, mask),
                convert.sage_conv_state_dict_from_flax)
    if name == "gcn":
        return (jgnn.GCN(8, 5, 3, 0.5), (x, ei, n), gnn.GCN(6, 8, 5, 3, 0.5),
                (x, ei, n), convert.gcn_state_dict_from_flax)
    if name == "sage":
        return (jgnn.SAGE(8, 5, 2, 0.5, residual=False), (x, ei, n),
                gnn.SAGE(6, 8, 5, 2, 0.5, residual=False), (x, ei, n),
                convert.sage_state_dict_from_flax)
    xi, xj = x[:20], x[20:40]
    return (jgnn.MLPLinkPredictor(8, 1, 3, 0.5), (xi, xj),
            gnn.MLPLinkPredictor(6, 8, 1, 3, 0.5), (xi, xj),
            convert.mlp_link_predictor_state_dict_from_flax)


@pytest.mark.parametrize("name", ["sage_conv", "gcn", "sage", "mlp"])
def test_gnn_classes_match_jax(name):
    """``SAGEConv`` (with an edge mask), ``GCN``, ``SAGE`` and
    ``MLPLinkPredictor`` from the flax weights: eval forward and the
    input's gradient in float32."""
    rng = np.random.default_rng(3)
    jm, jargs, pm, pargs, conv = _gnn_case(name, rng)
    jargs = tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                  for a in jargs)
    key = jax.random.PRNGKey(0)
    static = tuple(i for i, a in enumerate(jargs) if isinstance(a, int))
    variables = jax.jit(lambda *a: jm.init({"params": key, "dropout": key},
                                           *a), static_argnums=static)(*jargs)
    pm.load_state_dict(conv(_np(variables["params"])))
    pm.eval()
    rest = jargs[1:]
    shape = jax.eval_shape(lambda a: jm.apply(variables, a, *rest),
                           jargs[0]).shape
    t = rng.normal(size=shape)
    want, want_grad = jax.jit(lambda a: _value_and_vjp(
        lambda u: jm.apply(variables, u, *rest), a,
        jnp.asarray(t, jnp.float32)))(jargs[0])
    x = torch.from_numpy(np.asarray(pargs[0])).requires_grad_()
    rest = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in pargs[1:]]
    got = pm(x, *rest)
    (got * torch.from_numpy(t).float()).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-5)


def test_utils_helpers_match_jax():
    import scipy.sparse as ssp
    a = ssp.random(30, 30, density=0.2, format="csr", random_state=1)
    a.data[:] = 1.0
    for s, d, cap in ((0, 1, None), (4, 9, 2), (7, 7, 100)):
        assert utils.get_src_dst_degree(s, d, a, cap) == \
            jutils.get_src_dst_degree(s, d, a, cap)
    for arg, n in ((0.25, 37), (5, 37), (100, 37), (1, 0), (0.999, 10)):
        assert utils.get_num_samples(arg, n) == \
            jutils.get_num_samples(arg, n)
