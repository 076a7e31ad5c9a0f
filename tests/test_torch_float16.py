"""The port's float16 and float64 ``--dtype`` values and SEAL and KGE
under ``--mesh_shape`` in one process, against the JAX package's, on the
CPU.

``--dtype float16`` is the bfloat16 path of tests/test_torch_dtype.py at
another 16-bit type: flax's per-module ``dtype`` (models/gnn.py ``Dense``,
``BatchNorm``, ``Dropout``), K1's float16 add (ops/segscan.py, summed in
float32 and rounded once a row) under both SpMM routes and the row-gather
backward.  Both packages get the same seeded numpy inputs and the same
weights (flax initialises them, ``models/convert.py`` carries them over).
JAX runs its float16 models as its own tests/test_dtype.py runs its
bfloat16 ones: on the CPU, where XLA sums a float16 segment in float16 in
its own order.  The inputs stay well inside float16's range (no sum
passes 65,504) except in the overflow test, which says where.
Tolerances:

  * K1's plain float16 add against a float64 sum: at most half a float16
    ulp of the sum (2^-11 of it) plus 2·n·2^-24·Σ|v| (float32
    accumulation over a row's n terms);
  * sums past 65,504 are ±inf and inf − inf is nan in both packages, and
    a sum that JAX keeps finite the port keeps finite;
  * ``PlanSpmm`` and ``spmm`` at float16, forward and x-gradient, against
    JAX's at float16: rtol = atol = 2^-8 (float16 products and sums of at
    most 8 terms, XLA rounding each add at 2^-11);
  * each model's float16 output against JAX's at float16 and against the
    port's own float32 output: rtol = atol = 0.01, ELPH's node features
    0.02 (a fifth of the bfloat16 tolerances: float16 keeps three more
    bits); DGCNN's sort keys atol 2^-10 (one float16 ulp at 1);
  * one step's gradients against ``jax.grad`` at float16: each tensor
    within 0.02 of JAX's by norm (||g - g_jax|| <= 0.02 ||g_jax||),
    DGCNN's within 0.05: there each package's float16 gradient of the
    1D convolutions and the MLP lies 1.4-5.4% from its own float32 one
    (the float32 gradients agree within 1e-6), and the two float16
    gradients lie at most 3.5% apart;
  * the runner at ``--dtype float64`` and SEAL and KGE with a mesh: equal
    to the float32 run and to the run without the mesh, bit for bit, as
    the JAX runner's are (one JAX run of each shows it).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subgraph_sketching_tpu.runners import run as jrun
from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.models import gnn
from subgraph_sketching_tpu_torch.ops import segscan
from subgraph_sketching_tpu_torch.runners import run
from subgraph_sketching_tpu_torch.serving import scorer_from_checkpoint
from test_torch_dtype import (  # noqa: F401 (seal_batch: a fixture)
    MODELS, float32_state_after_a_step, gather_rows_backward_sums_once,
    models_half_match_jax, one_step_gradients_match_jax_grad,
    plain_half_add_against_float64, seal_batch, spmm_half_matches_jax,
)

F16 = torch.float16
TOL = dict(rtol=0.01, atol=0.01)
TOL_ELPH = dict(rtol=0.02, atol=0.02)
SPMM_TOL = dict(rtol=2 ** -8, atol=2 ** -8)
GRAD_TOL = 0.02
GRAD_TOL_DGCNN = 0.05


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's small tensors, as in
    tests/test_torch_dtype.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------ K1's plain add --

@pytest.mark.parametrize("width", [1, 3, 8, 24])
def test_plain_f16_add_against_float64(width):
    """The plain version (what the kernel computes: upcast, sum in
    float32, round once) within its bound of the float64 sum, a 600-term
    hub row included; float16 in, float16 out; dyadic rows exact."""
    plain_half_add_against_float64(width, F16, 2.0 ** -11)


def test_f16_add_overflows_as_jax():
    """Sums past float16's 65,504 give inf in both packages (the port's on
    its one rounding, XLA's on the add that passes it), inf − inf gives
    nan, and a sum that stays in range stays finite in both.  XLA adds
    in float16, so a row whose partial sum passes the range before its
    last term brings it back can differ; no row here does."""
    rows = [[30000.0, 30000.0, 30000.0], [-30000.0, -30000.0, -30000.0],
            [60000.0, 5000.0, -1000.0], [65504.0, 8.0, 0.0],
            [np.inf, -np.inf, 1.0], [1.0, 2.0, 3.0]]
    v = np.asarray(rows, np.float16).reshape(-1, 1)
    seg = np.repeat(np.arange(len(rows)), 3)
    ptr = torch.arange(0, 3 * len(rows) + 1, 3)
    got = segscan.segment_combine(torch.from_numpy(v),
                                  torch.empty(len(rows), 1, dtype=F16), "add",
                                  ptr)[:, 0].float().numpy()
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(v), jnp.asarray(seg),
                                          len(rows))[:, 0], np.float32)
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert list(np.isfinite(got)) == [False, False, True, True, False, True]
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=2 ** -10)


# ------------------------------------------------------------- the SpMM --

@pytest.mark.parametrize("route", ["plan", "scatter"])
def test_spmm_f16_matches_jax(route):
    """The gcn_norm'd SpMM at float16 by either route, forward and
    x-gradient, against JAX's at float16; both stay float16."""
    spmm_half_matches_jax(route, F16, SPMM_TOL)


def test_gather_rows_backward_sums_f16_rows_once():
    """A float16 table's row-gather gradient: K1's float16 add, summed in
    float32 and rounded once per row (the hot row of 300 picks too)."""
    gather_rows_backward_sums_once(F16)


# ------------------------------------------------------------- the models --

@pytest.mark.parametrize("name", MODELS)
def test_models_f16_match_jax(name, seal_batch):  # noqa: F811
    """Each model's eval forward at float16 from the same weights: against
    JAX's at float16, and against the port's own float32 output.  The
    logits (and ELPH's node features) are float32, as in JAX; SIGN's and
    SIGNEmbedding's outputs float16.  DGCNN's keys are held within
    2^-10 and its logits on the links whose sort picks agree, as at
    bfloat16 (tests/test_torch_dtype.py)."""
    models_half_match_jax(name, seal_batch, F16,
                          TOL_ELPH if name.startswith("elph") else TOL,
                          2 ** -10)


@pytest.mark.parametrize("name", ["buddy_sign", "elph_gcn", "seal_dgcnn",
                                  "seal_gcn"])
def test_one_step_gradients_match_jax_grad(name, seal_batch):  # noqa: F811
    """The gradients of one training-mode step (dropout 0; BatchNorm on
    the batch's statistics) at float16 against ``jax.grad`` at float16:
    ELPH through the plan route's float16 backward, SEAL through the
    label table's (its hot row 0 summed in float32 and rounded once by
    K1, at every add by XLA), DGCNN through its sort pool, on the links
    whose picks agree between the packages (as its forward is held).  The
    biases that feed a BatchNorm have a true gradient of zero and are
    left out."""
    one_step_gradients_match_jax_grad(
        name, seal_batch, F16,
        GRAD_TOL_DGCNN if name == "seal_dgcnn" else GRAD_TOL)


@pytest.mark.parametrize("name", ["buddy_sign", "elph_gcn", "seal_dgcnn"])
def test_float32_state_after_a_f16_step(name, seal_batch):  # noqa: F811
    """After an Adam step at float16 the parameters, the BatchNorm
    statistics and Adam's moments are float32 and finite, the logits
    were float32, and the state_dict has the float32 model's keys and
    dtypes."""
    float32_state_after_a_step(name, seal_batch, F16)


# ------------------------------------------------------------ the runner --

SMALL = ["--dataset_name", "synth-ba", "--hidden_channels", "8",
         "--batch_size", "256", "--train_samples", "1024",
         "--val_samples", "512", "--test_samples", "512", "--epochs", "1"]
SEAL_SMALL = ["--num_seal_layers", "2", "--train_samples", "200",
              "--val_samples", "100", "--test_samples", "100"]


def _args(model, *extra):
    return ["--model", model, *(SEAL_SMALL if model.startswith("SEAL")
                                else []), *extra]


def _main(extra):
    return run.main(SMALL + extra + ["--device", "cpu"])


@pytest.fixture(scope="module")
def port_run():
    """The port runner's result for a flag list, each run once a module
    (the runs are functions of their flags)."""
    cache = {}

    def get(*extra):
        if extra not in cache:
            cache[extra] = _main(list(extra))
        return cache[extra]
    return get


@pytest.fixture(scope="module")
def jax_run():
    """The JAX runner's result for a flag list, each run once a module
    (3-16 s each here)."""
    cache = {}

    def get(*extra):
        if extra not in cache:
            cache[extra] = jrun.main(SMALL + list(extra) +
                                     ["--platform", "cpu"])
        return cache[extra]
    return get


def test_jax_float64_run_is_its_float32_run(jax_run):
    """The reference: the JAX runner's BUDDY at ``--dtype float64`` is its
    float32 run, bit for bit (flax's float64 compute dtype is float32
    without x64)."""
    assert jax_run(*_args("BUDDY", "--dtype", "float64")) == \
        jax_run(*_args("BUDDY"))


@pytest.mark.parametrize("model", ["BUDDY", "ELPH", "SEALDGCNN"])
def test_runner_float64_is_the_float32_run(model, port_run):
    """``--dtype float64`` computes in float32, bit-equal to the float32
    run, as the JAX runner's does."""
    assert port_run(*_args(model, "--dtype", "float64")) == \
        port_run(*_args(model))


# the reference's ogbl-ddi kind: a trainable table diffused in every step
DDI = ["--train_node_embedding", "--propagate_embeddings", "--use_feature",
       "0", "--sign_k", "2"]


@pytest.mark.parametrize("model", ["BUDDY", "ELPH", "SEALDGCNN", "ELPH_ddi"])
def test_runner_trains_f16(model, tmp_path):
    """BUDDY, ELPH, SEALDGCNN and ELPH with a diffused node table (the ddi
    kind) train at ``--dtype float16`` with finite results.  The BUDDY
    and ELPH checkpoints serve in float16 (their config says so), within
    0.01 of the same weights served in float32."""
    ck = str(tmp_path / "ck")
    extra = _args(model.split("_")[0], "--dtype", "float16")
    if model == "ELPH_ddi":
        assert np.all(np.isfinite(_main(extra + DDI)))
        return
    if not model.startswith("SEAL"):
        extra += ["--save_model", "--checkpoint_dir", ck]
    assert np.all(np.isfinite(_main(extra)))
    if model.startswith("SEAL"):
        return
    scorer = scorer_from_checkpoint(ck, device="cpu")
    dense = scorer.model.lin if model == "BUDDY" else \
        scorer.model.predictor.lin
    assert dense.dtype == F16
    links = np.array([[0, 1], [3, 40], [7, 7], [99, 2]])
    got = scorer.score(links)
    assert np.all(np.isfinite(got))
    with open(os.path.join(ck, "config.json")) as f:
        cfg = dataclasses.replace(Config.from_json(f.read()), dtype="float32")
    f32 = scorer_from_checkpoint(ck, cfg=cfg, device="cpu")
    np.testing.assert_allclose(got, f32.score(links), atol=0.01)


MESH_2_GRAPH = ("--mesh_shape", "2", "--mesh_axes", "graph")
MESH_1_ROWS = ("--mesh_shape", "1", "--mesh_axes", "rows")


@pytest.mark.parametrize("model, mesh", [("SEALGCN", MESH_2_GRAPH),
                                         ("transE", MESH_1_ROWS)])
def test_jax_seal_and_kge_ignore_the_mesh(model, mesh, jax_run):
    """The reference: the JAX runner builds neither trainer with a mesh,
    so its SEALGCN and transE runs with one are the runs without, bit
    for bit."""
    assert jax_run(*_args(model, *mesh)) == jax_run(*_args(model))


@pytest.mark.parametrize("model, mesh", [
    ("SEALGCN", MESH_2_GRAPH), ("SEALGCN", MESH_1_ROWS),
    ("SEALGCN", ("--mesh_shape", "1")),
    ("SEALDGCNN", ("--mesh_shape", "1", "--mesh_axes", "graph")),
    ("transE", MESH_1_ROWS), ("transE", ("--mesh_shape", "1", "--mesh_axes",
                                         "graph")),
    ("transE", ("--mesh_shape", "2,2", "--mesh_axes", "data,graph")),
    ("rotatE", ("--mesh_shape", "1"))])
def test_seal_and_kge_ignore_the_mesh_in_one_process(model, mesh, port_run):
    """In one process SEAL and KGE train with ``--mesh_shape`` and
    ``--mesh_axes`` unread and unchecked (an unknown axis, a shape that
    one process does not fill), bit-equal to the run without them, as
    the JAX runner's are."""
    assert port_run(*_args(model, *mesh)) == port_run(*_args(model))


def test_kge_f16_trains_in_float32(port_run):
    """A KGE run with --dtype float16 is the float32 run, bit for bit (the
    JAX package's kge_loop never reads the dtype)."""
    assert port_run(*_args("distmult", "--dtype", "float16")) == \
        port_run(*_args("distmult"))


@pytest.mark.parametrize("model", ["SEALGCN", "transE"])
def test_seal_and_kge_refuse_several_ranks(model, monkeypatch):
    """Over several ranks SEAL and KGE raise: their trainers have no data
    axis, and W copies of one run, each writing the same checkpoints,
    are not one run."""
    monkeypatch.setattr(run.multihost, "world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="over 2 ranks"):
        _main(["--model", model])


@pytest.mark.parametrize("name", ["float8", "float17", "half32"])
def test_dtype_that_jax_refuses_is_refused(name):
    """A dtype name that ``jnp.dtype`` rejects raises ValueError in the
    port too, and so does a run with it."""
    with pytest.raises(TypeError):
        jnp.dtype(name)
    with pytest.raises(ValueError, match=f"--dtype {name}"):
        gnn.compute_dtype(name)
    if name == "float17":
        with pytest.raises(ValueError, match="--dtype float17"):
            _main(_args("ELPH", "--dtype", name))
