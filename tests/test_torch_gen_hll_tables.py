"""The port's HLL++ table generator
(subgraph_sketching_tpu_torch/tools/gen_hll_tables.py) against the JAX
repository's tool (tools/gen_hll_tables.py, numpy only, loaded by path:
``tools/`` is no package) and against the committed table the estimator
reads, on the CPU.

Every array is bit-equal: the draws are the JAX tool's, the register max
is order-free, and a trial's sum of powers of two is exact in float64 in
any order at these cardinalities.
"""

import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

from subgraph_sketching_tpu_torch.tools import gen_hll_tables as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(REPO, "subgraph_sketching_tpu_torch", "sketch",
                         "_hll_tables.npz")
SEED = 20260816   # both tools' default base seed

torch.set_num_threads(1)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_gen_hll_tables", os.path.join(REPO, "tools",
                                           "gen_hll_tables.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JTOOL = _jax_tool()


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """The port's CLI at ``--only-p 4`` then ``--only-p 6`` into one file
    (the second merges into the first)."""
    out = str(tmp_path_factory.mktemp("hll") / "tables.npz")
    for p in (4, 6):
        tool.main(["--only-p", str(p), "--out", out, "--device", "cpu"])
    with np.load(out) as z:
        return {k: np.asarray(z[k]) for k in z.files}


@pytest.mark.parametrize("p", [4, 6])
def test_tables_equal_jax_tool(generated, p):
    raw, bias, se = JTOOL.gen_for_p(p, np.random.default_rng(SEED + p))
    np.testing.assert_array_equal(generated[f"raw_estimate_p{p}"], raw)
    np.testing.assert_array_equal(generated[f"bias_p{p}"], bias)
    np.testing.assert_array_equal(generated[f"bias_se_p{p}"], se)


@pytest.mark.parametrize("p", [4, 6])
def test_tables_equal_committed(generated, p):
    with np.load(COMMITTED) as z:
        for key in (f"raw_estimate_p{p}", f"bias_p{p}"):
            np.testing.assert_array_equal(generated[key], z[key])


def test_only_p_keeps_the_other_arrays(tmp_path):
    out = str(tmp_path / "tables.npz")
    shutil.copy(COMMITTED, out)
    with np.load(COMMITTED) as z:
        before = {k: np.asarray(z[k]) for k in z.files}
    tool.main(["--only-p", "4", "--out", out, "--device", "cpu"])
    with np.load(out) as z:
        after = {k: np.asarray(z[k]) for k in z.files}
    assert set(after) == set(before) | {"bias_se_p4"}
    for k, v in before.items():
        np.testing.assert_array_equal(after[k], v)


def test_bit_length_matches_jax_tool():
    edges = np.array([0, 1, 2, 3, 2 ** 31, 2 ** 32 - 1, 2 ** 32,
                      2 ** 32 + 1, 2 ** 53 + 1, 2 ** 63 - 1, 2 ** 63,
                      2 ** 64 - 1], dtype=np.uint64)
    rand = np.random.default_rng(0).integers(0, 2 ** 64, 10_000,
                                             dtype=np.uint64)
    for x in (edges, rand, rand >> np.uint64(17)):
        got = tool.bit_length_u64(torch.from_numpy(x.view(np.int64)))
        np.testing.assert_array_equal(got.numpy(), JTOOL.bit_length_u64(x))
        for s in (4, 8, 16):
            shifted = tool.shift_right_u64(torch.from_numpy(x.view(np.int64)),
                                           s)
            np.testing.assert_array_equal(
                shifted.numpy().view(np.uint64), x >> np.uint64(s))


def test_raises_without_a_card(tmp_path):
    """No ``--device``: the card, which this CPU-only run lacks."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(["--only-p", "4", "--out", str(tmp_path / "t.npz")])
    assert not (tmp_path / "t.npz").exists()
