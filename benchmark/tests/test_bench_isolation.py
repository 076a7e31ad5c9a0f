"""No module a cell imports has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``subgraph_sketching_tpu`` (compared whole: the port's name
begins with the JAX package's), and the reference imports nothing of the
program.  Each check runs in a fresh interpreter."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _fresh(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    got = _fresh(
        "import json, sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from benchmark import run, control\n"
        "from benchmark.tests.tiny import tiny_cell\n"
        "for c in ('elph-collab.train', 'buddy-citation2.train'):\n"
        "    r = run.run(c, 5, 0.2, False, device='cpu', cell=tiny_cell(c))\n"
        "    assert r['correct']\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not {"jax", "jaxlib", "flax", "subgraph_sketching_tpu"} & set(got)
    assert "subgraph_sketching_tpu_torch" in got


def test_the_reference_imports_nothing_of_the_program():
    got = _fresh(
        "import json, sys\n"
        "import benchmark.reference.check, benchmark.reference.models\n"
        "import benchmark.reference.sketches, benchmark.reference.buddy\n"
        "import benchmark.reference.elph\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not {"jax", "jaxlib", "flax", "subgraph_sketching_tpu",
                "subgraph_sketching_tpu_torch"} & set(got)


def test_forbidden_names_compare_whole():
    from benchmark.run import FORBIDDEN, forbidden_modules
    assert "subgraph_sketching_tpu_torch" not in FORBIDDEN
    sys.modules["subgraph_sketching_tpu_torch_probe"] = sys
    try:
        assert "subgraph_sketching_tpu_torch_probe" not in forbidden_modules()
    finally:
        del sys.modules["subgraph_sketching_tpu_torch_probe"]
