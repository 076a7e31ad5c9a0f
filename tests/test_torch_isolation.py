"""The port imports neither jax nor anything of the JAX package.

Checked in a fresh interpreter: this test process has jax loaded already
(tests/conftest.py imports it).
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
import subgraph_sketching_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k in ("jax", "flax", "subgraph_sketching_tpu")
             or k.startswith(("jax.", "flax.", "jaxlib", "subgraph_sketching_tpu.")))
print(len(names), bad)
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split(maxsplit=1)
    assert int(out[0]) >= 20          # every module of the package was imported
    assert out[1].strip() == "[]"
