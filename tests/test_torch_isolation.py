"""The port imports neither jax nor anything of the JAX package, and
neither pandas nor ogb (it reads the raw dataset layouts itself).

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
             if k in ("jax", "flax", "optax", "orbax", "subgraph_sketching_tpu",
                      "pandas", "ogb")
             or k.startswith(("jax.", "flax.", "jaxlib", "optax.", "orbax.",
                              "subgraph_sketching_tpu.", "pandas.", "ogb.")))
print(len(names), bad)
print(" ".join(names))
"""

# the training slice's modules, the dataset slice's (loading, LCC, RA
# and the plan builder's build), ELPH's, the node embeddings', the
# heuristics tier's, the SEAL and KGE tiers', the multi-process layer's
# and the command-line tools', which must be among those imported
REQUIRED = {"train", "train.losses", "train.evaluation", "train.inference",
            "train.loops", "train.checkpoint", "train.determinism",
            "runners.run", "metrics_logging", "utils",
            "graph.datasets", "graph.lcc", "heuristics", "ops.cuda_build",
            "ops.segment_scan", "graph.preprocess", "models.elph",
            "models.predictor", "models.gnn", "models.buddy",
            "models.convert", "serving", "runners.run_heuristics",
            "runners.serve", "labelling", "graph.native", "graph.seal",
            "models.seal", "models.transx", "train.seal_loop",
            "train.kge_loop", "parallel", "parallel.mesh",
            "parallel.multihost", "parallel.fault", "parallel.train",
            "parallel.dryrun", "parallel.collectives",
            "parallel.breakdown", "parallel.node_sharded",
            "parallel.dist_sketch", "parallel.scaling", "device",
            "tools", "tools.citation2_train", "tools.repro_baseline",
            "tools.run_protocol", "tools.scale_equality",
            "tools.gen_hll_tables"}


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.splitlines()
    count, bad = out[0].split(maxsplit=1)
    assert int(count) >= 40            # every module of the package was imported
    assert bad.strip() == "[]"
    imported = set(out[1].split())
    assert {"subgraph_sketching_tpu_torch." + m for m in REQUIRED} <= imported
