"""PyTorch / CUDA port of subgraph_sketching_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout (``sketch/``, ``ops/``, ``graph/``,
``models/``, ``runners/``, ``serving.py``, ``config.py``) so each module has
an obvious counterpart.  The JAX package is the reference; this package
imports none of it and keeps its own copies of the host-side code it needs.

Entry points take ``device="cuda"`` by default and raise when CUDA is
absent; pass ``device="cpu"`` to run the plain PyTorch versions of the
kernels on the CPU.
"""

__version__ = "0.1.0"

from subgraph_sketching_tpu_torch.config import Config  # noqa: F401
from subgraph_sketching_tpu_torch.device import resolve_device  # noqa: F401
