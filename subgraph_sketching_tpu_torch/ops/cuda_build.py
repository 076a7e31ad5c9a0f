"""Build and load the port's hand-written CUDA kernels.

``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ctypes.  The build runs
at first use, from the sources in this package only, into ``_build/``
beside it; the library's file name carries a hash of its source and flags,
so an edited source is rebuilt and a current one is reused.  nvcc's output
(``-Xptxas -v``: registers and spills) is kept beside it as ``.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:12]}.so")


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    if name not in _LIBS:
        out = library_path(name)
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                                  os.path.join(CSRC, f"{name}.cu")],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                                   f"(rc {res.returncode}):\n{res.stdout}"
                                   f"{res.stderr}")
            with open(out[:-3] + ".log", "w") as f:
                f.write(res.stdout + res.stderr)
            os.replace(tmp, out)   # atomic: no process loads a partial file
        _LIBS[name] = ctypes.CDLL(out)
    return _LIBS[name]
