"""Build and load the port's native code: the hand-written CUDA kernels
and the C++ plan builder.

``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``, and
``csrc/<name>.cpp`` (host code: ``plan_build.cpp``, the plan tables of
``ops/segment_scan.py``, and ``seal_extract.cpp``, the SEAL extractor of
``graph/native.py``) by ``g++ -O3 -fopenmp``, each into a shared
library with a plain C interface, loaded with ctypes.  The build runs at
first use, from the sources in this package only, into ``_build/`` beside
it, or the directory that :func:`set_build_dir` names (the runner's
``--compilation_cache_dir``); the library's file name carries a hash of
its source, the shared headers (``csrc/*.cuh``, for the CUDA sources) and
the flags, so an edited source or header is rebuilt and a current one is
reused.  The
compiler's output (for nvcc ``-Xptxas -v``: registers and spills) is kept
beside it as ``.log``.  ``load_all`` starts one compiler per source, all
at once; its builds and loads are the set-up stage ``setup.kernels``
(``spans.py``), so a checkout's first run pays its builds there and not
in the stage that first runs a kernel.

The wrappers (``ops/segscan.py``, ``studies/*.py``) share the glue below:
``entry`` declares a C entry point's argument types, ``share_steps``
reads a kernel's share size, ``check_tensors`` refuses what no kernel
takes, ``merge_path_scratch`` allocates the carry-out scratch of K1 and
K3, and ``launch`` calls an entry point on the
current stream and raises on the cudaError it returns.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

from subgraph_sketching_tpu_torch import spans

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17"]

# library path -> the loaded library
_LIBS: dict = {}


def set_build_dir(path: str) -> None:
    """Build into and load from ``path`` from now on, in this process (the
    counterpart of the JAX package's persistent compilation cache,
    ``--compilation_cache_dir``): a library already there is reused, a
    missing one built there at first use."""
    global BUILD_DIR
    BUILD_DIR = os.path.abspath(path)
    entry.cache_clear()
    share_steps.cache_clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: the host code of csrc/*.cpp (the "
                       "plan builder, the SEAL extractor) is built with a "
                       "C++ compiler")


def _is_host(name: str) -> bool:
    """``csrc/<name>.cpp`` (host code for g++) rather than ``<name>.cu``."""
    return os.path.exists(os.path.join(CSRC, f"{name}.cpp"))


def _sources(name: str) -> list:
    """The files the library of ``name`` is built from, main source first:
    a CUDA source with every shared header, or a host source alone."""
    if _is_host(name):
        return [f"{name}.cpp"]
    return [f"{name}.cu",
            *sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))]


def _command(name: str, out: str) -> list:
    src = os.path.join(CSRC, _sources(name)[0])
    if _is_host(name):
        return [_gxx(), *GXX_FLAGS, "-o", out, src]
    return [_nvcc(), *NVCC_FLAGS, "-o", out, src]


def library_path(name: str) -> str:
    """The library of ``csrc/<name>.cu`` (or ``.cpp``), named by a hash of
    its sources and the compiler's flags."""
    flags = GXX_FLAGS if _is_host(name) else NVCC_FLAGS
    digest = hashlib.sha256(" ".join(flags).encode())
    for f in _sources(name):
        with open(os.path.join(CSRC, f), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:12]}.so")


def load_all(names) -> dict:
    """Build every missing library of ``names`` with one compiler each,
    all running together, then load them.  Returns {name: seconds from the
    start of the builds to the end of that one's compiler} (0.0 for a
    library that was already built)."""
    with spans.stage("setup.kernels"):
        return _load_all(names)


def _load_all(names) -> dict:
    t0 = time.perf_counter()
    running = {}
    for name in names:
        out = library_path(name)
        if out in _LIBS or os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"the build of csrc/{_sources(name)[0]} failed "
                          f"(rc {proc.returncode}):\n{log}")
            continue
        with open(out[:-3] + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, out)   # atomic: no process loads a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        path = library_path(name)
        if path not in _LIBS:
            _LIBS[path] = ctypes.CDLL(path)
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (or ``.cpp``), built if
    needed."""
    path = library_path(name)
    if path not in _LIBS:
        load_all([name])
    return _LIBS[path]


@functools.lru_cache(maxsize=None)
def entry(name: str, fn_name: str, argtypes: tuple):
    """The C entry point ``fn_name`` of ``csrc/<name>.cu`` (built at first
    use) with its argument types declared; it returns a cudaError_t."""
    fn = getattr(load(name), fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def share_steps(name: str) -> int:
    """The steps of one share of ``csrc/<name>.cu``'s kernels (merge-path
    steps for K1 and K3, the edges of one piece for K2): its ``constexpr``,
    exported as ``<name>_share_steps`` and read from the built library."""
    fn = getattr(load(name), f"{name}_share_steps")
    fn.argtypes = []
    fn.restype = ctypes.c_int64
    return int(fn())


def merge_path_shares(num_rows: int, num_items: int, steps: int) -> int:
    """Shares of a merge path of ``num_rows`` row ends and ``num_items``
    items, ``steps`` steps a share: the rows of the carry-out scratch that
    a merge-path kernel (``csrc/merge_path.cuh``) launches with."""
    return -(-(num_rows + num_items) // steps)


def merge_path_scratch(name: str, num_rows: int, num_items: int, words: int,
                       device, heads: bool = False):
    """The carry-out scratch of one launch of ``csrc/<name>.cu``'s
    merge-path kernels: (shares, carry int32 [shares, words], carry_row
    int64 [shares]), uninitialised (the kernels write before they read).
    ``heads``: an op that sums wider than it stores (K1's 16-bit adds)
    also keeps the head of each row it finishes in the carry pass, in
    ``shares`` more rows of carry."""
    import torch
    shares = merge_path_shares(num_rows, num_items, share_steps(name))
    rows = 2 * shares if heads else shares
    return (shares,
            torch.empty((rows, words), dtype=torch.int32, device=device),
            torch.empty(shares, dtype=torch.int64, device=device))


def check_tensors(what: str, align: int = 4, **tensors) -> None:
    """Raise unless every tensor lies on the first one's CUDA device, is
    contiguous and starts on an ``align``-byte boundary (the kernels read
    32-bit words; K1's 16-bit adds read 16-bit elements, ``align`` 2)."""
    device = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"{what}: {name} is not {align}-byte aligned")


def launch(fn, what: str, device, *args) -> None:
    """Call the C entry point ``fn`` on ``device``'s current stream (passed
    last) and raise if it reports a CUDA error."""
    import torch
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what}: kernel failed to launch: cudaError {rc}")
