"""setup_kernels_s: the program's stage ``setup.kernels`` (the builds and
loads of the native libraries, ``ops/cuda_build.py``: the CUDA kernels and
the C++ plan builder), its seconds in the run's set-up: a few ms where a
build directory holds them, the compilers' time where it does not
(``benchmark/spans.py``)."""

from benchmark import spans

measure = spans.measure


def read(s: dict):
    return spans.stage_s(s, "setup.kernels")
