"""One run of one benchmark cell.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The run builds the cell's inputs from ``--seed``, sets the program up
through its own entry points and warms it up (``setup_s``, from process
start to the window), measures for ``--seconds``, reads the device's
peak memory, frees the program, and compares what the window's path
produced with the plain reference (``reference/``).  With ``--trace 1`` a
slice of the window runs under ``torch.profiler`` and the cell's
per-layer metrics are reported instead of its end-to-end ones.  The last
line of standard output is one JSON object; the compared numbers, each
beside its limit, close standard error and the result's ``checks``.

It needs CUDA with as many cards as the cell asks for: without them it
exits non-zero and prints no result.  Kernel builds and caches go to
``benchmark/_cache`` inside the checkout, so only a checkout's first run
builds.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from contextlib import contextmanager  # noqa: E402

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(CACHE, _sub)
os.environ["USE_FLAX"] = "0"

# the JAX side of the repository, compared by whole top-level names: the
# port's own package name begins with the JAX package's
FORBIDDEN = {"jax", "jaxlib", "flax", "subgraph_sketching_tpu"}
HOST_CPUS = 4


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


@contextmanager
def few_host_threads():
    """The window runs on the first ``HOST_CPUS`` cores this process may
    use, with one torch thread, so runs on a shared host spread less; the
    set-up before it keeps every core."""
    import torch
    cpus, threads = os.sched_getaffinity(0), torch.get_num_threads()
    os.sched_setaffinity(0, sorted(cpus)[:HOST_CPUS])
    torch.set_num_threads(1)
    try:
        yield
    finally:
        os.sched_setaffinity(0, cpus)
        torch.set_num_threads(threads)


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def _checks(numbers: dict, limits: dict) -> dict:
    missing = set(numbers) - set(limits)
    if missing:
        raise KeyError(f"no limit for {sorted(missing)}")
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", cell=None) -> dict:
    """One run; returns the result object.  For the harness's own tests,
    ``cell`` may stand in for the cell's files."""
    import torch

    from benchmark import spec
    from benchmark.trace import Tracer

    cell = cell or spec.find_cell(workload)
    dev = torch.device(device)
    tf32 = bool(cell.config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    if dev.type == "cuda":
        from subgraph_sketching_tpu_torch.ops import cuda_build
        cuda_build.set_build_dir(os.path.join(CACHE, "build"))
        torch.cuda.reset_peak_memory_stats(dev)
    driver = spec.load_driver(cell.mix["kind"]).Driver(cell, seed, dev, log)
    driver.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - T0
    log(f"set-up {setup_s:.3f} s")

    tracer = Tracer() if trace else None
    with few_host_threads():
        out = driver.window(seconds, tracer,
                            cell.mix.get("trace_seconds", 2.0))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded {', '.join(found)}")

    result = {"correct": False, "attempted": out["attempted"],
              "failed": out["failed"]}
    units = spec.metric_units(cell)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        summary = tracer.summary()
        summary.update(driver.layer_summary())
        ctx = driver.measure_context()
        values = {}
        for m in cell.per_layer:
            reader = spec.load_metric(m["name"])
            if hasattr(reader, "measure"):
                summary.update(reader.measure(ctx))
            v = reader.read(summary)
            if v is not None:
                values[m["name"]] = v
        device_info.update(busy_s=summary["busy_s"],
                           window_s=summary["window_s"])
        result["breakdown"] = summary["breakdown"]
    else:
        values = dict(out["metrics"], setup_s=setup_s)
        values = {m["name"]: values[m["name"]] for m in cell.end_to_end}
    result["metrics"] = {k: {"value": v, "unit": units[k]}
                         for k, v in values.items()}
    result["device"] = device_info

    driver.free()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    compared = driver.check()
    log(f"reference {time.perf_counter() - t:.3f} s; "
        f"{json.dumps(compared['notes'], default=str)[:1500]}")
    checks = _checks(compared["numbers"], cell.limits)
    result["correct"] = bool(out["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    result["checks"] = checks
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import spec
    chips = spec.find_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"the cell needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" available")
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
