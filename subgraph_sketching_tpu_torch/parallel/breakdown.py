"""Where a data-parallel training step's time goes, rank by rank.

:func:`profile_steps` runs a trainer's steps under ``torch.profiler`` and
splits them: the step's wall time by the host clock, the device's busy
time and idle share, the device time by kernel, the host's own time by
operator (each operator's self time: what it spent outside the operators
it called; the rest of the wall time is Python between operators), the
step's phases by the port's spans (``spans.py``: forward, backward and
optimizer on the device's clock), and the collectives issued, with the
host time spent inside ``torch.distributed.all_reduce``.
``chip_smoke.py``'s ``dp`` phase reads it at world size 1; as a program
it reads it on every rank of a torchrun launch:

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        -m subgraph_sketching_tpu_torch.parallel.breakdown \\
        --dataset_name synth-ws-200000 --model ELPH --mesh_shape 4 \\
        --mesh_axes data --steps 20 --out breakdown_w4

which stages the run's data as ``runners.run`` does, takes the trainer's
steps on one seeded order of the train links (the same on every rank),
and writes ``<out>/rank<r>.json`` for each rank.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from subgraph_sketching_tpu_torch import spans
from subgraph_sketching_tpu_torch.parallel import collectives

# operators that are ranges over other operators' work, not work of
# their own: the profiler's step marks
_MARKS = ("ProfilerStep",)


@contextlib.contextmanager
def _timed_all_reduce(spent: list):
    """``torch.distributed.all_reduce`` with its host seconds added to
    ``spent[0]``."""
    inner = dist.all_reduce

    def timed(*a, **k):
        t = time.perf_counter()
        try:
            return inner(*a, **k)
        finally:
            spent[0] += time.perf_counter() - t

    dist.all_reduce = timed
    try:
        yield
    finally:
        dist.all_reduce = inner


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_steps(trainer, model, optimizer, order: torch.Tensor,
                  steps: int, seed: int, top: int = 12,
                  on_window=None) -> dict:
    """``steps`` steps of ``trainer.run_epoch`` on the first
    ``steps * batch_size`` links of ``order`` (the global order, the same
    on every rank), under torch.profiler, after three profiled warm-up
    steps whose trace is dropped.  ``on_window()`` runs just before the
    window (to set counters to 0).  Per step: wall ms, device busy ms
    and idle share, the ``top`` kernels by device ms and operators by
    host self ms (name, ms, calls), every operator's in ``host_ops``
    ({name: [ms, calls]}), the device ms of the spans ``train.step``,
    ``train.forward``, ``train.backward`` and ``train.optimizer``
    (``phases_ms``: step, forward, backward, optimizer; None for a span
    the trainer did not record), NCCL's device ms, the host ms in
    ``all_reduce``, the collectives' calls and bytes.  The spans' records
    (not the stages') are reset at the window's start."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    device = torch.device(trainer.device)
    bs = trainer.cfg.batch_size
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    spent = [0.0]
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        trainer.run_epoch(model, optimizer, seed, order=order[:3 * bs])
        _sync(device)
        prof.step()
        if on_window is not None:
            on_window()
        collectives.reset_collectives()
        spans.reset_spans()
        with _timed_all_reduce(spent):
            t0 = time.perf_counter()
            trainer.run_epoch(model, optimizer, seed,
                              order=order[3 * bs:(3 + steps) * bs])
            _sync(device)
            wall = time.perf_counter() - t0
        prof.step()
    kernels, ops = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue    # a range on the device's timeline, not a kernel
            slot = kernels.setdefault(e.name[:96], [0.0, 0])
            slot[0] += e.time_range.elapsed_us() / 1e3
            slot[1] += 1
    for a in prof.key_averages():
        if a.device_type == DeviceType.CPU and not a.key.startswith(_MARKS):
            ops[a.key[:96]] = [a.self_cpu_time_total / 1e3, a.count]
    busy = sum(v[0] for v in kernels.values())
    phases = spans.totals()
    phases_ms = {p: (phases[f"train.{p}"]["device_s"] * 1e3 / steps
                     if f"train.{p}" in phases else None)
                 for p in ("step", "forward", "backward", "optimizer")}

    def per_step(table: dict) -> list:
        rows = sorted(table.items(), key=lambda kv: -kv[1][0])
        return [[k, ms / steps, n / steps] for k, (ms, n) in rows]

    return {"steps": steps, "step_ms": wall * 1e3 / steps,
            "device_busy_ms": busy / steps,
            "device_idle_share": 1 - busy / (wall * 1e3),
            "host_op_self_ms": sum(v[0] for v in ops.values()) / steps,
            "phases_ms": phases_ms,
            "all_reduce_host_ms": spent[0] * 1e3 / steps,
            "collective_calls": collectives.collectives["calls"] / steps,
            "collective_bytes": collectives.collectives["bytes"] / steps,
            "nccl_device_ms": sum(ms for k, (ms, _) in kernels.items()
                                  if "nccl" in k.lower()) / steps,
            "top_kernels": per_step(kernels)[:top],
            "top_host_ops": per_step(ops)[:top],
            "host_ops": {k: [ms, n] for k, ms, n in per_step(ops)}}


def timed_steps(trainer, model, optimizer, order: torch.Tensor,
                steps: int, seed: int) -> float:
    """Mean ms of ``steps`` steps by the host clock, after two warm
    ones, without the profiler."""
    device = torch.device(trainer.device)
    bs = trainer.cfg.batch_size
    trainer.run_epoch(model, optimizer, seed, order=order[:2 * bs])
    _sync(device)
    t = time.perf_counter()
    trainer.run_epoch(model, optimizer, seed,
                      order=order[2 * bs:(2 + steps) * bs])
    _sync(device)
    return (time.perf_counter() - t) * 1e3 / steps


def main(argv: Optional[list] = None) -> dict:
    """The program (see the module's docstring): the runner's flags, and
    ``--steps`` (the profiled and the timed steps, each) and ``--out``."""
    from subgraph_sketching_tpu_torch.device import (
        device_from_flags, resolve_device,
    )
    from subgraph_sketching_tpu_torch.graph.datasets import get_data
    from subgraph_sketching_tpu_torch.graph.preprocess import (
        build_all_splits,
    )
    from subgraph_sketching_tpu_torch.parallel import multihost
    from subgraph_sketching_tpu_torch.runners import run as runner
    from subgraph_sketching_tpu_torch.train.loops import make_optimizer

    parser = runner.make_parser()
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--out", default="breakdown")
    args = parser.parse_args(argv)
    steps, out = args.steps, args.out
    del args.steps, args.out
    cfg = runner.config_from_parsed(args)
    device = device_from_flags(args.device, cfg.platform)
    if "WORLD_SIZE" in os.environ:
        multihost.initialize(device=device)
    try:
        dev = resolve_device(device)
        splits, directed, _ = get_data(cfg)
        datasets = build_all_splits(splits, cfg, directed=directed,
                                    device=dev)
        x = datasets["train"].x
        trainer = runner.build_trainer(
            cfg, datasets, None if x is None else x.shape[-1], dev)
        model = trainer.init_model(0)
        optimizer = make_optimizer(cfg, model.parameters())
        g = torch.Generator(device=dev).manual_seed(0)
        order = torch.randperm(trainer.num_links("train"), generator=g,
                               device=dev)
        if order.numel() < (5 + steps) * cfg.batch_size:
            raise ValueError(f"{order.numel()} train links are fewer than "
                             f"{5 + steps} batches of {cfg.batch_size}")
        record = {"rank": multihost.rank(),
                  "world_size": multihost.world_size(),
                  "backend": dist.get_backend() if multihost.initialized()
                  else None,
                  "model": cfg.model, "dataset": cfg.dataset_name,
                  "batch_size": cfg.batch_size,
                  "hidden_channels": cfg.hidden_channels,
                  "timed_step_ms": timed_steps(trainer, model, optimizer,
                                               order, steps, seed=1),
                  **profile_steps(trainer, model, optimizer, order, steps,
                                  seed=2)}
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"rank{record['rank']}.json"), "w") as f:
            json.dump(record, f, indent=1)
        print(json.dumps({k: v for k, v in record.items()
                          if not k.startswith(("top_", "host_ops"))}),
              flush=True)
        return record
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
