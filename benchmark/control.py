"""The readings the limits of ``correct`` are set from, at the cell's own
size, each judged against ``limits/<cell>.json`` as a run judges it:

  * ``program``: the program's set-up and checked steps (the driver's
    own), against the reference (float64);
  * ``control_tf32``: the reference put in the program's place, computed
    in the precision below the configuration's (float32 with TF32 matrix
    products, against float32 with TF32 off);
  * ``fault_half_batch``: the same with half of each batch left out of
    the loss.

    python -m benchmark.control --workload <cell> --seeds 1 2 3

prints one JSON line a seed: for each reading its numbers, each beside
its limit, and ``correct``.  The program's has to come out correct, the
control's and the fault's not.  Benchmark runs do not run this; it needs
the card, as TF32 exists only there.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch


def judged(gaps: dict, limits: dict) -> dict:
    """A reading's numbers beside their limits, and whether all hold."""
    from benchmark.run import _checks
    checks = _checks(gaps["numbers"], limits)
    return {"correct": all(math.isfinite(c["value"])
                           and c["value"] <= c["limit"]
                           for c in checks.values()),
            "checks": checks,
            "notes": {k: gaps["notes"][k]
                      for k in ("later_loss_gap", "change_worst",
                                "grad_leaf")}}


def train_readings(cell, seed: int, device, log=print) -> dict:
    from benchmark.drivers.train import Driver
    from benchmark.reference import check
    drv = Driver(cell, seed, device, log)
    drv.setup()
    drv.free()
    torch.cuda.empty_cache()
    args = (cell.config, drv.inputs, drv.weights, drv.checked, device)
    ref = check.reference_train(*args)
    out = {"program": judged(check.train_gaps(drv.checked, ref),
                             cell.limits)}
    for name, kw in (("control_tf32", {"dtype": torch.float32,
                                       "tf32": True}),
                     ("fault_half_batch", {"fault": "half_batch"})):
        other = check.reference_train(*args, **kw)
        out[name] = judged(check.train_gaps(other, ref), cell.limits)
    return out


def main(argv=None) -> int:
    from benchmark import spec
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control needs the card (TF32)", file=sys.stderr)
        return 2
    cell = spec.find_cell(args.workload)
    if cell.mix["kind"] != "train":
        print(f"no control for a {cell.mix['kind']!r} mix", file=sys.stderr)
        return 2
    from benchmark.run import CACHE
    from subgraph_sketching_tpu_torch.ops import cuda_build
    cuda_build.set_build_dir(os.path.join(CACHE, "build"))
    tf32 = bool(cell.config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    dev = torch.device("cuda")
    for seed in args.seeds:
        out = train_readings(cell, seed, dev,
                             lambda *a: print(*a, file=sys.stderr))
        print(json.dumps({"workload": args.workload, "seed": seed, **out},
                         default=str), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
