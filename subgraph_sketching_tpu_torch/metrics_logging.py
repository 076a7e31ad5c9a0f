"""Structured metrics logging (the reference's wandb channel, decoupled).

The reference logs through wandb with init/offline/disabled modes
(src/wandb_setup.py:10-35) plus prints.  Here the structured sink is a local
JSONL file (it needs no network) and wandb becomes an optional passthrough
when the package is importable and --wandb is set.  A copy of the JAX
package's metrics_logging.py.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


def apply_sweep_overrides(cfg):
    """Sweep-driven config override (reference wandb_setup.py:31: when
    sweeping, ``wandb.config`` values replace the parsed args).

    Two sources, merged in order:
      * ``SWEEP_OVERRIDES`` env var — a JSON object of field: value pairs
        (works without wandb / network, e.g. for local grid sweeps)
      * ``wandb.config`` when ``cfg.wandb_sweep`` and wandb is importable

    Returns the (mutated) cfg.
    """
    overrides: Dict[str, Any] = {}
    env = os.environ.get("SWEEP_OVERRIDES")
    if env:
        overrides.update(json.loads(env))
    if getattr(cfg, "wandb_sweep", False):
        try:
            import wandb
            if wandb.run is None:
                wandb.init(entity=cfg.wandb_entity, project=cfg.wandb_project,
                           group=cfg.wandb_group, name=cfg.wandb_run_name,
                           dir=cfg.wandb_output_dir)
            overrides.update(dict(wandb.run.config))
        except ImportError:
            print("wandb_sweep set but wandb not installed; "
                  "using SWEEP_OVERRIDES only")
    for k, v in overrides.items():
        if hasattr(cfg, k):
            setattr(cfg, k, v)
        else:
            print(f"sweep override ignores unknown config field {k!r}")
    return cfg


class MetricsLogger:
    """log(dict) -> stdout summary + JSONL file (+ optional wandb)."""

    def __init__(self, run_dir: Optional[str] = None, use_wandb: bool = False,
                 config: Optional[Dict[str, Any]] = None, quiet: bool = True,
                 wandb_kwargs: Optional[Dict[str, Any]] = None):
        self.run_dir = run_dir
        self.quiet = quiet
        self._fh = None
        self._step = 0
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            self._fh = open(os.path.join(run_dir, "metrics.jsonl"), "a")
            if config:
                with open(os.path.join(run_dir, "config.json"), "w") as f:
                    json.dump(config, f, indent=2, default=str)
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb
                if wandb.run is None:
                    wandb.init(config=config or {}, **(wandb_kwargs or {}))
            except ImportError:
                print("wandb requested but not installed; logging to JSONL only")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        step = self._step if step is None else step
        self._step = step + 1
        rec = {"step": step, "time": time.time(), **metrics}
        if self._fh:
            self._fh.write(json.dumps(rec, default=float) + "\n")
            self._fh.flush()
        if self._wandb:
            self._wandb.log(metrics, step=step)
        if not self.quiet:
            print({k: (round(v, 5) if isinstance(v, float) else v)
                   for k, v in metrics.items()})

    def finish(self):
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._wandb:
            self._wandb.finish()
