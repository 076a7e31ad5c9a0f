"""Carry trained flax BUDDY weights into the port's ``BUDDY``.

The JAX package checkpoints with orbax, which needs jax to read; this
module takes the restored trees as numpy arrays instead, so weights cross
over without the port importing jax:

    sd = buddy_state_dict_from_flax(
        jax.tree.map(np.asarray, state.params),
        jax.tree.map(np.asarray, state.batch_stats))
    model.load_state_dict(sd)
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def buddy_state_dict_from_flax(params: dict, batch_stats: dict
                               ) -> Dict[str, torch.Tensor]:
    """A ``BUDDY`` state_dict from flax ``params`` / ``batch_stats`` trees.

    Each Dense kernel [in, out] becomes a Linear weight [out, in]; each
    BatchNorm (scale, bias, mean, var) becomes (weight, bias, running_mean,
    running_var).  The trainer's ``BuddyWithEmbedding`` wrapper (a
    top-level ``buddy`` entry) is unwrapped.
    """
    if "buddy" in params:
        params = params["buddy"]
        batch_stats = batch_stats.get("buddy", {})
    out: Dict[str, torch.Tensor] = {}

    def walk(p: dict, bs: dict, prefix: str):
        for name, sub in p.items():
            key = prefix + name
            if "kernel" in sub:
                out[key + ".weight"] = _tensor(sub["kernel"]).T.contiguous()
                if "bias" in sub:
                    out[key + ".bias"] = _tensor(sub["bias"])
            elif "scale" in sub:
                stats = bs[name]
                out[key + ".weight"] = _tensor(sub["scale"])
                out[key + ".bias"] = _tensor(sub["bias"])
                out[key + ".running_mean"] = _tensor(stats["mean"])
                out[key + ".running_var"] = _tensor(stats["var"])
                out[key + ".num_batches_tracked"] = torch.tensor(0)
            else:
                walk(sub, bs.get(name, {}), key + ".")

    walk(params, batch_stats, "")
    return out
