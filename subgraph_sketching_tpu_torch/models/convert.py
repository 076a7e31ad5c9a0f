"""Carry trained flax BUDDY weights, and their optax Adam state, into the
port.

The JAX package checkpoints with orbax, which needs jax to read; this
module takes the restored trees as numpy arrays instead, so weights cross
over without the port importing jax:

    sd = buddy_state_dict_from_flax(
        jax.tree.map(np.asarray, state.params),
        jax.tree.map(np.asarray, state.batch_stats))
    model.load_state_dict(sd)
    optimizer.load_state_dict(adam_state_from_optax(
        jax.tree.map(np.asarray, state.opt_state), model, optimizer))
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _unwrap(params: dict) -> dict:
    """The trainer's ``BuddyWithEmbedding`` wrapper holds the BUDDY under a
    top-level ``buddy`` entry."""
    return params["buddy"] if "buddy" in params else params


def _parameters_from_flax(params: dict, prefix: str = ""
                          ) -> Dict[str, torch.Tensor]:
    """torch parameter name -> tensor for a flax ``params``-shaped tree:
    each Dense kernel [in, out] becomes a Linear weight [out, in]; each
    BatchNorm (scale, bias) becomes (weight, bias)."""
    out: Dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        key = prefix + name
        if "kernel" in sub:
            out[key + ".weight"] = _tensor(sub["kernel"]).T.contiguous()
            if "bias" in sub:
                out[key + ".bias"] = _tensor(sub["bias"])
        elif "scale" in sub:
            out[key + ".weight"] = _tensor(sub["scale"])
            out[key + ".bias"] = _tensor(sub["bias"])
        else:
            out.update(_parameters_from_flax(sub, key + "."))
    return out


def _batch_stats_from_flax(batch_stats: dict, prefix: str = ""
                           ) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for name, sub in batch_stats.items():
        key = prefix + name
        if "mean" in sub:
            out[key + ".running_mean"] = _tensor(sub["mean"])
            out[key + ".running_var"] = _tensor(sub["var"])
            out[key + ".num_batches_tracked"] = torch.tensor(0)
        else:
            out.update(_batch_stats_from_flax(sub, key + "."))
    return out


def buddy_state_dict_from_flax(params: dict, batch_stats: dict
                               ) -> Dict[str, torch.Tensor]:
    """A ``BUDDY`` state_dict from flax ``params`` / ``batch_stats`` trees.

    Each Dense kernel [in, out] becomes a Linear weight [out, in]; each
    BatchNorm (scale, bias, mean, var), ``bn_RA`` of a ``use_RA`` model
    included, becomes (weight, bias, running_mean, running_var).  The
    trainer's ``BuddyWithEmbedding`` wrapper (a
    top-level ``buddy`` entry) is unwrapped.
    """
    if "buddy" in params:
        batch_stats = batch_stats.get("buddy", {})
    return {**_parameters_from_flax(_unwrap(params)),
            **_batch_stats_from_flax(batch_stats)}


def _find_adam_state(opt_state):
    """optax's ``ScaleByAdamState`` (count, mu, nu) inside a chain's nested
    tuples: ``adam`` alone, or ``add_decayed_weights`` then ``adam``."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _find_adam_state(sub)
            if found is not None:
                return found
    return None


def adam_state_from_optax(opt_state, model: torch.nn.Module,
                          optimizer: torch.optim.Adam) -> dict:
    """A ``torch.optim.Adam`` state dict holding the moments of an optax
    Adam state (numpy trees), for ``optimizer`` over ``model.parameters()``.

    optax's ``add_decayed_weights`` then ``adam`` is torch's Adam with
    ``weight_decay`` (decay added to the gradient, eps outside the sqrt),
    so after loading, the next step of either is the same step.  The param
    groups (lr, betas, eps, weight decay) are ``optimizer``'s own.
    """
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no optax ScaleByAdamState (count, mu, nu) found")
    mu = _parameters_from_flax(_unwrap(adam.mu))
    nu = _parameters_from_flax(_unwrap(adam.nu))
    names = [name for name, _ in model.named_parameters()]
    if sorted(names) != sorted(mu):
        raise ValueError(f"optax moments do not match the model's "
                         f"parameters: {sorted(set(names) ^ set(mu))}")
    step = torch.tensor(float(np.asarray(adam.count)))
    sd = optimizer.state_dict()
    sd["state"] = {i: {"step": step.clone(), "exp_avg": mu[name],
                       "exp_avg_sq": nu[name]}
                   for i, name in enumerate(names)}
    return sd
