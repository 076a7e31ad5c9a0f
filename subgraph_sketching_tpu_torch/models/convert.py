"""Carry trained flax BUDDY and ELPH weights, and their optax Adam state,
into the port.

The JAX package checkpoints with orbax, which needs jax to read; this
module takes the restored trees as numpy arrays instead, so weights cross
over without the port importing jax:

    sd = buddy_state_dict_from_flax(
        jax.tree.map(np.asarray, state.params),
        jax.tree.map(np.asarray, state.batch_stats), model)
    model.load_state_dict(sd)
    optimizer.load_state_dict(adam_state_from_optax(
        jax.tree.map(np.asarray, state.opt_state), model, optimizer))

(``elph_state_dict_from_flax`` for an ELPH trainer's state,
``seal_state_dict_from_flax`` for a SEAL model's; ``gcn_``, ``sage_``,
``sage_conv_`` and ``mlp_link_predictor_state_dict_from_flax`` for the
JAX package's ``GCN``, ``SAGE``, ``SAGEConv`` and ``MLPLinkPredictor``.)
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Optional

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


# the JAX BUDDY trainer's tree: its BuddyWithEmbedding holds the BUDDY
# under ``buddy``, the table and its diffusion beside it
_TABLE_ENTRIES = ("node_embedding", "sign_embedding")


def _carries_table(tree: Mapping) -> bool:
    return any(_nonempty(tree.get(k)) for k in _TABLE_ENTRIES)


def _nonempty(sub) -> bool:
    return sub is not None and (not isinstance(sub, Mapping) or len(sub) > 0)


def _is_wrapped(model: torch.nn.Module) -> bool:
    """Whether the port's module is a ``BuddyWithEmbedding`` (a child
    ``buddy``)."""
    return "buddy" in dict(model.named_children())


def _unwrap(tree: Mapping, wrapped: bool) -> Mapping:
    """A JAX BUDDY trainer's tree (``{"buddy", "node_embedding",
    "sign_embedding"}``; params, batch statistics or Adam moments) in the
    layout of the port's module: whole for a ``BuddyWithEmbedding``
    (``wrapped``), else the BUDDY alone, refusing a tree that carries a
    table the module has no place for.  A tree with no ``buddy`` entry
    (an ELPH tree, or a bare BUDDY's) is returned as it is."""
    if "buddy" not in tree or wrapped:
        return tree
    if _carries_table(tree):
        raise ValueError(
            "the tree carries a node-embedding table (node_embedding / "
            "sign_embedding) but the target BUDDY has none: build the "
            "model with the run's embedding config (train/loops.py "
            "build_buddy)")
    return tree["buddy"]


# flax's automatic submodule names -> the port's: a GCNConv's Dense
_RENAME = {"Dense_0": "lin"}
# ... and a SAGEConv's two
_SAGE_RENAME = {"Dense_0": "lin", "Dense_1": "lin_root"}


def _parameters_from_flax(params: dict, prefix: str = "",
                          rename: Optional[dict] = None
                          ) -> Dict[str, torch.Tensor]:
    """torch parameter name -> tensor for a flax ``params``-shaped tree:
    each Dense kernel [in, out] becomes a Linear weight [out, in]; each
    BatchNorm (scale, bias) becomes (weight, bias); a module's own
    parameter (a GCNConv's ``bias``) keeps its name; ``rename`` maps
    flax's automatic names (default: a GCNConv's)."""
    rename = _RENAME if rename is None else rename
    out: Dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        key = prefix + rename.get(name, name)
        if not isinstance(sub, Mapping):
            out[key] = _tensor(sub)
        elif "kernel" in sub:
            out[key + ".weight"] = _tensor(sub["kernel"]).T.contiguous()
            if "bias" in sub:
                out[key + ".bias"] = _tensor(sub["bias"])
        elif "scale" in sub:
            out[key + ".weight"] = _tensor(sub["scale"])
            out[key + ".bias"] = _tensor(sub["bias"])
        else:
            out.update(_parameters_from_flax(sub, key + ".", rename))
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


def buddy_state_dict_from_flax(params: dict, batch_stats: dict,
                               model: Optional[torch.nn.Module] = None
                               ) -> Dict[str, torch.Tensor]:
    """A state_dict for ``model`` (a ``BUDDY``, or a
    ``BuddyWithEmbedding`` with node embeddings) from the flax ``params``
    / ``batch_stats`` trees of the JAX BUDDY trainer.

    Each Dense kernel [in, out] becomes a Linear weight [out, in]; each
    BatchNorm (scale, bias, mean, var), ``bn_RA`` of a ``use_RA`` model
    and ``sign_embedding``'s ``bn_k`` included, becomes (weight, bias,
    running_mean, running_var); ``node_embedding`` [N, hidden] keeps its
    layout.  The JAX tree always wraps the BUDDY (``{"buddy",
    "node_embedding", "sign_embedding"}``); for a plain ``BUDDY`` it is
    unwrapped, and a tree carrying a table is refused.  Without
    ``model`` the target is a ``BuddyWithEmbedding`` exactly when the
    tree carries a table.
    """
    wrapped = (_is_wrapped(model) if model is not None
               else _carries_table(params))
    return {**_parameters_from_flax(_unwrap(params, wrapped)),
            **_batch_stats_from_flax(_unwrap(batch_stats, wrapped))}


def elph_state_dict_from_flax(params: dict, batch_stats: dict
                              ) -> Dict[str, torch.Tensor]:
    """An ``ELPHPredictor`` state_dict from the flax ``params`` /
    ``batch_stats`` trees of the JAX ``ElphTrainer`` (``{"gnn",
    "predictor", "embedding"}``): ``gnn/conv_k/Dense_0/kernel``
    (transposed) becomes ``gnn.conv_k.lin.weight``, ``gnn/conv_k/bias``
    ``gnn.conv_k.bias``; ``gnn/feature_encoder``, every ``predictor/*``
    Dense and BatchNorm, ``embedding/node_embedding`` and
    ``embedding/sign_embedding/{lin_k, bn_k, lin_out}`` map by name."""
    trees = ("gnn", "predictor", "embedding")
    return {**_parameters_from_flax({k: params.get(k, {}) for k in trees}),
            **_batch_stats_from_flax({k: batch_stats.get(k, {})
                                      for k in trees})}


def seal_state_dict_from_flax(params: dict,
                              batch_stats: Optional[dict] = None
                              ) -> Dict[str, torch.Tensor]:
    """A state_dict for one of the port's five SEAL models
    (``models/seal.py``) from the flax ``params`` / ``batch_stats`` trees
    of the JAX model: Dense kernels transposed; the ``Embed`` tables
    (``z_embedding``, ``node_embedding``) as ``<name>.weight``; DGCNN's
    ``nn.Conv`` kernel [5, 16, 32] (width, in, out) as the
    ``Conv1d`` weight [32, 16, 5]; SEALGIN's BatchNorms (``gin_bn_<i>``:
    scale, bias, mean, var) and, with ``train_eps``, its ``eps_<i>``;
    SEALMLP's automatic ``Dense_0`` / ``Dense_1`` as ``lin1`` / ``lin2``."""
    tree = dict(params)
    if "Dense_0" in tree:
        tree["lin1"], tree["lin2"] = tree.pop("Dense_0"), tree.pop("Dense_1")
    out: Dict[str, torch.Tensor] = {}
    for name in ("z_embedding", "node_embedding"):
        if name in tree:
            out[f"{name}.weight"] = _tensor(tree.pop(name)["embedding"])
    conv2 = tree.pop("conv2", None)
    if conv2 is not None:
        out["conv2.weight"] = _tensor(conv2["kernel"]).permute(
            2, 1, 0).contiguous()
        out["conv2.bias"] = _tensor(conv2["bias"])
    out.update(_parameters_from_flax(tree))
    out.update(_batch_stats_from_flax(batch_stats or {}))
    return out


def _numbered(params: dict, flax_prefix: str, port_name: str) -> dict:
    """flax's ``<flax_prefix>_<i>`` entries as ``<port_name>.<i>`` (a
    ``ModuleList``'s children)."""
    return {f"{port_name}.{name[len(flax_prefix) + 1:]}": sub
            for name, sub in params.items()}


def sage_conv_state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """A ``SAGEConv`` state_dict from the JAX ``SAGEConv``'s params:
    ``Dense_0`` (the neighbour mean's) is ``lin``, ``Dense_1`` (the root
    weight, no bias) ``lin_root``."""
    return _parameters_from_flax(params, rename=_SAGE_RENAME)


def gcn_state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """A ``GCN`` state_dict from the JAX ``GCN``'s params:
    ``GCNConv_<i>/{Dense_0, bias}`` is ``convs.<i>.{lin, bias}``."""
    return _parameters_from_flax(_numbered(params, "GCNConv", "convs"))


def sage_state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """A ``SAGE`` state_dict from the JAX ``SAGE``'s params:
    ``SAGEConv_<i>`` is ``convs.<i>``, each as
    :func:`sage_conv_state_dict_from_flax`."""
    return _parameters_from_flax(_numbered(params, "SAGEConv", "convs"),
                                 rename=_SAGE_RENAME)


def mlp_link_predictor_state_dict_from_flax(params: dict
                                            ) -> Dict[str, torch.Tensor]:
    """An ``MLPLinkPredictor`` state_dict from the JAX one's params:
    ``Dense_<i>`` is ``lins.<i>``."""
    return _parameters_from_flax(_numbered(params, "Dense", "lins"))


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
    Adam state (numpy trees), for ``optimizer`` over ``model.parameters()``
    (a ``BUDDY``, a ``BuddyWithEmbedding`` or an ``ELPHPredictor``; a
    trainable table's moments included, a frozen table having none).

    optax's ``add_decayed_weights`` then ``adam`` is torch's Adam with
    ``weight_decay`` (decay added to the gradient, eps outside the sqrt),
    so after loading, the next step of either is the same step.  The param
    groups (lr, betas, eps, weight decay) are ``optimizer``'s own.
    """
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no optax ScaleByAdamState (count, mu, nu) found")
    wrapped = _is_wrapped(model)
    mu = _parameters_from_flax(_unwrap(adam.mu, wrapped))
    nu = _parameters_from_flax(_unwrap(adam.nu, wrapped))
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
