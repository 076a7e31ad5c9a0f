"""The model weights of a cell, made on the device from the seed.

The program's model gives only its structure (names, shapes, which
modules are BatchNorms); the values come from one uniform draw: every
two-dimensional weight glorot-uniform in ±sqrt(6 / (fan_in + fan_out)),
biases zero, BatchNorm scales one, running means zero and variances one.
Both the program and the reference are handed the same dictionary.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from benchmark.inputs.graphs import stream


def seeded_state_dict(model: nn.Module, seed: int,
                      device) -> Dict[str, torch.Tensor]:
    bn_scales = {f"{name}.weight" for name, m in model.named_modules()
                 if isinstance(m, nn.modules.batchnorm._BatchNorm)}
    state = model.state_dict()
    mats = [k for k, v in state.items() if v.dim() == 2]
    total = sum(state[k].numel() for k in mats)
    flat = torch.rand(total, generator=stream(seed, "weights", device),
                      device=device) * 2 - 1
    out, at = {}, 0
    for k, v in state.items():
        if v.dim() == 2:
            fan_out, fan_in = v.shape
            bound = (6.0 / (fan_in + fan_out)) ** 0.5
            out[k] = (flat[at:at + v.numel()].view(v.shape) * bound).clone()
            at += v.numel()
        elif k in bn_scales or k.endswith("running_var"):
            out[k] = torch.ones(v.shape, dtype=v.dtype, device=device)
        else:
            out[k] = torch.zeros(v.shape, dtype=v.dtype, device=device)
    return out
