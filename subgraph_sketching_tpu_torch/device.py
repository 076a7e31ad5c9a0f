"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import os
from typing import Optional

import torch

# the JAX package's --platform values the port runs on, as torch device
# types
PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent.  Nothing moves to the CPU unless the caller says so."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def device_from_flags(device: Optional[str],
                      platform: Optional[str] = None) -> str:
    """The device an entry point runs on, from its ``--device`` and the
    JAX package's ``--platform``.  ``--platform`` (cpu, gpu or cuda)
    picks the device when ``--device`` is not given and must agree with
    it when it is; tpu, or any other value, raises.  With neither, the
    device is CUDA: ``cuda:LOCAL_RANK`` under torchrun (one card per
    rank), else ``cuda``."""
    if platform is not None and platform not in PLATFORMS:
        raise ValueError(f"--platform {platform}: the port runs on "
                         f"{', '.join(PLATFORMS)}")
    want = PLATFORMS.get(platform)
    if device is None:
        device = want or "cuda"
        if device == "cuda" and "LOCAL_RANK" in os.environ:
            device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
        return device
    if want is not None and torch.device(device).type != want:
        raise ValueError(f"--platform {platform} conflicts with --device "
                         f"{device}")
    return device
