"""Misc utilities (reference src/utils.py); the port's own copies."""

from __future__ import annotations


def str2bool(x) -> bool:
    """Bool flags that survive string round-trips (reference utils.py:132-143)."""
    if isinstance(x, bool):
        return x
    if isinstance(x, (int, float)):
        return bool(x)
    if isinstance(x, str):
        v = x.strip().lower()
        if v in ("y", "yes", "t", "true", "on", "1"):
            return True
        if v in ("n", "no", "f", "false", "off", "0", ""):
            return False
        raise ValueError(f"unrecognised boolean string {x!r}")
    raise ValueError(f"unrecognised type {type(x)}")
