"""Misc utilities (reference src/utils.py); the port's own copies of the
JAX package's utils.py."""

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


def get_num_samples(sample_arg: float, dataset_len: int) -> int:
    """A fraction of ``dataset_len`` if ``sample_arg`` < 1, else a count
    capped at it (reference utils.py:32-43)."""
    if sample_arg < 1:
        return int(sample_arg * dataset_len)
    return int(min(sample_arg, dataset_len))


def get_src_dst_degree(src: int, dst: int, A, max_nodes=None):
    """The degrees of ``src`` and ``dst`` in the adjacency ``A`` (their
    row sums), each capped at ``max_nodes`` (reference
    utils.py:118-129)."""
    sd = A[src].sum()
    dd = A[dst].sum()
    if max_nodes is not None:
        sd = min(sd, max_nodes)
        dd = min(dd, max_nodes)
    return sd, dd


def neighbors(fringe, A, outgoing: bool = True) -> set:
    """The neighbour set of a set of nodes over a scipy CSR adjacency
    (reference utils.py:102-115): out-neighbours through the rows, or
    in-neighbours through the columns of a CSC one."""
    if not fringe:
        return set()
    if outgoing:
        return set(A[list(fringe)].indices)
    return set(A[:, list(fringe)].indices)


def load_pretrained_embedding(path: str, num_nodes=None):
    """A frozen node-embedding table as a float32 numpy array (reference
    utils.py:57-60 loads a torch-saved weight and freezes it; the JAX
    package's ``utils.load_pretrained_embedding``).  Accepts .npy, .npz
    (its first array) or a torch-saved tensor."""
    import numpy as np
    if path.endswith(".npz"):
        with np.load(path) as z:
            w = z[z.files[0]]
    elif path.endswith(".npy"):
        w = np.load(path)
    else:
        import torch
        w = torch.load(path, map_location="cpu", weights_only=True)
        w = w.detach().numpy() if hasattr(w, "detach") else np.asarray(w)
    w = np.asarray(w, dtype=np.float32)
    if w.ndim != 2:
        raise ValueError(f"embedding table must be 2-D, got {w.shape}")
    if num_nodes is not None and w.shape[0] != num_nodes:
        raise ValueError(f"embedding table has {w.shape[0]} rows for "
                         f"{num_nodes} nodes ({path})")
    return w
