"""ctypes binding of the native SEAL extractor (``csrc/seal_extract.cpp``),
the JAX package's graph/native.py.

The library is built by ``ops/cuda_build.py`` (g++, OpenMP) from the
port's own source at first use, into ``_build/``.  Where the JAX package
prints a note and takes the python path when the build fails, the port
raises: ``SEALDataset`` takes the python path only where the JAX package
takes it by design (a directed graph, a label the C++ lacks) or where its
caller asks for it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from subgraph_sketching_tpu_torch.ops import cuda_build

NODE_LABELS = {"drnl": 0, "hop": 1, "zo": 2, "degree": 3, "none": 4,
               "de": 5, "de+": 6}
# labelling schemes that emit two labels (dist-to-src, dist-to-dst) per node
TWO_DIM_LABELS = ("de", "de+")

_i32, _f32 = ctypes.c_int32, ctypes.c_float
_P_I32, _P_F32 = ctypes.POINTER(_i32), ctypes.POINTER(_f32)
_ARGTYPES = ((_P_I32, _P_I32, _P_F32, _i32, _P_I32, _i32, _i32, _i32, _i32,
              _i32, _i32, ctypes.c_double, _i32, ctypes.c_uint64)
             + (_P_I32,) * 4 + (_P_F32, _P_I32))


def _ptr(a: Optional[np.ndarray], ctype):
    return None if a is None else a.ctypes.data_as(ctypes.POINTER(ctype))


def seal_extract_batch_native(
        indptr: np.ndarray, indices: np.ndarray,
        weights: Optional[np.ndarray], num_nodes: int, links: np.ndarray,
        num_hops: int, max_nodes: int, max_edges: int, max_dist: int,
        node_label: str, ratio_per_hop: float = 1.0,
        max_nodes_per_hop: Optional[int] = None, seed: int = 0
        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                   np.ndarray, np.ndarray]:
    """Batched enclosing-subgraph extraction.

    Returns (nodes [B,N], z [B,N] — or [B,N,2] for de/de+ — src [B,E],
    dst [B,E], w [B,E], counts [B,2]) in the dense padded layout of
    graph.seal.SealBatchArrays.
    """
    if max_nodes < 2 or max_edges < 1:
        raise ValueError(f"max_nodes >= 2 and max_edges >= 1 required "
                         f"(got {max_nodes}, {max_edges}): the two center "
                         f"nodes are always extracted")
    if int(np.asarray(indptr)[-1]) > np.iinfo(np.int32).max:
        # a silent int32 cast would wrap CSR offsets negative
        raise OverflowError(
            "graph has >= 2^31 nonzeros — beyond the native extractor's "
            "int32 CSR; use the python path")
    B = len(links)
    links_arr = np.asarray(links)
    if B and (links_arr.min() < 0 or links_arr.max() >= num_nodes):
        # the C++ extractor indexes per-thread stamp/local_id arrays by
        # node id with no bounds check; a stray id (a -1 pad leaking into
        # the link table) would corrupt the heap inside the OpenMP workers.
        # Check the int64 array: an id >= 2^32 would wrap through the
        # int32 cast and alias a valid node.
        bad = links_arr[((links_arr < 0) | (links_arr >= num_nodes)).any(1)]
        raise ValueError(
            f"link endpoints out of range [0, {num_nodes}): "
            f"{bad[:5].tolist()}{' …' if len(bad) > 5 else ''}")
    # built at first use; a failed build raises
    fn = cuda_build.entry("seal_extract", "seal_extract_batch", _ARGTYPES)
    links_c = np.ascontiguousarray(links, dtype=np.int32)
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    w_in = (np.ascontiguousarray(weights, dtype=np.float32)
            if weights is not None else None)
    out_nodes = np.full((B, max_nodes), -1, dtype=np.int32)
    z_shape = ((B, max_nodes, 2) if node_label in TWO_DIM_LABELS
               else (B, max_nodes))
    out_z = np.zeros(z_shape, dtype=np.int32)
    out_src = np.zeros((B, max_edges), dtype=np.int32)
    out_dst = np.zeros((B, max_edges), dtype=np.int32)
    out_w = np.zeros((B, max_edges), dtype=np.float32)
    out_counts = np.zeros((B, 2), dtype=np.int32)
    rc = fn(_ptr(indptr, _i32), _ptr(indices, _i32), _ptr(w_in, _f32),
            num_nodes, _ptr(links_c, _i32), B, num_hops, max_nodes,
            max_edges, max_dist, NODE_LABELS[node_label], ratio_per_hop,
            -1 if max_nodes_per_hop is None else max_nodes_per_hop, seed,
            _ptr(out_nodes, _i32), _ptr(out_z, _i32), _ptr(out_src, _i32),
            _ptr(out_dst, _i32), _ptr(out_w, _f32), _ptr(out_counts, _i32))
    if rc != 0:
        raise RuntimeError(f"seal_extract_batch failed (rc={rc})")
    return out_nodes, out_z, out_src, out_dst, out_w, out_counts
