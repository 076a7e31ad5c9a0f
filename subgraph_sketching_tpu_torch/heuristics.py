"""Link-prediction heuristics of the port: the host half of RA.

A copy of the host functions of the JAX package's heuristics.py that
preprocessing needs: the batched sparse row products A[src] · f(A)[dst]
of the reference (src/heuristics.py), on scipy CSR.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as ssp


def _batched_row_product(A: ssp.csr_matrix, B: ssp.csr_matrix,
                         links: np.ndarray, batch_size: int) -> np.ndarray:
    scores = []
    for s in range(0, len(links), batch_size):
        src = links[s:s + batch_size, 0]
        dst = links[s:s + batch_size, 1]
        cur = np.asarray(A[src].multiply(B[dst]).sum(axis=1)).ravel()
        scores.append(cur)
    return np.concatenate(scores) if scores else np.zeros(0)


def resource_allocation(A: ssp.csr_matrix, links: np.ndarray,
                        batch_size: int = 100000) -> np.ndarray:
    """RA(u,v) = Σ_{w ∈ N(u)∩N(v)} 1/deg(w) (src/heuristics.py:52-71)."""
    with np.errstate(divide="ignore"):
        mult = 1.0 / np.asarray(A.sum(axis=0)).ravel()
    mult[np.isinf(mult)] = 0
    A_ = A.multiply(mult).tocsr()
    return _batched_row_product(A, A_, links, batch_size).astype(np.float32)
