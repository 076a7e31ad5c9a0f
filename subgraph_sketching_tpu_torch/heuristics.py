"""Link-prediction heuristics of the port: CN, AA, RA, PPR.

Counterpart of the JAX package's heuristics.py, with the same math as the
reference (src/heuristics.py), on two paths:
  * host (scipy CSR): the batched sparse row products A[src] · f(A)[dst]
    and PPR's power iteration.  Preprocessing and RA serving use them, and
    they are the plain versions ``DeviceHeuristics`` is held against.
  * device (torch): ``DeviceHeuristics``, CN/AA/RA over the padded
    neighbour lists by a degree-bucketed compare-all.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as ssp
import torch

from subgraph_sketching_tpu_torch.device import resolve_device


# ------------------------------------------------------------------- host --

def _batched_row_product(A: ssp.csr_matrix, B: ssp.csr_matrix,
                         links: np.ndarray, batch_size: int) -> np.ndarray:
    scores = []
    for s in range(0, len(links), batch_size):
        src = links[s:s + batch_size, 0]
        dst = links[s:s + batch_size, 1]
        cur = np.asarray(A[src].multiply(B[dst]).sum(axis=1)).ravel()
        scores.append(cur)
    return np.concatenate(scores) if scores else np.zeros(0)


def common_neighbours(A: ssp.csr_matrix, links: np.ndarray,
                      batch_size: int = 100000) -> np.ndarray:
    """CN(u,v) = |N(u) ∩ N(v)| (reference src/heuristics.py:11-27)."""
    return _batched_row_product(A, A, links, batch_size).astype(np.float32)


def adamic_adar(A: ssp.csr_matrix, links: np.ndarray,
                batch_size: int = 100000) -> np.ndarray:
    """AA(u,v) = Σ_{w ∈ N(u)∩N(v)} 1/log(deg(w)) (src/heuristics.py:30-49)."""
    with np.errstate(divide="ignore"):
        mult = 1.0 / np.log(np.asarray(A.sum(axis=0)).ravel())
    mult[np.isinf(mult)] = 0
    A_ = A.multiply(mult).tocsr()
    return _batched_row_product(A, A_, links, batch_size).astype(np.float32)


def resource_allocation(A: ssp.csr_matrix, links: np.ndarray,
                        batch_size: int = 100000) -> np.ndarray:
    """RA(u,v) = Σ_{w ∈ N(u)∩N(v)} 1/deg(w) (src/heuristics.py:52-71)."""
    with np.errstate(divide="ignore"):
        mult = 1.0 / np.asarray(A.sum(axis=0)).ravel()
    mult[np.isinf(mult)] = 0
    A_ = A.multiply(mult).tocsr()
    return _batched_row_product(A, A_, links, batch_size).astype(np.float32)


def personalized_pagerank(A: ssp.csr_matrix, links: np.ndarray,
                          alpha: float = 0.85, tol: float = 1e-7,
                          max_iter: int = 200) -> Tuple[np.ndarray, np.ndarray]:
    """PPR scores by power iteration, one solve per unique source
    (reference src/heuristics.py:74-113 used the fast_pagerank package).

    Returns (scores, links): ``scores[i]`` belongs to input ``links[i]``.
    Unlike the reference (which returns src-sorted links and scores), the
    scores are scattered back to input order, so the per-positive negative
    alignment of citation2's MRR survives; Hits and AUC do not depend on
    the order.
    """
    n = A.shape[0]
    deg = np.asarray(A.sum(axis=1)).ravel()
    inv_deg = np.where(deg > 0, 1.0 / np.maximum(deg, 1e-12), 0.0)
    # row-stochastic transition matrix
    W = ssp.diags(inv_deg) @ A
    order = np.argsort(links[:, 0], kind="stable")
    links_sorted = links[order]
    scores = np.zeros(len(links_sorted), dtype=np.float32)
    i = 0
    while i < len(links_sorted):
        src = links_sorted[i, 0]
        j = i
        while j < len(links_sorted) and links_sorted[j, 0] == src:
            j += 1
        p = np.zeros(n)
        p[src] = 1.0
        v = p.copy()
        for _ in range(max_iter):
            v_new = (1 - alpha) * p + alpha * (W.T @ v)
            if np.abs(v_new - v).sum() < tol:
                v = v_new
                break
            v = v_new
        scores[i:j] = v[links_sorted[i:j, 1]]
        i = j
    out = np.empty_like(scores)
    out[order] = scores
    return out, links


# ----------------------------------------------------------------- device --

class DeviceHeuristics:
    """Batched CN/AA/RA on ``device`` by degree-bucketed neighbour
    intersection (the JAX package's ``DeviceHeuristics``).

    score(u,v) = Σ_w A[u,w] · f(deg(w)) · A[v,w] (reference
    src/heuristics.py:11-71), with f = 1 (CN), 1/log (AA) or 1/x (RA) of
    the weighted column sum.  Each link goes to the smallest bucket width
    D that holds both endpoints' neighbour lists (by row length); a chunk
    of B = chunk_elems // D² links pads both lists to [B, D] with the id
    ``n``, which matches nothing, and reduces the compare-all
    eq[b,i,j] = (nbr_u[b,i] == nbr_v[b,j]) weighted by
    (w_u·f_u)[b,i] · w_v[b,j].  The padded lists are built on the device
    from the resident CSR, and the chunks run without a host
    synchronisation; the scores come back once.  On ``device="cpu"`` the
    same torch code runs on the CPU.
    """

    def __init__(self, A: ssp.csr_matrix, buckets: Tuple[int, ...] = (),
                 chunk_elems: int = 1 << 25, device="cuda"):
        self.device = resolve_device(device)
        A = A.tocsr()
        self.n = A.shape[0]
        deg_w = np.asarray(A.sum(axis=0)).ravel()  # weighted, like the ref
        with np.errstate(divide="ignore"):
            inv_log = 1.0 / np.log(deg_w)
            inv = 1.0 / deg_w
        f_by_kind = {
            "CN": np.ones(self.n, np.float32),
            "AA": np.where(np.isfinite(inv_log), inv_log, 0).astype(np.float32),
            "RA": np.where(np.isfinite(inv), inv, 0).astype(np.float32),
        }
        # one more entry each, read by the pad id n: f of a pad is 0
        self.f_by_kind = {
            k: torch.from_numpy(np.append(f, np.float32(0))).to(self.device)
            for k, f in f_by_kind.items()}
        # the row length buckets a link; a pad position reads the sentinel
        # appended to indices (id n) and data (weight 0)
        self.deg = np.diff(A.indptr)
        self._indptr = torch.from_numpy(A.indptr.astype(np.int64)).to(
            self.device)
        self._indices = torch.from_numpy(np.append(
            A.indices.astype(np.int64), self.n)).to(self.device)
        self._data = torch.from_numpy(np.append(
            A.data.astype(np.float32), np.float32(0))).to(self.device)
        max_deg = max(int(self.deg.max()), 1) if self.n else 1
        if not buckets:
            buckets, b = [], 32
            while b < max_deg:
                buckets.append(b)
                b *= 8
            buckets.append(1 << (max_deg - 1).bit_length())
        self.buckets = tuple(buckets)
        if self.buckets[-1] < max_deg:
            # a link whose max endpoint degree exceeds every bucket would
            # match no bucket in scores() and silently keep score 0.0 —
            # for exactly the highest-signal hub pairs
            raise ValueError(
                f"buckets {self.buckets} do not cover the graph's max "
                f"degree {max_deg}; add a bucket >= {max_deg} (default "
                f"buckets are derived from the graph and always cover it)")
        self.chunk_elems = chunk_elems

    def bucket_of(self, links: np.ndarray) -> np.ndarray:
        """Each link's bucket index: the first width that holds the larger
        of its endpoints' row lengths."""
        need = np.maximum(self.deg[links[:, 0]], self.deg[links[:, 1]])
        return np.searchsorted(np.asarray(self.buckets), need)

    def _padded(self, nodes: torch.Tensor, D: int):
        """[B, D] neighbour ids (pad = n, matches nothing) + weights."""
        start = self._indptr[nodes]
        count = self._indptr[nodes + 1] - start
        col = torch.arange(D, device=self.device)
        pos = torch.where(col < count[:, None], start[:, None] + col,
                          self._indices.shape[0] - 1)
        return self._indices[pos], self._data[pos]

    @staticmethod
    def _score_chunk(nu, wu, nv, wv, fu) -> torch.Tensor:
        eq = nu[:, :, None] == nv[:, None, :]
        # the one [B, D, D] float temporary
        hit = torch.where(eq, wv[:, None, :], 0.0).sum(dim=2)
        return (hit * (wu * fu)).sum(dim=1)

    def scores(self, links: np.ndarray, kind: str = "CN") -> np.ndarray:
        f = self.f_by_kind[kind]
        links = np.asarray(links, dtype=np.int64)
        out = torch.zeros(len(links), dtype=torch.float32, device=self.device)
        bucket_of = self.bucket_of(links)
        dev_links = torch.from_numpy(links).to(self.device)
        for bi, D in enumerate(self.buckets):
            sel = np.nonzero(bucket_of == bi)[0]
            if not len(sel):
                continue
            B = max(1, min(len(sel), self.chunk_elems // (D * D)))
            # pad the last chunk with a link from THIS bucket: a global
            # index-0 pad may have a higher degree than D
            pad = -len(sel) % B
            dev_sel = torch.from_numpy(np.concatenate(
                [sel, np.full(pad, sel[0], np.int64)])).to(self.device)
            for s in range(0, len(sel), B):
                idx = dev_sel[s:s + B]
                pair = dev_links[idx]
                nu, wu = self._padded(pair[:, 0], D)
                nv, wv = self._padded(pair[:, 1], D)
                res = self._score_chunk(nu, wu, nv, wv, f[nu])
                real = min(B, len(sel) - s)
                out[idx[:real]] = res[:real]
        return out.cpu().numpy()
