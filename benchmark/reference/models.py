"""What the plain models share (Chamberlain et al., ICLR 2023; the
authors' src/models/elph.py and gnn.py): layers as functions of a
parameter dictionary named as the benchmark hands the weights to both
sides, the GCN normalisation, SIGN features, the BCE loss and Adam.  Each
model is ``reference/<model>.py``.

Dropout masks come from the ``torch.Generator`` given, drawn as one
float32 Bernoulli(1 - p) tensor of the activation's shape each time, in
the order the layers run, kept units scaled by 1 / (1 - p).  BatchNorm in
training normalises by the batch mean and biased variance, in evaluation
by the running statistics; eps 1e-5.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
EPS = 1e-5


def gcn_adjacency(src: torch.Tensor, dst: torch.Tensor,
                  weight: Optional[torch.Tensor], n: int,
                  dtype=torch.float32) -> torch.Tensor:
    """D^-1/2 (A + I) D^-1/2 as a coalesced sparse [n, n] tensor whose
    row is the destination: repeated edges sum their weights, every node
    gets a self-loop of weight 1, the degree is the weighted in-degree."""
    w = (torch.ones(src.numel(), dtype=dtype, device=src.device)
         if weight is None else weight.to(dtype))
    loop = torch.arange(n, device=src.device)
    idx = torch.stack([torch.cat([dst, loop]), torch.cat([src, loop])])
    val = torch.cat([w, torch.ones(n, dtype=dtype, device=src.device)])
    a = torch.sparse_coo_tensor(idx, val, (n, n)).coalesce()
    row, col = a.indices()
    deg = torch.zeros(n, dtype=dtype, device=src.device).index_add_(
        0, row, a.values())
    dis = deg.pow(-0.5)
    dis[torch.isinf(dis)] = 0
    return torch.sparse_coo_tensor(a.indices(),
                                   dis[row] * a.values() * dis[col],
                                   (n, n)).coalesce()


def sign_features(x: torch.Tensor, adj: torch.Tensor, k: int) -> torch.Tensor:
    """[x, Ax, ..., A^k x] (k > 0) or Ax (k = 0)."""
    if k == 0:
        return torch.sparse.mm(adj, x)
    xs = [x]
    for _ in range(k):
        xs.append(torch.sparse.mm(adj, xs[-1]))
    return torch.cat(xs, dim=1)


def dropout(x: torch.Tensor, p: float, gen, train: bool) -> torch.Tensor:
    if not train or p == 0:
        return x
    keep = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    keep.bernoulli_(1 - p, generator=gen)
    return x * keep / (1 - p)


def dense(P: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    b = P.get(f"{name}.bias")
    out = x @ P[f"{name}.weight"].t()
    return out if b is None else out + b


def batch_norm(P: Params, name: str, x: torch.Tensor,
               train: bool) -> torch.Tensor:
    if train:
        mean = x.mean(0)
        var = ((x - mean) ** 2).mean(0)
    else:
        mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
    return ((x - mean) / torch.sqrt(var + EPS) * P[f"{name}.weight"]
            + P[f"{name}.bias"])


def bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (-labels * F.logsigmoid(logits)
            - (1 - labels) * F.logsigmoid(-logits)).mean()


class Adam:
    """Adam (Kingma and Ba) with bias correction, eps outside the root."""

    def __init__(self, params: Params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: Params, grads: Params) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k] / c2).sqrt_().add_(self.eps)
            params[k].addcdiv_(self.m[k], denom, value=-self.lr / c1)
