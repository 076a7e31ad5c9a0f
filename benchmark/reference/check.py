"""The comparison that decides ``correct``: the reference run on the
cell's own inputs, and the gaps between its numbers and the program's.

The reference computes in float64 from the same inputs and weights, so
its own rounding stays far below the float32 program's.  (A float32
reference read 8.9e-6 in the loss, 4.8e-5 in the first gradient and
6.5e-4 in the change on one ELPH seed where the program lay within 1e-6
of the float64 one: its own rounding.)

The model is the configuration's ``reference/<model>.py``.

Training (the checked steps of ``drivers/train.py``): the first step's
loss; the first gradient by leaf (the program's from Adam's first moment
after step 1), at the worst leaf; the parameters' change over the
checked steps by leaf, at the median leaf.  Each leaf's number is the gap
between the program's norm and the reference's, over the larger of the
reference's norm of that leaf and of the median leaf.  Leaves whose reference gradient is under a thousandth
of the median leaf's (a bias right before a BatchNorm: its gradient is
nought to rounding, and Adam moves it by round-off alone) are left out of
the gradient and of the change.

The control puts the reference in the program's place at float32 with
TF32 matrix products (``dtype`` float32, ``tf32``), the precision below
the configuration's float32 with TF32 off; ``fault`` plants a fault in
it (``half_batch``: the loss is the mean over half of each batch).
"""

from __future__ import annotations

import importlib
from contextlib import contextmanager

import numpy as np
import torch

from benchmark.reference import models, sketches


@contextmanager
def matmul_precision(tf32: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _drop(c: dict) -> dict:
    return {"label": c["label_dropout"], "feature": c["feature_dropout"],
            "sign": c["sign_dropout"]}


def _cast(weights: dict, dtype) -> dict:
    return {k: v.to(dtype) if v.is_floating_point() else v.clone()
            for k, v in weights.items()}


def model(name: str):
    """The plain model a configuration names (``reference/<model>.py``,
    the name in lower case)."""
    return importlib.import_module(f"benchmark.reference.{name.lower()}")


def _graph_state(conf: dict, inputs, dtype):
    """The reference's resident state: the sketches and the model's node
    state over the normalised adjacency."""
    c = conf["config"]
    src, dst = inputs.sym[0], inputs.sym[1]
    mh, hll, cards = sketches.sketch_tables(
        src, dst, inputs.n, c["minhash_num_perm"], c["hll_p"],
        c["max_hash_hops"])
    adj = models.gcn_adjacency(src, dst, inputs.sym_w, inputs.n, dtype)
    state = model(c["model"]).node_state(inputs.x.to(dtype), adj, c)
    state.update(mh=mh, hll=hll, cards=cards, dtype=dtype)
    return state


def _features(state, links, p):
    return sketches.link_features(links, state["mh"], state["hll"],
                                  state["cards"], p).to(state["dtype"])


def reference_train(conf: dict, inputs, weights: dict, checked: dict,
                    device, dtype=torch.float64, tf32: bool = False,
                    fault: str = None) -> dict:
    c = conf["config"]
    drop = _drop(c)
    net = model(c["model"])
    names = list(checked["grad"])
    P = _cast(weights, dtype)
    for k in names:
        P[k].requires_grad_(True)
    adam = models.Adam({k: P[k] for k in names}, lr=c["lr"])
    links, labels = inputs.links, inputs.labels.to(dtype)
    B = c["batch_size"]
    with matmul_precision(tf32):
        state = _graph_state(conf, inputs, dtype)
        losses, first = [], None
        for order, seed in zip(checked["orders"], checked["seeds"]):
            gen = torch.Generator(device=device).manual_seed(seed)
            for j in range(len(order) // B):
                idx = order[j * B:(j + 1) * B]
                pair, y = links[idx], labels[idx]
                sf = _features(state, pair, c["hll_p"])
                logit = net.logits(P, state, sf, pair, c, drop, gen, True)
                if fault == "half_batch":
                    logit, y = logit[:B // 2], y[:B // 2]
                loss = models.bce(logit, y)
                grads = torch.autograd.grad(loss, [P[k] for k in names])
                g = dict(zip(names, grads))
                if first is None:
                    first = {k: v.detach().clone() for k, v in g.items()}
                adam.step(P, g)
                losses.append(float(loss.detach()))
    return {"losses": losses, "grad": first, "before": _cast(weights, dtype),
            "after": {k: P[k].detach() for k in names}}


def _leaf_gaps(prog: dict, ref: dict) -> dict:
    """Each leaf's gap between the norms of two leaf dicts, over the
    leaves of ``ref``."""
    rn = {k: float(ref[k].double().norm()) for k in ref}
    pn = {k: float(prog[k].double().norm()) for k in ref}
    med = float(np.median(list(rn.values())))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in ref}


def train_gaps(checked: dict, ref: dict) -> dict:
    """The first step's loss gap, the first gradient's (worst leaf) and
    the change's (median leaf).  The later steps' losses and one leaf's
    change over three Adam steps swing with the sign Adam gives the
    near-zero elements of a gradient, which round-off decides (PERF.md,
    PR 18), so they are reported beside them and not compared."""
    gap = [abs(a - b) / abs(b) for a, b in zip(checked["losses"],
                                              ref["losses"])]
    gnorm = {k: float(v.double().norm()) for k, v in ref["grad"].items()}
    med = float(np.median(list(gnorm.values())))
    moved = {k for k, v in gnorm.items() if v >= 1e-3 * med}
    grad = _leaf_gaps(checked["grad"], {k: ref["grad"][k] for k in moved})
    before = ref["before"]
    d_prog = {k: checked["after"][k].double() - before[k].double()
              for k in moved}
    d_ref = {k: ref["after"][k].double() - before[k].double() for k in moved}
    change = _leaf_gaps(d_prog, d_ref)
    g_leaf, c_leaf = max(grad, key=grad.get), max(change, key=change.get)
    return {"numbers": {"loss_gap": gap[0], "grad_gap": grad[g_leaf],
                        "change_gap": float(np.median(list(
                            change.values())))},
            "notes": {"later_loss_gap": max(gap[1:], default=0.0),
                      "grad_leaf": g_leaf, "grad_median": float(np.median(
                          list(grad.values()))),
                      "change_worst": change[c_leaf], "change_leaf": c_leaf,
                      "left_out": sorted(set(gnorm) - moved),
                      "losses": checked["losses"],
                      "ref_losses": ref["losses"]}}
