"""citation2-scale BUDDY end to end on one card.

Counterpart of the JAX repository's ``tools/citation2_train.py``: the whole
training story at the north-star scale, resident on one device.

  1. host: a Watts-Strogatz ring (each node joined to its ``RING_K``
     nearest on either side, 10% of the edge heads rewired) from
     ``np.random.default_rng(seed)``, drawn in the JAX tool's order
     (rewiring, the edge permutation, the negatives, the MRR negatives),
     so the arrays at a given size and seed are the JAX tool's;
  2. the chunked plan (``SortedSegmentPlan(...).chunk(max_slots)``) with
     the gcn-norm weights staged for its add;
  3. hop-0 MinHash and HLL tables drawn on the device from a
     ``torch.Generator`` (random bits, one random register a node), then
     ``MAX_HOPS`` hops of min and max on the plan, K1 merging every chunk,
     and the hops-only stack;
  4. subgraph features for every train, val and MRR link, in chunks of
     ``feat_batch`` links resident on the device (a first and a steady
     pass);
  5. SIGN(k=0): the plan's weighted add (K1's float32 add per chunk) plus
     the self term;
  6. the port's BUDDY (hidden 256, Adam at 1e-4, BCE) for ``epochs``
     epochs of ``n_train // batch`` steps, each step gathering its rows
     from the resident tables;
  7. val AUC and Hits@50, and MRR over 100 same-source negatives per
     positive.

The data is synthetic: the quality numbers show learning at scale, not
parity with the reference on the real dataset.  Every stage is a function
of its inputs, so the tests hold each against the JAX package on the same
arrays; the hop-0 tables and the node features come from torch's
generator, which JAX's PRNG cannot reproduce, so a run's values differ
from the JAX tool's from the sketches on.

    python -m subgraph_sketching_tpu_torch.tools.citation2_train [--smoke]

runs on the card (``--device cpu`` runs the plain versions on the CPU) and
prints one JSON line per stage: seconds, links/s, chunks, peak memory,
the loss of every epoch, AUC, Hits@50 and MRR.  ``--smoke`` takes the JAX
tool's small sizes; each size has its own option.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from contextlib import contextmanager
from types import SimpleNamespace
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from subgraph_sketching_tpu_torch.device import (
    device_from_flags, resolve_device,
)
from subgraph_sketching_tpu_torch.models.buddy import BUDDY
from subgraph_sketching_tpu_torch.ops.segment_scan import (
    ChunkedSegmentPlan, SortedSegmentPlan,
)
from subgraph_sketching_tpu_torch.sketch.elph import subgraph_features
from subgraph_sketching_tpu_torch.sketch.hll import hll_count
from subgraph_sketching_tpu_torch.sketch.params import SketchParams, Sketches
from subgraph_sketching_tpu_torch.train.evaluation import (
    hits_at_k, mrr, roc_auc,
)
from subgraph_sketching_tpu_torch.train.loops import _init_like_flax
from subgraph_sketching_tpu_torch.train.losses import bce_loss

RING_K = 5          # 2 * RING_K directed edges per node
REWIRE = 0.10
MAX_HOPS = 2
HLL_P = 8
MAX_RANK = 40       # hop-0 registers hold a rank in [1, MAX_RANK)
LR = 1e-4
HITS_K = 50


@dataclasses.dataclass(frozen=True)
class Sizes:
    """A run's sizes (the JAX tool's constants)."""

    nodes: int = 2_927_963
    n_pos: int = 14_000_000       # train positives, and as many negatives
    n_val: int = 1_000_000        # val positives, and as many negatives
    mrr_pos: int = 10_000         # MRR positives (the first val positives)
    mrr_negs: int = 100           # same-source negatives per MRR positive
    batch: int = 262_144          # training batch B
    feat_batch: int = 262_144     # feature and prediction chunk BF
    epochs: int = 3
    num_perm: int = 128
    hidden: int = 256
    features: int = 128           # node feature width D
    max_slots: int = 4 << 20      # slot rows a plan chunk gathers, most


FULL = Sizes()
SMOKE = Sizes(nodes=20_011, n_pos=40_000, n_val=10_000, mrr_pos=100,
              batch=4_096, feat_batch=4_096, max_slots=1 << 16)


# ------------------------------------------------------------ host inputs --

def ws_graph(n: int, rng: np.random.Generator) -> tuple:
    """(src, dst, deg): the ring's 2·RING_K·n directed edges as int32, a
    REWIRE share of the heads redrawn uniformly, and each node's in- plus
    out-degree as float32.  Draws from ``rng`` in the JAX tool's order."""
    base = np.arange(n, dtype=np.int64)
    srcs, dsts = [], []
    for off in range(1, RING_K + 1):
        srcs += [base, base]
        dsts += [(base + off) % n, (base - off) % n]
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    rw = rng.random(len(src)) < REWIRE
    dst[rw] = rng.integers(0, n, int(rw.sum()), dtype=np.int32)
    deg = (np.bincount(src, minlength=n)
           + np.bincount(dst, minlength=n)).astype(np.float32)
    return src, dst, deg


class Links(NamedTuple):
    """The links of a run, on the host."""

    links: np.ndarray    # [n_all, 2] int32: train pos, neg; val pos, neg
    labels: np.ndarray   # [n_all] float32
    n_train: int
    mrr: np.ndarray      # [mrr_pos * (1 + mrr_negs), 2] int32: positives,
    #                      then each positive's negatives in turn
    mrr_pos: int


def make_links(src: np.ndarray, dst: np.ndarray, sizes: Sizes,
               rng: np.random.Generator) -> Links:
    """Positives drawn from the edges without replacement, uniform random
    negatives, and the MRR set: the first ``mrr_pos`` val positives, each
    with ``mrr_negs`` negatives of the same source.  Continues ``rng``
    after :func:`ws_graph`, as the JAX tool does."""
    n_pos, n_val, n = sizes.n_pos, sizes.n_val, sizes.nodes
    if n_pos + n_val > len(src) or sizes.mrr_pos > n_val:
        raise ValueError(f"{n_pos} + {n_val} positives from {len(src)} edges, "
                         f"{sizes.mrr_pos} MRR positives of {n_val}")
    perm_e = rng.permutation(len(src))
    pos_idx = perm_e[:n_pos + n_val]
    pos = np.stack([src[pos_idx], dst[pos_idx]], axis=1)
    neg = rng.integers(0, n, (n_pos + n_val, 2), dtype=np.int32)
    links = np.concatenate([pos[:n_pos], neg[:n_pos], pos[n_pos:],
                            neg[n_pos:]])
    labels = np.concatenate([np.ones(n_pos), np.zeros(n_pos), np.ones(n_val),
                             np.zeros(n_val)]).astype(np.float32)
    mrr_pos = pos[n_pos:n_pos + sizes.mrr_pos]
    mrr_neg = np.stack([np.repeat(mrr_pos[:, 0], sizes.mrr_negs),
                        rng.integers(0, n, sizes.mrr_pos * sizes.mrr_negs,
                                     dtype=np.int32)], axis=1)
    return Links(links, labels, 2 * n_pos, np.concatenate([mrr_pos, mrr_neg]),
                 len(mrr_pos))


def pad_rows(a: np.ndarray, mult: int) -> np.ndarray:
    """``a`` with zero rows appended up to a multiple of ``mult``."""
    pad = (-len(a)) % mult
    if not pad:
        return a
    return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])


def make_plan(src: np.ndarray, dst: np.ndarray, n: int, max_slots: int,
              device) -> ChunkedSegmentPlan:
    """The plan over the directed edges, streamed in chunks of at most
    ``max_slots`` slots."""
    return SortedSegmentPlan(np.stack([src, dst]), n,
                             device=device).chunk(max_slots)


def gcn_slots(plan: ChunkedSegmentPlan, src: np.ndarray, dst: np.ndarray,
              deg: np.ndarray) -> torch.Tensor:
    """The gcn-norm weights 1/sqrt((d_u + 1)(d_v + 1)) in the plan's slot
    order, on its device."""
    w = (1.0 / np.sqrt((deg[src] + 1.0) * (deg[dst] + 1.0))).astype(
        np.float32)
    return plan.stage_edge_data(w)


# ---------------------------------------------------------- device stages --

def hop0_tables(n: int, num_perm: int, hll_p: int,
                generator: torch.Generator) -> tuple:
    """(MinHash [n, num_perm] biased int32, HLL [n, 2^hll_p] int8) on the
    generator's device: uniform random lanes, and one register a node set
    to a rank in [1, MAX_RANK), the others 0."""
    dev = generator.device
    mh0 = torch.empty((n, num_perm), dtype=torch.int32, device=dev).random_(
        -2 ** 31, 2 ** 31, generator=generator)
    m = 1 << hll_p
    idx = torch.randint(0, m, (n,), device=dev, generator=generator)
    rank = torch.randint(1, MAX_RANK, (n,), dtype=torch.int8, device=dev,
                         generator=generator)
    hll0 = torch.zeros((n, m), dtype=torch.int8, device=dev)
    hll0[torch.arange(n, device=dev), idx] = rank
    return mh0, hll0


def build_sketches(plan, mh0: torch.Tensor, hll0: torch.Tensor,
                   params: SketchParams) -> Sketches:
    """``params.max_hops`` hops of MinHash min and HLL max on ``plan``
    from the hop-0 tables, with each hop's cardinalities: the hops-only
    stack (hop 0 left out)."""
    mhs, hlls, cards = [mh0], [hll0], []
    for _ in range(params.max_hops):
        mhs.append(plan.reduce(mhs[-1], "min"))
        hlls.append(plan.reduce(hlls[-1], "max"))
        cards.append(hll_count(hlls[-1], params.hll_p))
    return Sketches(minhash=torch.stack(mhs[1:]), hll=torch.stack(hlls[1:]),
                    cards=torch.stack(cards, dim=1))


def features_all(links: torch.Tensor, sk: Sketches, params: SketchParams,
                 chunk: int) -> torch.Tensor:
    """[len(links), sf_dim] float32 subgraph features of device-resident
    [L, 2] int64 ``links``, ``chunk`` links at a time."""
    out = torch.empty((len(links), params.sf_dim), dtype=torch.float32,
                      device=links.device)
    for s in range(0, len(links), chunk):
        out[s:s + chunk] = subgraph_features(links[s:s + chunk], sk, params)
    return out


def sign0(plan, x: torch.Tensor, deg: torch.Tensor,
          w_slots: torch.Tensor) -> torch.Tensor:
    """SIGN(k=0) node features: A_gcn x over the edges plus the self term
    x / (d + 1)."""
    return (plan.reduce(x, "add", edge_data_slots=w_slots)
            + x / (deg[:, None] + 1.0))


# ------------------------------------------------------ training and eval --

class Tables(NamedTuple):
    """What a step or a prediction gathers from, resident on the device."""

    sf: torch.Tensor       # [L, sf_dim] float32 per-link features
    links: torch.Tensor    # [L, 2] int64
    x: torch.Tensor        # [n, D] float32 node features
    deg: torch.Tensor      # [n] float32
    labels: Optional[torch.Tensor] = None   # [L] float32


def make_model(sizes: Sizes, params: SketchParams, device,
               dropout: float = 0.5, seed: int = 0) -> BUDDY:
    """The JAX tool's BUDDY (use_feature, sign_k 0, default dropouts)
    initialised as flax initialises it, from a CPU generator seeded with
    ``seed``; ``dropout`` sets the label and feature dropouts (the tests
    run at 0)."""
    model = BUDDY(sf_dim=params.sf_dim, hidden_channels=sizes.hidden,
                  num_features=sizes.features, use_feature=True, sign_k=0,
                  label_dropout=dropout, feature_dropout=dropout)
    _init_like_flax(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def batch_loss(model: BUDDY, t: Tables, idx: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The BCE loss of the links ``idx``, their rows gathered from ``t``."""
    lk = t.links[idx]
    logits = model(t.sf[idx], t.x[lk], t.deg[lk[:, 0]], t.deg[lk[:, 1]],
                   generator=generator)
    return bce_loss(logits, t.labels[idx])


def train_epoch(model: BUDDY, opt: torch.optim.Optimizer, t: Tables,
                order: torch.Tensor, batch: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``len(order) // batch`` Adam steps over the links of ``order`` in
    turn; the [steps] step losses, on the device."""
    model.train()
    steps = len(order) // batch
    losses = torch.empty(steps, dtype=torch.float32, device=t.sf.device)
    for i in range(steps):
        loss = batch_loss(model, t, order[i * batch:(i + 1) * batch],
                          generator)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses[i] = loss.detach()
    return losses


@torch.no_grad()
def predict_range(model: BUDDY, t: Tables, lo: int, n: int,
                  chunk: int) -> torch.Tensor:
    """[n] logits of rows [lo, lo + n), ``chunk`` rows a call: the last
    chunk is shifted left to keep its size, and only its unseen suffix is
    kept (``t`` holds at least ``chunk`` rows)."""
    model.eval()
    outs = []
    s0 = lo
    while s0 < lo + n:
        s0c = max(min(s0, lo + n - chunk), 0)
        lk = t.links[s0c:s0c + chunk]
        o = model(t.sf[s0c:s0c + chunk], t.x[lk], t.deg[lk[:, 0]],
                  t.deg[lk[:, 1]]).ravel()
        outs.append(o[s0 - s0c:])
        s0 = s0c + chunk
    return torch.cat(outs)[:n]


def evaluate(val_pred: np.ndarray, val_labels: np.ndarray,
             mrr_pred: np.ndarray, mrr_pos: int) -> dict:
    """Val AUC and Hits@50; MRR of each MRR positive among its own
    negatives (``mrr_pred``: the positives, then their negatives)."""
    pos, neg = val_pred[val_labels > 0.5], val_pred[val_labels < 0.5]
    return {"auc": roc_auc(val_pred, val_labels),
            f"hits@{HITS_K}": hits_at_k(torch.from_numpy(pos),
                                        torch.from_numpy(neg), HITS_K),
            "mrr": mrr(torch.from_numpy(mrr_pred[:mrr_pos]),
                       torch.from_numpy(mrr_pred[mrr_pos:]).reshape(
                           mrr_pos, -1))}


# ------------------------------------------------------------- the run ----

def _print(record: dict) -> None:
    print(json.dumps(record), flush=True)


class _Clock:
    """Stage records: seconds on the host clock around work that ends in
    a device synchronize, links/s where the record counts ``links``, and
    the device's peak memory so far on a card."""

    def __init__(self, dev: torch.device, log: Callable[[dict], None]):
        self.dev, self.log, self.records = dev, log, []

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    @contextmanager
    def stage(self, name: str, **fields):
        rec = {"stage": name, **fields}
        t0 = time.perf_counter()
        yield rec
        self.sync()
        rec["s"] = time.perf_counter() - t0
        if "links" in rec:
            rec["links_per_s"] = rec["links"] / rec["s"]
        if self.dev.type == "cuda":
            rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated(
                self.dev)
        self.records.append(rec)
        self.log(rec)


def run(sizes: Sizes = FULL, device="cuda", seed: int = 0,
        log: Callable[[dict], None] = _print,
        keep_inputs: bool = False) -> SimpleNamespace:
    """The whole pipeline at ``sizes`` on ``device``.  Returns
    ``records`` (one per stage, each also passed to ``log``),
    ``metrics`` and the state a caller may inspect further: the plan and
    its staged weights, the train and MRR tables, the model, its
    optimizer, the generator, the steps an epoch, the link arrays and,
    with ``keep_inputs``, the hop-0 tables and the node features ``x``
    that SIGN propagated."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = SketchParams(max_hops=MAX_HOPS, num_perm=sizes.num_perm,
                          hll_p=HLL_P)
    bf, n = sizes.feat_batch, sizes.nodes
    clock = _Clock(dev, log)
    t_start = time.perf_counter()
    rng = np.random.default_rng(seed)

    with clock.stage("graph", nodes=n) as r:
        src, dst, deg = ws_graph(n, rng)
        r["edges"] = len(src)
    with clock.stage("plan") as r:
        plan = make_plan(src, dst, n, sizes.max_slots, dev)
        r.update(chunks=plan.num_chunks, sub_runs=plan.base.num_subruns,
                 max_slots=sizes.max_slots, window_rows=plan.window)
    with clock.stage("links") as r:
        lk = make_links(src, dst, sizes, rng)
        r.update(train=lk.n_train, val=len(lk.links) - lk.n_train,
                 mrr=len(lk.mrr))
    with clock.stage("uploads") as r:
        w_slots = gcn_slots(plan, src, dst, deg)
        # the plan's device tables, made at first use: made here, so
        # their upload is timed in this stage
        plan.base.gather_idx, plan.ptrs
        links_dev = torch.from_numpy(pad_rows(lk.links, bf)).to(
            dev, torch.int64)
        mrr_dev = torch.from_numpy(pad_rows(lk.mrr, bf)).to(dev, torch.int64)
        labels_dev = torch.from_numpy(lk.labels).to(dev)
        deg_dev = torch.from_numpy(deg).to(dev)
        r["bytes"] = sum(a.numel() * a.element_size() for a in (
            plan.base.gather_idx, w_slots, links_dev, mrr_dev, labels_dev,
            deg_dev, *plan.ptrs))
    del src, dst
    gen = torch.Generator(device=dev).manual_seed(seed)
    with clock.stage("hop0"):
        mh0, hll0 = hop0_tables(n, sizes.num_perm, HLL_P, gen)
    with clock.stage("sketches", hops=MAX_HOPS) as r:
        sk = build_sketches(plan, mh0, hll0, params)
        r["mean_card"] = sk.cards.mean(dim=0).tolist()
        r["resident_bytes"] = (sk.minhash.numel() * 4 + sk.hll.numel())
    hop0 = (mh0, hll0) if keep_inputs else None
    del mh0, hll0
    with clock.stage("features",
                     links=len(lk.links) + len(lk.mrr)) as r:
        sf = features_all(links_dev, sk, params, bf)
        sf_mrr = features_all(mrr_dev, sk, params, bf)
        r["chunks"] = (len(links_dev) + len(mrr_dev)) // bf
    with clock.stage("features_steady", links=len(lk.links)):
        features_all(links_dev, sk, params, bf)
    del sk
    with clock.stage("sign", width=sizes.features) as r:
        x = torch.randn((n, sizes.features), generator=gen, device=dev)
        x_sign = sign0(plan, x, deg_dev, w_slots)
        r["chunks"] = plan.num_chunks
    x = x if keep_inputs else None

    with clock.stage("model", hidden=sizes.hidden):
        model = make_model(sizes, params, dev, seed=seed)
        opt = torch.optim.Adam(model.parameters(), lr=LR)
    tables = Tables(sf, links_dev, x_sign, deg_dev, labels_dev)
    steps = lk.n_train // sizes.batch
    losses = []
    for ep in range(sizes.epochs):
        with clock.stage("epoch", epoch=ep, steps=steps,
                         links=steps * sizes.batch) as r:
            order = torch.randperm(lk.n_train, generator=gen,
                                   device=dev)[:steps * sizes.batch]
            r["loss"] = float(train_epoch(model, opt, tables, order,
                                          sizes.batch, gen).mean())
        losses.append(r["loss"])

    mrr_tables = Tables(sf_mrr, mrr_dev, x_sign, deg_dev)
    with clock.stage("eval", links=len(lk.links) - lk.n_train
                     + len(lk.mrr)) as r:
        val_pred = predict_range(model, tables, lk.n_train,
                                 len(lk.links) - lk.n_train, bf)
        mrr_pred = predict_range(model, mrr_tables, 0, len(lk.mrr), bf)
        metrics = evaluate(val_pred.cpu().numpy(),
                           lk.labels[lk.n_train:], mrr_pred.cpu().numpy(),
                           lk.mrr_pos)
        r.update(metrics)
    metrics["epoch_loss"] = losses
    clock.records.append({"stage": "total",
                          "s": time.perf_counter() - t_start,
                          "device": str(dev), **metrics})
    log(clock.records[-1])
    return SimpleNamespace(
        records=clock.records, metrics=metrics, plan=plan, w_slots=w_slots,
        tables=tables, mrr_tables=mrr_tables, model=model, opt=opt,
        generator=gen, steps=steps, links=lk, hop0=hop0, x=x,
        params=params)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the JAX tool's small sizes (C2_SMOKE)")
    for f in dataclasses.fields(Sizes):
        ap.add_argument(f"--{f.name}", type=int, default=None,
                        help=f"default {f.default} (--smoke: "
                             f"{getattr(SMOKE, f.name)})")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: --platform's, else cuda)")
    ap.add_argument("--platform", default=None)
    args = ap.parse_args(argv)
    sizes = dataclasses.replace(
        SMOKE if args.smoke else FULL,
        **{f.name: getattr(args, f.name) for f in dataclasses.fields(Sizes)
           if getattr(args, f.name) is not None})
    return run(sizes, device_from_flags(args.device, args.platform),
               args.seed).metrics


if __name__ == "__main__":
    main()
