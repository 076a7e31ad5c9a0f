"""BUDDY training and inference loops of the port (the JAX package's
train/loops.py, BUDDY part).

As in the JAX package:

  * every per-link tensor of a split lives on the device, packed into one
    [L, F] float32 row array (sf ‖ label ‖ src degree ‖ dst degree, and
    ‖ RA with ``use_RA``);
  * an epoch walks a device-side permutation; the last batch is padded
    with index -1, which reads link 0 and is masked out of the loss only
    (the padding rows do enter the BatchNorm batch statistics, as in the
    JAX package);
  * Adam with torch-style weight decay (decay added to the gradient).

An epoch is a function of (model, optimizer, seed): the shuffle and every
dropout mask come from one ``torch.Generator`` on the device, seeded by
:func:`epoch_seed` from (rep, epoch), the counterpart of the JAX runner's
``fold_in(PRNGKey(rep), epoch)``.  The step losses stay on the device and
are read once per epoch.

Not ported yet (queued): node embeddings (``BuddyWithEmbedding``), the
data-parallel mesh, ``dtype`` other than float32, and the ELPH trainer.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.device import resolve_device
from subgraph_sketching_tpu_torch.graph.preprocess import LinkDataset
from subgraph_sketching_tpu_torch.models.buddy import BUDDY
from subgraph_sketching_tpu_torch.train.losses import get_loss


def make_optimizer(cfg: Config, params) -> torch.optim.Adam:
    """Adam at ``cfg.lr`` with ``cfg.weight_decay`` added to the gradient:
    optax's ``add_decayed_weights`` then ``adam`` (eps 1e-8 outside the
    sqrt), the JAX package's optimizer."""
    return torch.optim.Adam(params, lr=cfg.lr, weight_decay=cfg.weight_decay)


def epoch_seed(rep: int, epoch: int) -> int:
    """The seed of epoch ``epoch`` of repetition ``rep``: distinct for every
    (rep, epoch), so reps do not share a stream."""
    return (rep << 32) | epoch


def eval_subset(total: int, n_samples, dataset_name: str = "",
                num_pos: Optional[int] = None) -> np.ndarray:
    """Indices to evaluate when subsampling a split.

    The reference shuffles its val/test loaders so taking the first n gives a
    random pos/neg mix (data.py:47-54); a plain prefix would be all
    positives.  citation2 keeps aligned same-source negatives and must stay
    ordered (data.py:48-49): links are [all positives] ++ [per-positive
    negative blocks], so the subsample takes the first k positives PLUS
    their k*negs_per_pos aligned negatives.  Pass ``num_pos`` (the split's
    positive count) to enable that; trainers record it at staging.

    The subsample uses a FIXED seed (12345), so every repetition and epoch
    evaluates the same subset, as in the JAX package.
    """
    if n_samples is None or n_samples >= total:
        return np.arange(total, dtype=np.int32)
    if dataset_name.startswith("ogbl-citation"):
        if not num_pos or num_pos >= total:
            return np.arange(n_samples, dtype=np.int32)
        npp = (total - num_pos) // num_pos      # negatives per positive
        k = int(max(1, min(num_pos, n_samples // (npp + 1))))
        return np.concatenate([
            np.arange(k, dtype=np.int32),
            (num_pos + np.arange(k * npp)).astype(np.int32)])
    rng = np.random.default_rng(12345)
    return np.sort(rng.permutation(total)[:n_samples]).astype(np.int32)


def batched_predict(score_fn: Callable[[np.ndarray], torch.Tensor],
                    sel: np.ndarray, batch_size: int,
                    pad_value: int = 0) -> np.ndarray:
    """Shared eval loop: pad the tail batch to the uniform size, launch
    every batch before reading any result, then slice the pads off.

    ``score_fn(idx)`` receives an int32 [bs] index array (tail padded with
    ``pad_value``) and returns a [bs] tensor of scores."""
    n = len(sel)
    bs = min(batch_size, max(1, n))
    preds = []
    for s in range(0, n, bs):
        idx = sel[s:min(s + bs, n)]
        pad = bs - len(idx)
        if pad:
            idx = np.concatenate(
                [idx, np.full(pad, pad_value, dtype=np.int32)])
        out = score_fn(np.asarray(idx, dtype=np.int32))
        preds.append(out[:bs - pad] if pad else out)
    if not preds:
        return np.zeros((0,), np.float32)
    return torch.cat([torch.as_tensor(p).ravel() for p in preds]).cpu().numpy()


def _epoch_plan(num_links: int, batch_size: int,
                train_samples: float = math.inf) -> Tuple[int, int]:
    """(links used per epoch, steps).  Subsampling semantics follow reference
    get_num_samples (utils.py:32-43): a fraction if < 1, else a count."""
    n = num_links
    if train_samples < 1:
        n = int(train_samples * num_links)
    elif train_samples != math.inf:
        n = min(int(train_samples), num_links)
    return n, max(1, math.ceil(n / batch_size))


def _init_like_flax(model: nn.Module, generator: torch.Generator) -> None:
    """flax's initialisers: every Linear weight lecun-normal (a normal
    truncated at two standard deviations, scaled to variance 1/fan_in) and
    bias zero; BatchNorm at scale 1, bias 0 and unit running statistics."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                std = (1.0 / m.in_features) ** 0.5 / .87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()


class BuddyTrainer:
    """Owns the device-resident split data and the BUDDY step.

    The model and its optimizer are the caller's: ``init_model`` builds a
    model, ``make_optimizer`` its Adam, and ``train_epoch`` / ``predict``
    take them.
    """

    def __init__(self, cfg: Config, dataset: LinkDataset,
                 num_features: Optional[int], device="cuda"):
        if cfg.train_node_embedding or cfg.pretrained_node_embedding:
            raise NotImplementedError("BUDDY's node embeddings are not "
                                      "ported yet")
        if cfg.mesh_shape:
            raise NotImplementedError("the data-parallel mesh is not ported "
                                      "yet")
        if cfg.dtype not in (None, "float32", "f32"):
            raise NotImplementedError(f"--dtype {cfg.dtype} is not ported "
                                      f"yet (float32 only)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.use_feature = cfg.use_feature and dataset.x is not None
        self.num_features = num_features if self.use_feature else None
        self.loss_fn = get_loss(cfg.loss)
        self._data: Dict[str, Dict[str, torch.Tensor]] = {}
        self._num_pos: Dict[str, int] = {}
        self.stage("train", dataset)

    # -- data staging -------------------------------------------------------
    def stage(self, split: str, ds: LinkDataset) -> None:
        """Put one split's per-link data on the device: ``links``, ``rows``
        (sf ‖ label ‖ src degree ‖ dst degree ‖ RA with ``use_RA``, one
        [L, F] float32 array, so a batch is one row gather) and the node
        features ``x``."""
        sf = np.asarray(ds.subgraph_features, dtype=np.float32)
        labels = np.asarray(ds.labels, dtype=np.float32)[:, None]
        deg = np.asarray(ds.degrees, dtype=np.float32)
        links = np.asarray(ds.links, dtype=np.int64)
        cols = [sf, labels, deg[links[:, 0]][:, None],
                deg[links[:, 1]][:, None]]
        if self.cfg.use_RA:
            cols.append(np.asarray(ds.RA, dtype=np.float32)[:, None])
        rows = np.concatenate(cols, axis=1)
        d = {"links": torch.from_numpy(links).to(self.device),
             "rows": torch.from_numpy(rows).to(self.device)}
        if self.use_feature:
            d["x"] = torch.from_numpy(
                np.asarray(ds.x, dtype=np.float32)).to(self.device)
        self._sf_dim = sf.shape[1]
        self._data[split] = d
        # positive count, for pos/neg-aligned eval subsampling (citation2)
        self._num_pos[split] = int(np.asarray(ds.labels).sum())

    def _batch(self, data: Dict[str, torch.Tensor],
               idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Gather one batch by link indices (idx may hold -1 padding, which
        reads link 0 and is masked)."""
        safe = idx.clamp(min=0)
        links = data["links"][safe]
        rows = data["rows"][safe]
        c = self._sf_dim
        batch = {"sf": rows[:, :c], "labels": rows[:, c], "mask": idx >= 0,
                 "src_degree": rows[:, c + 1], "dst_degree": rows[:, c + 2],
                 "node_features": data["x"][links] if self.use_feature
                 else None,
                 "RA": rows[:, c + 3] if self.cfg.use_RA else None}
        if self.cfg.use_struct_feature is False:
            batch["sf"] = torch.zeros_like(batch["sf"])
        return batch

    @staticmethod
    def _apply(model: BUDDY, batch, generator=None) -> torch.Tensor:
        return model(batch["sf"], node_features=batch["node_features"],
                     src_degree=batch["src_degree"],
                     dst_degree=batch["dst_degree"], RA=batch["RA"],
                     generator=generator)

    # -- model --------------------------------------------------------------
    def init_model(self, seed: int) -> BUDDY:
        """A BUDDY for this run on the trainer's device, initialised as flax
        initialises it, from a CPU generator seeded with ``seed`` (so the
        same seed gives the same weights on every device)."""
        model = BUDDY.from_config(self.cfg, self.num_features)
        _init_like_flax(model, torch.Generator().manual_seed(seed))
        return model.to(self.device)

    # -- public API ---------------------------------------------------------
    def num_links(self, split: str) -> int:
        return int(self._data[split]["links"].shape[0])

    def run_epoch(self, model: BUDDY, optimizer: torch.optim.Optimizer,
                  seed: int, order: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
        """One epoch; returns the [steps] step losses, on the device.

        The generator seeded with ``seed`` draws the permutation (unless
        ``order``, a [n_used] index tensor, gives it) and then every dropout
        mask, step by step."""
        data = self._data["train"]
        bs = self.cfg.batch_size
        g = torch.Generator(device=self.device).manual_seed(seed)
        if order is None:
            n_used, _ = _epoch_plan(self.num_links("train"), bs,
                                    self.cfg.train_samples)
            order = torch.randperm(self.num_links("train"), generator=g,
                                   device=self.device)[:n_used]
        order = order.to(self.device, torch.int64)
        steps = max(1, math.ceil(len(order) / bs))
        pad = steps * bs - len(order)
        if pad:
            order = torch.cat([order, order.new_full((pad,), -1)])
        perm = order.view(steps, bs)
        model.train()
        losses = torch.empty(steps, device=self.device)
        for step in range(steps):
            batch = self._batch(data, perm[step])
            logits = self._apply(model, batch, g)
            loss = self.loss_fn(logits, batch["labels"], batch["mask"])
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            losses[step] = loss.detach()
        return losses

    def train_epoch(self, model: BUDDY, optimizer: torch.optim.Optimizer,
                    seed: int, order: Optional[torch.Tensor] = None) -> float:
        """One epoch (see ``run_epoch``); returns the reference's epoch
        loss, sum(step loss) * batch_size / num_links (train.py:77,89)."""
        losses = self.run_epoch(model, optimizer, seed, order)
        total = float(losses.sum()) * self.cfg.batch_size
        return total / self.num_links("train")

    @torch.inference_mode()
    def predict(self, model: BUDDY, split: str,
                n_samples: Optional[int] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
        """(pred, labels) over the split's links in order, batched at
        eval_batch_size (reference get_buddy_preds, inference.py:99-140)."""
        model.eval()
        data = self._data[split]
        total = self.num_links(split)
        sel = eval_subset(total, n_samples, self.cfg.dataset_name,
                          self._num_pos.get(split))

        def score(idx: np.ndarray) -> torch.Tensor:
            batch = self._batch(data, torch.from_numpy(idx).to(self.device))
            return self._apply(model, batch).ravel()

        # pad with -1: _batch reads link 0 for it, and the pads are sliced off
        pred = batched_predict(score, sel, self.cfg.eval_batch_size,
                               pad_value=-1)
        labels = data["rows"][:, self._sf_dim].cpu().numpy()[sel]
        return pred, labels
