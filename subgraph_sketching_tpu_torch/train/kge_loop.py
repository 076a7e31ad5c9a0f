"""KGE trainer of the port (the JAX package's train/kge_loop.py): the
transE / distmult / complEx / rotatE baselines in the runner's trainer
protocol.

Link prediction as one-relation KGE: entities are nodes and every link
has relation 0 (the reference's own 'single' use, transx.py:88-100).  An
epoch takes ⌊train positives / B⌋ steps over a shuffled permutation: the
first half of the batches corrupts heads, the rest tails, each positive
with ``NUM_NEGS`` uniform random entities, under the self-adversarial
loss (transx.py:241-298).  The permutation and the negatives come from a
``torch.Generator`` on the device seeded with the epoch's seed; ``step``
takes one batch's (positives, negatives, mode), so a test can drive it
with the JAX package's draws.  Eval scores the split's links with
``score_links`` in ``eval_batch_size`` batches.  It trains in float32
whatever ``--dtype`` says, as the JAX package's kge_loop.py, which never
reads it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.device import resolve_device
from subgraph_sketching_tpu_torch.models.transx import KGE_MODELS, KGEModel
from subgraph_sketching_tpu_torch.train.loops import (
    batched_predict, eval_subset,
)

__all__ = ["KGE_MODELS", "KgeTrainer"]


class KgeTrainer:
    """The KGE step and evaluation over a run's splits (no sketches, no
    features)."""

    NUM_NEGS = 64          # corrupted entities per positive
    GAMMA = 12.0

    def __init__(self, cfg: Config, splits, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_nodes = splits["train"].graph.num_nodes
        pos = np.asarray(splits["train"].pos_edges, dtype=np.int64)
        self.batch = min(cfg.batch_size, max(1, len(pos)))
        self.steps = max(1, len(pos) // self.batch)
        self._pos = torch.from_numpy(pos).to(self.device)
        self._links = {s: torch.from_numpy(np.asarray(
            sd.links, dtype=np.int64)).to(self.device)
            for s, sd in splits.items()}
        self._labels = {s: np.asarray(sd.labels, dtype=np.float32)
                        for s, sd in splits.items()}
        self.train_eval_split = "train"

    def num_links(self, split: str) -> int:
        return int(self._links[split].shape[0])

    def init_model(self, seed: int) -> KGEModel:
        """A KGEModel for ``cfg.model`` (rotatE and complEx with double
        entity embeddings, complEx with double relation ones), initialised
        from a CPU generator seeded with ``seed``, on the device."""
        name = self.cfg.model
        model = KGEModel(name, nentity=self.num_nodes, nrelation=1,
                         hidden_dim=self.cfg.hidden_channels,
                         gamma=self.GAMMA,
                         double_entity_embedding=name in ("rotatE",
                                                          "complEx"),
                         double_relation_embedding=name == "complEx")
        model.reset_parameters(torch.Generator().manual_seed(seed))
        return model.to(self.device)

    def step(self, model: KGEModel, optimizer: torch.optim.Optimizer,
             pos: torch.Tensor, negs: torch.Tensor,
             mode: str) -> torch.Tensor:
        """One step on [B, 2] positive links and [B, K] negatives that
        replace their heads (``head-batch``) or tails (``tail-batch``);
        returns the loss, on the device."""
        triples = torch.stack([pos[:, 0], torch.zeros_like(pos[:, 0]),
                               pos[:, 1]], dim=1)
        loss = model.loss(triples, negs, mode,
                          negative_adversarial_sampling=True)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    def run_epoch(self, model: KGEModel, optimizer: torch.optim.Optimizer,
                  seed: int) -> torch.Tensor:
        """One epoch; returns its [steps] losses, on the device."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        B, steps = self.batch, self.steps
        perm = torch.randperm(len(self._pos), generator=g,
                              device=self.device)
        half = max(1, steps // 2)
        model.train()
        losses = []
        for mode, lo, k in (("head-batch", 0, half),
                            ("tail-batch", half, steps - half)):
            if k <= 0:
                continue
            idx = perm[lo * B:(lo + k) * B].view(k, B)
            negs = torch.randint(0, self.num_nodes, (k, B, self.NUM_NEGS),
                                 generator=g, device=self.device)
            for i in range(k):
                losses.append(self.step(model, optimizer,
                                        self._pos[idx[i]], negs[i], mode))
        return torch.stack(losses)

    def train_epoch(self, model: KGEModel, optimizer: torch.optim.Optimizer,
                    seed: int) -> float:
        """One epoch; returns the mean step loss."""
        return float(self.run_epoch(model, optimizer, seed).mean())

    @torch.inference_mode()
    def predict(self, model: KGEModel, split: str,
                n_samples: Optional[int] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
        model.eval()
        links, labels = self._links[split], self._labels[split]
        sel = eval_subset(len(labels), n_samples, self.cfg.dataset_name,
                          num_pos=int(labels.sum()))
        pred = batched_predict(
            lambda idx: model.score_links(
                links[torch.from_numpy(idx).to(self.device)]),
            sel, self.cfg.eval_batch_size)
        return pred, labels[sel]
