"""Online link scoring with a trained BUDDY model.

Counterpart of the JAX package's serving.py ``LinkScorer``: the per-hop
sketch stacks, the SIGN-propagated node features, the degrees and the
model stay resident on the device, and a query batch computes subgraph
features straight from the sketches (the same math as preprocessing,
including the zero-one knockout / floor) and runs the BUDDY MLP.

Checkpoints: a directory holding ``config.json`` (the ``Config``) and
either ``step_<N>.pt`` files from a training run (``runners/run.py`` with
``--checkpoint_dir``) or ``buddy.pt`` (a ``BUDDY`` state_dict), written by
:func:`save_buddy_checkpoint`.  Weights trained by the JAX package cross
over through ``models/convert.py``.

Not ported yet (queued): streaming edge insert/delete, the ELPH scorer, the
RA and node-embedding inputs (a ``use_RA`` config is refused).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.device import resolve_device
from subgraph_sketching_tpu_torch.graph.preprocess import (
    LinkDataset, sketch_params_from_config,
)
from subgraph_sketching_tpu_torch.models.buddy import BUDDY
from subgraph_sketching_tpu_torch.sketch.elph import subgraph_features
from subgraph_sketching_tpu_torch.sketch.params import Sketches

CONFIG_FILE = "config.json"
WEIGHTS_FILE = "buddy.pt"


def _refuse_unported(cfg: Config) -> None:
    if cfg.use_RA:
        raise NotImplementedError(
            "serving a use_RA model is not ported yet: the scorer computes "
            "no RA scores for its queries (queued with the other serving "
            "inputs); train without --use_RA to serve on the port")


class LinkScorer:
    """Serve scores for arbitrary (src, dst) pairs.

    Parameters
    ----------
    cfg: the run's Config.
    model: a BUDDY built for ``cfg`` (put in eval mode and moved to
        ``device`` here).
    dataset: the served split's LinkDataset — must retain ``sketches`` and
        carry x/degrees.
    min_bucket: the batch size ``warmup`` scores.
    max_bucket: larger queries are scored in chunks of this many links.
    """

    def __init__(self, cfg: Config, model: BUDDY, dataset: LinkDataset,
                 min_bucket: int = 1024, max_bucket: int = 1 << 18,
                 device="cuda"):
        _refuse_unported(cfg)
        if dataset.sketches is None and cfg.use_struct_feature:
            raise ValueError(
                "serving needs the sketch stacks: build the dataset with "
                "build_link_dataset so LinkDataset.sketches is retained")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model.to(self.device).eval()
        self.sketch_params = sketch_params_from_config(cfg)
        # under --use_struct_feature 0 the model was trained on zeroed
        # structure features (reference train.py:58) — serve the same zeros
        self.sk = None
        if cfg.use_struct_feature:
            self.sk = Sketches(*(t.to(self.device)
                                 for t in dataset.sketches))
        self.num_nodes = dataset.num_nodes
        self.x = (torch.from_numpy(np.asarray(dataset.x)).to(self.device)
                  if model.use_feature and dataset.x is not None else None)
        self.deg = torch.from_numpy(
            np.asarray(dataset.degrees, dtype=np.float32)).to(self.device)
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket

    @torch.inference_mode()
    def _score_batch(self, links: torch.Tensor) -> torch.Tensor:
        if self.sk is not None:
            sf = subgraph_features(links, self.sk, self.sketch_params)
        else:
            sf = torch.zeros((links.shape[0], self.sketch_params.sf_dim),
                             device=self.device)
        out = self.model(
            sf, node_features=None if self.x is None else self.x[links],
            src_degree=self.deg[links[:, 0]],
            dst_degree=self.deg[links[:, 1]])
        return out.ravel()

    def score(self, links: np.ndarray) -> np.ndarray:
        """Scores (logits) for [B, 2] int link pairs, any B ≥ 0."""
        links = np.asarray(links, dtype=np.int64).reshape(-1, 2)
        if len(links) and (links.min() < 0 or links.max() >= self.num_nodes):
            raise ValueError(f"link ids must be in [0, {self.num_nodes}); "
                             f"got [{links.min()}, {links.max()}]")
        outs = [self._score_batch(
                    torch.from_numpy(links[s:s + self.max_bucket])
                    .to(self.device)).cpu().numpy()
                for s in range(0, len(links), self.max_bucket)]
        return np.concatenate(outs) if outs else np.zeros((0,), np.float32)

    def warmup(self, buckets: Optional[list] = None) -> None:
        """Score one batch of each given size (default: min_bucket), so the
        first query does not pay one-time costs (kernel load, allocator)."""
        for b in (buckets or [self.min_bucket]):
            self.score(np.zeros((b, 2), np.int64))


def save_buddy_checkpoint(checkpoint_dir: str, cfg: Config,
                          model: BUDDY) -> None:
    """Write ``config.json`` and ``buddy.pt`` (the model's state_dict)."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    with open(os.path.join(checkpoint_dir, CONFIG_FILE), "w") as f:
        f.write(cfg.to_json())
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(checkpoint_dir, WEIGHTS_FILE))


def scorer_from_checkpoint(checkpoint_dir: str, cfg: Optional[Config] = None,
                           split: str = "train", min_bucket: int = 1024,
                           max_bucket: int = 1 << 18,
                           device="cuda") -> LinkScorer:
    """Rebuild the serving stack from a checkpoint directory: re-run the
    deterministic preprocessing on ``device``, load the weights, and return
    a ready LinkScorer.  ``split`` picks the message graph served against.

    The weights are the newest ``step_<N>.pt`` that a training run with
    ``--checkpoint_dir D`` (``--save_model`` or ``--checkpoint_every``)
    wrote, with ``restored_step`` set to N; without one, ``buddy.pt``
    from :func:`save_buddy_checkpoint` (``restored_step`` None)."""
    from subgraph_sketching_tpu_torch.graph.datasets import get_data
    from subgraph_sketching_tpu_torch.graph.preprocess import build_all_splits
    from subgraph_sketching_tpu_torch.train.checkpoint import (
        latest_step, load_checkpoint,
    )

    dev = resolve_device(device)
    if cfg is None:
        path = os.path.join(checkpoint_dir, CONFIG_FILE)
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path} not found — pass cfg= "
                                    f"explicitly")
        with open(path) as f:
            cfg = Config.from_json(f.read())
    if cfg.model != "BUDDY":
        raise NotImplementedError(f"serving {cfg.model} is not ported yet")
    _refuse_unported(cfg)
    splits, directed, _ = get_data(cfg)
    datasets = build_all_splits(splits, cfg, directed=directed, device=dev)
    x = datasets["train"].x
    model = BUDDY.from_config(cfg, None if x is None else x.shape[-1])
    step = latest_step(checkpoint_dir)
    if step is not None:
        saved, step = load_checkpoint(checkpoint_dir, step)
        state = saved["model"]
    else:
        state = torch.load(os.path.join(checkpoint_dir, WEIGHTS_FILE),
                           map_location="cpu", weights_only=True)
    model.load_state_dict(state)
    scorer = LinkScorer(cfg, model, datasets[split], min_bucket=min_bucket,
                        max_bucket=max_bucket, device=dev)
    scorer.restored_step = step
    return scorer
