"""Knowledge-graph-embedding baselines: transE, distMult, complEx, rotatE
(the JAX package's models/transx.py; reference src/models/transx.py,
adapted there from the OGB biokg examples).

The entity and relation rows of a batch are looked up by ``gather_rows``
(each row's gradient summed in a fixed order by K1's add, where
indexing's backward adds with atomics on the card); the training loss
takes every entity row of a step, positives and negatives, in one
lookup, so the [entities, dim] gradient is written once a step.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from subgraph_sketching_tpu_torch.ops.segment_scan import gather_rows

KGE_MODELS = ("transE", "distmult", "complEx", "rotatE")


class KGEModel(nn.Module):
    """Scores triples; ``mode`` follows the reference (transx.py:84-155):
    'single' scores [B] triples, 'head-batch' / 'tail-batch' score B x K
    corrupted triples.  Parameters ``entity_embedding`` [nentity,
    entity_dim] and ``relation_embedding`` [nrelation, relation_dim],
    uniform in ±(gamma + 2) / hidden_dim (``reset_parameters``)."""

    def __init__(self, model_name: str, nentity: int, nrelation: int,
                 hidden_dim: int, gamma: float, criterion: str = "nll",
                 double_entity_embedding: bool = False,
                 double_relation_embedding: bool = False):
        super().__init__()
        if model_name == "rotatE" and (not double_entity_embedding
                                       or double_relation_embedding):
            raise ValueError("rotatE should use double_entity_embedding")
        if model_name == "complEx" and not (double_entity_embedding
                                            and double_relation_embedding):
            raise ValueError("complEx should use double entity and relation "
                             "embeddings")
        if model_name not in KGE_MODELS:
            raise ValueError(f"unknown KGE model {model_name}")
        self.model_name = model_name
        self.gamma = float(gamma)
        self.criterion = criterion
        self.embedding_range = (self.gamma + 2.0) / hidden_dim
        entity_dim = hidden_dim * 2 if double_entity_embedding else hidden_dim
        relation_dim = (hidden_dim * 2 if double_relation_embedding
                        else hidden_dim)
        self.entity_embedding = nn.Parameter(torch.empty(nentity, entity_dim))
        self.relation_embedding = nn.Parameter(
            torch.empty(nrelation, relation_dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        r = self.embedding_range
        with torch.no_grad():
            for p in (self.entity_embedding, self.relation_embedding):
                nn.init.uniform_(p, -r, r, generator=generator)

    # -- scoring functions (reference transx.py:176-239) --------------------
    def _score(self, head, relation, tail, mode: str) -> torch.Tensor:
        head_batch = mode == "head-batch"
        if self.model_name == "transE":
            s = (head + (relation - tail) if head_batch
                 else (head + relation) - tail)
            return s.abs().sum(dim=2)
        if self.model_name == "distmult":
            s = (head * (relation * tail) if head_batch
                 else (head * relation) * tail)
            return s.sum(dim=2)
        if self.model_name == "complEx":
            re_h, im_h = torch.chunk(head, 2, dim=2)
            re_r, im_r = torch.chunk(relation, 2, dim=2)
            re_t, im_t = torch.chunk(tail, 2, dim=2)
            if head_batch:
                re_s = re_r * re_t + im_r * im_t
                im_s = re_r * im_t - im_r * re_t
                s = re_h * re_s + im_h * im_s
            else:
                re_s = re_h * re_r - im_h * im_r
                im_s = re_h * im_r + im_h * re_r
                s = re_s * re_t + im_s * im_t
            return s.sum(dim=2)
        re_h, im_h = torch.chunk(head, 2, dim=2)   # rotatE
        re_t, im_t = torch.chunk(tail, 2, dim=2)
        phase = relation / (self.embedding_range / math.pi)
        re_r, im_r = torch.cos(phase), torch.sin(phase)
        if head_batch:
            re_s = re_r * re_t + im_r * im_t - re_h
            im_s = re_r * im_t - im_r * re_t - im_h
        else:
            re_s = re_h * re_r - im_h * im_r - re_t
            im_s = re_h * im_r + im_h * re_r - im_t
        return self.gamma - torch.sqrt(re_s ** 2 + im_s ** 2).sum(dim=2)

    def score_triples(self, heads: torch.Tensor, relations: torch.Tensor,
                      tails: torch.Tensor,
                      mode: str = "single") -> torch.Tensor:
        """heads/tails: [B] or [B, K] entity ids; relations: [B] ids."""
        h = gather_rows(self.entity_embedding, heads)
        t = gather_rows(self.entity_embedding, tails)
        r = gather_rows(self.relation_embedding, relations)[:, None, :]
        h = h[:, None, :] if h.dim() == 2 else h
        t = t[:, None, :] if t.dim() == 2 else t
        return self._score(h, r, t, mode)

    def score_links(self, links: torch.Tensor) -> torch.Tensor:
        """Relation-free link scoring, the reference's 'single' use
        (transx.py:88-100: relation 0 for every link)."""
        rel = torch.zeros(links.shape[0], dtype=torch.int64,
                          device=links.device)
        return self.score_triples(links[:, 0], rel, links[:, 1]).squeeze(-1)

    # -- training -----------------------------------------------------------
    def loss(self, pos: torch.Tensor, negs: torch.Tensor, mode: str,
             negative_adversarial_sampling: bool = False,
             adversarial_temperature: float = 1.0,
             regularization: float = 0.0) -> torch.Tensor:
        """The negative-sampling loss of one batch (transx.py:241-298):
        ``pos`` [B, 3] (head, relation, tail) triples, ``negs`` [B, K]
        corrupted heads (``head-batch``) or tails (``tail-batch``).
        ``criterion`` 'nll' is the log-sigmoid NLL, self-adversarial (the
        negatives weighted by a detached softmax of their scores) with
        ``negative_adversarial_sampling``; 'mrl' the margin ranking loss
        max(0, gamma - (pos - neg)).  ``regularization`` adds the L3
        penalty of complEx/distMult (transx.py:276-282)."""
        b = pos.shape[0]
        rows = gather_rows(self.entity_embedding,
                           torch.cat([pos[:, 0], pos[:, 2],
                                      negs.reshape(-1)]))
        head, tail = rows[:b, None, :], rows[b:2 * b, None, :]
        neg = rows[2 * b:].view(*negs.shape, -1)
        rel = gather_rows(self.relation_embedding, pos[:, 1])[:, None, :]
        neg_score = (self._score(neg, rel, tail, mode)
                     if mode == "head-batch"
                     else self._score(head, rel, neg, mode))
        pos_score = self._score(head, rel, tail, "single").squeeze(-1)
        if self.criterion == "mrl":
            loss = torch.clamp(self.gamma - (pos_score[:, None] - neg_score),
                               min=0.0).mean()
        else:
            if negative_adversarial_sampling:
                w = torch.softmax(neg_score * adversarial_temperature,
                                  dim=1).detach()
                neg_term = (w * F.logsigmoid(-neg_score)).sum(dim=1)
            else:
                neg_term = F.logsigmoid(-neg_score).mean(dim=1)
            loss = -(F.logsigmoid(pos_score).mean() + neg_term.mean()) / 2
        if regularization:
            loss = loss + regularization * (
                self.entity_embedding.abs().pow(3).sum()
                + self.relation_embedding.abs().pow(3).sum())
        return loss
