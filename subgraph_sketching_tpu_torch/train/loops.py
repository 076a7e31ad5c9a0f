"""BUDDY and ELPH training and inference loops of the port (the JAX
package's train/loops.py).

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

ELPH (:class:`ElphTrainer`) runs its full-graph GCN inside every step:
the SpMM is the staged ``PlanSpmm`` (forward and backward on K1) or, under
``--use_plan false`` or past ``max_gather_slots``, the scatter ``spmm``;
the sketches and subgraph features are built once at staging.

Node embeddings (``--train_node_embedding`` or
``--pretrained_node_embedding``, :class:`ElphEmbedding`, BUDDY's
:class:`BuddyWithEmbedding`): with ``--propagate_embeddings`` every step
diffuses the whole table ``sign_k`` times over the unweighted gcn_norm'd
train graph, through a staged ``PlanSpmm`` (K1 each way) or the scatter
``spmm``, and looks the batch's rows up by ``gather_rows``; eval diffuses
once by the scatter ``spmm``.

Data parallelism (``--mesh_shape W --mesh_axes data``, JAX's ``data``
axis): each of W ranks of the process group (``parallel/mesh.py``) holds
every table and the GCN's graph whole and takes its contiguous block of
each step's batch, the columns [r·B/W, (r+1)·B/W) of the global
[steps, B] order that every rank draws from the same generator (JAX's
``P(None, "data")``).  The link batch's BatchNorms and Dropouts work on
the global batch (``models/gnn.py`` ``shard_batch_axis``), the loss is
the global batch's, and the gradients are summed over the ranks before
``optimizer.step()``: a step is the single-device step on the whole
batch, up to the order of float sums.  ELPH's full-graph GCN, the
sketches and the embedding diffusion run on every rank (K1 per rank);
evaluation is replicated.  ``DistributedDataParallel`` is not used: it
divides by W, buckets in its own order and broadcasts buffers, which
would hide a divergence of the BatchNorm statistics.

The graph and lane axes (``--mesh_axes`` with ``graph`` / ``lane``, JAX's
ElphTrainer branches): the peers of a rank on those axes hold its block
of the batch, so the losses, the BatchNorm statistics and the gradients
are summed over the data axis alone.  ELPH on a graph axis builds its
sketches edge-sharded (``parallel/dist_sketch.py``: the state replicated)
and runs its GCN over the rank's block of the gcn_norm'd edges, summed
over the axis (``models/gnn.py`` ``EdgeShardSpmm``); on a lane axis the
subgraph features come from the rank's width slice, summed over the
axis.  With ``--memory_sharded`` the sketch state stays node-sharded
(``parallel/node_sharded.py``: 1/D rows a rank, built once per distinct
message graph and shared across splits) and each batch's subgraph
features are assembled from the ranks that own its rows.  A BUDDY split
built under a graph mesh carries position-ordered sketches
(``LinkDataset.sketch_perm``); the ELPH trainer translates through the
permutation, and refuses them without a graph axis.

``--dtype bfloat16`` or ``float16`` (the JAX package's
``_dtype_from_cfg``) is the models' compute dtype, module by module as
flax's ``dtype`` field (``models/gnn.py``): the dense layers, BatchNorm
outputs, dropout, the GCN's and the diffusion's products and SpMMs run
in it (K1's bfloat16 or float16 add), while the parameters, the
BatchNorm statistics, the Adam moments and the logits stay float32, so
such a run's checkpoint has the float32 run's keys and dtypes.
``--dtype float64`` is the float32 run, as in the JAX package, which
never enables x64.  Preprocessing does not read it.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.device import resolve_device
from subgraph_sketching_tpu_torch.graph.preprocess import (
    LinkDataset, sketch_params_from_config,
)
from subgraph_sketching_tpu_torch.models.buddy import BUDDY
from subgraph_sketching_tpu_torch.models.elph import ELPHPredictor
from subgraph_sketching_tpu_torch.models.gnn import (
    EdgeShardSpmm, GCNConv, SIGNEmbedding, compute_dtype, shard_batch_axis,
)
from subgraph_sketching_tpu_torch.ops.graph_ops import gcn_norm, spmm
from subgraph_sketching_tpu_torch.ops.segment_scan import (
    PlanSpmm, gather_rows, make_auto_plan,
)
from subgraph_sketching_tpu_torch.parallel.mesh import (
    Mesh, flat_grads, mesh_from_config,
)
from subgraph_sketching_tpu_torch.parallel.dist_sketch import (
    edge_sharded_build_hash_tables, lane_sharded_subgraph_features,
    lane_sharded_subgraph_features_batched, pad_edges, weighted_edge_block,
)
from subgraph_sketching_tpu_torch.parallel.node_sharded import (
    make_node_partition, node_sharded_build_hash_tables,
    node_sharded_subgraph_features, node_sharded_subgraph_features_batched,
)
from subgraph_sketching_tpu_torch.sketch.elph import (
    build_hash_tables, subgraph_features, subgraph_features_batched,
)
from subgraph_sketching_tpu_torch.train.losses import get_loss
from subgraph_sketching_tpu_torch.utils import load_pretrained_embedding


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
    bias zero, except a GCNConv's, which is glorot-uniform (uniform in
    +-sqrt(6 / (fan_in + fan_out))) with the conv's bias zero; a
    trainable node-embedding table xavier-uniform, flax's glorot with
    fan_in = num_nodes and fan_out = hidden; an ``nn.Embedding`` (a flax
    ``Embed``: the SEAL models' tables) normal with variance 1/dim; a
    ``Conv1d`` lecun-normal over fan_in = in_channels * width, bias zero;
    BatchNorm at scale 1, bias 0 and unit running statistics."""
    glorot = {id(m.lin) for m in model.modules() if isinstance(m, GCNConv)}
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ElphEmbedding) and m.trainable:
                a = (6.0 / sum(m.node_embedding.shape)) ** 0.5
                nn.init.uniform_(m.node_embedding, -a, a,
                                 generator=generator)
            if isinstance(m, nn.Linear) and id(m) in glorot:
                a = (6.0 / (m.in_features + m.out_features)) ** 0.5
                nn.init.uniform_(m.weight, -a, a, generator=generator)
            elif isinstance(m, nn.Linear):
                std = (1.0 / m.in_features) ** 0.5 / .87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Conv1d):
                fan_in = m.in_channels * m.kernel_size[0]
                std = (1.0 / fan_in) ** 0.5 / .87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, std=m.embedding_dim ** -0.5,
                                generator=generator)
            elif isinstance(m, GCNConv):
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()


def _epoch_order(num_links: int, cfg: Config, g: torch.Generator,
                 order: Optional[torch.Tensor], device,
                 mesh: Optional[Mesh] = None) -> torch.Tensor:
    """[steps, batch_size] link indices of one epoch: ``order`` (an
    [n_used] index tensor) or a permutation drawn from ``g``, its tail
    padded with -1.  With ``mesh`` the global order is built the same
    way on every rank, and the rank's [steps, batch_size / W] block of
    columns returned."""
    bs = cfg.batch_size
    if order is None:
        n_used, _ = _epoch_plan(num_links, bs, cfg.train_samples)
        order = torch.randperm(num_links, generator=g,
                               device=device)[:n_used]
    order = order.to(device, torch.int64)
    steps = max(1, math.ceil(len(order) / bs))
    pad = steps * bs - len(order)
    if pad:
        order = torch.cat([order, order.new_full((pad,), -1)])
    order = order.view(steps, bs)
    return order if mesh is None else mesh.shard(order, dim=1)


# ------------------------------------------------------ node embeddings --

def uses_embedding(cfg: Config) -> bool:
    return bool(cfg.train_node_embedding
                or cfg.pretrained_node_embedding is not None)


def load_frozen_embedding(cfg: Config,
                           num_nodes: int) -> Optional[torch.Tensor]:
    """The pretrained (frozen) node-embedding table on the CPU, or None
    (reference select_embedding, utils.py:57-60)."""
    if cfg.pretrained_node_embedding is None:
        return None
    return torch.from_numpy(load_pretrained_embedding(
        cfg.pretrained_node_embedding, num_nodes))


class ElphEmbedding(nn.Module):
    """A run's node-embedding table (the JAX package's ``ElphEmbedding``
    and ``_node_embedding_table``): a trainable ``node_embedding``
    [num_nodes, hidden] or a pretrained ``frozen_table``, SIGN-diffused by
    ``sign_embedding`` with ``propagate`` (reference
    propagate_embeddings_func, models/elph.py:148-151).

    A frozen table is a non-persistent buffer: no gradient, no Adam
    state, not in the state_dict (a checkpoint re-reads it from the
    config's path).  ELPH holds this module as its child ``embedding``;
    :class:`BuddyWithEmbedding` extends it, so the parameter names follow
    the JAX trees (``node_embedding``, ``sign_embedding/...``).
    """

    def __init__(self, num_nodes: int, hidden_channels: int,
                 propagate: bool = False, sign_k: int = 1,
                 sign_dropout: float = 0.5,
                 frozen_table: Optional[torch.Tensor] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.trainable = frozen_table is None
        if self.trainable:
            self.node_embedding = nn.Parameter(
                torch.empty(num_nodes, hidden_channels))
            width = hidden_channels
        else:
            self.register_buffer("frozen_table", frozen_table,
                                 persistent=False)
            width = frozen_table.shape[1]
        self.propagate = propagate
        if propagate:
            self.sign_embedding = SIGNEmbedding(
                width, hidden_channels, hidden_channels, sign_k,
                sign_dropout, dtype=dtype)

    def table(self, plan: Optional[PlanSpmm] = None,
              norm: Optional[tuple] = None,
              edge_index: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The [num_nodes, W] table, diffused with ``propagate``
        by ``plan`` or the scatter ``spmm`` over ``norm`` (from
        ``edge_index`` when absent)."""
        t = self.node_embedding if self.trainable else self.frozen_table
        if self.propagate:
            t = self.sign_embedding(t, edge_index, t.shape[0], plan=plan,
                                    norm=norm, generator=generator)
        return t


class BuddyWithEmbedding(ElphEmbedding):
    """BUDDY with its node-embedding table (the JAX package's
    ``BuddyWithEmbedding``): the table's entries beside the child
    ``buddy``.  The BUDDY trainer builds one only with embeddings on, so
    a run without them keeps a plain ``BUDDY``."""

    def __init__(self, buddy: BUDDY, num_nodes: int, hidden_channels: int,
                 propagate: bool = False, sign_k: int = 1,
                 sign_dropout: float = 0.5,
                 frozen_table: Optional[torch.Tensor] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(num_nodes, hidden_channels, propagate, sign_k,
                         sign_dropout, frozen_table, dtype)
        self.buddy = buddy


def _embedding_width(cfg: Config, frozen: Optional[torch.Tensor]) -> int:
    """The width of the embedding rows the head reads: hidden_channels
    when the table is diffused (``sign_embedding``'s ``lin_out``) or
    trained, else the pretrained table's own width."""
    if cfg.propagate_embeddings or frozen is None:
        return cfg.hidden_channels
    return int(frozen.shape[1])


def _embedding_args(cfg: Config, num_nodes: int,
                    frozen: Optional[torch.Tensor]) -> dict:
    return dict(num_nodes=num_nodes, hidden_channels=cfg.hidden_channels,
                propagate=cfg.propagate_embeddings,
                sign_k=max(cfg.sign_k, 1), sign_dropout=cfg.sign_dropout,
                frozen_table=frozen, dtype=compute_dtype(cfg.dtype))


def build_buddy(cfg: Config, num_features: Optional[int], num_nodes: int,
                frozen: Optional[torch.Tensor] = None) -> nn.Module:
    """The model a BUDDY run trains, on the CPU and not initialised: a
    ``BUDDY``, wrapped in :class:`BuddyWithEmbedding` with node
    embeddings (``frozen``: the pretrained table, see
    :func:`load_frozen_embedding`)."""
    if not uses_embedding(cfg):
        return BUDDY.from_config(cfg, num_features)
    buddy = BUDDY.from_config(cfg, num_features,
                              emb_dim=_embedding_width(cfg, frozen))
    return BuddyWithEmbedding(buddy, **_embedding_args(cfg, num_nodes,
                                                       frozen))


class _Trainer:
    """What the BUDDY and ELPH trainers share: the staged splits'
    (``_data``) link counts, the epoch loss and the node-embedding
    table."""

    cfg: Config
    _data: Dict[str, Dict[str, torch.Tensor]]

    def _init_mesh(self) -> None:
        """The mesh (None without ``--mesh_shape``) and the loss over its
        global batch."""
        self.mesh = mesh_from_config(self.cfg, self.device)
        if self.mesh is not None and self.cfg.batch_size \
                % self.mesh.data_size:
            raise ValueError(f"batch_size {self.cfg.batch_size} does not "
                             f"split over {self.mesh.data_size} ranks")
        self.loss_fn = get_loss(self.cfg.loss)
        if self.mesh is not None:
            self.loss_fn = functools.partial(self.loss_fn, mesh=self.mesh)

    def _update(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                loss: torch.Tensor) -> None:
        """The backward, the gradients summed over the mesh's ranks (in
        the model's flat gradient buffer), and the optimizer's step."""
        if self.mesh is None:
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        else:
            grads = flat_grads(model)
            grads.zero_grad()
            loss.backward()
            grads.all_reduce(self.mesh.group("data"))
        optimizer.step()

    def _init_embedding(self, dataset: LinkDataset) -> None:
        self.use_embedding = uses_embedding(self.cfg)
        self.num_nodes = dataset.num_nodes
        self.frozen_emb = load_frozen_embedding(self.cfg, dataset.num_nodes)

    def _stage_embedding(self, split: str, ds: LinkDataset) -> dict:
        """The embedding diffusion's SpMM for one split, with
        ``--propagate_embeddings``: ``emb_norm``, the unweighted
        gcn_norm'd edges for the scatter ``spmm``, and for the train split
        under ``use_plan`` ``emb_plan``, a ``PlanSpmm`` over them where
        ``try_build`` admits one (the JAX package stages the plan for
        train only: eval diffuses once, by the scatter route)."""
        cfg = self.cfg
        if not (self.use_embedding and cfg.propagate_embeddings):
            return {}
        ei = torch.from_numpy(np.asarray(ds.edge_index, dtype=np.int64))
        ein, wn = gcn_norm(ei.to(self.device), None, ds.num_nodes)
        d = {"emb_norm": (ein, wn)}
        if split == "train" and cfg.use_plan:
            plan = PlanSpmm.try_build(ein.cpu().numpy(), wn.cpu().numpy(),
                                      ds.num_nodes,
                                      max_slots=cfg.max_gather_slots,
                                      device=self.device)
            if plan is not None:
                d["emb_plan"] = plan
        return d

    def embedding_table(self, model: nn.Module, data: dict,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
        """The node-embedding table for a staged split: in training mode
        by the split's staged ``PlanSpmm`` where there is one, in eval
        mode (and without a plan) by the scatter ``spmm``."""
        emb = getattr(model, "embedding", model)
        plan = data.get("emb_plan") if model.training else None
        return emb.table(plan=plan, norm=data.get("emb_norm"),
                         generator=generator)

    def num_links(self, split: str) -> int:
        return int(self._data[split]["links"].shape[0])

    def train_epoch(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                    seed: int, order: Optional[torch.Tensor] = None) -> float:
        """One epoch (see ``run_epoch``); returns the reference's epoch
        loss, sum(step loss) * batch_size / num_links (train.py:77,89)."""
        losses = self.run_epoch(model, optimizer, seed, order)
        total = float(losses.sum()) * self.cfg.batch_size
        return total / self.num_links("train")


class BuddyTrainer(_Trainer):
    """Owns the device-resident split data and the BUDDY step.

    The model and its optimizer are the caller's: ``init_model`` builds a
    model, ``make_optimizer`` its Adam, and ``train_epoch`` / ``predict``
    take them.
    """

    def __init__(self, cfg: Config, dataset: LinkDataset,
                 num_features: Optional[int], device="cuda"):
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.dtype)   # raises on an unknown one
        self.device = resolve_device(device)
        self._init_mesh()
        self.use_feature = cfg.use_feature and dataset.x is not None
        self.num_features = num_features if self.use_feature else None
        self._init_embedding(dataset)
        self._data: Dict[str, Dict[str, torch.Tensor]] = {}
        self._num_pos: Dict[str, int] = {}
        self.stage("train", dataset)

    # -- data staging -------------------------------------------------------
    def stage(self, split: str, ds: LinkDataset) -> None:
        """Put one split's per-link data on the device: ``links``, ``rows``
        (sf ‖ label ‖ src degree ‖ dst degree ‖ RA with ``use_RA``, one
        [L, F] float32 array, so a batch is one row gather), the node
        features ``x`` and the embedding diffusion's SpMM
        (``_stage_embedding``)."""
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
        d.update(self._stage_embedding(split, ds))
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
                 "links": links, "src_degree": rows[:, c + 1],
                 "dst_degree": rows[:, c + 2],
                 "node_features": data["x"][links] if self.use_feature
                 else None,
                 "RA": rows[:, c + 3] if self.cfg.use_RA else None}
        if self.cfg.use_struct_feature is False:
            batch["sf"] = torch.zeros_like(batch["sf"])
        return batch

    @staticmethod
    def _apply(model: nn.Module, batch, generator=None,
               emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The BUDDY (``model`` or its ``buddy``) on one batch, with the
        batch's embedding rows ``emb``."""
        buddy = getattr(model, "buddy", model)
        return buddy(batch["sf"], node_features=batch["node_features"],
                     src_degree=batch["src_degree"],
                     dst_degree=batch["dst_degree"], RA=batch["RA"],
                     emb=emb, generator=generator)

    # -- model --------------------------------------------------------------
    def init_model(self, seed: int) -> nn.Module:
        """The run's model (:func:`build_buddy`: a BUDDY, or a
        BuddyWithEmbedding) on the trainer's device, initialised as flax
        initialises it, from a CPU generator seeded with ``seed`` (so the
        same seed gives the same weights on every device)."""
        model = build_buddy(self.cfg, self.num_features, self.num_nodes,
                            self.frozen_emb)
        _init_like_flax(model, torch.Generator().manual_seed(seed))
        if self.mesh is not None:
            # the BUDDY sees the link batch; a table's diffusion does not
            shard_batch_axis(getattr(model, "buddy", model), self.mesh)
        return model.to(self.device)

    # -- public API ---------------------------------------------------------
    def run_epoch(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                  seed: int, order: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
        """One epoch; returns the [steps] step losses, on the device.

        The generator seeded with ``seed`` draws the permutation (unless
        ``order``, a [n_used] index tensor, gives it) and then every dropout
        mask, step by step.  With node embeddings each step first builds
        the (diffused) table and gathers the batch's rows by
        ``gather_rows``, whose backward sums in a fixed order.  On a mesh
        the step runs on this rank's block of each batch, and the losses
        are the global batch's."""
        data = self._data["train"]
        g = torch.Generator(device=self.device).manual_seed(seed)
        perm = _epoch_order(self.num_links("train"), self.cfg, g, order,
                            self.device, self.mesh)
        steps = perm.shape[0]
        model.train()
        losses = torch.empty(steps, device=self.device)
        for step in range(steps):
            batch = self._batch(data, perm[step])
            emb = (gather_rows(self.embedding_table(model, data, g),
                               batch["links"])
                   if self.use_embedding else None)
            logits = self._apply(model, batch, g, emb)
            loss = self.loss_fn(logits, batch["labels"], batch["mask"])
            self._update(model, optimizer, loss)
            losses[step] = loss.detach()
        return losses

    @torch.inference_mode()
    def predict(self, model: nn.Module, split: str,
                n_samples: Optional[int] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
        """(pred, labels) over the split's links in order, batched at
        eval_batch_size (reference get_buddy_preds, inference.py:99-140);
        the embedding table is diffused once, by the scatter ``spmm``."""
        model.eval()
        data = self._data[split]
        total = self.num_links(split)
        sel = eval_subset(total, n_samples, self.cfg.dataset_name,
                          self._num_pos.get(split))
        table = (self.embedding_table(model, data) if self.use_embedding
                 else None)

        def score(idx: np.ndarray) -> torch.Tensor:
            batch = self._batch(data, torch.from_numpy(idx).to(self.device))
            emb = table[batch["links"]] if table is not None else None
            return self._apply(model, batch, emb=emb).ravel()

        # pad with -1: _batch reads link 0 for it, and the pads are sliced off
        pred = batched_predict(score, sel, self.cfg.eval_batch_size,
                               pad_value=-1)
        labels = data["rows"][:, self._sf_dim].cpu().numpy()[sel]
        return pred, labels


class ElphTrainer(_Trainer):
    """Owns the device-resident split data and the ELPH step (the JAX
    package's ``ElphTrainer``, with its graph- and lane-sharded branches
    and the memory-sharded mode; see the module docstring).

    The full-graph GCN runs inside every step, as in the reference
    (train.py:188-204); the sketch side is built once at staging (the same
    values, gradient-free).  The model is one ``ELPHPredictor`` (children
    ``gnn``, ``predictor`` and, with node embeddings, ``embedding``, an
    :class:`ElphEmbedding`), the caller's, as for ``BuddyTrainer``.
    """

    def __init__(self, cfg: Config, dataset: LinkDataset,
                 num_features: Optional[int], device="cuda"):
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.dtype)   # raises on an unknown one
        self.device = resolve_device(device)
        self._init_mesh()
        axes = self.mesh.axis_names if self.mesh is not None else ()
        self._has_graph = "graph" in axes
        self._has_lane = "lane" in axes
        # memory-sharded: the sketch state stays node-partitioned (1/D per
        # rank) through training; each batch's features are assembled
        # from the shards (only with the structure features on)
        self._memory_sharded = bool(cfg.memory_sharded and self._has_graph
                                    and cfg.use_struct_feature)
        # split -> (edge_index, num_nodes) of its node-sharded tables
        self._ms_graphs: Dict[str, tuple] = {}
        self.sketch_params = sketch_params_from_config(cfg)
        self.use_feature = cfg.use_feature and dataset.x is not None
        self.num_features = num_features if self.use_feature else None
        self._init_embedding(dataset)
        self._data: Dict[str, Dict[str, torch.Tensor]] = {}
        self._num_pos: Dict[str, int] = {}
        # split -> (edge_index, edge_weight, num_nodes) of its staged SpMM
        self._spmm_edges: Dict[str, tuple] = {}
        # one sketch table set, keyed by its message graph
        self._sk_graph: Optional[tuple] = None
        self.stage("train", dataset)

    # -- data staging -------------------------------------------------------
    def graph_sketches(self, edge_index: np.ndarray, num_nodes: int):
        """The sketch stacks of a message graph: the held set when it is
        this graph's, else built (through a plan, or by the scatter route
        under ``--use_plan false``) and held in place of the last set.  One
        set per distinct message graph, so eval splits that share the
        train graph reuse its tables, and one set held at a time."""
        held = self._sk_graph
        if (held is not None and held[1] == num_nodes
                and held[0].shape == edge_index.shape
                and np.array_equal(held[0], edge_index)):
            return held[2]
        if self._has_graph:
            # edge-sharded: each rank's block of the (padded) edges
            ei, mask = pad_edges(edge_index, self.mesh.axis_size("graph"))
            sk = edge_sharded_build_hash_tables(
                ei, num_nodes, self.sketch_params, self.mesh, mask=mask,
                max_gather_slots=self.cfg.max_gather_slots)
        else:
            plan = (make_auto_plan(edge_index, num_nodes,
                                   max_slots=self.cfg.max_gather_slots,
                                   device=self.device)
                    if self.cfg.use_plan else None)
            sk = build_hash_tables(edge_index, num_nodes, self.sketch_params,
                                   plan=plan,
                                   hops_only=self.cfg.hops_only_sketches,
                                   device=self.device)
        self._sk_graph = (edge_index, num_nodes, sk)
        return sk

    def stage(self, split: str, ds: LinkDataset) -> None:
        """Put one split on the device: ``links``, ``labels``, the subgraph
        features ``sf`` (zeros under ``--use_struct_feature 0``, which
        builds no sketch), the message graph and its weights, the raw
        features ``x``, and the GCN's SpMM: a ``PlanSpmm`` over the
        gcn_norm'd edges (``plan``) where ``try_build`` admits one, else
        the gcn_norm'd edges for the scatter ``spmm`` (``norm``).  A split
        whose edges and weights equal another staged split's reuses its
        SpMM; and the embedding diffusion's SpMM (``_stage_embedding``,
        apart from the GCN's)."""
        dev = self.device
        params = self.sketch_params
        extra = {}
        if self.cfg.use_struct_feature is False:
            sf = torch.zeros((len(ds.links), params.sf_dim),
                             dtype=torch.float32, device=dev)
        elif self._memory_sharded:
            sf = None   # assembled per batch from the node-sharded tables
            extra = self._stage_memory_sharded(split, ds)
        elif ds.sketches is not None and ds.sketch_perm is not None:
            # POSITION-ordered node-sharded tables (a BUDDY split built
            # under a graph mesh): node ids go through the permutation
            if not self._has_graph:
                raise ValueError(
                    "the dataset carries node-sharded sketches but this "
                    "trainer has no 'graph' mesh axis; build the dataset "
                    "without a mesh or give --mesh_axes a graph axis")
            sf = node_sharded_subgraph_features_batched(
                ds.links, ds.sketches, params, self.mesh,
                perm=ds.sketch_perm,
                batch_size=min(self.cfg.subgraph_feature_batch_size,
                               1 << 18))
        else:
            sk = (ds.sketches if ds.sketches is not None
                  else self.graph_sketches(ds.edge_index, ds.num_nodes))
            if self._has_lane:
                sf = lane_sharded_subgraph_features_batched(
                    ds.links, sk, params, self.mesh)
            else:
                sf = subgraph_features_batched(ds.links, sk, params)
        d = {"links": torch.from_numpy(
                 np.asarray(ds.links, dtype=np.int64)).to(dev),
             "labels": torch.from_numpy(
                 np.asarray(ds.labels, dtype=np.float32)).to(dev),
             "num_nodes": ds.num_nodes, **extra,
             "edge_index": torch.from_numpy(
                 np.asarray(ds.edge_index, dtype=np.int64)).to(dev),
             "edge_weight": torch.from_numpy(
                 np.asarray(ds.edge_weight, dtype=np.float32)).to(dev)}
        if sf is not None:
            d["sf"] = sf
        if self.use_feature:
            d["x"] = torch.from_numpy(
                np.asarray(ds.x, dtype=np.float32)).to(dev)
            d.update(self._stage_spmm(split, ds, d))
        d.update(self._stage_embedding(split, ds))
        self._data[split] = d
        # positive count, for pos/neg-aligned eval subsampling (citation2)
        self._num_pos[split] = int(np.asarray(ds.labels).sum())

    def _stage_spmm(self, split: str, ds: LinkDataset, d: dict) -> dict:
        """``{"plan": PlanSpmm}`` or ``{"norm": (edge_index, weight)}`` for
        this split's message graph, reused from a staged split with the
        same edges and weights."""
        self._spmm_edges.pop(split, None)   # a re-staged split may change
        reuse = next(
            (s for s, (e, w, n) in self._spmm_edges.items()
             if n == ds.num_nodes and e.shape == ds.edge_index.shape
             and np.array_equal(e, ds.edge_index)
             and np.array_equal(w, ds.edge_weight)), None)
        self._spmm_edges[split] = (ds.edge_index, ds.edge_weight,
                                   ds.num_nodes)
        if reuse is not None:
            return {k: self._data[reuse][k] for k in ("plan", "norm")
                    if k in self._data[reuse]}
        ein, wn = gcn_norm(d["edge_index"], d["edge_weight"], ds.num_nodes)
        if self._has_graph:
            # this rank's block of the gcn_norm'd edges (the whole graph's
            # degrees), its SpMM summed over the graph axis
            ein, wn = weighted_edge_block(ein, wn, self.mesh)
        plan = (PlanSpmm.try_build(ein.cpu().numpy(), wn.cpu().numpy(),
                                   ds.num_nodes,
                                   max_slots=self.cfg.max_gather_slots,
                                   device=self.device)
                if self.cfg.use_plan else None)
        if self._has_graph:
            n = ds.num_nodes
            inner = plan if plan is not None else (
                lambda h, e=ein, w=wn: spmm(e, w, h, n))
            return {"plan": EdgeShardSpmm(inner, self.mesh.group("graph"))}
        return {"plan": plan} if plan is not None else {"norm": (ein, wn)}

    def _stage_memory_sharded(self, split: str, ds: LinkDataset) -> dict:
        """The node-partitioned sketch tables of this split's message graph
        (``sk_shard``: this rank's 1/D rows, in partition order) and the
        node -> row map (``sk_perm``), built by halo exchange once per
        distinct message graph: a split on a staged split's graph shares
        its tables."""
        self._ms_graphs.pop(split, None)   # a re-staged split may change
        reuse = next(
            (s for s, (e, n) in self._ms_graphs.items()
             if n == ds.num_nodes and e.shape == ds.edge_index.shape
             and np.array_equal(e, ds.edge_index)), None)
        self._ms_graphs[split] = (ds.edge_index, ds.num_nodes)
        if reuse is not None:
            return {k: self._data[reuse][k] for k in ("sk_shard", "sk_perm")}
        part = make_node_partition(ds.edge_index, ds.num_nodes,
                                   self.mesh.axis_size("graph"))
        sk = node_sharded_build_hash_tables(
            part, self.sketch_params, self.mesh,
            max_gather_rows=self.cfg.max_gather_slots)
        return {"sk_shard": sk, "sk_perm": torch.from_numpy(
            part.perm.astype(np.int64)).to(self.device)}

    def batch_features(self, data: dict, idx: torch.Tensor,
                       links: torch.Tensor) -> torch.Tensor:
        """The subgraph features of a staged split's links ``idx`` (node
        pairs ``links``): staged, or under ``--memory_sharded`` assembled
        from the node-sharded tables (gradient-free)."""
        if "sf" in data:
            return data["sf"][idx]
        with torch.no_grad():
            return node_sharded_subgraph_features(
                links, data["sk_shard"], self.sketch_params, self.mesh,
                perm=data["sk_perm"])

    def link_feature_fn(self, data: dict):
        """The subgraph features of any [B, 2] node pairs on a staged
        split's message graph (serving), as a function of the pairs whose
        sketch state is resolved once, here: the split's node-sharded
        tables under ``--memory_sharded``, else the graph's stacks (the
        held set when it is this graph's, else built), lane-sharded on a
        lane axis; zeros under ``--use_struct_feature 0``.  A call makes
        no host round trip."""
        params, mesh, dev = self.sketch_params, self.mesh, self.device
        if self.cfg.use_struct_feature is False:
            return lambda links: torch.zeros((links.shape[0], params.sf_dim),
                                             device=dev)
        if "sk_shard" in data:
            sk, perm = data["sk_shard"], data["sk_perm"]
            return lambda links: node_sharded_subgraph_features(
                links, sk, params, mesh, perm=perm)
        sk = self.graph_sketches(data["edge_index"].cpu().numpy(),
                                 data["num_nodes"])
        if self._has_lane:
            return lambda links: lane_sharded_subgraph_features(
                links, sk, params, mesh)
        return lambda links: subgraph_features(links, sk, params)

    # -- model --------------------------------------------------------------
    def init_model(self, seed: int) -> ELPHPredictor:
        """An ELPHPredictor for this run on the trainer's device (with its
        ``embedding`` child under node embeddings), initialised as flax
        initialises it (glorot-uniform GCN kernels, a xavier-uniform
        table), from a CPU generator seeded with ``seed``."""
        model = ELPHPredictor.from_config(
            self.cfg, self.sketch_params, self.num_features,
            emb_dim=_embedding_width(self.cfg, self.frozen_emb))
        if self.use_embedding:
            model.embedding = ElphEmbedding(**_embedding_args(
                self.cfg, self.num_nodes, self.frozen_emb))
        _init_like_flax(model, torch.Generator().manual_seed(seed))
        if self.mesh is not None:
            # the head sees the link batch; the GCN and the table do not
            shard_batch_axis(model.predictor, self.mesh)
        return model.to(self.device)

    def node_features(self, model: ELPHPredictor, data: dict,
                      generator: Optional[torch.Generator] = None
                      ) -> Optional[torch.Tensor]:
        """The full-graph GCN's output for a staged split (None without
        features)."""
        feats, _ = model.gnn(data.get("x"), data["edge_index"],
                             data["num_nodes"],
                             edge_weight=data["edge_weight"],
                             norm=data.get("norm"), plan=data.get("plan"),
                             generator=generator)
        return feats

    # -- public API ---------------------------------------------------------
    def run_epoch(self, model: ELPHPredictor,
                  optimizer: torch.optim.Optimizer, seed: int,
                  order: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One epoch; returns the [steps] step losses, on the device.  Each
        step runs the full-graph GCN with dropout, gathers the batch's
        node-feature rows (``gather_rows``: a backward that is the same
        from run to run), builds the (diffused) embedding table and
        gathers its rows the same way, runs the head, the BCE loss, the
        backward through ``PlanSpmm`` and the Adam step.  The generator
        seeded with ``seed`` draws the permutation (unless ``order``
        gives it) and every dropout mask.  On a mesh every rank runs the
        GCN and the diffusion whole, and the head on its block of each
        batch."""
        data = self._data["train"]
        g = torch.Generator(device=self.device).manual_seed(seed)
        perm = _epoch_order(self.num_links("train"), self.cfg, g, order,
                            self.device, self.mesh)
        model.train()
        losses = torch.empty(perm.shape[0], device=self.device)
        for step, idx in enumerate(perm):
            safe = idx.clamp(min=0)   # -1 padding reads link 0, masked
            links = data["links"][safe]
            feats = self.node_features(model, data, g)
            nf = gather_rows(feats, links) if feats is not None else None
            emb = (gather_rows(self.embedding_table(model, data, g), links)
                   if self.use_embedding else None)
            logits = model.predictor(self.batch_features(data, safe, links),
                                     nf, emb, generator=g)
            loss = self.loss_fn(logits, data["labels"][safe], idx >= 0)
            self._update(model, optimizer, loss)
            losses[step] = loss.detach()
        return losses

    @torch.inference_mode()
    def predict(self, model: ELPHPredictor, split: str,
                n_samples: Optional[int] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
        """(pred, labels) over the split's links in order: the full-graph
        forward and the embedding diffusion (by the scatter ``spmm``) once,
        then the head in eval_batch_size batches (reference
        get_elph_preds, inference.py:167-205)."""
        model.eval()
        data = self._data[split]
        feats = self.node_features(model, data)
        table = (self.embedding_table(model, data) if self.use_embedding
                 else None)
        sel = eval_subset(self.num_links(split), n_samples,
                          self.cfg.dataset_name, self._num_pos.get(split))

        def score(idx: np.ndarray) -> torch.Tensor:
            j = torch.from_numpy(idx).to(self.device)
            links = data["links"][j]
            nf = feats[links] if feats is not None else None
            emb = table[links] if table is not None else None
            return model.predictor(self.batch_features(data, j, links), nf,
                                   emb).ravel()

        pred = batched_predict(score, sel, self.cfg.eval_batch_size)
        labels = data["labels"].cpu().numpy()[sel]
        return pred, labels
