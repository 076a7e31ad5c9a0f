"""Single source of truth for experiment configuration.

Mirrors the reference CLI flag surface (reference: src/runners/run.py:147-261)
as one serialisable dataclass.  Field names keep CLI-name compatibility so the
reproduction commands in the reference README work verbatim against our
runner.  The reference duplicates defaults in three places (argparse,
utils.DEFAULT_DIC, test OPT); here there is exactly one.

A copy of the JAX package's ``config.py`` with every field kept, so a
``config.json`` written by either package loads in the other.  The port
reads every field the JAX runner reads: ``platform`` as the device,
``profile_dir`` as a ``torch.profiler`` trace, ``compilation_cache_dir`` as
the native build directory, the mesh and the checkpoint options.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from math import inf
from typing import List, Optional


@dataclass
class Config:
    # ---- data settings (run.py:149-168) ----
    dataset_name: str = "Cora"
    val_pct: float = 0.1
    test_pct: float = 0.2
    train_samples: float = inf  # number of training edges, or fraction if < 1
    val_samples: float = inf
    test_samples: float = inf
    # parse-only, like the reference (--preprocessing is declared at
    # run.py:161 and never read)
    preprocessing: Optional[str] = None
    sign_k: int = 0
    load_features: bool = False
    load_hashes: bool = False
    cache_subgraph_features: bool = False
    train_cache_size: float = inf  # parse-only in the reference too (run.py:167)
    year: int = 0  # ogbl-collab: drop training edges before this year

    # ---- GNN settings (run.py:170-180) ----
    model: str = "BUDDY"
    hidden_channels: int = 1024
    batch_size: int = 1024
    eval_batch_size: int = 1000000
    label_dropout: float = 0.5
    feature_dropout: float = 0.5
    sign_dropout: float = 0.5
    save_model: bool = False
    feature_prop: str = "gcn"  # gcn | residual | cat

    # ---- SEAL settings (run.py:182-194) ----
    dropout: float = 0.5
    num_seal_layers: int = 3
    sortpool_k: float = 0.6
    label_pooling: str = "add"
    seal_pooling: str = "edge"
    num_hops: int = 1
    ratio_per_hop: float = 1.0
    max_nodes_per_hop: Optional[int] = None
    node_label: str = "drnl"
    max_dist: int = 4
    max_z: int = 1000
    dynamic_train: bool = False
    dynamic_val: bool = False
    dynamic_test: bool = False
    pretrained_node_embedding: Optional[str] = None
    sample_size: Optional[int] = None  # SEAL cache naming (datasets/seal.py:162)
    data_appendix: str = ""

    # ---- feature toggles (run.py:195-200) ----
    use_feature: bool = True
    use_struct_feature: bool = True
    use_edge_weight: bool = False

    # ---- training settings (run.py:202-214) ----
    lr: float = 1e-4
    weight_decay: float = 0.0
    epochs: int = 100
    num_workers: int = 4  # reference DataLoader workers; no loader here
    num_negs: int = 1
    train_node_embedding: bool = False
    propagate_embeddings: bool = False
    loss: str = "bce"  # bce | auc
    add_normed_features: bool = False
    use_RA: bool = False

    # ---- eval settings (run.py:223-229) ----
    reps: int = 1
    # parse-only like the reference (run.py:224; collab behaviour is
    # instead hardcoded at data.py:173-176, mirrored in graph/datasets.py)
    use_valedges_as_input: bool = False
    eval_steps: int = 1
    log_steps: int = 1  # parse-only in the reference too (run.py:226)
    eval_metric: str = "hits"  # hits | mrr | auc
    K: int = 100

    # ---- hash settings (run.py:231-240) ----
    use_zero_one: bool = False
    floor_sf: bool = False
    hll_p: int = 8
    minhash_num_perm: int = 128
    max_hash_hops: int = 2
    subgraph_feature_batch_size: int = 11000000

    # ---- logging (reference: wandb, run.py:242-259; here: JSONL sink with
    # optional wandb passthrough — the full sweep/diagnostic flag surface is
    # mirrored so reference sweep commands parse) ----
    wandb: bool = False
    use_wandb_offline: bool = False   # reference --wandb_offline
    wandb_sweep: bool = False         # sweep mode: wandb.config overrides cfg
    wandb_watch_grad: bool = False
    wandb_track_grad_flow: bool = False
    wandb_entity: str = "link-prediction"
    wandb_project: str = "link-prediction"
    wandb_group: str = "testing"
    wandb_run_name: Optional[str] = None
    wandb_output_dir: str = "./wandb_output"
    wandb_log_freq: int = 1
    wandb_epoch_list: List[int] = field(
        default_factory=lambda: [0, 1, 2, 4, 8, 16])
    # parse-only in the reference too: --wandb_watch_grad is declared but
    # never read (run.py:248), and --log_features calls model.log_wandb()
    # which no model defines (train.py:87 would AttributeError)
    log_features: bool = False

    # ---- TPU-native additions (no reference equivalent) ----
    platform: Optional[str] = None  # force jax platform ("cpu"/"tpu"); None = default
    profile_dir: Optional[str] = None  # write a jax.profiler trace of epoch 0
    seed: int = 0
    dtype: str = "float32"  # compute dtype for the MLP/conv path
    use_plan: bool = True  # padded-tree static reduction plan for segment ops
    # bound the padded-tree gather intermediate to this many slot rows; plans
    # bigger than this stream in chunks (ops/segment_scan.ChunkedSegmentPlan)
    # so citation2-scale propagation fits one chip's HBM
    max_gather_slots: int = 8 << 20
    # keep only hops 1..K of the sketch stacks (drop hop 0): saves 1/(K+1)
    # of resident sketch HBM plus the stack-time transient — at citation2
    # scale the difference between one chip and OOM.  Features are
    # identical (the extractor reads hops 1..K), and serving's streaming
    # insert/delete work too (hop-0 rows are recomputed per touched id)
    hops_only_sketches: bool = False
    mesh_shape: Optional[List[int]] = None  # e.g. [8] for 8-way data parallel
    mesh_axes: List[str] = field(default_factory=lambda: ["data"])
    # memory-sharded ELPH training: sketch tables stay node-partitioned
    # (1/D per device, locality partition + halo-exchange build) THROUGH
    # training; per-batch subgraph features are psum-assembled from the
    # shards inside the step.  Requires a "graph" mesh axis.  This is the
    # citation2-scale configuration — the full sketch state never sits
    # whole on one chip (parallel/node_sharded.py)
    memory_sharded: bool = False
    checkpoint_dir: Optional[str] = None
    resume: bool = False  # restore the latest checkpoint from checkpoint_dir
    # save a checkpoint every N epochs (process 0 only); with --resume the
    # run continues FROM the restored epoch with the same per-epoch keys,
    # so an interrupted run's final state is bit-identical to an
    # uninterrupted one (tests/test_fault.py drill)
    checkpoint_every: Optional[int] = None
    # persistent XLA compilation cache: repeat runs (and --resume restarts)
    # skip the 15-60s-per-shape remote compiles
    compilation_cache_dir: Optional[str] = None
    # multi-process failure detection (parallel/fault.py): shared dir for
    # heartbeats; a peer silent for heartbeat_timeout seconds aborts the run
    # cleanly (restartable via --resume) instead of hanging in a collective
    heartbeat_dir: Optional[str] = None
    heartbeat_timeout: float = 60.0
    # run epoch 0 twice from identical state and assert bitwise-equal
    # results (train/determinism.py — the race-detection analogue)
    check_determinism: bool = False
    cache_dir: Optional[str] = None  # preprocessing cache root
    data_root: Optional[str] = None  # dataset download/storage root

    def __post_init__(self):
        if self.max_hash_hops == 1 and not self.use_zero_one:
            # reference warns and runs with all features (run.py:262-263)
            self.use_zero_one = True
        if self.dataset_name == "ogbl-ddi":
            # ddi has no node features (run.py:264-266)
            self.use_feature = False
        if self.memory_sharded and (
                not self.mesh_shape
                or "graph" not in (self.mesh_axes or [])):
            raise ValueError("--memory_sharded needs a 'graph' mesh axis "
                             "(e.g. --mesh_shape 2,4 --mesh_axes data,graph)")
        if self.train_node_embedding and self.pretrained_node_embedding:
            # mutually exclusive table sources (reference select_embedding,
            # utils.py:56-60, silently prefers the trainable one)
            raise ValueError("--train_node_embedding and "
                             "--pretrained_node_embedding are mutually "
                             "exclusive")

    # -- serialisation ------------------------------------------------------
    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if v == inf:
                d[k] = "inf"
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        d = json.loads(s)
        for k, v in d.items():
            if v == "inf":
                d[k] = inf
        return cls(**d)

    @property
    def sf_dim(self) -> int:
        """Structure-feature dimension: k(k+2) (reference hashing.py:22-25)."""
        return self.max_hash_hops * (self.max_hash_hops + 2)
