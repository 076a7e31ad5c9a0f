"""Experiment runner of the port: BUDDY, ELPH and the SEAL and KGE
baseline tiers, training and evaluation (the JAX package's
runners/run.py, reference src/runners/run.py).

    python -m subgraph_sketching_tpu_torch.runners.run \
        --dataset_name synth-ba --model BUDDY --epochs 2 --device cpu

The flags are the JAX runner's (every ``Config`` field, reference names)
plus ``--device`` (default ``cuda``; the run raises when CUDA is absent).
Preprocessing runs on the device through the plan and K1; ELPH's GCN
runs in every step through the staged ``PlanSpmm`` (K1 forward and
backward) or, under ``--use_plan false``, the scatter SpMM.  Node
embeddings (``--train_node_embedding`` or ``--pretrained_node_embedding``)
serve both models; with ``--propagate_embeddings`` every step diffuses the
table over the train graph the same way (the reference's ogbl-ddi
commands).  ``--model`` SEALDGCNN, SEALGCN, SEALSAGE, SEALGIN or
SEALMLP trains on per-link enclosing subgraphs extracted on the host
(``train/seal_loop.py``; ``--dynamic_train/val/test`` extract per
batch), and transE, distmult, complEx or rotatE on the links alone
(``train/kge_loop.py``): neither tier builds sketches.

Datasets: ``synth-*``, Planetoid (Cora, Citeseer, Pubmed) and ogbl-*
from their raw files under ``--data_root`` (default ``SKETCH_DATA_ROOT``
or ``dataset/`` in the checkout).  On ogbl-citation2 the train metric is
taken on a small ``train_eval`` subset with its same-source negatives.

Data parallelism (BUDDY and ELPH, ``train/loops.py``): one process per
rank, launched by torchrun, whose environment ``main`` joins (NCCL on
CUDA, gloo on the CPU and where the local ranks outnumber the cards, as
two ranks on one card do, which NCCL refuses):

    torchrun --nproc_per_node 2 -m subgraph_sketching_tpu_torch.runners.run \
        --dataset_name synth-ba --model BUDDY --mesh_shape 2 --mesh_axes data

Each rank runs on ``cuda:LOCAL_RANK`` unless ``--device`` names a
device.  ``--heartbeat_dir`` (a directory every rank shares) starts the
heartbeat failure detector (``parallel/fault.py``): every epoch begins at
an out-of-band barrier, so a dead peer raises a named ``PeerFailure``
instead of hanging the survivors in the next collective, and ``--resume``
first agrees with every rank on the newest checkpoint they all see.

The mesh takes any mix of the JAX runner's axes ``data``, ``graph`` and
``lane`` (``parallel/mesh.py``), e.g.

    torchrun --nproc_per_node 4 -m subgraph_sketching_tpu_torch.runners.run \
        --dataset_name synth-ba --model ELPH --mesh_shape 2,2 \
        --mesh_axes data,graph --memory_sharded 1

A graph axis builds BUDDY's sketches node-sharded by halo exchange and
ELPH's edge-sharded (node-sharded with ``--memory_sharded``), and runs
ELPH's GCN over each rank's block of the edges; a lane axis shards the
sketch width of the subgraph features.  Unknown axes and shapes that do
not match the process group raise ValueError, as does
``--memory_sharded`` without a graph axis; SEAL and KGE on a mesh or
under a process group of several ranks raise NotImplementedError: their
trainers have no mesh.

``--dtype bfloat16`` runs BUDDY, ELPH and the SEAL models in bfloat16
compute (``train/loops.py``; KGE trains in float32 whatever it says, as
in the JAX package).  ``--profile_dir D`` traces epoch 1 of repetition 0
with ``torch.profiler`` (CPU and, on the card, CUDA activity) into
``D/epoch1_rank<r>.pt.trace.json``, as the JAX runner traces that epoch;
with ``--epochs 1`` nothing is traced.  ``--compilation_cache_dir D`` is
where the native code (the CUDA kernels, the plan builder, the SEAL
extractor; ``ops/cuda_build.py``) is built and loaded from, the
counterpart of the JAX runner's compilation cache.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import random
import time
from math import inf

import numpy as np

from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.device import (
    device_from_flags, resolve_device,
)
from subgraph_sketching_tpu_torch.graph.datasets import get_data
from subgraph_sketching_tpu_torch.graph.preprocess import (
    build_all_splits, make_train_eval_dataset,
)
from subgraph_sketching_tpu_torch.metrics_logging import (
    MetricsLogger, apply_sweep_overrides,
)
from subgraph_sketching_tpu_torch.ops import cuda_build
from subgraph_sketching_tpu_torch.parallel import fault, multihost
from subgraph_sketching_tpu_torch.parallel.mesh import check_axes
from subgraph_sketching_tpu_torch.train import checkpoint
from subgraph_sketching_tpu_torch.train.determinism import (
    assert_ranks_agree, check_epoch_determinism,
)
from subgraph_sketching_tpu_torch.train.inference import test
from subgraph_sketching_tpu_torch.train.kge_loop import KGE_MODELS, KgeTrainer
from subgraph_sketching_tpu_torch.train.loops import (
    BuddyTrainer, ElphTrainer, epoch_seed, make_optimizer,
)
from subgraph_sketching_tpu_torch.train.seal_loop import (
    SEAL_MODELS, build_seal_trainer,
)
from subgraph_sketching_tpu_torch.utils import str2bool


def set_seed(seed: int) -> np.random.Generator:
    """Reproducibility per OGB rules (reference run.py:37-48)."""
    random.seed(seed)
    np.random.seed(seed)
    return np.random.default_rng(seed)


TRAINERS = {"BUDDY": BuddyTrainer, "ELPH": ElphTrainer}


def _refuse_unported(cfg: Config) -> None:
    if cfg.model not in (*TRAINERS, *SEAL_MODELS, *KGE_MODELS):
        raise NotImplementedError(
            f"model {cfg.model} is not wired into the runner (available: "
            f"{', '.join((*TRAINERS, *SEAL_MODELS, *KGE_MODELS))})")
    if cfg.model in (*SEAL_MODELS, *KGE_MODELS) and (
            cfg.mesh_shape or multihost.world_size() > 1):
        raise NotImplementedError(
            f"{cfg.model} on a mesh or over {multihost.world_size()} "
            f"ranks: the SEAL and KGE trainers have no data axis (the JAX "
            f"package's train/seal_loop.py and train/kge_loop.py never read "
            f"the mesh), and W independent copies are not one run")
    if cfg.mesh_shape:   # (Config gives --memory_sharded a graph axis)
        check_axes(cfg.mesh_shape, cfg.mesh_axes)


def build_trainer(cfg: Config, datasets, num_features, device):
    """The run's trainer (``BuddyTrainer`` or ``ElphTrainer``) with every
    split staged."""
    trainer = TRAINERS[cfg.model](cfg, datasets["train"], num_features,
                                  device=device)
    for split in ("valid", "test"):
        trainer.stage(split, datasets[split])
    # citation2 (BUDDY, as in the JAX runner): the train metric on a small
    # subset with aligned same-source negatives (reference get_loaders,
    # data.py:55-59)
    trainer.train_eval_split = "train"
    if cfg.dataset_name == "ogbl-citation2" and cfg.model == "BUDDY":
        trainer.stage("train_eval", make_train_eval_dataset(datasets["train"]))
        trainer.train_eval_split = "train_eval"
    return trainer


def _heartbeat(cfg: Config):
    """The failure detector of a multi-process run with
    ``--heartbeat_dir`` (None otherwise): a peer silent for
    ``heartbeat_timeout`` seconds is dead; each rank beats 20 times a
    timeout, at most every 2 s."""
    return fault.maybe_start(cfg.heartbeat_dir,
                             interval=min(2.0, cfg.heartbeat_timeout / 20),
                             timeout=cfg.heartbeat_timeout)


@contextlib.contextmanager
def _profile(profile_dir: str, dev):
    """``torch.profiler`` over the block (host activity, and the card's
    kernels on a CUDA device), its trace written to
    ``profile_dir/epoch1_rank<r>.pt.trace.json``."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"epoch1_rank{multihost.rank()}.pt.trace.json"))


def run(cfg: Config, device=None):
    """Rep loop with best-val model selection (reference run.py:50-110).

    ``device`` None: ``cfg.platform``'s device, else CUDA
    (``cuda:LOCAL_RANK`` under torchrun).  Besides the JAX runner's
    per-rep logger keys, each eval row carries ``rep<r>_get_data_time``
    (loading and splitting the dataset), ``rep<r>_preprocess_time``,
    ``rep<r>_train_time`` (the epoch's training alone) and
    ``rep<r>_eval_time``, in seconds.  In a process group of several
    ranks every rank runs this loop (evaluation is replicated), rank 0
    writes the checkpoints and the run's metadata, and after every epoch
    the ranks must hold the same state bits."""
    dev = resolve_device(device_from_flags(device, cfg.platform))
    _refuse_unported(cfg)
    if cfg.compilation_cache_dir:
        cuda_build.set_build_dir(cfg.compilation_cache_dir)
    print(f"executing on {dev} (rank {multihost.rank()} of "
          f"{multihost.world_size()})")
    detector = _heartbeat(cfg)
    try:
        return _run(cfg, dev, detector)
    finally:
        if detector is not None:
            detector.stop()


def _run(cfg: Config, dev, detector):
    # one metrics sink a run: rank 0's (every rank computes the same rows)
    lead = multihost.rank() == 0
    logger = MetricsLogger(
        run_dir=cfg.checkpoint_dir if lead else None,
        use_wandb=cfg.wandb and lead,
        config=None if cfg.checkpoint_dir is None else
        json.loads(cfg.to_json()),
        wandb_kwargs=dict(
            entity=cfg.wandb_entity, project=cfg.wandb_project,
            group=cfg.wandb_group, name=cfg.wandb_run_name,
            dir=cfg.wandb_output_dir,
            mode="offline" if cfg.use_wandb_offline else "online"))
    results_list = []
    for rep in range(cfg.reps):
        set_seed(rep)
        t0 = time.time()
        splits, directed, eval_metric = get_data(cfg)
        get_data_time = time.time() - t0
        if cfg.eval_metric != "hits":
            eval_metric = cfg.eval_metric
        t0 = time.time()
        if cfg.model in SEAL_MODELS:
            trainer = build_seal_trainer(cfg, splits, dev)
        elif cfg.model in KGE_MODELS:
            trainer = KgeTrainer(cfg, splits, device=dev)
        else:
            datasets = build_all_splits(splits, cfg, directed=directed,
                                        device=dev)
            num_features = (None if datasets["train"].x is None
                            else datasets["train"].x.shape[-1])
            trainer = build_trainer(cfg, datasets, num_features, dev)
        preprocess_time = time.time() - t0
        print(f"preprocessing ran in {preprocess_time:.2f}s")
        model = trainer.init_model(rep)
        optimizer = make_optimizer(cfg, model.parameters())
        start_epoch = 0
        resumed_meta = None
        if cfg.resume and cfg.checkpoint_dir and rep == 0:
            # the loop continues FROM the restored epoch: each epoch's seed
            # is epoch_seed(rep, epoch), so the resumed run's remaining
            # epochs are bit-identical to an uninterrupted run's
            step = checkpoint.latest_step(cfg.checkpoint_dir)
            if detector is not None:
                # ranks may see different directory states (lag, a copy
                # that was not shared): agree on the newest step every
                # rank sees, or none, so that the barrier tags of every
                # rank's epochs stay the same
                step = detector.agree_min(
                    "resume_step", -1 if step is None else step)
                step = None if step < 0 else step
            if step is not None:
                step = checkpoint.restore_into(cfg.checkpoint_dir, model,
                                               optimizer, step=step)
                start_epoch = min(step, cfg.epochs)
                # best-val tracking is host state: without it the resumed
                # run would re-select best-val over the remaining epochs
                resumed_meta = checkpoint.load_run_meta(cfg.checkpoint_dir,
                                                        step)
                print(f"resumed from checkpoint step {step}")

        if cfg.check_determinism and rep == 0:
            n_arr, dloss = check_epoch_determinism(
                trainer, model, optimizer, epoch_seed(rep, 0))
            print(f"determinism check passed: {n_arr} state tensors "
                  f"bitwise-identical across epoch reruns (loss {dloss:.4f})")

        val_res = test_res = train_res = 0.0
        best_epoch = 0
        if resumed_meta is not None:
            val_res = resumed_meta.get("val_res", 0.0)
            test_res = resumed_meta.get("test_res", 0.0)
            train_res = resumed_meta.get("train_res", 0.0)
            best_epoch = resumed_meta.get("best_epoch", 0)
        print(f"running repetition {rep}")
        for epoch in range(start_epoch, cfg.epochs):
            if detector is not None:
                # out of band, before the epoch's first collective: a peer
                # that died since the last check raises PeerFailure here
                # instead of hanging this rank inside the fabric
                detector.barrier(f"rep{rep}_ep{epoch}")
            t0 = time.time()
            if cfg.profile_dir and epoch == 1 and rep == 0:
                # epoch 1, as the JAX runner: epoch 0's first calls (kernel
                # builds, allocator growth) stay out of the trace
                with _profile(cfg.profile_dir, dev):
                    loss = trainer.train_epoch(model, optimizer,
                                               epoch_seed(rep, epoch))
                print(f"wrote profiler trace to {cfg.profile_dir}")
            else:
                loss = trainer.train_epoch(model, optimizer,
                                           epoch_seed(rep, epoch))
            train_time = time.time() - t0
            if detector is not None:
                detector.check()
            assert_ranks_agree(model, optimizer)
            if (epoch + 1) % cfg.eval_steps == 0:
                t1 = time.time()
                results = test(trainer, model, cfg, eval_metric,
                               train_split=trainer.train_eval_split)
                eval_time = time.time() - t1
                for key, result in results.items():
                    train_res, tmp_val, tmp_test = (list(result) + [0.0])[:3]
                    if tmp_val > val_res:
                        val_res, test_res, best_epoch = tmp_val, tmp_test, epoch
                    # per-rep metric dict mirrors the reference's wandb keys
                    # (run.py:82-88)
                    logger.log({f"rep{rep}_loss": loss,
                                f"rep{rep}_Train{key}": 100 * train_res,
                                f"rep{rep}_Val{key}": 100 * val_res,
                                f"rep{rep}_tmp_val{key}": 100 * tmp_val,
                                f"rep{rep}_tmp_test{key}": 100 * tmp_test,
                                f"rep{rep}_Test{key}": 100 * test_res,
                                f"rep{rep}_best_epoch": best_epoch,
                                f"rep{rep}_epoch_time": time.time() - t0,
                                f"rep{rep}_get_data_time": get_data_time,
                                f"rep{rep}_preprocess_time": preprocess_time,
                                f"rep{rep}_train_time": train_time,
                                f"rep{rep}_eval_time": eval_time},
                               # globally monotonic across reps: wandb drops
                               # rows whose step goes backwards
                               step=rep * cfg.epochs + epoch)
                    print(key)
                    print(f"Epoch: {epoch:02d}, Best epoch: {best_epoch}, "
                          f"Loss: {loss:.4f}, Train: {100 * train_res:.2f}%, "
                          f"Valid: {100 * val_res:.2f}%, "
                          f"Test: {100 * test_res:.2f}%, "
                          f"epoch time: {time.time() - t0:.1f}")
            if (cfg.checkpoint_every and cfg.checkpoint_dir and rep == 0
                    and (epoch + 1) % cfg.checkpoint_every == 0):
                # after this epoch's eval, so the sidecar meta carries the
                # best-val tracking including it
                checkpoint.save_checkpoint(cfg.checkpoint_dir, model,
                                           optimizer, step=epoch + 1)
                if multihost.rank() == 0:
                    checkpoint.save_run_meta(cfg.checkpoint_dir, epoch + 1, {
                        "val_res": float(val_res),
                        "test_res": float(test_res),
                        "train_res": float(train_res),
                        "best_epoch": int(best_epoch)})
        if start_epoch >= cfg.epochs and cfg.epochs > 0:
            # resumed from a checkpoint at/past cfg.epochs (e.g. one written
            # by --save_model after a completed run): the loop body never
            # ran.  Evaluate the restored model instead of reporting zeros.
            print(f"checkpoint step {start_epoch} >= epochs {cfg.epochs}; "
                  f"evaluating restored state")
            results = test(trainer, model, cfg, eval_metric,
                           train_split=trainer.train_eval_split)
            for key, result in results.items():
                train_res, tmp_val, tmp_test = (list(result) + [0.0])[:3]
                if tmp_val > val_res:
                    val_res, test_res = tmp_val, tmp_test
        results_list.append([test_res, val_res, train_res])
        if cfg.reps > 1:
            for idx, res in enumerate(results_list):
                print(f"repetition {idx}: test {res[0]:.2f}, val {res[1]:.2f}, "
                      f"train {res[2]:.2f}")
    if cfg.reps > 1:
        arr = np.array(results_list) * 100
        print({"test_mean": arr[:, 0].mean(), "val_mean": arr[:, 1].mean(),
               "train_mean": arr[:, 2].mean(),
               "test_acc_std": arr[:, 0].std(), "val_acc_std": arr[:, 1].std()})
    if cfg.save_model and cfg.checkpoint_dir:
        path = checkpoint.save_checkpoint(cfg.checkpoint_dir, model,
                                          optimizer, step=cfg.epochs)
        print(f"saved checkpoint to {path}")
    logger.finish()
    return results_list


def make_parser() -> argparse.ArgumentParser:
    """Flags mirror reference run.py:147-261 (same names/defaults), built
    from ``Config`` as the JAX runner builds them, plus ``--device``."""
    parser = argparse.ArgumentParser(
        description="Efficient Link Prediction with Hashes (ELPH) — "
                    "PyTorch/CUDA")
    defaults = Config()
    for f in dataclasses.fields(Config):
        name = f"--{f.name}"
        default = getattr(defaults, f.name)
        if f.name == "use_wandb_offline":
            # the reference spells the flag --wandb_offline with dest
            # use_wandb_offline (run.py:243); accept both
            parser.add_argument("--wandb_offline", name,
                                dest="use_wandb_offline", type=str2bool,
                                nargs="?", const=True, default=default)
            continue
        if f.name == "mesh_shape":
            parser.add_argument(name, type=lambda s: [int(x) for x in
                                                      s.split(",")],
                                default=None,
                                help="device mesh, e.g. '8' or '4,2'")
            continue
        if f.name == "mesh_axes":
            parser.add_argument(name, type=lambda s: s.split(","),
                                default=["data"])
            continue
        if isinstance(default, bool):
            # nargs="?": both the reference's store_true style
            # (`--cache_subgraph_features`, README.md:77) and the sweepable
            # `--use_feature 0` style parse
            parser.add_argument(name, type=str2bool, nargs="?", const=True,
                                default=default)
        elif f.type in ("float", float) or isinstance(default, float):
            parser.add_argument(name, type=float, default=default)
        elif isinstance(default, int):
            parser.add_argument(name, type=int, default=default)
        elif default is None and "int" in str(f.type):
            parser.add_argument(name, type=int, default=None)
        else:
            parser.add_argument(name, type=str, default=default)
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: "
                             "--platform's device, else cuda; "
                             "cuda:LOCAL_RANK under torchrun)")
    return parser


def config_from_parsed(args) -> Config:
    """Parsed args -> Config (``--device`` is not a Config field), with the
    negative-means-unlimited normalisation of the sample-count fields (the
    reference CLI's -1 sentinel)."""
    d = {k: v for k, v in vars(args).items() if k != "device"}
    for k in ("train_samples", "val_samples", "test_samples",
              "train_cache_size"):
        if d[k] is not None and d[k] < 0:
            d[k] = inf
    return Config(**d)


def main(argv=None):
    """The CLI.  Under torchrun (``WORLD_SIZE`` in the environment), or
    with ``--mesh_shape``, it first joins the process group (staying
    single-process, loudly, where there is none) and leaves it at the
    end; a group its caller joined is left as it is."""
    args = make_parser().parse_args(argv)
    cfg = apply_sweep_overrides(config_from_parsed(args))
    print(cfg)
    device = device_from_flags(args.device, cfg.platform)
    joined = False
    if (cfg.mesh_shape or "WORLD_SIZE" in os.environ) \
            and not multihost.initialized():
        multihost.initialize(device=device)
        joined = multihost.initialized()
    try:
        return run(cfg, device=device)
    finally:
        if joined:
            multihost.shutdown()


if __name__ == "__main__":
    main()
