"""Multi-rank dry run of the data-parallel ELPH step: the data-axis half
of the JAX package's ``__graft_entry__.dryrun_multichip``.

Run it on every rank of a process group of ``n_devices`` ranks (one
process each, ``multihost.initialize``), or with ``n_devices`` 1 in a
single process:

    python -c "from subgraph_sketching_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(1, device='cpu')"

It runs TWO steps of the full ELPH step (GCN feature side and
LinkPredictor head) over the ranks, and asserts that each loss equals the
single-device step's on the whole batch: the mesh program must be the
same math, not just a finite one.
"""

from __future__ import annotations

import numpy as np
import torch

from subgraph_sketching_tpu_torch.device import resolve_device
from subgraph_sketching_tpu_torch.graph.synthetic import (
    barabasi_albert_graph,
)
from subgraph_sketching_tpu_torch.parallel import multihost
from subgraph_sketching_tpu_torch.parallel.mesh import make_mesh
from subgraph_sketching_tpu_torch.parallel.train import (
    make_distributed_train_step, single_device_reference_step,
)
from subgraph_sketching_tpu_torch.sketch.params import SketchParams

# |loss - single-device loss| <= LOSS_RTOL * max(1, |single-device loss|)
LOSS_RTOL = 1e-4


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Two data-parallel ELPH steps over the process group's
    ``n_devices`` ranks against the single-device step on every rank;
    returns {"losses": [...], "reference_losses": [...]}."""
    world = multihost.world_size()
    if world != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) runs on a process "
                         f"group of {n_devices} ranks; this one has {world}")
    dev = resolve_device(device)
    mesh = make_mesh([n_devices], ("data",), dev)
    num_nodes = 64
    params = SketchParams(max_hops=2)
    ei = torch.from_numpy(barabasi_albert_graph(num_nodes, 4, seed=0)
                          .astype(np.int64)).to(dev)
    B = max(16, 2 * n_devices)
    links = torch.from_numpy(np.stack(
        [np.arange(B) % num_nodes, (np.arange(B) * 7 + 3) % num_nodes],
        axis=1)).to(dev)
    labels = torch.from_numpy((np.arange(B) % 2).astype(np.float32)).to(dev)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (num_nodes, 16), dtype=np.float32)).to(dev)

    kw = dict(hidden_channels=16, num_nodes=num_nodes, label_dropout=0.0,
              feature_dropout=0.0)
    init_fn, step_fn, build = make_distributed_train_step(mesh, params, **kw)
    ref_init, ref_step, ref_build = single_device_reference_step(
        params, device=dev, **kw)
    # sketches built ONCE per graph (step-constant), passed into every step
    sk, sk_ref = build(ei), ref_build(ei)
    if not (torch.equal(sk.minhash, sk_ref.minhash)
            and torch.equal(sk.hll, sk_ref.hll)):
        raise AssertionError("the mesh's sketches differ from the "
                             "single-device build")
    state, ref_state = init_fn(0, x), ref_init(0, x)
    losses, ref_losses = [], []
    for i in range(2):
        loss = float(step_fn(state, x, ei, None, sk, links, labels,
                             torch.Generator(dev).manual_seed(7 + i)))
        ref = float(ref_step(ref_state, x, ei, None, sk_ref, links, labels,
                             torch.Generator(dev).manual_seed(7 + i)))
        if not np.isfinite(loss):
            raise AssertionError(f"non-finite loss {loss}")
        if abs(loss - ref) > LOSS_RTOL * max(1.0, abs(ref)):
            raise AssertionError(f"mesh step diverges from single-device: "
                                 f"{loss} vs {ref}")
        losses.append(loss)
        ref_losses.append(ref)
    return {"losses": losses, "reference_losses": ref_losses}
