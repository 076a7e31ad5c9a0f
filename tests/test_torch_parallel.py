"""The port's data-parallel layer (subgraph_sketching_tpu_torch/parallel,
the trainers' data axis) on the CPU: two gloo ranks against one process
and against the JAX package's ``mesh_shape=[2]`` trainers (the conftest's
virtual CPU devices).

One two-rank session per module (``session``): the parent writes the
inputs, spawns the two ranks (a FileStore in ``tmp_path``, one torch
thread each), computes the JAX and single-process references while they
run, and the tests assert on what each rank saved.  The ranks import
neither jax nor the JAX package.

Tolerances:
  * shard helpers, sketches, the dry run's refusals: equal;
  * cross-rank BatchNorm against ``F.batch_norm`` over the concatenated
    batch (forward, input and parameter gradients, running statistics):
    rtol 1e-6, atol 1e-6 (the sums split over two ranks round
    differently);
  * BCE and AUC losses and their gradients over the global batch:
    rtol 1e-6, atol 1e-7;
  * a W = 2 epoch (2 epochs, dropout on) against the single-process epoch
    of the same seed: step losses rtol 1e-5;
  * a W = 2 epoch against JAX's ``mesh_shape=[2]`` trainer on its order,
    with dropout 0 and the biases that feed a BatchNorm frozen: the
    tolerances of tests/test_torch_train.py (step losses rtol 1e-4;
    parameters and BN buffers rtol 1e-4, atol 1e-5; embedding tables as
    tests/test_torch_embedding_train.py holds them);
  * the distributed ELPH step against its single-device oracle: losses
    rtol 1e-5; the oracle against JAX's: losses rtol 1e-5; parameters
    rtol 1e-4, atol 1e-5, but for the two biases that feed a BatchNorm
    (as tests/test_parallel.py skips them);
  * every parameter, buffer and Adam moment bit-equal across the ranks.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from subgraph_sketching_tpu.config import Config as JConfig
from subgraph_sketching_tpu.graph.preprocess import (
    LinkDataset as JLinkDataset, sketch_params_from_config as jsketch_params,
)
from subgraph_sketching_tpu.parallel import multihost as jmultihost
from subgraph_sketching_tpu.parallel.train import (
    single_device_reference_step as jreference_step,
)
from subgraph_sketching_tpu.sketch import SketchParams as JSketchParams
from subgraph_sketching_tpu.train import loops as jloops
from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.graph.datasets import get_data
from subgraph_sketching_tpu_torch.graph.preprocess import build_all_splits
from subgraph_sketching_tpu_torch.models import (
    buddy_state_dict_from_flax, elph_state_dict_from_flax,
)
from subgraph_sketching_tpu_torch.models.gnn import batch_norm
from subgraph_sketching_tpu_torch.parallel import multihost
from subgraph_sketching_tpu_torch.parallel.mesh import (
    flat_grads, make_mesh, mesh_from_config,
)
from subgraph_sketching_tpu_torch.train import loops
from subgraph_sketching_tpu_torch.train.losses import get_loss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2

# the three trained shapes: BUDDY, ELPH and BUDDY with a trainable table
# diffused in every step (the ogbl-ddi shape: no node features)
BASE = dict(dataset_name="synth-ba", hidden_channels=16, batch_size=1024,
            eval_batch_size=2048)
SHAPES = {
    "BUDDY": dict(model="BUDDY"),
    "ELPH": dict(model="ELPH"),
    "BUDDY_emb": dict(model="BUDDY", train_node_embedding=True,
                      propagate_embeddings=True, sign_k=2,
                      use_feature=False),
}
NO_DROPOUT = dict(label_dropout=0.0, feature_dropout=0.0, sign_dropout=0.0)
# biases of the Linear layers that feed a BatchNorm (tests/test_torch_
# train.py): frozen on both sides of the JAX comparisons
PRE_BN = {
    "BUDDY": re.compile(r"(label_lin_layer|lin_out)\.bias"),
    "ELPH": re.compile(r"predictor\.(label_lin_layer|lin_out)\.bias"),
    "BUDDY_emb": re.compile(r"(buddy\.(label_lin_layer|lin_emb_out)|"
                            r"sign_embedding\.lin_\d+)\.bias"),
}
EPOCHS = 2
STEP = dict(num_nodes=64, hidden_channels=16, batch=32, steps=2)

_RANK = r'''
import os, re, sys
repo, work, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
sys.path.insert(0, repo)
import torch
torch.set_num_threads(1)
from subgraph_sketching_tpu_torch.parallel import multihost
multihost.initialize("file://" + os.path.join(work, "store"), num_processes=2,
                     process_id=rank, backend="gloo")
try:
    from subgraph_sketching_tpu_torch.config import Config
    from subgraph_sketching_tpu_torch.graph.datasets import get_data
    from subgraph_sketching_tpu_torch.graph.preprocess import build_all_splits
    from subgraph_sketching_tpu_torch.models.gnn import (
        batch_norm, shard_batch_axis)
    from subgraph_sketching_tpu_torch.parallel.dryrun import dryrun_multichip
    from subgraph_sketching_tpu_torch.parallel.mesh import (
        flat_grads, make_mesh)
    from subgraph_sketching_tpu_torch.parallel.train import (
        make_distributed_train_step, single_device_reference_step)
    from subgraph_sketching_tpu_torch.sketch.params import SketchParams
    from subgraph_sketching_tpu_torch.train import loops
    from subgraph_sketching_tpu_torch.train.determinism import (
        check_epoch_determinism)
    from subgraph_sketching_tpu_torch.train.losses import get_loss

    inp = torch.load(os.path.join(work, "inputs.pt"))
    mesh = make_mesh([2], ["data"], "cpu")
    out = {}

    b = inp["bn"]
    bn = batch_norm(b["x"].shape[1])
    bn.load_state_dict(b["state"])
    shard_batch_axis(bn, mesh)
    bn.train()
    x = mesh.shard(b["x"]).clone().requires_grad_()
    y = bn(x)
    grads = flat_grads(bn)
    grads.zero_grad()
    (y * mesh.shard(b["cot"])).sum().backward()
    grads.all_reduce()
    out["bn"] = dict(y=y.detach(), x_grad=x.grad, weight_grad=bn.weight.grad,
                     bias_grad=bn.bias.grad, running_mean=bn.running_mean,
                     running_var=bn.running_var)

    for name in ("bce", "auc"):
        lg = mesh.shard(inp["loss"]["logits"]).clone().requires_grad_()
        loss = get_loss(name)(lg, mesh.shard(inp["loss"]["labels"]),
                              mesh.shard(inp["loss"]["mask"]), mesh=mesh)
        loss.backward()
        out[name] = dict(loss=loss.detach(), grad=lg.grad)

    datasets = {}
    for name, case in inp["cases"].items():
        cfg = Config(**case["cfg"], mesh_shape=[2], mesh_axes=["data"])
        key = (cfg.model, cfg.sign_k)   # BUDDY's x is SIGN-propagated
        if key not in datasets:
            splits, directed, _ = get_data(cfg)
            datasets[key] = build_all_splits(splits, cfg, directed=directed,
                                             device="cpu")
        ds = datasets[key]["train"]
        trainer = {"BUDDY": loops.BuddyTrainer,
                   "ELPH": loops.ElphTrainer}[cfg.model]
        tr = trainer(cfg, ds, ds.x.shape[-1], device="cpu")
        model = tr.init_model(0)
        if case["state"] is not None:
            model.load_state_dict(case["state"])
        for p_name, p in model.named_parameters():
            p.requires_grad_(case["frozen"] is None
                             or not re.fullmatch(case["frozen"], p_name))
        opt = loops.make_optimizer(cfg, model.parameters())
        losses = [tr.run_epoch(model, opt, loops.epoch_seed(0, e),
                               order=None if case["orders"] is None
                               else case["orders"][e])
                  for e in range(case["epochs"])]
        out[name] = dict(losses=torch.cat(losses), state=model.state_dict(),
                         adam=[t for s in opt.state.values()
                               for t in (s["exp_avg"], s["exp_avg_sq"])])
        if name == "BUDDY/dropout":
            model = tr.init_model(1)
            opt = loops.make_optimizer(cfg, model.parameters())
            out["determinism"] = check_epoch_determinism(tr, model, opt, 5)
            try:
                trainer(Config(**{**case["cfg"], "batch_size": 1023},
                               mesh_shape=[2], mesh_axes=["data"]),
                        ds, ds.x.shape[-1], device="cpu")
            except ValueError as e:
                out["odd_batch"] = str(e)

    s = inp["step"]
    params = SketchParams(max_hops=2)
    kw = dict(hidden_channels=s["hidden_channels"], num_nodes=s["num_nodes"],
              label_dropout=0.0, feature_dropout=0.0)
    runs = {"mesh": make_distributed_train_step(mesh, params, **kw),
            "oracle": single_device_reference_step(params, device="cpu", **kw)}
    for what, (init_fn, step_fn, build) in runs.items():
        state = init_fn(0, s["x"])
        state.model.load_state_dict(s["state"])
        sk = build(s["edge_index"])
        losses = [step_fn(state, s["x"], s["edge_index"], None, sk,
                          s["links"], s["labels"],
                          torch.Generator().manual_seed(7 + i))
                  for i in range(s["steps"])]
        out["step/" + what] = dict(losses=torch.stack(losses),
                                   state=state.model.state_dict(),
                                   minhash=sk.minhash, hll=sk.hll)
    out["dryrun"] = dryrun_multichip(2, device="cpu")
    out["jax_modules"] = sorted(
        k for k in sys.modules if k in ("jax", "flax", "subgraph_sketching_tpu")
        or k.startswith(("jax.", "jaxlib", "flax.", "subgraph_sketching_tpu.")))
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
finally:
    multihost.shutdown()
'''


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _freeze_in_optax(jtr, pattern, strip_top: bool):
    """Freeze the JAX parameters whose port names match ``pattern``: the
    tree's path joined by dots (its top key dropped where the port model
    is the plain BUDDY that the tree wraps)."""
    def frozen(path, _):
        keys = [k.key for k in path][1 if strip_top else 0:]
        return bool(pattern.fullmatch(".".join(keys)))

    jtr.optimizer = optax.chain(jtr.optimizer, optax.masked(
        optax.set_to_zero(),
        lambda params: jax.tree_util.tree_map_with_path(frozen, params)))


def _datasets(cfg: Config) -> dict:
    splits, directed, _ = get_data(cfg)
    return build_all_splits(splits, cfg, directed=directed, device="cpu")


def _jax_trainer(shape: str) -> dict:
    """JAX's ``mesh_shape=[2]`` trainer of ``shape`` (dropout 0, PRE_BN
    frozen) on the port's arrays, its initial state, that state's weights
    as a port state_dict, and the orders of its two epochs."""
    kw = {**BASE, **SHAPES[shape], **NO_DROPOUT}
    cfg = Config(**kw)
    jcfg = JConfig(**kw, mesh_shape=[WORLD], mesh_axes=["data"])
    ds = _datasets(cfg)["train"]
    buddy = cfg.model == "BUDDY"
    jds = JLinkDataset(ds.links, ds.labels, ds.edge_index, ds.edge_weight,
                       ds.num_nodes, ds.x, ds.degrees,
                       subgraph_features=ds.subgraph_features if buddy
                       else None)
    width = ds.x.shape[-1]
    jtr = (jloops.BuddyTrainer(jcfg, jds, width) if buddy
           else jloops.ElphTrainer(jcfg, jds, jsketch_params(jcfg), width))
    _freeze_in_optax(jtr, PRE_BN[shape], strip_top=shape == "BUDDY")
    model = (loops.BuddyTrainer if buddy else loops.ElphTrainer)(
        cfg, ds, width, device="cpu").init_model(0)

    def to_port(state):
        params, stats = _np_tree(state.params), _np_tree(state.batch_stats)
        if buddy:
            return buddy_state_dict_from_flax(params, stats, model)
        return elph_state_dict_from_flax(params, stats)

    state = jtr.init_state(jax.random.PRNGKey(0))
    n = jtr.num_links("train")
    assert n % jcfg.batch_size != 0            # a padded tail
    n_used, _ = jloops._epoch_plan(n, jcfg.batch_size, jcfg.train_samples)
    orders = [torch.from_numpy(np.asarray(jax.random.permutation(
        jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), e))[0],
        n)[:n_used]).astype(np.int64)) for e in range(EPOCHS)]
    return dict(jtr=jtr, state=state, init=to_port(state), orders=orders,
                to_port=to_port)


def _jax_epochs(side: dict) -> tuple:
    """The JAX trainer's two epochs (on the orders of ``_jax_trainer``):
    (step losses, final state as a port state_dict)."""
    jtr, state = side["jtr"], side["state"]
    n = jtr.num_links("train")
    n_used, steps = jloops._epoch_plan(n, jtr.cfg.batch_size,
                                       jtr.cfg.train_samples)
    epoch_jit = jtr._train_epoch_fn(n_used, steps)
    arrays = {k: v for k, v in jtr._data["train"].items()
              if k != "num_nodes"}
    losses = []
    for epoch in range(EPOCHS):
        key = jax.random.fold_in(jax.random.PRNGKey(0), epoch)
        state, step_losses = epoch_jit(state, key, arrays)
        losses.append(np.asarray(step_losses))
    return np.concatenate(losses), side["to_port"](state)


def _single_process(shape: str) -> np.ndarray:
    """The port's single-process step losses of the dropout case."""
    cfg = Config(**BASE, **SHAPES[shape])
    ds = _datasets(cfg)["train"]
    tr = (loops.BuddyTrainer if cfg.model == "BUDDY" else loops.ElphTrainer)(
        cfg, ds, ds.x.shape[-1], device="cpu")
    model = tr.init_model(0)
    opt = loops.make_optimizer(cfg, model.parameters())
    return torch.cat([tr.run_epoch(model, opt, loops.epoch_seed(0, e))
                      for e in range(EPOCHS)]).numpy()


def _step_inputs():
    """The distributed step's graph and batch (tests/test_parallel.py's
    shape), and JAX's single-device reference step run on them: its
    initial weights as an ELPHPredictor state_dict and its losses."""
    from subgraph_sketching_tpu.graph.synthetic import barabasi_albert_graph
    from subgraph_sketching_tpu.sketch.elph import initialise_sketches
    n, b = STEP["num_nodes"], STEP["batch"]
    ei = barabasi_albert_graph(n, 4, seed=0).astype(np.int64)
    links = np.stack([np.arange(b) % n, (np.arange(b) * 7 + 3) % n], axis=1)
    labels = (np.arange(b) % 2).astype(np.float32)
    x = np.random.default_rng(0).random((n, 16), dtype=np.float32)
    params = JSketchParams(max_hops=2)
    init_fn, step_fn, _, build = jreference_step(
        params, STEP["hidden_channels"], n, label_dropout=0.0,
        feature_dropout=0.0)
    mask = jnp.ones(ei.shape[1], bool)
    mh0, hll0 = initialise_sketches(n, params)
    sk = build(jnp.asarray(ei), mask, jnp.asarray(mh0), jnp.asarray(hll0))
    state = init_fn(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ei),
                    mask, jnp.asarray(links))
    init = elph_state_dict_from_flax(_np_tree(state.params),
                                     _np_tree(state.batch_stats))
    losses = []
    for i in range(STEP["steps"]):
        state, loss = step_fn(state, jnp.asarray(x), jnp.asarray(ei), mask,
                              sk, jnp.asarray(links), jnp.asarray(labels),
                              jax.random.PRNGKey(7 + i))
        losses.append(float(loss))
    return (dict(x=torch.from_numpy(x), edge_index=torch.from_numpy(ei),
                 links=torch.from_numpy(links),
                 labels=torch.from_numpy(labels), state=init,
                 steps=STEP["steps"], num_nodes=n,
                 hidden_channels=STEP["hidden_channels"]),
            dict(losses=np.array(losses), minhash=np.asarray(sk.minhash),
                 state=elph_state_dict_from_flax(
                     _np_tree(state.params), _np_tree(state.batch_stats))))


def _spawn(script: str, work: str, args_of_rank) -> list:
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    return [subprocess.Popen([sys.executable, script, *args_of_rank(r)],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, env=env)
            for r in range(WORLD)]


def run_once(request, tmp_path_factory, name: str, compute):
    """``compute(work_dir)``'s result, computed once per test run: under
    pytest-xdist the first worker to need it computes it (holding a lock
    in the run's shared temporary directory, which the other workers
    wait on) and saves it there, and the others load it; in one process
    the module fixture's own caching does."""
    if getattr(request.config, "workerinput", None) is None:
        return compute(str(tmp_path_factory.mktemp(name)))
    import fcntl
    root = tmp_path_factory.getbasetemp().parent   # shared by the workers
    saved = root / f"{name}.pt"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not saved.exists():
            work = root / name
            work.mkdir()
            torch.save(compute(str(work)), saved)
    # written by this run's own worker: not outside input
    return torch.load(saved, weights_only=False)


@pytest.fixture(scope="module")
def session(request, tmp_path_factory):
    """The two-rank session (module docstring), once per run."""
    return run_once(request, tmp_path_factory, "dp_session", _session)


def _session(work: str) -> dict:
    g = torch.Generator().manual_seed(0)
    bn = batch_norm(6)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.uniform_(-0.5, 0.5, generator=g)
    inputs = {
        "bn": dict(x=torch.randn(24, 6, generator=g) * 3 + 1,
                   cot=torch.randn(24, 6, generator=g),
                   state=bn.state_dict()),
        "loss": dict(logits=torch.randn(20, generator=g),
                     labels=(torch.rand(20, generator=g) < 0.4).float(),
                     mask=torch.arange(20) < 17),
        "cases": {}}
    jax_trainers = {s: _jax_trainer(s) for s in SHAPES}
    for s, shape in SHAPES.items():
        inputs["cases"][f"{s}/dropout"] = dict(
            cfg={**BASE, **shape}, epochs=EPOCHS, orders=None, state=None,
            frozen=None)
        inputs["cases"][f"{s}/jax"] = dict(
            cfg={**BASE, **shape, **NO_DROPOUT}, epochs=EPOCHS,
            orders=jax_trainers[s]["orders"], state=jax_trainers[s]["init"],
            frozen=PRE_BN[s].pattern)
    inputs["step"], jax_step = _step_inputs()
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    script = os.path.join(work, "rank.py")
    with open(script, "w") as f:
        f.write(_RANK)
    procs = _spawn(script, work, lambda r: [REPO, work, str(r)])
    try:   # the references, while the ranks run
        jax_side = {s: _jax_epochs(t) for s, t in jax_trainers.items()}
        single = {s: _single_process(s) for s in SHAPES}
    finally:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"))
             for r in range(WORLD)]
    return dict(inputs=inputs, ranks=ranks, jax=jax_side, single=single,
                jax_step=jax_step)


def _bits_equal(a, b) -> bool:
    a, b = (t.detach().reshape(-1).view(torch.uint8) for t in (a, b))
    return torch.equal(a, b)


def _global(ranks, key, field):
    """The W ranks' blocks of one output, concatenated in rank order."""
    return torch.cat([r[key][field] for r in ranks])


# ------------------------------------------------------ shard helpers --

@pytest.mark.parametrize("n,index,count", [
    (10, 0, 3), (10, 2, 3), (12, 1, 4), (3, 3, 4), (0, 0, 2)])
def test_process_shard_matches_jax(n, index, count):
    assert multihost.process_shard(n, index, count) \
        == jmultihost.process_shard(n, index, count)


@pytest.mark.parametrize("n,index,count,pad", [
    (12, 1, 4, None), (10, 2, 3, -1), (10, 0, 3, None), (10, 3, 4, 0)])
def test_host_local_batch_matches_jax(monkeypatch, n, index, count, pad):
    monkeypatch.setattr(jmultihost.jax, "process_index", lambda: index)
    monkeypatch.setattr(jmultihost.jax, "process_count", lambda: count)
    arr = np.arange(2 * n).reshape(n, 2)
    try:
        want = jmultihost.host_local_batch(arr, pad_value=pad)
    except ValueError:
        with pytest.raises(ValueError):
            multihost.host_local_batch(arr, pad, index, count)
        return
    np.testing.assert_array_equal(
        multihost.host_local_batch(arr, pad, index, count), want)


# ------------------------------------------------------------ refusals --

def test_make_mesh_refuses_what_is_not_the_data_axis():
    assert make_mesh([1], ["data"], "cpu").world_size == 1  # no group
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh([2], ["data"], "cpu")
    for axes in (["graph"], ["data", "lane"]):
        with pytest.raises(NotImplementedError, match="item 9b"):
            make_mesh([1] * len(axes), axes, "cpu")
    with pytest.raises(NotImplementedError, match="item 9b"):
        mesh_from_config(Config(mesh_shape=[1, 1], mesh_axes=["data",
                                                               "graph"],
                                memory_sharded=True), "cpu")


def test_make_mesh_defaults_to_the_card(monkeypatch):
    """Without a device the mesh is on this rank's card, and without a
    card it raises rather than run on the CPU."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh([1], ["data"])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert make_mesh([1], ["data"]).device == torch.device("cuda")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert make_mesh([1], ["data"]).device == torch.device("cuda:3")


@pytest.mark.parametrize("device, local_ranks, cards, want", [
    ("cpu", 1, 0, "gloo"), ("cuda:0", 1, 1, "nccl"), ("cuda:1", 4, 4, "nccl"),
    ("cuda:0", 2, 1, "gloo"), (None, 1, 0, "gloo"), (None, 1, 1, "nccl")])
def test_default_backend(monkeypatch, device, local_ranks, cards, want):
    """NCCL where every local rank has a card of its own, else gloo."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_ranks))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert multihost.default_backend(device) == want


def test_flat_grads_match_set_to_none():
    """Two steps through the flat gradient buffer (no process group: the
    all-reduce is the identity) equal two steps of zero_grad(set_to_none)
    bit for bit; the gradients are views of the buffer, a parameter the
    backward does not reach (``unused``) keeps no gradient, so Adam
    leaves it and its state alone, and a frozen one is left out."""
    def make():
        torch.manual_seed(0)
        m = torch.nn.ModuleDict({"used": torch.nn.Linear(4, 3),
                                 "unused": torch.nn.Linear(4, 3),
                                 "frozen": torch.nn.Linear(3, 1)})
        m["frozen"].weight.requires_grad_(False)
        return m, torch.optim.Adam(m.parameters(), lr=0.1)

    x = torch.randn(8, 4)
    (a, opt_a), (b, opt_b) = make(), make()
    grads = flat_grads(b)
    assert flat_grads(b) is grads
    assert len(grads.params) == 5 and [t.numel() for t in grads.buffers] \
        == [12 + 3 + 12 + 3 + 1]
    for _ in range(2):
        opt_a.zero_grad(set_to_none=True)
        a["frozen"](a["used"](x)).square().sum().backward()
        opt_a.step()
        grads.zero_grad()
        b["frozen"](b["used"](x)).square().sum().backward()
        grads.all_reduce()
        opt_b.step()
    buf = grads.buffers[0]
    for p in b["used"].parameters():
        assert buf.data_ptr() <= p.grad.data_ptr() < buf.data_ptr() \
            + buf.numel() * buf.element_size()
    assert all(p.grad is None for p in b["unused"].parameters())
    assert b["frozen"].weight.grad is None
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
        assert (pa.grad is None) == (pb.grad is None), name
        assert len(opt_a.state[pa]) == len(opt_b.state[pb]), name


def test_trainer_refuses_a_batch_that_does_not_split(session):
    for r in session["ranks"]:
        assert "does not split over 2 ranks" in r["odd_batch"]


def test_ranks_import_no_jax(session):
    assert [r["jax_modules"] for r in session["ranks"]] == [[], []]


# ----------------------------------------------------------- BatchNorm --

def test_cross_rank_batch_norm_equals_one_process(session):
    b = session["inputs"]["bn"]
    bn = batch_norm(b["x"].shape[1])
    bn.load_state_dict(b["state"])
    bn.train()
    x = b["x"].clone().requires_grad_()
    y = bn(x)
    (y * b["cot"]).sum().backward()
    ranks = session["ranks"]
    tol = dict(rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(_global(ranks, "bn", "y"), y.detach(), **tol)
    torch.testing.assert_close(_global(ranks, "bn", "x_grad"), x.grad, **tol)
    for r in ranks:
        torch.testing.assert_close(r["bn"]["weight_grad"], bn.weight.grad,
                                   **tol)
        torch.testing.assert_close(r["bn"]["bias_grad"], bn.bias.grad, **tol)
        torch.testing.assert_close(r["bn"]["running_mean"], bn.running_mean,
                                   **tol)
        torch.testing.assert_close(r["bn"]["running_var"], bn.running_var,
                                   **tol)
    # flax's running variance: from the biased batch variance
    want_var = 0.9 + 0.1 * torch.var(b["x"], dim=0, correction=0)
    torch.testing.assert_close(ranks[0]["bn"]["running_var"], want_var,
                               **tol)


# -------------------------------------------------------------- losses --

@pytest.mark.parametrize("name", ["bce", "auc"])
def test_loss_over_the_global_batch(session, name):
    inp = session["inputs"]["loss"]
    logits = inp["logits"].clone().requires_grad_()
    want = get_loss(name)(logits, inp["labels"], inp["mask"])
    want.backward()
    ranks = session["ranks"]
    for r in ranks:
        torch.testing.assert_close(r[name]["loss"], want.detach(),
                                   rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(_global(ranks, name, "grad"), logits.grad,
                               rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ trainers --

@pytest.mark.parametrize("shape", list(SHAPES))
def test_dp_epoch_equals_the_single_process_epoch(session, shape):
    """Dropout on: the ranks draw the global batch's masks from one
    generator in step, so two epochs at W = 2 repeat the single-process
    epochs of the same seed."""
    ranks = session["ranks"]
    got = ranks[0][f"{shape}/dropout"]["losses"].numpy()
    np.testing.assert_allclose(got, session["single"][shape], rtol=1e-5)


@pytest.mark.parametrize("case", [f"{s}/{k}" for s in SHAPES
                                  for k in ("dropout", "jax")])
def test_state_is_bit_equal_across_ranks(session, case):
    a, b = (r[case] for r in session["ranks"])
    assert _bits_equal(a["losses"], b["losses"])
    assert set(a["state"]) == set(b["state"])
    assert all(_bits_equal(v, b["state"][k]) for k, v in a["state"].items())
    assert len(a["adam"]) == len(b["adam"]) > 0
    assert all(_bits_equal(u, v) for u, v in zip(a["adam"], b["adam"]))


def _assert_param_close(got, want, lr, name):
    """rtol 1e-4 / atol 1e-5 on all but 0.5% of the elements, none of
    them more than lr away (tests/test_torch_embedding_train.py)."""
    err = np.abs(got - want)
    beyond = err > 1e-5 + 1e-4 * np.abs(want)
    assert beyond.mean() <= 0.005, (name, int(beyond.sum()),
                                    float(err.max()))
    assert float(err.max()) <= lr, (name, float(err.max()))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_dp_epoch_matches_jax_mesh_trainer(session, shape):
    want_losses, want_state = session["jax"][shape]
    got = session["ranks"][0][f"{shape}/jax"]
    np.testing.assert_allclose(got["losses"].numpy(), want_losses,
                               rtol=1e-4)
    lr = Config().lr
    for k, v in want_state.items():
        if k.endswith("num_batches_tracked"):
            continue
        g = got["state"][k].numpy()
        if k.endswith("node_embedding"):
            _assert_param_close(g, v.numpy(), lr, k)
        else:
            np.testing.assert_allclose(g, v.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def test_meshed_trainer_is_bitwise_deterministic(session):
    """check_epoch_determinism on the W = 2 BUDDY trainer (dropout on):
    two reruns of an epoch bit-identical, and the ranks' states too."""
    (n0, l0), (n1, l1) = (r["determinism"] for r in session["ranks"])
    assert n0 == n1 > 0 and l0 == l1 and np.isfinite(l0)


# ------------------------------------------------ the distributed step --

# ELPH's biases that feed a BatchNorm (tests/test_parallel.py skips them)
DEGENERATE = re.compile(r"predictor\.(label_lin_layer|lin_out)\.bias")


def _assert_step_states_close(got: dict, want: dict):
    """The parameters, as tests/test_parallel.py compares them (the BN
    running means take in the degenerate biases' drift)."""
    for k, v in want.items():
        if DEGENERATE.fullmatch(k) or ".running_" in k \
                or k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_distributed_step_equals_its_oracle(session):
    ranks = session["ranks"]
    for r in ranks:
        mesh, oracle = r["step/mesh"], r["step/oracle"]
        assert torch.equal(mesh["minhash"], oracle["minhash"])
        assert torch.equal(mesh["hll"], oracle["hll"])
        np.testing.assert_allclose(mesh["losses"].numpy(),
                                   oracle["losses"].numpy(), rtol=1e-5)
        _assert_step_states_close(mesh["state"], oracle["state"])
    a, b = (r["step/mesh"]["state"] for r in ranks)
    assert all(_bits_equal(v, b[k]) for k, v in a.items())


def test_oracle_step_matches_jax(session):
    got, want = session["ranks"][0]["step/oracle"], session["jax_step"]
    from subgraph_sketching_tpu_torch.sketch.minhash import from_biased
    np.testing.assert_array_equal(from_biased(got["minhash"].numpy()),
                                  want["minhash"])
    np.testing.assert_allclose(got["losses"].numpy(), want["losses"],
                               rtol=1e-5)
    _assert_step_states_close(got["state"], want["state"])


def test_dryrun_multichip_on_two_ranks(session):
    for r in session["ranks"]:
        d = r["dryrun"]
        assert len(d["losses"]) == 2 and np.isfinite(d["losses"]).all()
    assert session["ranks"][0]["dryrun"] == session["ranks"][1]["dryrun"]
