"""The port's spans and stages (``subgraph_sketching_tpu_torch/spans.py``)
on the CPU: spans record only under ``torch.profiler``, one of each
training phase a step and one ``PlanSpmm`` pass each way a GCN layer,
under the names the profiler's trace shows; stages record without a
profiler, nest and give self time, sit at the set-up call sites of
preprocessing and staging, and a training step or a prediction adds
none.  The device's clock is the card's only there
(``tests/test_torch_cuda.py``).
"""

import contextlib
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from subgraph_sketching_tpu_torch import spans
from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.graph.datasets import get_data
from subgraph_sketching_tpu_torch.graph.preprocess import build_link_dataset
from subgraph_sketching_tpu_torch.models.gnn import BatchNorm, GCNConv
from subgraph_sketching_tpu_torch.ops import cuda_build
from subgraph_sketching_tpu_torch.train import loops

BASE = dict(dataset_name="synth-ws", hidden_channels=16, batch_size=256,
            eval_batch_size=4096, K=100)
PHASES = ("train.step", "train.forward", "train.backward", "train.optimizer")
STEPS = 2

_BUILT = {}


@contextlib.contextmanager
def _nesting():
    """Collects (name, the stage it ran inside, its record) of every stage
    opened in the block."""
    seen, real = [], spans.stage

    @contextlib.contextmanager
    def watched(name, *args, **kwargs):
        stack = getattr(spans._open, "stack", None)
        parent = stack[-1].name if stack else None
        with real(name, *args, **kwargs) as rec:
            seen.append((name, parent, rec))
            yield rec

    with pytest.MonkeyPatch.context() as m:
        m.setattr(spans, "stage", watched)
        yield seen


def _built(model: str):
    """(trainer, (name, parent, record) of each stage of the build) of a
    tiny ``model`` run on synth-ws's train split, built once a module."""
    if model not in _BUILT:
        cfg = Config(**BASE, model=model)
        splits, directed, _ = get_data(cfg)
        spans.reset()
        with _nesting() as seen:
            ds = build_link_dataset(splits["train"], cfg, "train",
                                    directed=directed, device="cpu")
            trainer = getattr(loops, f"{model.title()}Trainer")(
                cfg, ds, ds.x.shape[1], device="cpu")
        _BUILT[model] = trainer, seen
    return _BUILT[model]


def _model_and_opt(trainer):
    model = trainer.init_model(0)
    return model, loops.make_optimizer(trainer.cfg, model.parameters())


def _order(trainer) -> torch.Tensor:
    return torch.arange(STEPS * trainer.cfg.batch_size)


def test_span_records_nothing_without_a_profiler():
    spans.reset()
    with spans.span("train.step"):
        torch.ones(4).sum()
    assert spans.totals() == {}
    assert not spans.recording()


@pytest.mark.parametrize("model", ["BUDDY", "ELPH"])
def test_training_step_spans_under_the_profiler(model):
    """One of each phase a step, one PlanSpmm pass each way a GCN layer a
    step (ELPH), one BatchNorm forward a BatchNorm a step (on the CPU the
    plain version has no backward span), each among the profiler's
    events; on the CPU a span's device seconds are its host clock's, and
    the phases fit in the step."""
    trainer, _ = _built(model)
    net, opt = _model_and_opt(trainer)
    trainer.run_epoch(net, opt, 1, order=_order(trainer))   # warm
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.recording()
        trainer.run_epoch(net, opt, 2, order=_order(trainer))
    got = spans.totals()
    want = set(PHASES)
    for name in PHASES:
        assert got[name]["count"] == STEPS, name
    if model == "ELPH":
        layers = sum(isinstance(m, GCNConv) for m in net.modules())
        assert layers == trainer.cfg.max_hash_hops
        for name in ("spmm.forward", "spmm.backward"):
            assert got[name]["count"] == layers * STEPS, name
        want |= {"spmm.forward", "spmm.backward"}
    bns = sum(isinstance(m, BatchNorm) for m in net.modules())
    assert bns >= 2
    assert got["bn.forward"]["count"] == bns * STEPS
    want.add("bn.forward")
    assert set(got) == want
    for t in got.values():
        assert t["device_s"] > 0
    phases = sum(got[n]["device_s"] for n in PHASES[1:])
    assert phases <= got["train.step"]["device_s"]
    assert want <= {e.name for e in prof.events()}


def test_spans_and_stages_from_many_threads_lose_no_record():
    """Spans enter from autograd's threads, so the aggregates are shared:
    more threads than cores, switching often, lose no count; each thread
    nests its stages on its own stack."""
    import os
    import sys
    import threading

    workers, each = min(64, 2 * len(os.sched_getaffinity(0)) + 1), 200

    def work(i):
        for _ in range(each):
            with spans.span("probe"):
                pass
        with spans.stage(f"outer{i}"):
            with spans.stage("inner"):
                pass

    spans.reset()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert spans.totals()["probe"]["count"] == workers * each
    tot = spans.stage_totals()
    assert set(tot) == {"inner"} | {f"outer{i}" for i in range(workers)}
    spans.reset()


def test_stages_record_without_a_profiler_nest_and_give_self_time():
    spans.reset()
    with spans.stage("outer") as outer:
        time.sleep(0.02)
        with spans.stage("inner") as first:
            time.sleep(0.05)
        with spans.stage("inner") as second:
            time.sleep(0.01)
    with pytest.raises(RuntimeError):
        with spans.stage("failed"):
            raise RuntimeError("not recorded")
    inner = first.seconds + second.seconds
    assert outer.child_s == pytest.approx(inner)
    assert outer.self_seconds == pytest.approx(outer.seconds - inner)
    assert 0.015 < outer.self_seconds < outer.seconds - 0.055
    tot = spans.stage_totals()
    assert set(tot) == {"outer", "inner"}
    assert tot["inner"] == pytest.approx(inner)
    assert tot["outer"] == pytest.approx(outer.self_seconds)
    assert spans.totals() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("train.step"):
            pass
    spans.reset_spans()
    assert spans.totals() == {} and set(spans.stage_totals()) == set(tot)
    spans.reset()
    assert spans.stage_totals() == {}


# the stages a tiny build records, each with the stage it sits in
SETUP_STAGES = {
    "BUDDY": {("setup.graph", None), ("setup.plans", "setup.sign"),
              ("setup.sign", None), ("setup.plans", None),
              ("setup.sketches", None), ("setup.features", None),
              ("setup.staging", None)},
    "ELPH": {("setup.graph", None), ("setup.plans", "setup.staging"),
             ("setup.sketches", "setup.staging"),
             ("setup.features", "setup.staging"), ("setup.staging", None)},
}


@pytest.mark.parametrize("model", ["BUDDY", "ELPH"])
def test_set_up_records_its_stages(model):
    """build_link_dataset and the trainer's staging record the set-up's
    stages, nested where one calls another: a parent's self time leaves
    out its children's."""
    _, seen = _built(model)
    assert {(name, parent) for name, parent, _ in seen} == \
        SETUP_STAGES[model]
    for name, _, rec in seen:
        assert rec.seconds >= rec.self_seconds >= 0, name
        children = sum(r.seconds for _, p, r in seen if p == name and
                       rec.start <= r.start <= r.end <= rec.end)
        assert rec.child_s == pytest.approx(children), name


def test_kernel_loads_are_their_own_stage(monkeypatch):
    """A native library's build and load (``cuda_build.load_all``) is the
    stage ``setup.kernels``, nested in the stage that first needs it and
    left out of that stage's self time; a library already loaded adds no
    stage."""
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    spans.reset()
    with _nesting() as seen:
        with spans.stage("setup.plans") as plans:
            cuda_build.load("plan_build")
            cuda_build.load("plan_build")
    assert [(n, p) for n, p, _ in seen] == [
        ("setup.plans", None), ("setup.kernels", "setup.plans")]
    kernels = seen[1][2]
    assert plans.child_s == kernels.seconds > 0
    assert spans.stage_totals() == pytest.approx(
        {"setup.plans": plans.seconds - kernels.seconds,
         "setup.kernels": kernels.seconds})


@pytest.mark.parametrize("model", ["BUDDY", "ELPH"])
def test_training_step_and_predict_add_no_stage(model):
    trainer, _ = _built(model)
    net, opt = _model_and_opt(trainer)
    spans.reset()
    trainer.run_epoch(net, opt, 1, order=_order(trainer))
    pred, labels = trainer.predict(net, "train", n_samples=512)
    assert len(pred) == len(labels) == 512
    assert spans.stage_totals() == {}


def test_profile_steps_gives_the_phases():
    """``parallel.breakdown.profile_steps``' ``phases_ms``: the spans'
    device ms a step of its window, the phases within the step."""
    from subgraph_sketching_tpu_torch.parallel import breakdown
    trainer, _ = _built("ELPH")
    net, opt = _model_and_opt(trainer)
    order = torch.arange(5 * trainer.cfg.batch_size)
    out = breakdown.profile_steps(trainer, net, opt, order, 2, seed=3)
    ph = out["phases_ms"]
    assert set(ph) == {"step", "forward", "backward", "optimizer"}
    assert all(v > 0 for v in ph.values())
    assert ph["forward"] + ph["backward"] + ph["optimizer"] <= ph["step"]
    assert ph["step"] <= out["step_ms"]


def test_citation2_clock_is_a_stage():
    """The citation2 tool's stage timer records the port's stages, under
    its own names, with its record keys."""
    from subgraph_sketching_tpu_torch.tools.citation2_train import _Clock
    logged = []
    clock = _Clock(torch.device("cpu"), logged.append)
    spans.reset()
    with clock.stage("graph", links=10) as r:
        r["edges"] = 5
    assert logged == clock.records
    rec = clock.records[0]
    assert set(rec) == {"stage", "links", "edges", "s", "links_per_s"}
    assert rec["links_per_s"] == pytest.approx(10 / rec["s"])
    assert spans.stage_totals() == {"citation2.graph": rec["s"]}
