"""The port's failure detection (subgraph_sketching_tpu_torch/parallel/
fault.py) and the kill-and-resume drill on its runner, on the CPU.

The detector's unit cases are tests/test_fault.py's: live and dead peers,
a vanished heartbeat file, the startup timeout, the single-process
no-op, ``agree_min`` and ``barrier``.

The drill runs ``runners.run.run`` (BUDDY on synth-ba, 4 epochs, a
checkpoint every epoch, ``--heartbeat_dir``) on two gloo ranks:

  * A: uninterrupted;
  * B: rank 1 runs 2 epochs and then hard-crashes (``os._exit``); rank 0
    must raise ``PeerFailure`` at the epoch-2 barrier (heartbeat timeout
    10 s, interval 0.5 s), not hang;
  * C: both ranks restart with ``--resume`` on B's checkpoints and a
    fresh heartbeat directory.

C's final checkpoint must be bit-identical to A's, and so must its last
``Epoch:`` line (best-val tracking included).  A and B run at once; no
sleep stands in for synchronisation: the ranks meet at the process
group's rendezvous, the detector's barriers and the checkpoint barrier.
"""

import os
import pathlib
import subprocess
import sys
import threading
import time

import pytest
import torch

from subgraph_sketching_tpu_torch.parallel.fault import (
    HeartbeatDetector, PeerFailure, maybe_start,
)
from subgraph_sketching_tpu_torch.train.checkpoint import (
    load_run_meta, save_run_meta,
)
from test_torch_parallel import run_once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 4
CRASH_AFTER = 2


# ------------------------------------------------------- detector units --

def test_live_peers_pass(tmp_path):
    d0 = HeartbeatDetector(str(tmp_path), 0, 2, interval=0.05, timeout=5.0)
    d1 = HeartbeatDetector(str(tmp_path), 1, 2, interval=0.05, timeout=5.0)
    d0.start()
    d1.start()
    try:
        d0.wait_all_started(startup_timeout=5.0)
        d1.wait_all_started(startup_timeout=5.0)
        for _ in range(3):
            d0.check()
            d1.check()
            time.sleep(0.1)
    finally:
        d0.stop()
        d1.stop()


def test_dead_peer_detected(tmp_path):
    d0 = HeartbeatDetector(str(tmp_path), 0, 2, interval=0.05, timeout=0.5)
    d1 = HeartbeatDetector(str(tmp_path), 1, 2, interval=0.05, timeout=0.5)
    d0.start()
    d1.start()
    d0.wait_all_started(startup_timeout=5.0)
    d1.stop()                       # rank 1 "dies"
    # backdate rank 1's heartbeat past the deadline
    stale = time.time() - 10.0
    os.utime(os.path.join(str(tmp_path), "hb_1"), (stale, stale))
    try:
        with pytest.raises(PeerFailure) as ei:
            d0.check()
        assert ei.value.dead == [1]
        assert "--resume" in str(ei.value)
    finally:
        d0.stop()


def test_vanished_heartbeat_file_detected(tmp_path):
    d0 = HeartbeatDetector(str(tmp_path), 0, 2, interval=0.05, timeout=0.5)
    d0.start()
    try:
        (tmp_path / "hb_1").write_text(str(time.time()))
        d0.check()
        os.remove(tmp_path / "hb_1")
        with pytest.raises(PeerFailure):
            d0.check()
    finally:
        d0.stop()


def test_startup_barrier_times_out(tmp_path):
    d0 = HeartbeatDetector(str(tmp_path), 0, 3, interval=0.05, timeout=1.0)
    d0.start()
    try:
        with pytest.raises(PeerFailure) as ei:
            d0.wait_all_started(startup_timeout=0.5)
        assert set(ei.value.dead) == {1, 2}
    finally:
        d0.stop()


def test_maybe_start_single_process_noop(tmp_path):
    # no process group of several ranks -> detector disabled
    assert maybe_start(str(tmp_path)) is None
    assert maybe_start(None) is None


def _agree(d0, d1, tag, v0, v1):
    out = {}
    t = threading.Thread(
        target=lambda: out.update(r1=d1.agree_min(tag, v1, timeout=10.0)))
    t.start()
    out["r0"] = d0.agree_min(tag, v0, timeout=10.0)
    t.join(timeout=10.0)
    assert not t.is_alive()
    return out["r0"], out["r1"]


def test_agree_min_two_threads(tmp_path):
    """agree_min returns the same minimum on every process: the
    resume-step agreement."""
    d0 = HeartbeatDetector(str(tmp_path), 0, 2, interval=0.05, timeout=5.0)
    d1 = HeartbeatDetector(str(tmp_path), 1, 2, interval=0.05, timeout=5.0)
    d0.start()
    d1.start()
    try:
        assert _agree(d0, d1, "rs", 3, 7) == (3, 3)
        # -1 ("no checkpoint visible") wins so nobody resumes
        assert _agree(d0, d1, "rs2", 5, -1) == (-1, -1)
    finally:
        d0.stop()
        d1.stop()


def test_agree_min_ignores_stale_files_from_previous_incarnation(tmp_path):
    for pid in (0, 1):
        f = tmp_path / f"val_rs_{pid}"
        f.write_text("1")
        old = time.time() - 300.0
        os.utime(f, (old, old))
    d0 = HeartbeatDetector(str(tmp_path), 0, 2, interval=0.05, timeout=5.0)
    d1 = HeartbeatDetector(str(tmp_path), 1, 2, interval=0.05, timeout=5.0)
    d0.start()
    d1.start()
    try:
        # fresh agreement is min(5, 7) = 5; the stale 1s must not leak in
        assert _agree(d0, d1, "rs", 5, 7) == (5, 5)
    finally:
        d0.stop()
        d1.stop()


def test_agree_min_absent_peer_times_out(tmp_path):
    d0 = HeartbeatDetector(str(tmp_path), 0, 2, interval=0.05, timeout=30.0)
    d0.start()
    try:
        with pytest.raises(PeerFailure):
            d0.agree_min("rs", 4, timeout=0.5)
    finally:
        d0.stop()


def test_barrier_passes_and_detects(tmp_path):
    d0 = HeartbeatDetector(str(tmp_path), 0, 2, interval=0.05, timeout=0.6)
    d1 = HeartbeatDetector(str(tmp_path), 1, 2, interval=0.05, timeout=0.6)
    d0.start()
    d1.start()
    try:
        d0.wait_all_started(startup_timeout=5.0)
        t = threading.Thread(target=d1.barrier, args=("ep0",))
        t.start()
        d0.barrier("ep0")            # both arrive -> both release
        t.join(timeout=5)
        assert not t.is_alive()
        d1.stop()                    # rank 1 dies before the next barrier
        stale = time.time() - 10.0
        os.utime(os.path.join(str(tmp_path), "hb_1"), (stale, stale))
        with pytest.raises(PeerFailure) as ei:
            d0.barrier("ep1")
        assert ei.value.dead == [1]
    finally:
        d0.stop()
        d1.stop()


def test_run_meta_roundtrip(tmp_path):
    assert load_run_meta(str(tmp_path), 5) is None
    meta = {"val_res": 0.5, "test_res": 0.4, "train_res": 0.9,
            "best_epoch": 3}
    save_run_meta(str(tmp_path), 5, meta)
    assert load_run_meta(str(tmp_path), 5) == meta


# ---------------------------------------------------------------- drill --

_DRILL = r'''
import os, sys
repo, store, ckpt, hb, rank, epochs, mode = sys.argv[1:8]
rank, epochs = int(rank), int(epochs)
sys.path.insert(0, repo)
import torch
torch.set_num_threads(1)
from subgraph_sketching_tpu_torch.config import Config
from subgraph_sketching_tpu_torch.parallel import multihost
from subgraph_sketching_tpu_torch.parallel.fault import PeerFailure
from subgraph_sketching_tpu_torch.runners.run import run

multihost.initialize("file://" + store, num_processes=2, process_id=rank,
                     backend="gloo")
cfg = Config(dataset_name="synth-ba", model="BUDDY", hidden_channels=16,
             batch_size=1024, eval_batch_size=2048, epochs=epochs,
             mesh_shape=[2], mesh_axes=["data"], checkpoint_dir=ckpt,
             checkpoint_every=1, resume=mode == "resume", heartbeat_dir=hb,
             heartbeat_timeout=10.0)
try:
    run(cfg, device="cpu")
except PeerFailure as e:
    print(f"PEERFAILURE dead={e.dead}", flush=True)
    os._exit(3)    # the process group cannot shut down against a dead peer
if mode == "crash":
    print(f"rank {rank} crashing after {epochs} epochs", flush=True)
    os._exit(1)    # hard crash: no cleanup of the group or the detector
multihost.shutdown()
print(f"rank {rank} finished {epochs} epochs", flush=True)
'''


def _launch(tmp_path, phase: str, ckpt: str, hb: str, rank_args) -> list:
    script = tmp_path / "drill.py"
    if not script.exists():
        script.write_text(_DRILL)
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    store = str(tmp_path / f"store_{phase}")
    return [subprocess.Popen(
        [sys.executable, str(script), REPO, store, ckpt, hb, str(r),
         str(epochs), mode], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env)
        for r, (epochs, mode) in enumerate(rank_args)]


def _wait(procs) -> list:
    return [(p.communicate(timeout=300)[0], p.returncode) for p in procs]


@pytest.fixture(scope="module")
def drill(request, tmp_path_factory):
    """The drill's three phases, once per run (``run_once``)."""
    return run_once(request, tmp_path_factory, "drill", _drill)


def _drill(work: str) -> dict:
    tmp = pathlib.Path(work)
    ck_a, ck_b = str(tmp / "ck_a"), str(tmp / "ck_b")
    a = _launch(tmp, "a", ck_a, str(tmp / "hb_a"),
                [(EPOCHS, "fresh"), (EPOCHS, "fresh")])
    b = _launch(tmp, "b", ck_b, str(tmp / "hb_b"),
                [(EPOCHS, "fresh"), (CRASH_AFTER, "crash")])
    out_a, out_b = _wait(a), _wait(b)
    # a fresh heartbeat directory: B's stale files must not release C's
    # barriers or age out C's peers
    c = _launch(tmp, "c", ck_b, str(tmp / "hb_c"),
                [(EPOCHS, "resume"), (EPOCHS, "resume")])
    return dict(a=out_a, b=out_b, c=_wait(c), ck_a=ck_a, ck_b=ck_b)


def test_drill_uninterrupted_run_finishes(drill):
    for r, (out, rc) in enumerate(drill["a"]):
        assert rc == 0, f"rank {r}:\n{out[-3000:]}"
        assert f"finished {EPOCHS} epochs" in out


def test_drill_survivor_names_the_dead_peer(drill):
    (out0, rc0), (out1, rc1) = drill["b"]
    assert rc1 == 1, out1[-3000:]                 # the hard crash
    assert rc0 == 3, f"survivor:\n{out0[-3000:]}"
    assert "PEERFAILURE dead=[1]" in out0
    # the survivor stopped at the barrier of the epoch after the crash
    assert f"Epoch: {CRASH_AFTER - 1:02d}" in out0
    assert f"Epoch: {CRASH_AFTER:02d}" not in out0


def test_drill_resume_is_bit_identical(drill):
    for r, (out, rc) in enumerate(drill["c"]):
        assert rc == 0, f"rank {r}:\n{out[-3000:]}"
        assert f"resumed from checkpoint step {CRASH_AFTER}" in out
    a = torch.load(os.path.join(drill["ck_a"], f"step_{EPOCHS}.pt"))
    b = torch.load(os.path.join(drill["ck_b"], f"step_{EPOCHS}.pt"))
    assert a["model"].keys() == b["model"].keys()
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys() and len(sa) > 0
    for i in sa:
        for k, v in sa[i].items():
            assert torch.equal(v, sb[i][k]), (i, k)

    def last_epoch_line(out):
        lines = [ln for ln in out.splitlines()
                 if ln.startswith(f"Epoch: {EPOCHS - 1:02d}")]
        assert lines, out[-2000:]
        return lines[-1].rsplit(", epoch time", 1)[0]

    assert last_epoch_line(drill["a"][0][0]) \
        == last_epoch_line(drill["c"][0][0])
