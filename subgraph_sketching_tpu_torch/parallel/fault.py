"""Failure detection for multi-process runs (a copy of the JAX package's
parallel/fault.py, which is pure Python; the port imports nothing of
that package).

When a peer process dies, the survivors do not crash: they hang inside
the next collective, waiting for a contribution that will never arrive.
This module turns that silent hang into a prompt, named error, so that a
launcher can restart the job from the latest checkpoint
(train/checkpoint.py and ``--resume``).

Design: a filesystem heartbeat, deliberately out of band of the
collective fabric (NCCL, gloo): if the fabric is wedged, an in-band probe
would wedge with it.  Every process writes a timestamp to
``<dir>/hb_<rank>`` from a daemon thread; ``check()`` (called between
epochs from the training loop) compares every peer's mtime against
``timeout`` and raises ``PeerFailure`` naming the dead ranks.  The
directory is whatever the job already shares (NFS on a cluster, tmp on
one host); heartbeat traffic is one tiny write per interval.

Single-process runs: ``maybe_start`` returns None and everything is a
no-op, so the detector costs nothing unless the run is distributed.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional, Sequence


class PeerFailure(RuntimeError):
    """A peer process missed its heartbeat deadline."""

    def __init__(self, dead: Sequence[int], timeout: float):
        self.dead = list(dead)
        super().__init__(
            f"peer process(es) {self.dead} missed the heartbeat deadline "
            f"({timeout:.1f}s); aborting before the next collective hangs. "
            f"Restart the job and pass --resume to continue from the latest "
            f"checkpoint.")


class HeartbeatDetector:
    """Write own heartbeat periodically; check peers' on demand.

    Parameters
    ----------
    directory: shared directory (must be visible to all processes).
    process_id / num_processes: this process's rank and the world size.
    interval: seconds between own-heartbeat writes.
    timeout: seconds of peer silence that counts as death.  Must be
        comfortably larger than both ``interval`` and the longest gap
        between ``check()`` call sites (an epoch counts as one gap).
    """

    def __init__(self, directory: str, process_id: int, num_processes: int,
                 interval: float = 2.0, timeout: float = 60.0):
        self.dir = directory
        self.pid = process_id
        self.n = num_processes
        self.interval = interval
        self.timeout = timeout
        os.makedirs(directory, exist_ok=True)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # check() also beats (from the main thread) to get a same-clock
        # reference timestamp; serialise against the daemon thread's beats
        # or the two race on the shared tmp file
        self._beat_lock = threading.Lock()

    def _path(self, pid: int) -> str:
        return os.path.join(self.dir, f"hb_{pid}")

    def _beat_once(self) -> None:
        # atomic replace so a reader never sees a partial file
        with self._beat_lock:
            tmp = self._path(self.pid) + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(time.time()))
            os.replace(tmp, self._path(self.pid))

    def start(self) -> "HeartbeatDetector":
        self._beat_once()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self._beat_once()
            except OSError:
                pass  # transient fs hiccup; next beat retries

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 1)

    def wait_all_started(self, startup_timeout: float = 120.0) -> None:
        """Block until every peer has written its first heartbeat (job
        startup barrier that cannot hang past ``startup_timeout``)."""
        deadline = time.time() + startup_timeout
        missing = set(range(self.n)) - {self.pid}
        while missing and time.time() < deadline:
            missing = {p for p in missing if not os.path.exists(self._path(p))}
            if missing:
                time.sleep(0.2)
        if missing:
            raise PeerFailure(sorted(missing), startup_timeout)

    def agree_min(self, tag: str, value: int, poll: float = 0.05,
                  timeout: Optional[float] = None) -> int:
        """All-process agreement on ``min(value)`` — out-of-band, bounded.

        Used to agree the resume step before the epoch loop: each process
        reads its OWN filesystem view of the checkpoint dir, and if those
        views differ (fs lag, a non-shared dir, a corrupt step) the
        processes would enter the epoch-barrier sequence at different
        epochs and deadlock with fresh heartbeats.  Agreeing on the
        minimum visible step first makes every process restore the same
        checkpoint (or none, if any process sees none), so the barrier tag
        sequences are identical by construction.

        Exchange rides the heartbeat directory, not the collective
        fabric.  Hang-proofness comes from ``check()`` each poll: a peer
        that DIES raises a prompt ``PeerFailure``; a peer that is merely
        slow (minutes-scale preprocessing skew between hosts is normal at
        citation2 scale) keeps heartbeating and is waited for — the same
        contract as ``barrier()``.  ``timeout`` (default None = no
        deadline) is an optional hard cap for tests and callers that
        prefer bounded waits over trusting heartbeats.

        Stale-file safety: a restart that reuses the directory sees the
        previous incarnation's ``val_`` files, and (unlike the barrier,
        where staleness only weakens) a stale VALUE read here would make
        processes restore DIVERGENT checkpoints.  So freshness is
        enforced: every participant re-writes its value file each poll
        while waiting, and a reader only accepts a peer file whose mtime
        is at least its own first write's (mtimes come from the same fs
        server, so the comparison is skew-free — same trick as
        ``check()``).  A dead incarnation's file never refreshes and is
        ignored until the timeout raises ``PeerFailure``; a live peer
        that wrote earlier refreshes within one ``poll`` and is accepted.
        """
        path = os.path.join(self.dir, f"val_{tag}_{{}}")

        def write_own():
            tmp = path.format(self.pid) + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(int(value)))
            os.replace(tmp, path.format(self.pid))

        write_own()
        my_mtime = os.path.getmtime(path.format(self.pid))
        # a peer that COMPLETES its agreement stops re-writing; its last
        # write happened at most one poll (+ fs mtime granularity) before
        # it read our fresh value, so accept that much slack.  A dead
        # incarnation's file would need to have been written within ~1s of
        # this process's start to slip through — a restart cannot be that
        # fast (process spawn + torch import alone take seconds).
        fresh_floor = my_mtime - poll - 1.0
        deadline = time.time() + timeout if timeout is not None else None
        values = {self.pid: int(value)}
        missing = set(range(self.n)) - {self.pid}
        while missing:
            for p in list(missing):
                try:
                    if os.path.getmtime(path.format(p)) < fresh_floor:
                        continue  # stale: a previous incarnation's file
                    with open(path.format(p)) as f:
                        values[p] = int(f.read())
                    missing.discard(p)
                except (OSError, ValueError):
                    pass  # not written yet (or mid-replace); retry
            if not missing:
                break
            self.check()
            if deadline is not None and time.time() > deadline:
                raise PeerFailure(sorted(missing), timeout)
            time.sleep(poll)
            write_own()  # keep own file fresh for late-starting peers
        return min(values.values())

    def barrier(self, tag: str, poll: float = 0.05,
                startup_timeout: Optional[float] = None) -> None:
        """Out-of-band, hang-proof epoch barrier.

        Entering a collective behind a dead peer hangs forever (the
        failure mode this module exists for) — ``check()`` between epochs
        cannot help once a process is already blocked inside the fabric.
        Gating each epoch on this barrier closes that window: every
        process marks its arrival at ``tag`` with a file, then waits for
        all peers' marks while heartbeat-checking, so a peer that dies at
        any point before the epoch raises a prompt ``PeerFailure`` instead
        of wedging the survivors in the epoch's first collective.

        ``tag`` must be unique per barrier point (e.g. ``f"ep{epoch}"``).

        A restart that reuses the same directory sees the previous
        incarnation's markers, which can release a barrier early.  That
        only WEAKENS the barrier back to plain collective skew (the
        survivor blocks inside the fabric until the live peer catches
        up); it cannot produce a wrong result.  A peer that dies in that
        window is caught by the process group's own timeout (if ever)
        rather than a named PeerFailure — wipe the directory on restart
        for full coverage.
        """
        marker = os.path.join(self.dir, f"bar_{tag}_{{}}")
        tmp = marker.format(self.pid) + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(time.time()))
        os.replace(tmp, marker.format(self.pid))
        deadline = (time.time() + startup_timeout
                    if startup_timeout is not None else None)
        missing = set(range(self.n)) - {self.pid}
        while missing:
            missing = {p for p in missing
                       if not os.path.exists(marker.format(p))}
            if not missing:
                return
            self.check()  # raises PeerFailure on a stale/vanished peer
            if deadline is not None and time.time() > deadline:
                raise PeerFailure(sorted(missing), startup_timeout)
            time.sleep(poll)

    def check(self) -> None:
        """Raise PeerFailure if any peer's heartbeat is older than
        ``timeout``.  Call between steps/epochs on every process."""
        # Reference clock = our OWN heartbeat file's mtime, written right
        # now: on NFS the server assigns mtimes, so comparing peer
        # mtimes against local time.time() would bias ages by host<->server
        # clock skew (a 70s-slow server with timeout=60 would kill healthy
        # jobs).  Same-source timestamps make the skew cancel.
        try:
            self._beat_once()
            now = os.path.getmtime(self._path(self.pid))
        except OSError:
            now = time.time()  # own beat failed: degrade gracefully
        dead = []
        for p in range(self.n):
            if p == self.pid:
                continue
            try:
                age = now - os.path.getmtime(self._path(p))
            except OSError:
                dead.append(p)  # file vanished
                continue
            if age > self.timeout:
                dead.append(p)
        if dead:
            raise PeerFailure(dead, self.timeout)


def maybe_start(directory: Optional[str],
                interval: float = 2.0,
                timeout: float = 60.0) -> Optional[HeartbeatDetector]:
    """Start a detector iff this is a real multi-process run (a
    ``torch.distributed`` process group of more than one rank).

    Returns None (all call sites then no-op) for single-process runs or
    when no shared directory is configured.
    """
    from subgraph_sketching_tpu_torch.parallel import multihost
    if directory is None or multihost.world_size() <= 1:
        return None
    det = HeartbeatDetector(directory, multihost.rank(),
                            multihost.world_size(), interval=interval,
                            timeout=timeout)
    det.start()
    det.wait_all_started()
    return det
