"""File-based superstep coordination for the multi-process launch.

A copy of ``repro/core/coordinator.py`` (stdlib only): the same record
names, fields and JSON, so either package's coordinator reads the other's
directory.

One worker process per shard, one coordinator in the job process, a shared
filesystem between them — the smallest deployment that makes the paper's
n-machines claim real. Every record is published with the repo-wide atomic
idiom (write ``.tmp``, then ``os.replace``), so a reader either sees a
complete JSON document or no file at all; no locks, no sockets.

Protocol per superstep ``s`` (all paths under the coordinator directory)::

    worker w                         coordinator (job process)
    --------                         -------------------------
    heartbeat/w.json  (daemon, ~4Hz) watches ages + process liveness
    ...send/receive/apply...
    step-SSSSSS/arrive-w.json  ───►  waits for all n arrivals
                                     reduces totals / halt vote / aggregator
                                     (shard-ascending order, matching the
                                     threaded driver's accumulation)
    step-SSSSSS/commit.json    ◄───  publishes totals + halt + ckpt_landed
    reads commit, continues / halts

``abort.json`` is the poison pill: the coordinator writes it when the run
cannot continue (worker death without recovery wiring); every worker wait
loop polls it and exits instead of hanging on a barrier that will never
open.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time


class WorkerFailed(RuntimeError):
    """A worker process died (or went heartbeat-silent) and the run could
    not recover it. ``record`` carries the worker's structured failure
    record (``repro_torch.fault.failure_record``) when it classified itself —
    e.g. which storage tier faulted — before exiting; ``shard`` is -1 when
    the coordinator process itself is the casualty."""

    def __init__(self, shard: int, message: str, record: dict | None = None):
        super().__init__(message)
        self.shard = shard
        self.record = record


class RunAborted(RuntimeError):
    """The coordinator published ``abort.json``; workers raise this instead
    of waiting forever on a barrier no one will open."""


def atomic_write_json(path: str, obj, *, fsync: bool = True) -> None:
    """The repo-wide publish idiom: a record appears complete or not at all,
    and (by default) is durable before its name exists. ``fsync=False`` is
    for high-rate ephemeral records (heartbeats) where losing the newest
    write in a crash is exactly the signal the record exists to carry."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)


def read_json(path: str):
    """Read a published record; None when not (yet) published."""
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        # a concurrent os.replace is atomic, so decode errors only happen
        # for unrelated partial files; treat both as "not published yet"
        return None


class FileCoordinator:
    """Path schema + record IO + barrier waits over one coordinator dir.

    The same class serves both sides: the coordinator (in the job process)
    calls :meth:`wait_arrivals` / :meth:`publish_commit` /
    :meth:`reduce_arrivals`; each worker calls :meth:`arrive` /
    :meth:`wait_commit` / :meth:`start_heartbeat`. Neither side holds any
    state the filesystem does not — a respawned worker re-derives
    everything from the records.
    """

    POLL = 0.005  # first barrier poll interval (seconds)
    POLL_MAX = 0.1  # backoff cap: blocked waiters settle at <= 10 stats/s
    POLL_GROWTH = 2.0

    def __init__(self, directory: str, n_shards: int, *,
                 heartbeat_interval: float = 0.25,
                 heartbeat_timeout: float = 10.0):
        self.dir = directory
        self.n = int(n_shards)
        self.heartbeat_interval = float(heartbeat_interval)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self._beat_seq = 0  # this process's own beat counter
        # shard -> (last JSON progress key, monotonic time it was first seen)
        self._hb_seen: dict[int, tuple] = {}
        os.makedirs(os.path.join(directory, "heartbeat"), exist_ok=True)

    def _poll_delays(self):
        """Exponential backoff for barrier waits: starts at POLL so a
        nearly-open barrier stays fast, caps at POLL_MAX so n blocked
        workers cost O(n/POLL_MAX) stat syscalls/s instead of starving
        co-located folds. One generator per wait — backoff never leaks
        across barriers."""
        d = self.POLL
        while True:
            yield d
            d = min(d * self.POLL_GROWTH, self.POLL_MAX)

    # -- paths ----------------------------------------------------------------
    def step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step-{step:06d}")

    def arrive_path(self, step: int, shard: int) -> str:
        return os.path.join(self.step_dir(step), f"arrive-{shard}.json")

    def commit_path(self, step: int) -> str:
        return os.path.join(self.step_dir(step), "commit.json")

    def heartbeat_path(self, shard: int) -> str:
        return os.path.join(self.dir, "heartbeat", f"{shard}.json")

    def abort_path(self) -> str:
        return os.path.join(self.dir, "abort.json")

    # -- abort (poison pill) ---------------------------------------------------
    def abort(self, reason: str) -> None:
        atomic_write_json(self.abort_path(), dict(reason=reason))

    def aborted(self) -> str | None:
        rec = read_json(self.abort_path())
        return rec["reason"] if rec else None

    def check_abort(self) -> None:
        reason = self.aborted()
        if reason is not None:
            raise RunAborted(f"run aborted by coordinator: {reason}")

    # -- heartbeats ------------------------------------------------------------
    def beat(self, shard: int) -> None:
        """One heartbeat record. ``seq`` is the liveness signal: staleness
        is judged from sequence PROGRESS (plus the watcher's own monotonic
        clock), never from file mtime — shared filesystems round mtime to
        whole seconds and writer/watcher wall clocks skew, either of which
        false-trips worker-dead detection. ``t`` (writer wall time) stays in
        the record for post-mortem reading only."""
        self._beat_seq += 1
        atomic_write_json(self.heartbeat_path(shard),
                          dict(shard=shard, seq=self._beat_seq,
                               # post-mortem reporting only, never liveness
                               t=time.time()),  # analysis: allow[liveness-clock] wall time is recorded, not compared
                          fsync=False)  # ~4Hz; durability loss IS the signal

    def start_heartbeat(self, shard: int) -> threading.Thread:
        """Daemon heartbeat writer; dies with the process — which is the
        point: SIGKILL stops the beats, and the coordinator notices."""
        self.beat(shard)
        stop = threading.Event()

        def run():
            while not stop.wait(self.heartbeat_interval):
                self.beat(shard)

        # deliberately never joined: the thread's whole job is to die with
        # the process so the coordinator sees the beats stop
        t = threading.Thread(target=run, name=f"heartbeat-{shard}",  # analysis: allow[thread-lifecycle] daemon beat thread must die WITH the process, not before
                             daemon=True)
        t.stop = stop  # type: ignore[attr-defined]
        t.start()
        return t

    def heartbeat_age(self, shard: int) -> float:
        """Seconds (on THIS process's monotonic clock) since the shard's
        heartbeat record last made progress — inf before the first record.

        Progress means the ``(seq, t)`` content of the JSON changed; the
        file's mtime is deliberately ignored (coarse-granularity shared
        filesystems and clock skew made the mtime-based age false-trip).
        The first observation of any record counts as fresh: the watcher
        cannot know how long it sat there, and the spawn grace window is
        what covers startup latency."""
        rec = read_json(self.heartbeat_path(shard))
        if rec is None:
            return float("inf")
        key = (rec.get("seq"), rec.get("t"))
        seen = self._hb_seen.get(shard)
        now = time.monotonic()
        if seen is None or seen[0] != key:
            self._hb_seen[shard] = (key, now)
            return 0.0
        return now - seen[1]

    def stale(self, shard: int) -> bool:
        return self.heartbeat_age(shard) > self.heartbeat_timeout

    # -- worker side -----------------------------------------------------------
    def arrive(self, step: int, shard: int, stats: dict) -> None:
        os.makedirs(self.step_dir(step), exist_ok=True)
        atomic_write_json(self.arrive_path(step, shard),
                          dict(shard=shard, step=step, **stats))

    def wait_commit(self, step: int, shard: int) -> dict:
        path = self.commit_path(step)
        delays = self._poll_delays()
        while True:
            rec = read_json(path)
            if rec is not None:
                return rec
            self.check_abort()
            time.sleep(next(delays))

    def commit(self, step: int) -> dict | None:
        """The commit record for ``step`` if published (non-blocking)."""
        return read_json(self.commit_path(step))

    def wait_file(self, path: str, shard: int) -> None:
        """Worker-side wait for any published record (e.g. a peer's outbox
        announce marker); polls the poison pill so a dead coordinator run
        cannot strand the worker."""
        delays = self._poll_delays()
        while not os.path.exists(path):
            self.check_abort()
            time.sleep(next(delays))

    # -- coordinator side --------------------------------------------------------
    def arrivals(self, step: int) -> dict[int, dict]:
        out = {}
        for w in range(self.n):
            rec = read_json(self.arrive_path(step, w))
            if rec is not None:
                out[w] = rec
        return out

    def wait_arrivals(self, step: int, on_wait=None) -> dict[int, dict]:
        """Block until all n workers arrived at ``step``. ``on_wait()`` runs
        every poll tick — the launcher hooks liveness monitoring (process
        exit + heartbeat staleness → recovery or abort) there."""
        delays = self._poll_delays()
        while True:
            got = self.arrivals(step)
            if len(got) == self.n:
                return got
            if on_wait is not None:
                on_wait(got)
            time.sleep(next(delays))

    @staticmethod
    def reduce_arrivals(arrivals: dict[int, dict]) -> dict:
        """Shard-ascending reduction, exactly mirroring the threaded
        driver's per-destination accumulation (``n_active``/``n_msgs`` as
        ints, ``agg`` as a Python-float left fold), so the committed totals
        are bit-identical to the single-process history."""
        n_active = n_msgs = 0
        agg = 0.0
        blocks = 0
        residency = dict(blocks_read=0, cache_hits=0, cache_evictions=0,
                         blocks_skipped=0)
        # socket-transport channel accounting (seconds busy/stalled per
        # direction + bytes framed); zero under the file transport
        net = dict(net_send_s=0.0, net_stall_s=0.0, net_recv_s=0.0,
                   net_recv_stall_s=0.0, net_wire_bytes=0.0,
                   net_frames=0.0)
        for w in sorted(arrivals):
            rec = arrivals[w]
            n_active += int(rec["n_active"])
            n_msgs += int(rec["n_msgs"])
            agg += float(rec["agg"])
            blocks += int(rec.get("active_blocks", 0))
            for key in residency:
                residency[key] += int(rec.get(key, 0))
            for key in net:
                net[key] += float(rec.get(key, 0.0))
        return dict(n_active=n_active, n_msgs=n_msgs, agg=agg,
                    active_blocks=blocks, **residency, **net)

    def publish_commit(self, step: int, totals: dict, *, halt: bool,
                       ckpt_landed: bool) -> dict:
        os.makedirs(self.step_dir(step), exist_ok=True)
        rec = dict(step=step, halt=bool(halt),
                   ckpt_landed=bool(ckpt_landed), **totals)
        atomic_write_json(self.commit_path(step), rec)
        return rec

    # -- cleanup ----------------------------------------------------------------
    def gc_steps(self, before: int) -> None:
        """Drop barrier records older than ``before`` (they are audit crumbs,
        not recovery state — recovery replays from checkpoints + logs)."""
        for name in os.listdir(self.dir):
            if name.startswith("step-"):
                try:
                    s = int(name.split("-", 1)[1])
                except ValueError:
                    continue
                if s < before:
                    shutil.rmtree(os.path.join(self.dir, name),
                                  ignore_errors=True)
