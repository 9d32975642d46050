"""True multi-process deployment: one worker process per shard.

Port of ``repro/launch/procs.py``, both transports.
``run_processes(job)`` turns a planned streamed
:class:`~repro_torch.core.job.GraphDJob` into n real OS processes. Each
worker opens ONLY its owner view of the edge store
(``EdgeStreamStore.open(dir, owner=w)`` maps just shard w's byte extent),
holds only its own vertex rows, on the job's device, and talks to its peers
exclusively through the shared filesystem:

* **outbox**: per (step, source) :class:`MessageRunStore` in the exact
  inbox-run-file wire format of ``streams.channel`` (combined groups are
  ``append_combined`` sparse runs, combiner-less spills are per-chunk
  ``append_raw`` runs), published by an atomically-renamed announce marker;
* **inbox**: each worker copies the runs addressed to it, ascending source
  (the threaded sender's transmit order), into a local store and digests
  them through the real :class:`~repro_torch.streams.channel.ChannelReceiver`
  with the same :class:`~repro_torch.core.engine.StreamKernels` the
  threaded engine runs. The fold is the engine's own
  (:func:`~repro_torch.core.engine.fold_groups`: one accumulator a group,
  one-chunk groups batched, the same stager), so on the CPU a 3-process run
  is bit-identical to the single-process full-duplex streamed run;
* **coordinator**: the job process drives ``core.coordinator
  .FileCoordinator`` barriers: per-superstep arrive/commit records,
  shard-ascending aggregator + halt-vote reduction, and heartbeat liveness.
  A worker that dies mid-superstep (kill -9 included) stops beating; the
  coordinator respawns just that shard with ``--recover-to``, which replays
  forward from the latest checkpoint over the worker's own message log
  (paper §3.4 / [19] single-shard fast recovery) and rejoins the barrier.

``launch_opts={"transport": "sockets"}`` swaps the shared-filesystem
exchange for the TCP transport (``repro_torch.launch.net``): runs stream
over persistent per-peer loopback connections while the fold is still
producing (§4's transmit ∥ compute), receivers feed them straight into the
same ChannelReceiver digest path, and the coordinator protocol rides one
multiplexed connection per worker (pushed commits and aborts, in-band
heartbeats). Each sender keeps the step's runs in a LOCAL per-step outbox
store, the replay log the reconnect-with-resume handshake serves. The
worker folds through the same ``fold_groups`` and digests in the same
source-ascending order under both transports, so on the CPU the two give
bit-identical results.

Under the socket transport the coordinator is a separate OS process
(``python -m repro_torch.launch.procs coord <spec_dir> --incarnation k``):
it hosts the CoordServer and the superstep commit loop, write-ahead-logs
every commit under ``procs_dir/coord-wal/`` and publishes its listening
address to ``procs_dir/coord-addr.json``. It imports no torch and opens no
CUDA context. The launcher is a thin supervisor: it respawns a crashed
coordinator (bounded by ``coord_restart_limit``), respawns failed workers
with ``--recover-to`` taken from the WAL, and tails the WAL into the run
history. Workers reconnect to a respawned coordinator through the address
file, so a ``kill -9`` of the coordinator mid-barrier loses nothing.

Worker processes are started as ``python -m repro_torch.launch.procs worker
<spec_dir> <shard>`` through ``subprocess`` (never a fork: the job process
may hold a CUDA context). This module keeps its import-time dependencies to
the standard library, numpy, the coordinator and the (stdlib-only) chaos
layer, so a worker starts its heartbeat (and, under sockets, its peer
server and coordinator client) BEFORE paying the torch import. A worker
whose spec names CUDA and that finds no card fails with a ``no-device``
failure record; it never carries on on the CPU.
"""

from __future__ import annotations

import argparse
import errno
import json
import os
import pickle
import re
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np

import repro_torch.fault as _fault
from repro_torch.core.coordinator import (
    FileCoordinator, RunAborted, WorkerFailed, atomic_write_json,
)
from repro_torch.fault import (
    BlobCorruption,
    FaultEvent,
    FaultInjector,
    FaultSchedule,
    RetryExhausted,
    RetryPolicy,
    TierFault,
    failure_record,
    find_in_chain,
    write_record,
)

SPEC = "spec.json"
PROGRAM = "program.pkl"
_STEP_DIR = re.compile(r"^step-(\d+)$")
_WAL_COMMIT = re.compile(r"^commit-(\d+)\.json$")

# respawn budget per run: recovery is for crashes, not crash loops
MAX_RECOVERIES = 3
# extra seconds a freshly spawned worker gets before heartbeat staleness
# counts against it (interpreter start + first beat)
SPAWN_GRACE = 5.0
# errnos that mean "a storage tier failed", not "a bug": classified as
# TierFault so the failure record names the tier (spill vs checkpoint)
_DISK_ERRNOS = frozenset({errno.ENOSPC, errno.EIO, errno.EDQUOT})
# the socket transport's per-step channel accounting, summed over the run
# into ``job._last_run_net`` (all zero under the file transport)
NET_TOTALS = ("net_send_s", "net_stall_s", "net_recv_s", "net_recv_stall_s",
              "net_wire_bytes", "net_frames")


class NoDevice(RuntimeError):
    """The spec names a device this worker does not have (CUDA on a host
    without a card): the worker fails loud instead of running elsewhere."""

    def __init__(self, device: str):
        super().__init__(f"the job runs on {device!r} and this worker "
                         "process sees no such device")
        self.device = device


# --------------------------------------------------------------------------
# shared-filesystem layout (one helper per path, used by both sides)
# --------------------------------------------------------------------------

def _shard_dir(procs_dir: str, w: int) -> str:
    return os.path.join(procs_dir, f"shard-{w}")


def _outbox_dir(procs_dir: str, step: int, src: int) -> str:
    return os.path.join(procs_dir, "outbox", f"step-{step:06d}",
                        f"src-{src}")


def _announce_path(procs_dir: str, step: int, src: int) -> str:
    return os.path.join(procs_dir, "announce", f"step-{step:06d}",
                        f"src-{src}.json")


def _result_path(procs_dir: str, w: int) -> str:
    return os.path.join(procs_dir, "result", f"shard-{w}.npz")


def _wal_dir(procs_dir: str) -> str:
    return os.path.join(procs_dir, "coord-wal")


def _coord_addr_path(procs_dir: str) -> str:
    return os.path.join(procs_dir, "coord-addr.json")


def _failure_path(procs_dir: str, w: int) -> str:
    return os.path.join(procs_dir, "failures", f"shard-{w}.json")


def _recover_request_path(procs_dir: str, w: int) -> str:
    return os.path.join(procs_dir, f"recover-{w}.json")


def _abort_request_path(procs_dir: str) -> str:
    return os.path.join(procs_dir, "abort-request.json")


def _save_npz_atomic(path: str, **arrays) -> None:
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())  # arrays durable before the name appears
    os.replace(tmp, path)


# --------------------------------------------------------------------------
# launcher (runs in the job process)
# --------------------------------------------------------------------------

def _src_root() -> str:
    """The import root to hand worker processes (the directory holding the
    ``repro_torch`` package)."""
    import repro_torch

    return os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))


def _write_spec(job, procs_dir: str, coord_dir: str, *, start_step: int,
                target: int, bootstrap: str, ckpt_step: int | None,
                heartbeat_interval: float, heartbeat_timeout: float,
                transport: str = "files", coord_addr=None,
                kill_net=None, **extra) -> None:
    from repro_torch.convert import numpy_dtype

    pg, cfg = job.pg, job.plan.config
    rec = cfg.recovery
    spec = dict(
        n_shards=int(pg.n_shards),
        P=int(pg.P),
        n_vertices=int(pg.n_vertices),
        value_dtype=str(numpy_dtype(job.program.value_dtype)),
        msg_dtype=str(numpy_dtype(job.program.msg_dtype)),
        device=str(job.device),
        store_dir=job.store.dir,
        logs_dir=(job.message_log.dir if rec.log_messages else None),
        ckpt_dir=(job.checkpointer.dir if job.checkpointer else None),
        ckpt_keep=(job.checkpointer.keep if job.checkpointer else 0),
        store_signature=job.store.signature(),
        procs_dir=procs_dir,
        coord_dir=coord_dir,
        config=cfg.to_json(),
        checkpoint_every=int(rec.checkpoint_every),
        log_messages=bool(rec.log_messages),
        start_step=int(start_step),
        target=int(target),
        num_supersteps=job.program.num_supersteps,
        bootstrap=bootstrap,
        ckpt_step=ckpt_step,
        heartbeat_interval=heartbeat_interval,
        heartbeat_timeout=heartbeat_timeout,
        transport=transport,
        coord_addr=coord_addr,
        kill_net=kill_net,
        **extra,
    )
    atomic_write_json(os.path.join(procs_dir, SPEC), spec)
    with open(os.path.join(procs_dir, PROGRAM), "wb") as f:
        pickle.dump(job.program, f)
    # per-shard partition rows: a worker maps O(P) state, never the stacks
    rows = {name: getattr(pg, name).cpu().numpy()
            for name in ("degree", "vmask", "old_ids", "gids")}
    for w in range(pg.n_shards):
        d = _shard_dir(procs_dir, w)
        os.makedirs(d, exist_ok=True)
        _save_npz_atomic(os.path.join(d, "rows.npz"),
                         **{name: a[w] for name, a in rows.items()})


def _finalize_checkpoint_dir(ckpt_dir: str, step: int, n_shards: int, P: int,
                             dtype: str, meta, keep: int = 2) -> None:
    """Coordinator half of the distributed checkpoint: every worker has
    already dumped its ``shard-w.npz`` into the ``.tmp`` dir; write the
    manifest (the Checkpointer wire format, so ``restore``/``restore_shard``
    read it unchanged) and publish with the atomic rename.

    Idempotent: if the final dir exists and the tmp dir is gone, the work
    is done and we return."""
    tmp = os.path.join(ckpt_dir, f".tmp-step-{step:06d}")
    final = os.path.join(ckpt_dir, f"step-{step:06d}")
    if os.path.isdir(final) and not os.path.isdir(tmp):
        return
    for w in range(n_shards):
        if not os.path.exists(os.path.join(tmp, f"shard-{w}.npz")):
            raise RuntimeError(
                f"checkpoint step {step}: worker {w} voted ckpt but its "
                "shard file is missing"
            )
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(dict(step=step, n_shards=n_shards, P=P, dtype=dtype,
                       meta=meta), f)
        f.flush()
        os.fsync(f.fileno())  # recovery trusts any published step dir; the
        # manifest must be durable before the rename makes it visible
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # keep-newest gc, mirroring Checkpointer._gc
    steps = sorted(
        int(name[len("step-"):]) for name in os.listdir(ckpt_dir)
        if name.startswith("step-") and name[len("step-"):].isdigit()
    )
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step-{s:06d}"),
                      ignore_errors=True)


def run_processes(job, max_supersteps: int = 10_000, *,
                  verbose: bool = False, on_step=None):
    """Run ``job`` with one worker process per shard; returns
    ``((values, active), history)`` exactly like ``GraphDEngine.run``, the
    stacks on the job's device. ``on_step`` is called as ``on_step(record,
    None)``: the coordinator never holds the distributed state, only the
    barrier records."""
    import torch

    from repro_torch.convert import numpy_dtype
    from repro_torch.core.config import ConfigError, validate_launch_opts
    from repro_torch.core.engine import SuperstepRecord

    program, pg, store = job.program, job.pg, job.store
    cfg = job.plan.config
    if cfg.channel.payload_scheme == "auto":
        # defensive: GraphDJob downgrades auto -> lossless for processes
        # launches; reaching here means a caller bypassed the job facade.
        # The auto-pick's first-superstep sample is engine-local state; n
        # worker processes would each decide independently and diverge.
        raise ConfigError(
            "channel.compress_payload='auto' conflicts with "
            "launch='processes': the auto-pick is a single-process engine "
            "feature and n workers need one fixed wire format — pass "
            "'lossless' (or False) explicitly"
        )
    n = pg.n_shards
    opts = validate_launch_opts(dict(job.launch_opts or {}))
    transport = opts.get("transport", "files")
    heartbeat_interval = float(opts.get("heartbeat_interval", 0.25))
    heartbeat_timeout = float(opts.get("heartbeat_timeout", 10.0))
    # crash drill (tests / CI): {"shard": w, "step": s} SIGKILLs worker w
    # mid-superstep s — after it announced its outbox, before it arrives
    kill_spec = opts.get("kill")
    # alias for a faults= net.send torn_kill event; worker_main translates
    # it into the schedule so one injector drives both
    kill_net = opts.get("kill_net")
    can_recover = (job.checkpointer is not None
                   and cfg.recovery.log_messages)

    procs_dir = job._dir("procs", job._tag)
    coord_dir = os.path.join(procs_dir, "coord")
    # a fresh launch owns the transport namespace: stale barrier records,
    # WAL commits, failure records or half-written outboxes from a previous
    # (crashed) launch would open this run's barriers early or trip the
    # supervisor into phantom recoveries
    for sub in ("coord", "outbox", "announce", "result", "coord-wal",
                "failures"):
        shutil.rmtree(os.path.join(procs_dir, sub), ignore_errors=True)
    if os.path.isdir(procs_dir):
        for name in os.listdir(procs_dir):
            if name.startswith("shard-"):  # socket senders' per-step
                # outbox + the local (log-less) inbox
                for sub in ("outbox", "inbox"):
                    shutil.rmtree(os.path.join(procs_dir, name, sub),
                                  ignore_errors=True)
            elif (name in ("coord-addr.json", "abort-request.json",
                           "failure-summary.json", "coord.log")
                  or name.startswith("recover-")):
                try:
                    os.unlink(os.path.join(procs_dir, name))
                except OSError:
                    pass
    os.makedirs(procs_dir, exist_ok=True)

    target = min(
        program.num_supersteps
        if program.num_supersteps is not None
        else max_supersteps,
        max_supersteps,
    )
    state = job._state
    start_step = job._next_step
    restored_from = None
    ckpt_step = None
    if state is not None:
        bootstrap = "state"
        vals = state[0].cpu().numpy()
        act = state[1].cpu().numpy()
        for w in range(n):
            d = _shard_dir(procs_dir, w)
            os.makedirs(d, exist_ok=True)
            _save_npz_atomic(os.path.join(d, "boot.npz"),
                             values=vals[w], active=act[w])
    elif job.checkpointer is not None and job.checkpointer.latest() is not None:
        ckpt_step = job.checkpointer.latest()
        d = os.path.join(job.checkpointer.dir, f"step-{ckpt_step:06d}")
        with open(os.path.join(d, "manifest.json")) as f:
            got = json.load(f).get("meta")
        expected = store.signature()
        if got is not None and got != expected:
            raise ValueError(
                f"checkpoint step-{ckpt_step:06d} was written against "
                f"different edge streams: manifest meta {got} != expected "
                f"{expected}"
            )
        bootstrap = "checkpoint"
        start_step = ckpt_step
        restored_from = ckpt_step
    else:
        bootstrap = "init"

    if start_step >= target:
        # nothing to run: resolve the state in-process, exactly like the
        # engine's empty loop would
        if state is None:
            if job.checkpointer is not None and ckpt_step is not None:
                v, a, _ = job.checkpointer.restore(
                    expected_meta=store.signature(), device=job.device)
                state = (v, a)
            else:
                state = job.engine.init()
        return state, []

    # socket tunables + chaos schedule ride the spec into every process
    net = dict(
        handshake_timeout=float(opts.get("handshake_timeout", 5.0)),
        connect_timeout=float(opts.get("connect_timeout", 5.0)),
        send_timeout=float(opts.get("send_timeout", 60.0)),
        coord_connect_timeout=float(opts.get("coord_connect_timeout", 10.0)),
        retry=opts.get("retry"),
    )
    _write_spec(job, procs_dir, coord_dir, start_step=start_step,
                target=target, bootstrap=bootstrap, ckpt_step=ckpt_step,
                heartbeat_interval=heartbeat_interval,
                heartbeat_timeout=heartbeat_timeout,
                transport=transport, coord_addr=None,
                kill_net=kill_net, net=net, faults=opts.get("faults"),
                coord_kill=opts.get("coord_kill"),
                coord_addr_path=_coord_addr_path(procs_dir))
    if transport == "sockets":
        return _run_sockets(job, opts, n=n, procs_dir=procs_dir,
                            start_step=start_step, target=target,
                            restored_from=restored_from,
                            can_recover=can_recover, verbose=verbose,
                            on_step=on_step)
    coord = FileCoordinator(coord_dir, n,
                            heartbeat_interval=heartbeat_interval,
                            heartbeat_timeout=heartbeat_timeout)

    src_root = _src_root()
    procs: list[subprocess.Popen | None] = [None] * n
    grace = [0.0] * n
    recoveries = 0
    job._last_run_recoveries = 0  # audit: how many respawns this run took
    job._last_run_coord_restarts = 0  # files: the launcher IS the coord
    job._last_run_net = dict.fromkeys(NET_TOTALS, 0.0)  # no wire here

    def _spawn(w: int, recover_to: int | None = None) -> None:
        d = _shard_dir(procs_dir, w)
        os.makedirs(d, exist_ok=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.procs", "worker",
               procs_dir, str(w)]
        if recover_to is not None:
            cmd += ["--recover-to", str(recover_to)]
        env = dict(os.environ)
        env["PYTHONPATH"] = src_root + os.pathsep + env.get("PYTHONPATH", "")
        with open(os.path.join(d, "worker.log"), "ab") as logf:
            procs[w] = subprocess.Popen(cmd, stdout=logf,
                                        stderr=subprocess.STDOUT, env=env)
        # the parent's copy of the log fd is closed by the with-block; the
        # child holds its own. Grace deadlines live on the monotonic clock:
        # an NTP step during spawn must not shrink (or stretch) the window
        # a worker gets to reach its first heartbeat.
        grace[w] = time.monotonic() + heartbeat_timeout + SPAWN_GRACE

    def _killall() -> None:
        for p in procs:
            if p is not None and p.poll() is None:
                p.kill()
        for p in procs:
            if p is not None:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass

    def _fail(w: int, reason: str, record: dict | None = None) -> None:
        # the structured failure summary is the chaos-soak artifact: name
        # the failing tier/site in JSON before the run goes down loudly
        write_record(os.path.join(procs_dir, "failure-summary.json"),
                     failure_record("launch-failed", shard=w, message=reason,
                                    record=record))
        coord.abort(reason)
        _killall()
        raise WorkerFailed(w, reason, record=record)

    def _recover(w: int, recover_to: int, why: str,
                 record: dict | None = None) -> None:
        nonlocal recoveries
        if record is not None and record.get("kind") == "no-device":
            # a respawn would find the same host: not a crash to recover
            _fail(w, f"worker {w} {why}", record=record)
        if not can_recover:
            _fail(w, f"worker {w} {why} and the job has no checkpoint + "
                     "message-log recovery wiring (checkpoint_every=)",
                  record=record)
        if recoveries >= MAX_RECOVERIES:
            _fail(w, f"worker {w} {why} after {recoveries} recoveries — "
                     "crash loop, giving up", record=record)
        recoveries += 1
        job._last_run_recoveries = recoveries
        p = procs[w]
        if p is not None and p.poll() is None:
            p.kill()
            p.wait()
        if verbose:
            print(f"  [procs] worker {w} {why}; respawning with "
                  f"--recover-to {recover_to}")
        _spawn(w, recover_to=recover_to)

    def _liveness(step_or_none):
        """One poll tick: a worker that exited, or whose heartbeat went
        stale past its grace window, is recovered (or the run aborts)."""
        def check(got):
            now = time.monotonic()  # same clock as the grace deadlines
            for w in range(n):
                if w in got:
                    continue
                p = procs[w]
                exited = p is not None and p.poll() is not None
                silent = now > grace[w] and coord.stale(w)
                if exited:
                    rec = _read_failure(procs_dir, w)
                    _recover(w, step_or_none,
                             _describe_exit(rec, p.returncode, step_or_none),
                             record=rec)
                elif silent:
                    _recover(w, step_or_none,
                             "went heartbeat-silent "
                             f"(> {heartbeat_timeout:.1f}s) "
                             f"mid-superstep {step_or_none}")
        return check

    history: list[SuperstepRecord] = []
    every = job.checkpointer.every if job.checkpointer is not None else 0
    ok = False
    try:
        for w in range(n):
            _spawn(w)
        nonempty = max(store.nonempty_blocks(), 1)
        for s in range(start_step, target):
            t0 = time.perf_counter()
            if kill_spec is not None and int(kill_spec["step"]) == s:
                kw = int(kill_spec["shard"])
                kill_spec = None
                # kill -9 mid-superstep: the victim has published its
                # outbox (so peers are not re-sent to) but has not applied
                # or arrived — the recovery path must replay this step
                coord.wait_file(_announce_path(procs_dir, s, kw), kw)
                p = procs[kw]
                if p is not None and p.poll() is None:
                    p.kill()
            arrivals = coord.wait_arrivals(s, on_wait=_liveness(s))
            totals = coord.reduce_arrivals(arrivals)
            ckpt_landed = False
            if every and (s + 1) % every == 0:
                _finalize_checkpoint_dir(
                    job.checkpointer.dir, s + 1, n, pg.P,
                    str(numpy_dtype(program.value_dtype)),
                    store.signature(), keep=job.checkpointer.keep,
                )
                ckpt_landed = True
            halt = (
                (program.num_supersteps is None and totals["n_active"] == 0)
                or s + 1 >= target
            )
            coord.publish_commit(s, totals, halt=halt,
                                 ckpt_landed=ckpt_landed)
            dt = time.perf_counter() - t0
            rec = SuperstepRecord(
                step=s, n_active=totals["n_active"],
                n_msgs=totals["n_msgs"], agg=totals["agg"],
                density=totals["active_blocks"] / nonempty,
                mode="streamed", seconds=dt,
                restored_from=restored_from if s == start_step else None,
                blocks_read=totals.get("blocks_read", 0),
                cache_hits=totals.get("cache_hits", 0),
                cache_evictions=totals.get("cache_evictions", 0),
                blocks_skipped=totals.get("blocks_skipped", 0),
            )
            history.append(rec)
            if verbose:
                print(
                    f"  superstep {s:4d}: active={rec.n_active:>9d} "
                    f"msgs={rec.n_msgs:>10d} agg={rec.agg:.6g} "
                    f"density={rec.density:.4f} "
                    f"[streamed procs x{n}] {dt*1e3:.1f} ms"
                )
            if on_step is not None:
                on_step(rec, None)
            if halt:
                break
        last_step = history[-1].step if history else start_step - 1
        # results: every worker publishes its final rows and exits 0; a
        # worker that dies between its last commit and the result write is
        # recovered like any other (replays to last_step + 1, sees the halt
        # commit, writes the result)
        deadline_check = _liveness(last_step + 1)
        poll = FileCoordinator.POLL  # result wait backs off like barriers
        while True:
            missing = [w for w in range(n)
                       if not os.path.exists(_result_path(procs_dir, w))]
            if not missing:
                break
            deadline_check(set(range(n)) - set(missing))
            time.sleep(poll)
            poll = min(poll * FileCoordinator.POLL_GROWTH,
                       FileCoordinator.POLL_MAX)
        vals, acts = [], []
        for w in range(n):
            z = np.load(_result_path(procs_dir, w))
            vals.append(z["values"])
            acts.append(z["active"])
        for p in procs:
            if p is not None:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
        ok = True
    finally:
        if not ok:
            if coord.aborted() is None:
                coord.abort("launcher failed")
            _killall()
    return ((torch.from_numpy(np.stack(vals)).to(job.device),
             torch.from_numpy(np.stack(acts)).to(job.device)), history)


# --------------------------------------------------------------------------
# failure records (written by dying workers, folded in by the supervisor)
# --------------------------------------------------------------------------

def _read_failure(procs_dir: str, w: int) -> dict | None:
    """Consume worker ``w``'s classified failure record, if it published
    one before exiting (records land atomically BEFORE the exit code, so
    an observed exit implies a readable record or none at all)."""
    path = _failure_path(procs_dir, w)
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    try:
        os.unlink(path)
    except OSError:
        pass
    return rec


def _describe_exit(rec: dict | None, returncode, step) -> str:
    """One human line for a worker exit, naming the failing tier/site when
    the worker classified itself before dying."""
    at = f" mid-superstep {step}" if step is not None else ""
    if rec is None:
        return f"exited with code {returncode}{at}"
    kind = rec.get("kind")
    msg = rec.get("message", "")
    if kind == "disk-fault":
        return (f"hit a disk fault in the {rec.get('tier', '?')} tier{at}: "
                f"{msg}")
    if kind == "corruption":
        return f"found a corrupt blob{at} (quarantined for replay): {msg}"
    if kind == "retry-exhausted":
        return f"exhausted its retry budget{at}: {msg}"
    if kind == "no-device":
        return f"found no {rec.get('device', '?')} device{at}: {msg}"
    return f"exited with code {returncode}{at}: {msg or kind}"


def _classify_failure(exc: BaseException, shard: int) -> dict | None:
    """Turn a worker's terminal exception into a structured failure record,
    or None when it is an unclassified bug (exit 1, stack trace only)."""
    d = find_in_chain(exc, NoDevice)
    if d is not None:
        return failure_record("no-device", shard=shard, message=str(d),
                              device=d.device)
    t = find_in_chain(exc, TierFault)
    if t is not None:
        s = t.summary()
        return failure_record(s.pop("kind"), shard=shard, step=s.pop("step"),
                              message=str(t), **s)
    b = find_in_chain(exc, BlobCorruption)
    if b is not None:
        s = b.summary()
        return failure_record(s.pop("kind"), shard=shard, message=str(b), **s)
    r = find_in_chain(exc, RetryExhausted)
    if r is not None:
        s = r.summary()
        return failure_record(s.pop("kind"), shard=shard, message=str(r), **s)
    # a disk errno that escaped tier wrapping is still a spill-tier fault,
    # not a bug
    o = find_in_chain(exc, OSError)
    if o is not None and getattr(o, "errno", None) in _DISK_ERRNOS:
        t = TierFault("spill", cause=o)
        s = t.summary()
        s.pop("step")
        return failure_record(s.pop("kind"), shard=shard, message=str(t), **s)
    return None


def _quarantine(corrupt: BlobCorruption) -> None:
    """Move the corrupt blob's directory aside so bad bytes are never
    consumed twice. The quarantined step is by construction uncommitted —
    a torn run cannot have passed its barrier — so the respawned worker
    re-receives those messages fresh (senders' outboxes and announce
    markers still serve them)."""
    d = corrupt.directory
    if not d or not os.path.isdir(d):
        return
    try:
        # not a publish: an EVICTION from the lineage. If a crash undoes
        # the un-fsynced rename, the dir reappears under its old name and
        # the CRC check re-detects it on the next read.
        os.rename(d, d + ".quarantine")  # analysis: allow[atomic-publish] eviction, not publication; re-detected if undone
    except OSError:
        shutil.rmtree(d, ignore_errors=True)


def _sweep_partial(spec: dict, shard: int) -> None:
    """Drop this worker's torn write products before exiting on a disk
    fault, so neither the respawn nor the post-mortem ever reads a blob
    with no index: an un-announced outbox never published its index
    (markers land only after ``save_index``), and a checkpoint tmp shard
    file without its manifest is re-dumped by the respawn."""
    procs_dir = spec["procs_dir"]
    ob_root = os.path.join(procs_dir, "outbox")
    if os.path.isdir(ob_root):
        for name in os.listdir(ob_root):
            m = _STEP_DIR.match(name)
            if not m:
                continue
            s = int(m.group(1))
            d = os.path.join(ob_root, name, f"src-{shard}")
            if (os.path.isdir(d) and not
                    os.path.exists(_announce_path(procs_dir, s, shard))):
                shutil.rmtree(d, ignore_errors=True)
    ckpt_dir = spec.get("ckpt_dir")
    if ckpt_dir and os.path.isdir(ckpt_dir):
        for name in os.listdir(ckpt_dir):
            if name.startswith(".tmp-step-"):
                try:
                    os.unlink(os.path.join(ckpt_dir, name,
                                           f"shard-{shard}.npz"))
                except OSError:
                    pass


# --------------------------------------------------------------------------
# socket-transport supervision (the coordinator is its own child process)
# --------------------------------------------------------------------------

def _read_wal_commit(wal: str, step: int) -> dict | None:
    try:
        with open(os.path.join(wal, f"commit-{step:06d}.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _wal_last_commit(wal: str) -> int:
    last = -1
    try:
        names = os.listdir(wal)
    except OSError:
        return last
    for name in names:
        m = _WAL_COMMIT.match(name)
        if m:
            last = max(last, int(m.group(1)))
    return last


def _run_sockets(job, opts, *, n, procs_dir, start_step, target,
                 restored_from, can_recover, verbose, on_step):
    """Socket-transport launch: spawn the coordinator as its own process
    (:func:`coord_main`) plus one worker per shard, then supervise. The
    launcher holds NO barrier state (it tails the coordinator's WAL into
    the run history), so ``kill -9`` on the coordinator costs exactly one
    respawn (bounded by ``coord_restart_limit``) and zero committed
    supersteps. A worker that exits with a ``no-device`` record fails the
    run without a respawn: a new process would find the same host."""
    import torch

    from repro_torch.core.engine import SuperstepRecord

    store = job.store
    restart_limit = int(opts.get("coord_restart_limit", 3))
    retry = RetryPolicy.from_opts(opts.get("retry"))
    src_root = _src_root()
    wal = _wal_dir(procs_dir)
    addr_path = _coord_addr_path(procs_dir)
    os.makedirs(wal, exist_ok=True)

    procs: list[subprocess.Popen | None] = [None] * n
    coord_proc = None
    incarnation = 0
    coord_restarts = 0
    recoveries = 0
    job._last_run_recoveries = 0
    job._last_run_coord_restarts = 0

    def _env():
        env = dict(os.environ)
        env["PYTHONPATH"] = src_root + os.pathsep + env.get("PYTHONPATH", "")
        return env

    def _spawn_coord() -> None:
        nonlocal coord_proc
        cmd = [sys.executable, "-m", "repro_torch.launch.procs", "coord",
               procs_dir, "--incarnation", str(incarnation)]
        with open(os.path.join(procs_dir, "coord.log"), "ab") as logf:
            coord_proc = subprocess.Popen(cmd, stdout=logf,
                                          stderr=subprocess.STDOUT,
                                          env=_env())

    def _wait_addr() -> None:
        # trust only an address stamped with the CURRENT incarnation: a
        # predecessor's file still names a dead port
        deadline = time.monotonic() + max(retry.deadline, 30.0)
        while True:
            try:
                with open(addr_path) as f:
                    if int(json.load(f).get("incarnation", -1)) == \
                            incarnation:
                        return
            except (OSError, ValueError):
                pass
            if coord_proc.poll() is not None:
                raise WorkerFailed(
                    -1, f"coordinator incarnation {incarnation} exited "
                        f"with code {coord_proc.returncode} before "
                        "publishing its address")
            if time.monotonic() > deadline:
                raise WorkerFailed(
                    -1, f"coordinator incarnation {incarnation} never "
                        "published its address")
            time.sleep(0.05)

    def _spawn(w: int, recover_to: int | None = None) -> None:
        d = _shard_dir(procs_dir, w)
        os.makedirs(d, exist_ok=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.procs", "worker",
               procs_dir, str(w)]
        if recover_to is not None:
            cmd += ["--recover-to", str(recover_to)]
        with open(os.path.join(d, "worker.log"), "ab") as logf:
            procs[w] = subprocess.Popen(cmd, stdout=logf,
                                        stderr=subprocess.STDOUT,
                                        env=_env())

    def _killall() -> None:
        victims = [p for p in procs + [coord_proc] if p is not None]
        for p in victims:
            if p.poll() is None:
                p.kill()
        for p in victims:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass

    def _abort_run(w: int, reason: str, record: dict | None = None) -> None:
        write_record(os.path.join(procs_dir, "failure-summary.json"),
                     failure_record("launch-failed", shard=w, message=reason,
                                    record=record))
        # ask the coordinator to abort (stragglers exit via K_ABORT if any
        # survive the kill), then kill everything
        atomic_write_json(_abort_request_path(procs_dir),
                          dict(reason=str(reason)))
        _killall()
        raise WorkerFailed(w, reason, record=record)

    def _respawn_worker(w: int, recover_to: int | None, why: str,
                        record: dict | None = None) -> None:
        nonlocal recoveries
        if record is not None and record.get("kind") == "no-device":
            # a respawn would find the same host: not a crash to recover
            _abort_run(w, f"worker {w} {why}", record=record)
        if not can_recover:
            _abort_run(w, f"worker {w} {why} and the job has no checkpoint "
                          "+ message-log recovery wiring "
                          "(checkpoint_every=)", record=record)
        if recoveries >= MAX_RECOVERIES:
            _abort_run(w, f"worker {w} {why} after {recoveries} recoveries "
                          "— crash loop, giving up", record=record)
        recoveries += 1
        job._last_run_recoveries = recoveries
        p = procs[w]
        if p is not None and p.poll() is None:
            p.kill()
            p.wait()
        if recover_to is None:
            recover_to = max(_wal_last_commit(wal) + 1, start_step)
        if verbose:
            print(f"  [procs] worker {w} {why}; respawning with "
                  f"--recover-to {recover_to}")
        _spawn(w, recover_to=recover_to)

    history: list = []
    net_totals = dict.fromkeys(NET_TOTALS, 0.0)
    job._last_run_net = dict(net_totals)
    nonempty = max(store.nonempty_blocks(), 1)
    next_hist = start_step
    ok = False

    def _drain_wal() -> None:
        nonlocal next_hist
        while True:
            rec = _read_wal_commit(wal, next_hist)
            if rec is None:
                return
            s = int(rec["step"])
            r = SuperstepRecord(
                step=s, n_active=int(rec["n_active"]),
                n_msgs=int(rec["n_msgs"]), agg=float(rec["agg"]),
                density=float(rec.get("active_blocks", 0)) / nonempty,
                mode="streamed", seconds=float(rec.get("seconds", 0.0)),
                restored_from=restored_from if s == start_step else None,
                blocks_read=int(rec.get("blocks_read", 0)),
                cache_hits=int(rec.get("cache_hits", 0)),
                cache_evictions=int(rec.get("cache_evictions", 0)),
                blocks_skipped=int(rec.get("blocks_skipped", 0)),
            )
            history.append(r)
            next_hist = s + 1
            for key in net_totals:
                net_totals[key] += float(rec.get(key, 0.0))
            if verbose:
                print(
                    f"  superstep {s:4d}: active={r.n_active:>9d} "
                    f"msgs={r.n_msgs:>10d} agg={r.agg:.6g} "
                    f"density={r.density:.4f} "
                    f"[streamed procs x{n}] {r.seconds*1e3:.1f} ms"
                )
            if on_step is not None:
                on_step(r, None)

    try:
        _spawn_coord()
        _wait_addr()
        for w in range(n):
            _spawn(w)
        while True:
            _drain_wal()
            rc = coord_proc.poll()
            if rc == 0:
                break  # run complete: every result file landed
            if rc == 2:
                # coordinator aborted the run: surface the structured cause
                reason = "run aborted"
                try:
                    with open(os.path.join(wal, "abort.json")) as f:
                        reason = str(json.load(f)["reason"])
                except (OSError, ValueError, KeyError):
                    pass
                record = None
                for w in range(n):
                    record = record or _read_failure(procs_dir, w)
                _killall()
                shard = (int(record["shard"])
                         if record and record.get("shard") is not None
                         else -1)
                write_record(
                    os.path.join(procs_dir, "failure-summary.json"),
                    failure_record("launch-failed", shard=shard,
                                   message=reason, record=record))
                raise WorkerFailed(shard, reason, record=record)
            if rc is not None:
                # crashed (the kill -9 drill lands here): bounded respawn;
                # the successor restores the WAL and resumes mid-run
                if coord_restarts >= restart_limit:
                    _abort_run(-1, f"coordinator crashed (exit {rc}) after "
                                   f"{coord_restarts} restarts — giving up")
                coord_restarts += 1
                incarnation += 1
                job._last_run_coord_restarts = coord_restarts
                if verbose:
                    print(f"  [procs] coordinator crashed (exit {rc}); "
                          f"respawning incarnation {incarnation}")
                _spawn_coord()
                _wait_addr()
            for w in range(n):
                # the coordinator judges heartbeat staleness but cannot
                # respawn processes; it files a recover request instead
                req_path = _recover_request_path(procs_dir, w)
                if os.path.exists(req_path):
                    try:
                        with open(req_path) as f:
                            req = json.load(f)
                    except (OSError, ValueError):
                        req = None
                    try:
                        os.unlink(req_path)
                    except OSError:
                        pass
                    if req is not None:
                        _respawn_worker(
                            w, int(req["recover_to"]),
                            str(req.get("why", "went heartbeat-silent")),
                            record=_read_failure(procs_dir, w))
                        continue
                p = procs[w]
                if p is None or p.poll() is None:
                    continue
                if p.returncode in (0, 3):
                    # 0: result written post-halt; 3: told to abort — the
                    # cause surfaces through the coordinator exit path
                    procs[w] = None
                    continue
                rec = _read_failure(procs_dir, w)
                _respawn_worker(w, None,
                                _describe_exit(rec, p.returncode,
                                               _wal_last_commit(wal) + 1),
                                record=rec)
            time.sleep(0.05)
        _drain_wal()
        vals, acts = [], []
        for w in range(n):
            z = np.load(_result_path(procs_dir, w))
            vals.append(z["values"])
            acts.append(z["active"])
        for p in procs:
            if p is not None:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
        ok = True
    finally:
        if not ok:
            _killall()
        job._last_run_net = net_totals
    return ((torch.from_numpy(np.stack(vals)).to(job.device),
             torch.from_numpy(np.stack(acts)).to(job.device)), history)


# --------------------------------------------------------------------------
# coordinator process (sockets transport; stdlib, numpy and launch.net)
# --------------------------------------------------------------------------

def coord_main(procs_dir: str, incarnation: int = 0) -> int:
    """Host the CoordServer plus the barrier/commit loop as a standalone
    process. Exit codes: 0 = run completed (every result file landed),
    2 = run aborted (reason WAL-logged); anything else is a crash, which
    the launcher answers with a successor incarnation: the successor
    restores the WAL and carries on mid-run."""
    with open(os.path.join(procs_dir, SPEC)) as f:
        spec = json.load(f)
    from repro_torch.launch.net import CoordServer

    n = int(spec["n_shards"])
    hb_t = float(spec["heartbeat_timeout"])
    net = spec.get("net") or {}
    coord = CoordServer(
        n, heartbeat_timeout=hb_t,
        handshake_timeout=float(net.get("handshake_timeout", 5.0)),
        wal_dir=_wal_dir(procs_dir),
    )
    coord.start()
    try:
        # publish AFTER the WAL restore: a worker that reads this address
        # may immediately CHELLO and expect restored commit state
        atomic_write_json(_coord_addr_path(procs_dir),
                          dict(incarnation=int(incarnation),
                               addr=list(coord.addr)))
        return _coord_loop(spec, coord, procs_dir, int(incarnation))
    except RunAborted:
        return 2
    except Exception as e:
        import traceback

        traceback.print_exc()
        coord.abort(f"coordinator failed: {e}")
        return 2
    finally:
        coord.close()


def _coord_loop(spec: dict, coord, procs_dir: str, incarnation: int) -> int:
    n = int(spec["n_shards"])
    start_step = int(spec["start_step"])
    target = int(spec["target"])
    every = int(spec["checkpoint_every"]) if spec.get("ckpt_dir") else 0
    hb_t = float(spec["heartbeat_timeout"])
    num_supersteps = spec.get("num_supersteps")
    # the kill -9 drill arms in the first incarnation only: the successor
    # must prove recovery, not re-die
    drill = spec.get("coord_kill") if incarnation == 0 else None
    abort_path = _abort_request_path(procs_dir)

    def _poll_control() -> None:
        """Abort requests degrade the run to a clean loud stop."""
        coord.check_abort()
        if os.path.exists(abort_path):
            try:
                with open(abort_path) as f:
                    reason = str(json.load(f).get("reason",
                                                  "abort requested"))
            except (OSError, ValueError):
                reason = "abort requested"
            coord.abort(reason)
            raise RunAborted(reason)

    def _request_recover(step, got) -> None:
        """File a recover request for every heartbeat-stale worker; the
        launcher owns process lifecycles, so the respawn is its job. The
        grace grant keeps the request from being refiled while the
        replacement boots and reconnects."""
        for w in range(n):
            if w in got or not coord.stale(w):
                continue
            recover_to = max(coord.last_commit_step() + 1, start_step)
            atomic_write_json(
                _recover_request_path(procs_dir, w),
                dict(shard=w, recover_to=recover_to,
                     why=f"went heartbeat-silent (> {hb_t:.1f}s) "
                         f"mid-superstep {step}"))
            coord.grant_grace(w, hb_t + SPAWN_GRACE)

    # resume: never re-run a superstep the WAL already committed — workers
    # past that barrier would strand. Arrivals for the current (in-flight)
    # step are replayed by the reconnecting clients.
    last = coord.last_commit_step()
    start = max(last + 1, start_step)
    halted = last >= 0 and bool(coord.commit(last).get("halt"))

    if not halted:
        for s in range(start, target):
            t0 = time.perf_counter()
            while True:
                got = coord.arrivals(s)
                if (drill is not None and int(drill["step"]) == s
                        and len(got) >= int(drill.get("after_arrivals", 1))):
                    # mid-barrier kill -9: arrivals received, commit not
                    # yet WALed — the successor must re-collect them
                    os.kill(os.getpid(), signal.SIGKILL)
                if len(got) == n:
                    break
                _poll_control()
                _request_recover(s, got)
                time.sleep(0.05)
            totals = coord.reduce_arrivals(got)
            ckpt_landed = False
            if every and (s + 1) % every == 0:
                _finalize_checkpoint_dir(
                    spec["ckpt_dir"], s + 1, n, int(spec["P"]),
                    spec["value_dtype"], spec.get("store_signature"),
                    keep=int(spec.get("ckpt_keep", 2)) or 2,
                )
                ckpt_landed = True
            halt = ((num_supersteps is None and totals["n_active"] == 0)
                    or s + 1 >= target)
            coord.publish_commit(
                s, totals, halt=halt, ckpt_landed=ckpt_landed,
                extra=dict(seconds=time.perf_counter() - t0))
            if halt:
                break

    # wait for every worker's result file; a worker that dies between its
    # last commit and the result write is recovered like any other
    while True:
        missing = [w for w in range(n)
                   if not os.path.exists(_result_path(procs_dir, w))]
        if not missing:
            return 0
        _poll_control()
        _request_recover("result", set(range(n)) - set(missing))
        time.sleep(0.05)


# --------------------------------------------------------------------------
# worker (runs in its own process; everything below main() may import torch)
# --------------------------------------------------------------------------

def _latest_checkpoint_step(ckpt_dir: str, at_most: int) -> int | None:
    """Latest published checkpoint step <= ``at_most``, read directly from
    the directory: workers never construct a Checkpointer (its constructor
    sweeps ``.tmp-step-*`` dirs that peers may be writing into)."""
    steps = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_DIR.match(name)
        if m and os.path.isdir(os.path.join(ckpt_dir, name)):
            s = int(m.group(1))
            if s <= at_most:
                steps.append(s)
    return max(steps) if steps else None


class _Worker:
    """One shard's superstep loop, on the device the spec names, over
    either transport: shared-filesystem run files (default) or the TCP
    socket layer (``server`` is its PeerServer and a PeerSender transmit
    thread is wired to it)."""

    def __init__(self, spec: dict, program, shard: int, coord,
                 server=None, peer_addrs=None):
        import torch

        from repro_torch.core.checkpoint import RunFileMessageLog
        from repro_torch.core.config import EngineConfig
        from repro_torch.core.engine import StreamKernels, _ChunkStager
        from repro_torch.core.plan import fold_stager_slots
        from repro_torch.streams.reader import StreamReader
        from repro_torch.streams.residency import BlockResidency
        from repro_torch.streams.store import EdgeStreamStore

        dev = torch.device(spec["device"])
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise NoDevice(spec["device"])
        self.device = dev
        self.spec = spec
        self.program = program
        self.w = shard
        self.coord = coord
        self.n = int(spec["n_shards"])
        self.P = int(spec["P"])
        self.cfg = EngineConfig.from_json(spec["config"])
        self.msg_dtype = np.dtype(spec["msg_dtype"])
        self.comb = program.combiner
        self.procs_dir = spec["procs_dir"]
        # the owner view: this process maps ONLY shard w's store row
        self.store = EdgeStreamStore.open(spec["store_dir"], owner=shard)
        # stream.cache_bytes is the PER-SHARD hot-cache budget: each worker
        # process owns exactly one shard, so the per-process division of the
        # planner's budget is simply cache_bytes
        self.residency = BlockResidency(self.store,
                                        self.cfg.stream.cache_bytes)
        # shard w's share of the store's nonempty blocks: the baseline the
        # per-step skip() tally is measured against
        self.own_nonempty = int((self.store.blk_hi[shard] >= 0).sum())
        self.reader = StreamReader(self.store, self.cfg.stream.chunk_blocks,
                                   self.cfg.stream.depth,
                                   residency=self.residency)
        self.kern = StreamKernels(program, self.n, int(spec["n_vertices"]),
                                  self.P)
        # the engine's fold stager, at the engine's size: the same folds
        # of the same slots, so the same sums
        stream, B = self.cfg.stream, self.store.geom.edge_block
        self.edge_block = B
        self.stager = _ChunkStager(dev, fold_stager_slots(
            stream.chunk_blocks, stream.group_batch, B))
        z = np.load(os.path.join(_shard_dir(self.procs_dir, shard),
                                 "rows.npz"))
        self.degree, self.vmask, self.old_ids, self.gids = (
            torch.from_numpy(z[name]).to(dev)
            for name in ("degree", "vmask", "old_ids", "gids"))
        self.log = None
        if spec["log_messages"]:
            # per-worker log lineage: one run-file index per store dir, so
            # n writers need n directories (logs/shard-w/step-NNNNNN)
            self.log = RunFileMessageLog(
                os.path.join(spec["logs_dir"], f"shard-{shard}"))
            self.log.configure(
                self.n, self.P, self.msg_dtype,
                e0=self.comb.e0 if self.comb is not None else 0,
                combined=self.comb is not None,
                compress=self.cfg.channel.compress,
                compress_payload=self.cfg.channel.compress_payload,
            )
        # slice-cap growth persists across supersteps, like the engine's
        self._slice_cap_eff = self.cfg.spill.slice_cap
        # -- socket transport wiring (None under the file transport) -------
        self.server = server
        self.sender = None
        self.net_stats = None
        if server is not None:
            from repro_torch.launch.net import PeerSender
            from repro_torch.streams.channel import ChannelStats
            from repro_torch.streams.msgstore import MessageRunStore

            self.net_stats = ChannelStats()
            outbox_root = os.path.join(_shard_dir(self.procs_dir, shard),
                                       "outbox")
            n, P = self.n, self.P
            cfg, comb, mdt = self.cfg, self.comb, self.msg_dtype

            def make_store(step):
                # the sender's per-step replay log, in the SAME store
                # transform as the file transport's outbox: what goes on
                # the wire is what append_combined/append_raw produce
                d = os.path.join(outbox_root, f"step-{step:06d}")
                shutil.rmtree(d, ignore_errors=True)
                return MessageRunStore(
                    d, n, P, mdt, with_counts=comb is not None,
                    compress=cfg.channel.compress,
                    compress_payload=cfg.channel.compress_payload,
                )

            net = spec.get("net") or {}
            self.sender = PeerSender(
                shard, n, make_store, inflight=cfg.channel.inflight,
                stats=self.net_stats, check_abort=coord.check_abort,
                connect_timeout=float(net.get("connect_timeout", 5.0)),
                send_timeout=float(net.get("send_timeout", 60.0)),
                retry=RetryPolicy.from_opts(net.get("retry")),
            )
            self.sender.set_addrs(peer_addrs)
            # a respawned peer's new data address flows straight into the
            # transmit thread, which reconnects and resumes from its outbox
            coord.on_peer_update = self.sender.update_addr
            self.sender.start()

    # -- state bootstrap -------------------------------------------------------
    def bootstrap(self):
        spec, w = self.spec, self.w
        boot = os.path.join(_shard_dir(self.procs_dir, w), "boot.npz")
        if spec["bootstrap"] == "state" and os.path.exists(boot):
            return self._load_state(boot)
        if spec["bootstrap"] == "checkpoint":
            return self.restore_shard(int(spec["ckpt_step"]))
        return self.kern.init(w, self.degree, self.vmask, self.old_ids,
                              self.gids)

    def restore_shard(self, step: int):
        d = os.path.join(self.spec["ckpt_dir"], f"step-{step:06d}")
        return self._load_state(os.path.join(d, f"shard-{self.w}.npz"))

    def _load_state(self, path: str):
        import torch

        z = np.load(path)
        return (torch.from_numpy(z["values"]).to(self.device),
                torch.from_numpy(z["active"]).to(self.device))

    # -- send phase ------------------------------------------------------------
    def _own_schedule(self, active_w) -> list:
        prefix = np.concatenate(
            [[0], np.cumsum(active_w.cpu().numpy().astype(np.int64))]
        )
        out = []
        for k in range(self.n):
            ids = self.store.active_blocks(self.w, k, prefix)
            if ids.size:
                out.append((self.w, k, ids))
        return out

    def _send(self, s: int, values_w, active_w) -> None:
        """Fold/spill shard w's outgoing groups for step ``s`` into the
        outbox store and publish the announce marker. Idempotent: a marker
        already on disk means a pre-crash incarnation finished the send
        (markers land only after ``save_index``), so recovery skips it —
        peers may already have consumed those runs."""
        from repro_torch.core.engine import _host_copy, fold_groups
        from repro_torch.streams.msgstore import MessageRunStore

        marker = _announce_path(self.procs_dir, s, self.w)
        if os.path.exists(marker):
            return
        schedule = self._own_schedule(active_w)
        # §3.2 selective scheduling: every owned block skip() left off this
        # step's plan is disk I/O that never happens — tallied here (and
        # not on the marker short-circuit, so a recovery respawn does not
        # double-count) for the arrival record's residency counters
        self.residency.note_skipped(
            self.own_nonempty
            - sum(len(ids) for (_, _, ids) in schedule)
        )
        obox = MessageRunStore(
            _outbox_dir(self.procs_dir, s, self.w), self.n, self.P,
            self.msg_dtype, with_counts=self.comb is not None,
            compress=self.cfg.channel.compress,
            compress_payload=self.cfg.channel.compress_payload,
        )
        if self.comb is not None:
            def sink(i, k, A_g, cnt_g):
                # the shared append_combined wire format (streams/msgstore)
                obox.append_combined(k, A_g.cpu().numpy(),
                                     cnt_g.cpu().numpy(), tag=i)

            # the threaded engine's fold, over this worker's one row
            fold_groups(self.kern, self.stager, self.reader,
                        self.cfg.stream.group_batch, self.edge_block,
                        values_w[None], self.degree[None], active_w[None],
                        s, schedule, sink, first_shard=self.w)
        else:
            for chunk in self.reader.stream(schedule):
                msg, dp, valid = self.kern.msgs(
                    values_w, self.degree, active_w,
                    *self.stager.put(chunk.sp, chunk.dp, chunk.w), s,
                )
                # copies: dp may alias the reader's staging buffer
                obox.append_raw(chunk.dst_shard, _host_copy(dp),
                                _host_copy(msg), _host_copy(valid),
                                tag=self.w)
        obox.save_index()
        obox.close()
        os.makedirs(os.path.dirname(marker), exist_ok=True)
        atomic_write_json(marker, dict(src=self.w, step=s))

    def _send_net(self, s: int, values_w, active_w) -> None:
        """Socket-transport send phase: the fold of :meth:`_send` (the same
        ``fold_groups`` call, so the same folds of the same slots in the
        same order), but each completed group goes to the PeerSender the
        moment it is folded: the transmit thread appends it to the step's
        outbox store (the replay log) and frames it onto the destination's
        connection while the next group is still folding. The sender
        queues the arrays without copying them, so each is a host copy
        that shares no memory with a batch lane or a staging buffer. No
        idempotence marker: re-sent runs after a respawn are deduplicated
        by the resume protocol's sequence check."""
        from repro_torch.core.engine import _host_copy, fold_groups

        schedule = self._own_schedule(active_w)
        self.residency.note_skipped(
            self.own_nonempty
            - sum(len(ids) for (_, _, ids) in schedule)
        )
        if self.comb is not None:
            def sink(i, k, A_g, cnt_g):
                self.sender.send_combined(k, _host_copy(A_g),
                                          _host_copy(cnt_g), tag=i)

            fold_groups(self.kern, self.stager, self.reader,
                        self.cfg.stream.group_batch, self.edge_block,
                        values_w[None], self.degree[None], active_w[None],
                        s, schedule, sink, first_shard=self.w)
        else:
            for chunk in self.reader.stream(schedule):
                msg, dp, valid = self.kern.msgs(
                    values_w, self.degree, active_w,
                    *self.stager.put(chunk.sp, chunk.dp, chunk.w), s,
                )
                self.sender.send_raw(chunk.dst_shard, _host_copy(dp),
                                     _host_copy(msg), _host_copy(valid),
                                     tag=self.w)
        self.sender.end_step()

    def _superstep_net(self, s: int, values_w, active_w, inbox):
        """One socket-transport superstep: a reader thread drains the n
        peer connections in ascending source order into the inbox (and the
        ChannelReceiver digest, when combining) WHILE the fold transmits,
        §4's full overlap, with the same digest sequence as the file path:
        per source, runs land in sender append order; sources complete
        ascending. Returns the engine-shaped ``(nv, na, nact, nm, ag)``."""
        from repro_torch.streams.channel import ChannelReceiver

        self.server.begin_step(s)
        self.sender.begin_step(s)
        comb, stats = self.comb, self.net_stats
        receiver = None
        if comb is not None:
            receiver = ChannelReceiver(inbox, self._digest, self._identity,
                                       comb.e0, stats=stats)

        def on_run(hdr, dp, msg, cnt):
            t0 = time.perf_counter()
            lseg = inbox.append_run(
                self.w, dp, msg,
                cnt=cnt if comb is not None else None, tag=hdr["tag"])
            if receiver is not None:
                receiver.enqueue_digest(self.w, lseg)
            # reader busy time overlaps the fold exactly like digest time
            # (collect() accounts the stall side)
            stats.recv_seconds += time.perf_counter() - t0

        errs: list[BaseException] = []

        def drain():
            try:
                for j in range(self.n):
                    self.server.read_source(s, j, on_run,
                                            self.coord.check_abort)
                    if comb is None:
                        # per-source compaction, same as the file path:
                        # the run-table evolution the merge depends on
                        inbox.compact_tag(self.w, j,
                                          self.cfg.spill.merge_fanin,
                                          self.cfg.spill.read_chunk)
            except BaseException as e:  # surfaced on the compute thread
                errs.append(e)

        t = threading.Thread(target=drain, name="net-recv", daemon=True)
        t.start()
        try:
            self._send_net(s, values_w, active_w)
            while t.is_alive():
                t.join(0.2)
                self.sender.check_failed()
                self.coord.check_abort()
            if errs:
                raise errs[0]
            if comb is not None:
                A_r, cnt = receiver.collect(self.w)
                return self.kern.apply(
                    values_w, self.degree, self.vmask, self.old_ids,
                    self.gids, A_r, cnt, active_w, s, self.w,
                )
            acc_v, acc_a, cnt_k = self._apply_list_merged(
                inbox, values_w, active_w, s)
            nact, nm, ag = self.kern.finish(values_w, acc_v, acc_a, cnt_k,
                                            self.vmask)
            return acc_v, acc_a, nact, nm, ag
        finally:
            if receiver is not None:
                receiver.close()

    # -- receive phase ---------------------------------------------------------
    def _open_inbox(self, s: int):
        from repro_torch.streams.msgstore import MessageRunStore

        if self.log is not None:
            return self.log.open_step(s)
        return MessageRunStore(
            os.path.join(_shard_dir(self.procs_dir, self.w), "inbox",
                         f"step-{s:06d}"),
            self.n, self.P, self.msg_dtype,
            with_counts=self.comb is not None,
            compress=self.cfg.channel.compress,
            compress_payload=self.cfg.channel.compress_payload,
        )

    def _pull_runs(self, s: int, src: int, inbox, receiver=None) -> None:
        """Copy source ``src``'s runs for this shard out of its announced
        outbox into the local inbox, preserving run boundaries and tags.
        Bounded memory: a combined run is <= P positions, an uncompacted
        raw run is <= one staged chunk's messages."""
        from repro_torch.streams.msgstore import MessageRunStore

        self.coord.wait_file(
            _announce_path(self.procs_dir, s, src), self.w)
        src_store = MessageRunStore.open(_outbox_dir(self.procs_dir, s, src))
        try:
            for seg in src_store.runs(self.w):
                parts = src_store.read_run(self.w, seg)
                lseg = inbox.append_run(
                    self.w, parts[0], parts[1],
                    cnt=parts[2] if self.comb is not None else None,
                    tag=seg.tag,
                )
                if receiver is not None:
                    receiver.enqueue_digest(self.w, lseg)
        finally:
            src_store.close()

    def _identity(self):
        import torch

        return (self.comb.identity((self.P,), self.program.msg_dtype,
                                   self.device),
                torch.zeros(self.P, dtype=torch.int32, device=self.device))

    def _digest(self, A, cnt, A_d, c_d):
        """One densified run into the accumulator: the threaded engine's
        full-duplex digest (a fresh host array, copied to the device)."""
        import torch

        return self.kern.digest(A, cnt, torch.from_numpy(A_d).to(self.device),
                                torch.from_numpy(c_d).to(self.device))

    def _receive_combined(self, s: int, values_w, active_w, inbox):
        """Digest ascending source through the real ChannelReceiver: the
        per-position digest sequence equals the threaded full-duplex path's
        (transmit order == source-ascending), so results are bit-identical."""
        from repro_torch.streams.channel import ChannelReceiver

        receiver = ChannelReceiver(inbox, self._digest, self._identity,
                                   self.comb.e0)
        try:
            for j in range(self.n):
                self._pull_runs(s, j, inbox, receiver=receiver)
            A_r, cnt = receiver.collect(self.w)
        finally:
            receiver.close()
        return self.kern.apply(
            values_w, self.degree, self.vmask, self.old_ids, self.gids,
            A_r, cnt, active_w, s, self.w,
        )

    def _receive_nocomb(self, s: int, values_w, active_w, inbox):
        """Combiner-less receive: copy + per-source compaction reproduces
        the threaded engine's run-table evolution exactly, then the merged
        destination-aligned apply folds the slices."""
        for j in range(self.n):
            self._pull_runs(s, j, inbox)
            inbox.compact_tag(self.w, j, self.cfg.spill.merge_fanin,
                              self.cfg.spill.read_chunk)
        acc_v, acc_a, cnt_k = self._apply_list_merged(
            inbox, values_w, active_w, s)
        nact, nm, ag = self.kern.finish(values_w, acc_v, acc_a, cnt_k,
                                        self.vmask)
        return acc_v, acc_a, nact, nm, ag

    def _apply_list_merged(self, mstore, values_w, active_w, step: int):
        """Worker-local mirror of ``GraphDEngine._apply_list_merged`` (same
        slice-cap growth, covered-overwrite accumulation, and padding-only
        fallback; the slice decomposition is results-neutral)."""
        import torch

        w, dev = self.w, self.device
        counts = mstore.dest_counts(w)
        max_run = int(counts.max()) if counts.size else 0
        while self._slice_cap_eff < max_run:
            self._slice_cap_eff *= 2
        cap = self._slice_cap_eff
        cnt_k = torch.from_numpy(
            np.minimum(counts, np.iinfo(np.int32).max).astype(np.int32)
        ).to(dev)
        row = (self.degree, self.vmask, self.old_ids, self.gids)
        acc_v = acc_a = None
        for sdp, smsg, covered in mstore.merged_slices(
                w, cap, self.cfg.spill.read_chunk):
            nv, na = self.kern.apply_list(
                values_w, *row, torch.from_numpy(sdp).to(dev),
                torch.from_numpy(smsg).to(dev), cnt_k, active_w, step, w,
            )
            if acc_v is None:
                acc_v, acc_a = nv, na
            else:
                cov = torch.from_numpy(covered).to(dev)
                acc_v = torch.where(cov, nv, acc_v)
                acc_a = torch.where(cov, na, acc_a)
        if acc_v is None:  # no messages at all: one padding-only call
            acc_v, acc_a = self.kern.apply_list(
                values_w, *row,
                torch.full((cap,), self.P, dtype=torch.int32, device=dev),
                torch.zeros(cap, dtype=self.program.msg_dtype, device=dev),
                cnt_k, active_w, step, w,
            )
        return acc_v, acc_a, cnt_k

    # -- recovery replay -------------------------------------------------------
    def replay(self, t: int, values_w, active_w):
        """Re-derive the step-``t`` state transition from this worker's own
        message log (which holds EVERY run addressed to it, its own group
        included — the live receive copies them all), digesting in append
        order = the live digest order, so replay is bit-identical."""
        from repro_torch.streams.msgstore import MessageRunStore

        store_t = MessageRunStore.open(self.log.step_dir(t))
        try:
            if self.comb is not None:
                A_r, cnt = self._identity()
                for seg in store_t.runs(self.w):
                    A_r, cnt = self._digest(
                        A_r, cnt,
                        *store_t.read_combined(self.w, seg, self.comb.e0))
                nv, na, *_ = self.kern.apply(
                    values_w, self.degree, self.vmask, self.old_ids,
                    self.gids, A_r, cnt, active_w, t, self.w,
                )
                return nv, na
            acc_v, acc_a, _ = self._apply_list_merged(
                store_t, values_w, active_w, t)
            return acc_v, acc_a
        finally:
            store_t.close()

    # -- the superstep loop ----------------------------------------------------
    def run(self, recover_to: int | None = None) -> None:
        spec, coord, w = self.spec, self.coord, self.w
        start = int(spec["start_step"])
        target = int(spec["target"])
        every = int(spec["checkpoint_every"])
        if recover_to is not None:
            # read-path integrity: a respawn (especially one triggered by
            # a corruption quarantine) must not trust the edge tier
            # blindly — re-verify the store's per-channel CRCs first
            self.store.verify_integrity()
            C = _latest_checkpoint_step(spec["ckpt_dir"], recover_to)
            if C is None:
                # nothing checkpointed yet (e.g. the very first checkpoint
                # write faulted): the message logs for every committed step
                # are still intact — gc only runs after a checkpoint lands —
                # so replay the whole prefix on top of the bootstrap state
                values_w, active_w = self.bootstrap()
                C = int(spec["start_step"])
            else:
                values_w, active_w = self.restore_shard(C)
            for t in range(C, recover_to):
                values_w, active_w = self.replay(t, values_w, active_w)
            start = recover_to
            if start > int(spec["start_step"]):
                cm = coord.commit(start - 1)
                if cm is not None and cm.get("halt"):
                    # the job already halted; just republish the final rows
                    self._write_result(values_w, active_w)
                    return
        else:
            values_w, active_w = self.bootstrap()

        for s in range(start, target):
            inj = _fault.active()
            if inj is not None:  # step context for the file-write sites
                inj.set_step(s)
            # all edge-block reads happen inside _send's folds, through the
            # residency layer — the counter deltas around the step are this
            # shard's contribution to the coordinator's SuperstepRecord
            h0, m0, e0, k0 = self.residency.counters()
            st = self.net_stats
            ns0 = ((st.send_seconds, st.stall_seconds, st.recv_seconds,
                    st.recv_stall_seconds, st.wire_bytes, st.packets)
                   if st is not None else None)
            inbox = None
            try:
                if self.server is not None:
                    inbox = self._open_inbox(s)
                    nv, na, nact, nm, ag = self._superstep_net(
                        s, values_w, active_w, inbox)
                else:
                    self._send(s, values_w, active_w)
                    inbox = self._open_inbox(s)
                    if self.comb is not None:
                        nv, na, nact, nm, ag = self._receive_combined(
                            s, values_w, active_w, inbox)
                    else:
                        nv, na, nact, nm, ag = self._receive_nocomb(
                            s, values_w, active_w, inbox)
            except OSError as e:
                if e.errno in _DISK_ERRNOS:
                    # a spill/inbox blob write failed: name the tier so
                    # the failure record and the launcher's message do
                    raise TierFault("spill", s, e) from e
                raise
            finally:
                if inbox is not None:
                    if self.log is not None:
                        self.log.close_step(s)
                    else:
                        inbox.close()
                        inbox.delete()
            values_w, active_w = nv, na
            # next-frontier active blocks for this shard's source row (the
            # coordinator divides the sum by the store's nonempty blocks to
            # get the engine's density signal)
            nblocks = sum(
                len(ids) for (_, _, ids) in self._own_schedule(active_w)
            )
            ckpt = False
            if every and (s + 1) % every == 0 and spec["ckpt_dir"]:
                tmp = os.path.join(spec["ckpt_dir"],
                                   f".tmp-step-{s + 1:06d}")
                try:
                    os.makedirs(tmp, exist_ok=True)
                    inj = _fault.active()
                    if inj is not None:  # chaos: fail the shard dump
                        inj.check("io.write.ckpt", step=s + 1)
                    np.savez(os.path.join(tmp, f"shard-{w}.npz"),
                             values=values_w.cpu().numpy(),
                             active=active_w.cpu().numpy())
                except OSError as e:
                    if e.errno in _DISK_ERRNOS:
                        raise TierFault("checkpoint", s + 1, e) from e
                    raise
                ckpt = True
            h1, m1, e1, k1 = self.residency.counters()
            stats = dict(
                n_active=int(nact), n_msgs=int(nm), agg=float(ag),
                active_blocks=int(nblocks), ckpt=ckpt,
                blocks_read=m1 - m0, cache_hits=h1 - h0,
                cache_evictions=e1 - e0, blocks_skipped=k1 - k0,
            )
            if ns0 is not None:  # per-step socket channel accounting deltas
                stats.update(zip(NET_TOTALS, (
                    st.send_seconds - ns0[0], st.stall_seconds - ns0[1],
                    st.recv_seconds - ns0[2], st.recv_stall_seconds - ns0[3],
                    st.wire_bytes - ns0[4], st.packets - ns0[5])))
            coord.arrive(s, w, stats)
            # the arrival on the wall clock, in this worker's log: where a
            # start-up measurement reads it under either transport
            wall = time.time()  # analysis: allow[liveness-clock] a log line, never a deadline
            print(f"worker {w}: superstep {s} arrived at wall clock "
                  f"{wall:.6f}", flush=True)
            cm = coord.wait_commit(s, w)
            if self.log is not None and cm.get("ckpt_landed"):
                self.log.gc_before(s + 1)
            # every peer has consumed this step's messages (they arrived
            # before the commit could exist) — reclaim the outbox
            if self.sender is not None:
                self.sender.finish_step(s)
            else:
                shutil.rmtree(_outbox_dir(self.procs_dir, s, w),
                              ignore_errors=True)
            if cm.get("halt"):
                break
        self._write_result(values_w, active_w)

    def _write_result(self, values_w, active_w) -> None:
        path = _result_path(self.procs_dir, self.w)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _save_npz_atomic(path, values=values_w.cpu().numpy(),
                         active=active_w.cpu().numpy())


def _close_net(sender, server, coord, shard: int) -> None:
    """Close the worker's socket-transport pieces in dependency order
    (sender first: its transmit thread may still hold peer connections).
    Every failure is reported, only the first propagates: a close error
    must not shadow the ones after it."""
    first: BaseException | None = None
    for res in (sender, server, coord):
        if res is None:
            continue
        try:
            res.close()
        except Exception as e:
            print(f"worker {shard}: net close failed: {e}", file=sys.stderr)
            if first is None:
                first = e
    if first is not None:
        raise first


def worker_main(spec_dir: str, shard: int,
                recover_to: int | None = None) -> int:
    with open(os.path.join(spec_dir, SPEC)) as f:
        spec = json.load(f)
    n = int(spec["n_shards"])
    transport = spec.get("transport", "files")
    # arm the chaos schedule — FIRST incarnation only: the spec is shared
    # by every incarnation and a respawn must prove recovery, not re-trip
    # the drill that killed its predecessor
    if recover_to is None:
        sched = FaultSchedule.from_opts(spec.get("faults"))
        kn = spec.get("kill_net")
        if kn is not None and int(kn.get("shard", -1)) == int(shard):
            # the kill_net alias, as a schedule event: header + half the
            # payload on the wire, then SIGKILL
            sched.events.append(FaultEvent(
                site="net.send", kind="torn_kill", step=int(kn["step"]),
                after=int(kn.get("after_frames", 0))))
        if sched.events:
            _fault.install(FaultInjector(sched, shard=int(shard)))
    server = None
    peer_addrs = None
    net = spec.get("net") or {}
    if transport == "sockets":
        # stdlib-only wiring, started BEFORE the heavy imports below:
        # liveness (heartbeats) and peer registration must not depend on
        # the torch import's latency
        from repro_torch.launch.net import CoordClient, PeerServer

        start_step = (recover_to if recover_to is not None
                      else int(spec["start_step"]))
        server = PeerServer(
            n, start_step=start_step,
            handshake_timeout=float(net.get("handshake_timeout", 5.0)))
        server.start()
        coord = CoordClient(
            tuple(spec["coord_addr"]) if spec.get("coord_addr") else None,
            shard,
            heartbeat_interval=float(spec["heartbeat_interval"]),
            addr_file=spec.get("coord_addr_path"),
            connect_timeout=float(net.get("coord_connect_timeout", 10.0)),
            retry=RetryPolicy.from_opts(net.get("retry")),
        )
        coord.start()
    else:
        coord = FileCoordinator(
            spec["coord_dir"], n,
            heartbeat_interval=float(spec["heartbeat_interval"]),
            heartbeat_timeout=float(spec["heartbeat_timeout"]),
        )
        # beat BEFORE the heavy imports below (unpickling the program
        # imports repro_torch.core and torch): liveness must not depend on
        # import time
        coord.start_heartbeat(shard)
    wk = None
    try:
        if server is not None:
            peer_addrs = coord.register(server.addr)
        with open(os.path.join(spec_dir, PROGRAM), "rb") as f:
            program = pickle.load(f)
        wk = _Worker(spec, program, shard, coord,
                     server=server, peer_addrs=peer_addrs)
        wk.run(recover_to=recover_to)
        return 0
    except RunAborted as e:
        print(f"worker {shard}: {e}", file=sys.stderr)
        return 3
    except Exception as e:
        import traceback

        traceback.print_exc()
        rec = _classify_failure(e, int(shard))
        if rec is not None:
            # a named fault: quarantine corrupt blobs, sweep this shard's
            # torn write products, and publish the structured record the
            # launcher folds into WorkerFailed / failure-summary.json
            corrupt = find_in_chain(e, BlobCorruption)
            if corrupt is not None:
                _quarantine(corrupt)
            _sweep_partial(spec, int(shard))
            write_record(_failure_path(spec["procs_dir"], int(shard)), rec)
            return 4
        return 1
    finally:
        # every socket-transport resource joins its threads on close (and
        # raises on leak): a worker that cannot stop its net threads must
        # exit nonzero, not pretend it shut down cleanly
        _close_net(wk.sender if wk is not None else None, server,
                   coord if transport == "sockets" else None, shard)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.procs")
    sub = ap.add_subparsers(dest="cmd", required=True)
    wk = sub.add_parser("worker", help="run one shard's worker process")
    wk.add_argument("spec_dir")
    wk.add_argument("shard", type=int)
    wk.add_argument("--recover-to", type=int, default=None)
    co = sub.add_parser("coord",
                        help="run the coordinator process (sockets)")
    co.add_argument("spec_dir")
    co.add_argument("--incarnation", type=int, default=0)
    args = ap.parse_args(argv)
    if args.cmd == "coord":
        return coord_main(args.spec_dir, args.incarnation)
    return worker_main(args.spec_dir, args.shard, args.recover_to)


if __name__ == "__main__":
    sys.exit(main())
