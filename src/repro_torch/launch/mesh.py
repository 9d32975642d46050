"""One process a shard over ``torch.distributed``: the port's counterpart of
the reference's ``GraphDEngine(pg, program, mesh=mesh).run()``.

JAX drives a device mesh from one process (``shard_map``); PyTorch needs
one process a rank. :func:`run_mesh` does what the reference's call does
and adds nothing:

* it writes each rank's slice of the partition
  (``graph.partition.write_shard_slice``) into a work directory;
* it spawns ``python -m repro_torch.launch.mesh rank <workdir> <r>`` for
  each rank r, on a free loopback port, each NCCL rank with exactly one GPU
  in its own ``CUDA_VISIBLE_DEVICES``;
* each rank joins the process group, loads its slice and runs
  ``GraphDEngine(..., mesh=ProcessMesh(...))``;
* it gathers every rank's values and active bitmap in shard order, and the
  superstep history (the same on every rank; each superstep's ``seconds``
  is the slowest rank's).

``device="cpu"`` means gloo on the CPU. Otherwise the ranks run on CUDA and
the launcher raises without it; NCCL asked for with fewer GPUs than ranks
raises too, and never drops to gloo. A rank that exits non-zero, or a run
past its ``timeout``, fails the whole run with the rank's log tail; there
is no retry.

    (values, active), history = run_mesh(pg, PageRank(10), device="cpu")

:func:`run_mesh_cases` runs several (program, config) cases in one spawn
and returns what each rank measured as well: bytes a collective handed its
backend, kernel launches, peak device memory, and start-up (torch import,
rendezvous, slice load, spawn to the first superstep). A case may carry a
:class:`CaseFiles`: a message log and checkpoints in directories every rank
sees, made on each rank with its mesh (rank r writes shard r's files), so a
later case can resume from them and ``core.checkpoint.recover_shard`` can
recover a shard from them in one process.

This module imports only the standard library at its top (the import
hygiene pass holds it to that): the rank imports torch after it starts,
and times the import.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any

SPEC = "spec.json"
CASES = "cases.pkl"
LOG_TAIL = 4000  # bytes of a failed rank's log in the error


class MeshFailed(RuntimeError):
    """A rank died, or the run passed its deadline."""


@dataclass
class CaseFiles:
    """What a case of :func:`run_mesh_cases` keeps in directories every
    rank sees: a message log (``log``: every superstep is then the logged
    one) and checkpoints (``ckpt``, every ``every`` supersteps, the ``keep``
    latest), each made on every rank with the mesh, so that rank r writes
    shard r's files. ``save_initial`` checkpoints the initial state at step
    0 first. A case whose ``ckpt`` already holds a checkpoint resumes from
    its latest, as ``run(checkpointer=)`` does: a later case can resume
    from an earlier one's."""

    log: str | None = None
    ckpt: str | None = None
    every: int = 5
    keep: int = 2
    save_initial: bool = False


@dataclass
class MeshResult:
    """One case of a mesh run, gathered in shard order on the host."""

    values: Any  # (n, P) CPU tensor
    active: Any  # (n, P) CPU bool tensor
    history: list  # SuperstepRecord; seconds: the slowest rank's
    #: per rank: ``seconds`` (a superstep), ``bytes`` (ProcessMesh.bytes
    #: over the case), ``launches`` (edge_combine, digest, run_sum),
    #: ``peak_bytes``, ``log_bytes`` (the rank's message-log files, summed
    #: over supersteps) and ``ckpt_seconds`` (in ``Checkpointer.save``)
    ranks: list = field(default_factory=list)


@dataclass
class MeshRun:
    results: list  # MeshResult per case
    #: per rank: import_s, rendezvous_s, load_s, spawn_to_first_s
    startup: list
    devices: list  # the CUDA_VISIBLE_DEVICES each rank got ("" on the CPU)
    slices_s: float  # writing the slices
    seconds: float  # first spawn to the last rank's exit


def _src_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def visible_gpus() -> list[str]:
    """This process's GPUs as ``CUDA_VISIBLE_DEVICES`` names them, or
    indices 0.. of ``torch.cuda.device_count()`` where it is unset."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [g.strip() for g in env.split(",") if g.strip()]
    import torch

    return [str(i) for i in range(torch.cuda.device_count())]


def _tail(path: str) -> str:
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            fh.seek(max(0, fh.tell() - LOG_TAIL))
            return fh.read().decode(errors="replace")
    except OSError as e:
        return f"(no log: {e})"


def _log(workdir: str, rank: int) -> str:
    return os.path.join(workdir, f"rank-{rank}.log")


def _slice(workdir: str, rank: int) -> str:
    return os.path.join(workdir, f"slice-{rank}.npz")


def _out(workdir: str, case: int, rank: int, ext: str) -> str:
    return os.path.join(workdir, f"case-{case}-rank-{rank}.{ext}")


def run_mesh(pg, program, config=None, *, world_size: int | None = None,
             backend: str | None = None, device=None, gpus=None,
             workdir: str | None = None, timeout: float = 600.0):
    """``GraphDEngine(pg, program, config, mesh=...).run()`` over
    ``world_size`` (= ``pg.n_shards``) processes: ``((values, active),
    history)``, gathered in shard order on the host."""
    if world_size is not None and world_size != pg.n_shards:
        raise ValueError(f"one rank a shard: world_size {world_size}, "
                         f"{pg.n_shards} shards")
    res = run_mesh_cases(pg, [(program, config)], backend=backend,
                         device=device, gpus=gpus, workdir=workdir,
                         timeout=timeout).results[0]
    return (res.values, res.active), res.history


def run_mesh_cases(pg, cases, *, backend: str | None = None, device=None,
                   gpus=None, workdir: str | None = None,
                   timeout: float = 600.0) -> MeshRun:
    """Run each ``(program, config)`` of ``cases`` in turn on one mesh of
    ``pg.n_shards`` ranks (one spawn, one slice each); a case may carry a
    third item, its :class:`CaseFiles`. ``gpus`` names the
    GPUs the ranks take (default :func:`visible_gpus`): NCCL rank r gets
    ``gpus[r]``, gloo rank r ``gpus[r % len(gpus)]``. ``workdir`` (default a
    temporary directory, removed after) holds the slices, each rank's log
    ``rank-r.log`` and its outputs."""
    from repro_torch.device import resolve_device
    from repro_torch.graph.partition import write_shard_slice

    dev = resolve_device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"a mesh runs on cpu or cuda, not {dev}")
    backend = backend or ("gloo" if dev.type == "cpu" else "nccl")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: gloo or nccl")
    n = pg.n_shards
    if pg.n_rows != n:
        raise ValueError("run_mesh takes the whole partition, not a slice")
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL runs on CUDA; device='cpu' means gloo")
        devices = [""] * n
    else:
        ids = [str(g) for g in (visible_gpus() if gpus is None else gpus)]
        if not ids:
            raise RuntimeError("no GPU to run the mesh on")
        if backend == "nccl" and len(ids) < n:
            raise ValueError(f"NCCL runs one rank a GPU: {n} ranks, "
                             f"{len(ids)} GPUs {ids}")
        devices = [ids[r % len(ids)] for r in range(n)]
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="repro-mesh-") if own else workdir
    os.makedirs(workdir, exist_ok=True)
    try:
        t0 = time.perf_counter()
        for r in range(n):
            write_shard_slice(pg, r, _slice(workdir, r))
        slices_s = time.perf_counter() - t0
        with open(os.path.join(workdir, CASES), "wb") as fh:
            pickle.dump(list(cases), fh)
        with open(os.path.join(workdir, SPEC), "w") as fh:
            json.dump(dict(world_size=n, backend=backend, device=dev.type,
                           port=_free_port(), timeout=float(timeout)), fh)
        t0 = time.perf_counter()
        _spawn_and_wait(workdir, devices, timeout)
        seconds = time.perf_counter() - t0
        return MeshRun(
            results=[_gather(workdir, c, n) for c in range(len(cases))],
            startup=[_read_json(os.path.join(workdir, f"startup-{r}.json"))
                     for r in range(n)],
            devices=devices, slices_s=slices_s, seconds=seconds)
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)


def _spawn_and_wait(workdir: str, devices: list[str], timeout: float) -> None:
    """Spawn a rank a device and wait for all to exit 0; on the first
    failure or at the deadline, kill every rank and raise MeshFailed."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _src_root() + os.pathsep + env.get("PYTHONPATH", "")
    procs: list[subprocess.Popen] = []
    deadline = time.monotonic() + timeout
    try:
        for r, gpu in enumerate(devices):
            env["CUDA_VISIBLE_DEVICES"] = gpu
            # analysis: allow[liveness-clock] a start-up report, no deadline
            spawned = time.time()
            cmd = [sys.executable, "-m", "repro_torch.launch.mesh", "rank",
                   workdir, str(r), "--spawned", repr(spawned)]
            with open(_log(workdir, r), "ab") as logf:
                procs.append(subprocess.Popen(
                    cmd, stdout=logf, stderr=subprocess.STDOUT, env=env))
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:  # a rank's death fails its peers too: name them all
                raise MeshFailed(
                    "; ".join(f"mesh rank {r} exited with code {codes[r]}"
                              for r in bad)
                    + "; the run is lost (no retry)."
                    + "".join(f"\nrank {r}'s log ({_log(workdir, r)}) "
                              f"ends:\n{_tail(_log(workdir, r))}"
                              for r in bad))
            if all(c == 0 for c in codes):
                return
            if time.monotonic() > deadline:
                late = [r for r, c in enumerate(codes) if c is None]
                raise MeshFailed(
                    f"mesh ranks {late} still running after {timeout:.0f} s;"
                    f" the run is lost. Rank {late[0]}'s log ends:\n"
                    + _tail(_log(workdir, late[0])))
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass


def _read_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def _gather(workdir: str, case: int, n: int) -> MeshResult:
    import numpy as np
    import torch

    from repro_torch.core.engine import SuperstepRecord

    values, active, reports = [], [], []
    for r in range(n):
        with np.load(_out(workdir, case, r, "npz")) as z:
            values.append(z["values"])
            active.append(z["active"])
        reports.append(_read_json(_out(workdir, case, r, "json")))
    stats = lambda rep: [(h["step"], h["n_active"], h["n_msgs"], h["mode"])
                         for h in rep["history"]]
    for r, rep in enumerate(reports[1:], 1):
        if stats(rep) != stats(reports[0]):
            raise MeshFailed(f"case {case}: rank {r}'s superstep stats "
                             "differ from rank 0's")
    history = []
    for s, h in enumerate(reports[0]["history"]):
        h = dict(h, seconds=max(rep["history"][s]["seconds"]
                                for rep in reports))
        history.append(SuperstepRecord(**h))
    ranks = [dict(rep, seconds=[h["seconds"] for h in rep["history"]])
             for rep in reports]
    for rank in ranks:
        del rank["history"]
    return MeshResult(values=torch.from_numpy(np.concatenate(values)),
                      active=torch.from_numpy(np.concatenate(active)),
                      history=history, ranks=ranks)


# --------------------------------------------------------------------------
# the rank process
# --------------------------------------------------------------------------

def rank_main(workdir: str, rank: int, spawned: float) -> int:
    print(f"rank {rank} pid {os.getpid()}", flush=True)
    spec = _read_json(os.path.join(workdir, SPEC))
    t0 = time.perf_counter()
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core.checkpoint import Checkpointer, MessageLog
    from repro_torch.core.collectives import ProcessMesh
    from repro_torch.core.engine import GraphDEngine
    from repro_torch.graph.partition import load_shard_slice
    from repro_torch.kernels.digest import digest
    from repro_torch.kernels.edge_combine import edge_combine
    from repro_torch.kernels.run_sum import run_sum

    import_s = time.perf_counter() - t0
    n, backend = int(spec["world_size"]), spec["backend"]
    cuda = spec["device"] == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            # never the CPU in place of the card the caller asked for
            gpu = os.environ.get("CUDA_VISIBLE_DEVICES")
            raise RuntimeError(f"rank {rank}: no CUDA device "
                               f"(CUDA_VISIBLE_DEVICES={gpu!r})")
        torch.cuda.set_device(0)
        device = torch.device("cuda", 0)
    else:
        torch.set_num_threads(1)  # n ranks share the host's cores
        device = torch.device("cpu")
    t0 = time.perf_counter()
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{int(spec['port'])}",
        rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=float(spec["timeout"])))
    try:
        mesh = ProcessMesh(rank, n, backend=backend, device=device)
        mesh.barrier()
        rendezvous_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pg, shard = load_shard_slice(_slice(workdir, rank), device)
        if shard != rank:
            raise ValueError(f"rank {rank} was handed shard {shard}'s slice")
        load_s = time.perf_counter() - t0
        with open(os.path.join(workdir, CASES), "rb") as fh:
            cases = pickle.load(fh)  # written by this rank's launcher
        first = None
        for c, (program, config, *rest) in enumerate(cases):
            files = rest[0] if rest else CaseFiles()
            log = (MessageLog(files.log, mesh=mesh) if files.log is not None
                   else None)
            ckpt = (Checkpointer(files.ckpt, files.every, files.keep,
                                 mesh=mesh)
                    if files.ckpt is not None else None)
            mesh.reset()
            edge_combine.launches = digest.launches = run_sum.launches = 0
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            eng = GraphDEngine(pg, program, config, mesh=mesh,
                               message_log=log)
            if ckpt is not None and files.save_initial:
                ckpt.save(0, *eng.init())
            if first is None:
                # analysis: allow[liveness-clock] a start-up report
                first = time.time()
            log_bytes = [0]

            def on_step(rec, _state, c=c, log=log, log_bytes=log_bytes):
                if log is not None:
                    log_bytes[0] += os.path.getsize(os.path.join(
                        log.dir, f"step-{rec.step:06d}",
                        f"shard-{rank}.npz"))
                print(f"rank {rank} case {c}: superstep {rec.step} "
                      f"active {rec.n_active} msgs {rec.n_msgs} "
                      f"[{rec.mode}] {rec.seconds * 1e3:.3f} ms", flush=True)

            (v, a), hist = eng.run(on_step=on_step, checkpointer=ckpt)
            np.savez(_out(workdir, c, rank, "npz"), values=v.cpu().numpy(),
                     active=a.cpu().numpy())
            report = dict(
                history=[dataclasses.asdict(h) for h in hist],
                bytes=dict(mesh.bytes),
                launches=dict(edge_combine=edge_combine.launches,
                              digest=digest.launches,
                              run_sum=run_sum.launches),
                peak_bytes=(torch.cuda.max_memory_allocated() if cuda
                            else None),
                log_bytes=log_bytes[0] if log is not None else None,
                ckpt_seconds=(ckpt.save_seconds if ckpt is not None
                              else None))
            with open(_out(workdir, c, rank, "json"), "w") as fh:
                json.dump(report, fh)
        with open(os.path.join(workdir, f"startup-{rank}.json"), "w") as fh:
            json.dump(dict(import_s=import_s, rendezvous_s=rendezvous_s,
                           load_s=load_s,
                           spawn_to_first_s=(first - spawned
                                             if first is not None else None)),
                      fh)
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.mesh")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rk = sub.add_parser("rank", help="run one rank of a mesh")
    rk.add_argument("workdir")
    rk.add_argument("rank", type=int)
    rk.add_argument("--spawned", type=float, required=True,
                    help="the launcher's wall clock at the spawn")
    args = ap.parse_args(argv)
    return rank_main(args.workdir, args.rank, args.spawned)


if __name__ == "__main__":
    sys.exit(main())
