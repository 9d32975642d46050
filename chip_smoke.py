#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # RMAT scale 24, 8 shards
    python3 chip_smoke.py --scale 12      # a quick run

Phases, each of which ends the run non-zero on a failure:

1. the card's name and power limit, then the kernels' build from the sources
   in this checkout (``nvcc`` for the CUDA kernels; Triton compiles at its
   first launch, timed here too);
2. each kernel against its plain PyTorch version on the card, at the shapes
   of one ring round of the graph below (edge_combine: float sum within
   rtol 1e-5 / atol 1e-6, everything else exact; digest: exact; run_sum,
   the torch backend's ordered float sum: equal to its plain version on
   the CPU bit for bit, and within rtol 1e-5 of it on the card, where it
   is ``index_add_``'s atomics), with times and the least time the card
   could take for the same work;
3. a small graph run through the port on the card, against a numpy PageRank
   oracle, a numpy BFS, numpy oracles of the two combiner-less programs
   (``basic`` mode) and the port's plain backend on the CPU;
4. the main path: RMAT (edge factor 16, uniform weights) in 8 shards,
   PageRank (10 supersteps), Hash-Min, SSSP and BFS to quiescence, with the
   ``kernel`` backend and then the ``torch`` backend; the two must agree
   (PageRank within 1e-5 of its largest value and within rtol 1e-4 at
   every vertex, the rest exactly, superstep by superstep); both kernels
   launch in the first, run_sum in the second;
5. the other in-memory modes (``basic``, ``basic_sc``, ``recoded_compact``)
   on the same partition: PageRank (5 supersteps) and Hash-Min against the
   ``recoded`` torch run, and DistinctInLabels / SecondMinLabel under
   ``basic`` against numpy on a sample of destinations, each with its ms
   per superstep, edges/s and peak device memory; ``recoded`` and
   ``recoded_compact`` PageRank run twice, bit-identical; a dense ring
   round's ``_combine_scatter`` on the card against the same call on the
   CPU, bit for bit;
6. recovery on the same partition: PageRank and Hash-Min with a
   checkpointer and a message log, one shard recovered from the log against
   the live run, and a run resumed from the checkpoint against the
   uninterrupted one;
7. repartitioning 8 -> 6 -> 8 shards and topology mutation on a smaller RMAT
   graph (scale 19, as the host work of rebuilding a partition grows with
   |E|), against the run that was not rescaled;
8. the skip() prefix: the flat scan against the row-wise one it replaced;
9. two supersteps of the main path under ``torch.profiler``: PageRank's
   third (dense) and Hash-Min's fifth (a small frontier), each with its
   ten costliest device ops, the prefix's scan, and the card's idle share;
10. the out-of-core ``streamed`` mode at the main partition's full width:
    its edge groups spilled from the card to a store on disk (in a
    ``.chip_smoke-streamed-*`` directory of the checkout, removed at the
    end), then PageRank (1 superstep at the default chunks, 3 at
    256-block chunks) and Hash-Min (1 superstep at the default chunks, to
    quiescence at 256-block chunks), unpipelined and through
    the full-duplex channel at both chunk sizes, and a semi-external
    Hash-Min, each against a ``recoded`` run (Hash-Min exactly, PageRank
    within 1e-5 of its largest value), with its ms and edges/s, blocks and bytes read a superstep, the
    reader's wait, its peak device memory over what was allocated before
    (under 1.5 GiB and a third of ``recoded``'s peak) and the planner's
    memory model; no edge tensor of the streamed partition is on the card;
11. the streamed paths whose host work grows fastest, on RMAT scale 19:
    Hash-Min over a compressed store and through the compressed channel,
    DistinctInLabels and SecondMinLabel through the message spill and
    external merge (against numpy), a ``GraphDJob`` whose memory budget
    forces ``streamed`` (against the in-memory run), and a checkpoint and
    run-file-log drill (one shard recovered; a checkpoint refused against
    another store);
12. ``GraphDJob(launch="processes")`` on the main graph: one worker process
    a shard, each on the card, over the shared-filesystem transport,
    Hash-Min to quiescence and PageRank (3 supersteps) at 256-block chunks,
    each against the threads launch of the same job (Hash-Min exactly,
    PageRank within 1e-6 of its largest value; superstep stats, bitmaps
    and halt step exactly), with ms a superstep for both, each worker's
    start to its first heartbeat and first arrival, peak host RSS and
    device memory (polled from ``/proc`` and ``nvidia-smi`` while the job
    runs) beside the planned per-process bytes; then the kill -9 drill at
    scale 19 (Hash-Min with checkpoints and message logs, shard 3 killed in
    superstep 2, respawned alone, equal to an undisturbed processes run);
13. the same two scale-24 jobs over the socket transport
    (``launch_opts={"transport": "sockets"}``: 8 worker processes and a
    coordinator process, messages over loopback TCP), each against phase
    12's file-transport run of the same plan (Hash-Min, its bitmaps,
    superstep stats and halt step exactly, PageRank within 1e-6 of its
    largest value), with ms a superstep beside the files run's, each
    worker's start to its first arrival, the bytes on the wire a superstep
    and the coordinator process's resident set; then, at scale 19, an
    undisturbed sockets run and the two socket drills, each against phase
    12's undisturbed run: a worker killed with a frame half on the wire
    (``kill_net``, one respawn of shard 1) and the coordinator killed in a
    barrier (``coord_kill``, one coordinator respawn, no worker respawn);
14. ``GraphDEngine(mesh=)`` through ``launch.mesh.run_mesh_cases``, one
    process a shard over ``torch.distributed``: gloo with 8 ranks on the
    first card and the main partition (PageRank 3 supersteps and Hash-Min
    on the kernel backend, PageRank on ``basic`` and ``recoded_compact``),
    then NCCL with one rank a GPU where the machine has two or more (up to
    8; the main graph partitioned for that many), the same and SSSP, BFS
    and ``basic_sc``, or with one GPU NCCL with one rank at scale 20; each
    against the emulated run of the same partition (the torch backend and
    the integer programs bit for bit, the kernel backend's PageRank within
    1e-5 of its largest value; bitmaps, message counts and halt step
    exactly), each rank's bytes against the byte model from the
    partition's shape (NCCL stages none through the host) and its launches
    (n edge_combine and n-1 digest a superstep on the kernel backend,
    run_sum on the torch backend's float sums), with ms a superstep past
    the first against the emulated run's, start-up, the first GPU's memory
    and a rank's peak allocation; then, on the small graph (scale 19), gloo
    with 8 ranks (and NCCL with one rank a GPU where there are two or
    more): logged PageRank (6 supersteps) with a message log and a
    checkpoint every 4, the same resumed from its checkpoint, Hash-Min
    over the ring and logged, DistinctInLabels and SecondMinLabel under
    ``basic``, each bit-identical to the emulated run, the files the ranks
    wrote equal to the emulated run's, and shard 3 recovered in this
    process from the mesh's files, held to phase 6's bars.

It prints the launch counts of the main path's runs, and the per-kernel JSON
line and the device line last. It needs a CUDA device and the CUDA toolkit.
Its own process runs on the first GPU the machine gives it (the first of
``CUDA_VISIBLE_DEVICES``, else GPU 0); phase 14 spans them all.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM, NVIDIA's data sheet: HBM rate, and float32 outside the tensor
# cores (the sheet gives no int32 vector rate; float32's stands in for it)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SUM_RTOL, SUM_ATOL = 1e-5, 1e-6
PAGERANK_TOL = 1e-5  # absolute, on the small graph and on the main path
PAGERANK_REL_TOL = 1e-5  # main path: max |kernel - torch| over max |torch|
PAGERANK_RTOL = 1e-4  # main path: at every vertex
COMPACT_RTOL = 2e-2  # recoded_compact: one bf16 rounding a message
SHARDS = 8
# the small graph of phases 7, 11 and the drills of 12-13 (20 before
# phase 14 needed the room), and of the mesh's one-GPU run
ELASTIC_SCALE = 19
MESH_ONE_GPU_SCALE = 20


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def host_launch_ms(fn, k: int = 20) -> float:
    """Host wall clock of ``k`` back-to-back calls of ``fn()`` with no sync,
    over k: what a launch costs the host (hidden on the main path only
    while the card is busy)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(k):
        fn()
    dt = (time.perf_counter() - t0) / k
    torch.cuda.synchronize()
    return dt * 1e3


def time_ms(fn, reps: int = 7, budget_ms: float = 20.0) -> float:
    """Device time of one ``fn()``: the median over ``reps`` of the CUDA-event
    time of k back-to-back calls, over k. A sleep kernel ahead of the start
    event holds the card while the host enqueues the k calls, so the events
    bracket device work alone, not the host's launch time. k fills about
    ``budget_ms`` of device time (at most 50)."""
    import torch

    fn()  # warm-up
    launch = host_launch_ms(fn, 3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    k = max(1, min(50, int(budget_ms / max(start.elapsed_time(end), 1e-3))))
    # ~2 GHz clock: hold the card for twice the host's enqueue time
    cycles = int(2 * k * launch * 1e-3 * 2e9) + 100_000
    times = []
    for _ in range(reps):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(k):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / k)
    times.sort()
    return times[len(times) // 2]


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least ms the card could take: the larger of bytes over the HBM
    rate and operations over the float32 rate, and which one it is."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def max_abs_err(a, b) -> float:
    """Largest |a - b| over positions where both are finite (non-finite
    positions are held to equality by the caller's exact check)."""
    import torch

    a, b = a.double(), b.double()
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a - b).abs()[fin].max()) if bool(fin.any()) else 0.0


# --------------------------------------------------------------------------
# phase 1: device and build
# --------------------------------------------------------------------------

def phase_device_and_build() -> dict:
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.digest import digest

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = build.build_all()
    nvcc_s = time.perf_counter() - t0
    for name, log in logs.items():
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill", log))
        print(f"nvcc {name}: {len(regs)} kernels, registers "
              f"{min(regs, default=0)}-{max(regs, default=0)}, spill bytes "
              f"{spills} (ptxas -v)")
    t0 = time.perf_counter()
    x = torch.zeros(1024, dtype=torch.float32, device="cuda")
    c = torch.zeros(1024, dtype=torch.int32, device="cuda")
    for comb in ("sum", "min", "max"):
        digest(x, c, x, c, combiner=comb)
        digest(c, c, c, c, combiner=comb)
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    print(f"build: nvcc {nvcc_s:.3f} s for {sorted(logs)}; "
          f"triton first launches {triton_s:.3f} s")
    return dict(power=smi[0], nvcc_s=nvcc_s, triton_s=triton_s)


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions at the main path's shapes
# --------------------------------------------------------------------------

EC_CASES = [("div_deg", "sum", "f32"), ("add_w", "min", "f32"),
            ("add_1", "min", "f32"), ("deg", "sum", "f32"),
            ("copy", "min", "i32"), ("copy", "max", "i32")]
DENSITIES = (0.0, 0.02, 1.0)
# per source vertex, the state a message kind reads: values 4 B, degree 4 B,
# active flag 1 B
STATE_BYTES = {"div_deg": 9, "add_w": 5, "add_1": 5, "copy": 5, "deg": 5}


def kept_sources(sp, active, dest, ids, n_keep) -> tuple[int, int]:
    """Distinct sources that the kept slots of one ring round name, and how
    many of them are active, summed over the shards."""
    import torch

    n, P = active.shape
    ar = torch.arange(n, device=sp.device)[:, None]
    live = (torch.arange(ids.shape[1], device=sp.device)[None]
            < n_keep[:, None])[..., None]
    s = sp[ar, dest.long()[:, None], ids.long()]  # (n, NB, BLK)
    s = torch.where(live & (s >= 0), s, P).reshape(n, -1).long()
    named = torch.zeros((n, P + 1), dtype=torch.bool, device=sp.device)
    named.scatter_(1, s, True)
    named = named[:, :P]
    return int(named.sum()), int((named & active).sum())


def edge_combine_work(kind: str, n: int, P: int, kept_slots: int,
                      kept_blocks: int, msgs: int, sources: int,
                      active_sources: int) -> tuple[float, float]:
    """(bytes, operations) that one launch must move and do: sp of every
    kept slot; dp (and w for add_w) of each edge whose source is active,
    i.e. of each message; the active flag of each source a kept slot names
    and the rest of the kind's state of each active one, once; A_s and cnt
    written once; the kept block ids, dest and n_keep. Each message takes a
    message op, a combine and a count."""
    nbytes = (4 * kept_slots + (8 if kind == "add_w" else 4) * msgs
              + sources + (STATE_BYTES[kind] - 1) * active_sources
              + 8 * n * P + 4 * kept_blocks + 8 * n)
    return nbytes, 3 * msgs


def phase_kernels(pg, seed: int) -> dict:
    """edge_combine and digest on the card against their plain versions,
    for one ring round (round 0: dest = (i + n-1) mod n) of ``pg``."""
    import torch
    from repro_torch.core.engine import _active_prefix
    from repro_torch.kernels import ops
    from repro_torch.kernels.digest import digest, digest_plain
    from repro_torch.kernels.edge_combine import (
        edge_combine, edge_combine_plain,
    )

    n, P, NB, B = pg.n_shards, pg.P, pg.n_blocks, pg.edge_block
    dev = pg.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    ar = torch.arange(n, device=dev)
    dest = ((ar + n - 1) % n).to(torch.int32)
    blocks = lambda a: a.view(n, n, NB, B)
    sp, dp, w = blocks(pg.src_pos), blocks(pg.dst_pos), blocks(pg.eweight)
    f32 = torch.rand((n, P), generator=gen, device=dev)
    i32 = torch.randint(0, 2**31 - 1, (n, P), generator=gen, device=dev,
                        dtype=torch.int32)
    rows, worst = [], 0.0
    for kind, comb, vt in EC_CASES:
        values = f32 if vt == "f32" else i32
        for dens in DENSITIES:
            active = (torch.rand((n, P), generator=gen, device=dev) < dens) \
                & pg.vmask
            keep = ops.skip_keep_mask(pg.blk_lo[ar, dest.long()],
                                      pg.blk_hi[ar, dest.long()],
                                      _active_prefix(active))
            ids, n_keep = ops.compact_blocks(keep)
            args = (values, pg.degree, active, sp, dp, w, dest, ids, n_keep)
            kw = dict(msg_kind=kind, combiner=comb)
            A_k, c_k = edge_combine(*args, **kw)
            A_p, c_p = edge_combine_plain(*args, **kw)
            torch.cuda.synchronize()
            check(torch.equal(c_k, c_p), f"edge_combine {kind}/{comb} d={dens}:"
                  " counts differ from the plain version")
            if comb == "sum":
                check(torch.allclose(A_k, A_p, rtol=SUM_RTOL, atol=SUM_ATOL),
                      f"edge_combine {kind}/{comb} d={dens}: A_s differs "
                      f"from the plain version beyond rtol {SUM_RTOL}")
            else:
                check(torch.equal(A_k, A_p), f"edge_combine {kind}/{comb} "
                      f"d={dens}: A_s differs from the plain version")
            err = max_abs_err(A_k, A_p)
            worst = max(worst, err)
            kept_blocks = int(n_keep.sum())
            msgs = int(c_k.sum())
            srcs, act_srcs = kept_sources(sp, active, dest, ids, n_keep)
            bound_ms, bound_by = bound(*edge_combine_work(
                kind, n, P, kept_blocks * B, kept_blocks, msgs, srcs,
                act_srcs))
            row = dict(kind=kind, combiner=comb, dtype=vt, density=dens,
                       kept_slots=kept_blocks * B, messages=msgs,
                       sources=srcs, active_sources=act_srcs,
                       max_abs_err=err,
                       ms=time_ms(lambda: edge_combine(*args, **kw)),
                       launch_ms=host_launch_ms(
                           lambda: edge_combine(*args, **kw)),
                       plain_ms=time_ms(lambda: edge_combine_plain(*args, **kw)),
                       bound_ms=bound_ms, bound_by=bound_by)
            rows.append(row)
            print("edge_combine " + json.dumps(row))
    main = next(r for r in rows if (r["kind"], r["combiner"], r["density"])
                == ("div_deg", "sum", 1.0))
    ec = dict(name="edge_combine", route="cuda",
              source="src/repro_torch/kernels/csrc/edge_combine.cu",
              replaces="src/repro/kernels/edge_combine.py:204",
              max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
              bound_ms=main["bound_ms"], bound_by=main["bound_by"],
              library_ms=None)

    dg_rows, dg_worst = [], 0.0
    for comb, vt in (("sum", "f32"), ("min", "f32"), ("max", "f32"),
                     ("min", "i32")):
        if vt == "f32":
            A = torch.randn((n, P), generator=gen, device=dev)
            R = torch.randn((n, P), generator=gen, device=dev)
        else:
            A = torch.randint(0, 2**31 - 1, (n, P), generator=gen, device=dev,
                              dtype=torch.int32)
            R = torch.randint(0, 2**31 - 1, (n, P), generator=gen, device=dev,
                              dtype=torch.int32)
        C = torch.randint(0, 64, (n, P), generator=gen, device=dev,
                          dtype=torch.int32)
        RC = torch.randint(0, 64, (n, P), generator=gen, device=dev,
                           dtype=torch.int32)
        o_k, oc_k = digest(A, C, R, RC, combiner=comb)
        o_p, oc_p = digest_plain(A, C, R, RC, combiner=comb)
        torch.cuda.synchronize()
        check(torch.equal(o_k, o_p) and torch.equal(oc_k, oc_p),
              f"digest {comb}/{vt} differs from the plain version")
        dg_worst = max(dg_worst, max_abs_err(o_k, o_p))
        out, ocnt = torch.empty_like(A), torch.empty_like(C)
        op = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}[comb]

        def library():
            op(A, R, out=out)
            torch.add(C, RC, out=ocnt)

        # four 4 B inputs read and two 4 B outputs written per slot; a
        # combine and an add
        bound_ms, bound_by = bound(24 * n * P, 2 * n * P)
        row = dict(combiner=comb, dtype=vt, n_P=n * P,
                   ms=time_ms(lambda: digest(A, C, R, RC, combiner=comb)),
                   launch_ms=host_launch_ms(
                       lambda: digest(A, C, R, RC, combiner=comb)),
                   plain_ms=time_ms(lambda: digest_plain(A, C, R, RC,
                                                         combiner=comb)),
                   library_ms=time_ms(library),
                   library_launch_ms=host_launch_ms(library),
                   bound_ms=bound_ms, bound_by=bound_by)
        dg_rows.append(row)
        print("digest " + json.dumps(row))
    d0 = dg_rows[0]
    dg = dict(name="digest", route="triton",
              source="src/repro_torch/kernels/digest.py",
              replaces="src/repro/kernels/digest.py:41",
              max_abs_err=dg_worst, ms=d0["ms"], plain_ms=d0["plain_ms"],
              bound_ms=d0["bound_ms"], bound_by=d0["bound_by"],
              library_ms=d0["library_ms"])
    return dict(edge_combine=ec, digest=dg, run_sum=phase_run_sum(pg, seed))


def dense_round(pg, seed: int, round_: int = 0):
    """PageRank's messages of one dense ring round of ``pg`` (round r:
    dest = (i + n-1-r) mod n), with random values and every vertex active,
    as the engine hands them to ``_combine_scatter``: (msg, dp with the
    padding marked -1, aact, the partition's precomputed order), each (n,
    E_cap)."""
    import torch
    from repro_torch.core import PageRank
    from repro_torch.core.engine import _gen_messages

    n, dev = pg.n_shards, pg.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    ar = torch.arange(n, device=dev)
    dest = (ar + n - 1 - round_) % n
    values = torch.rand((n, pg.P), generator=gen, device=dev)
    sp = pg.src_pos[ar, dest]
    msg, aact = _gen_messages(PageRank(1), values, pg.degree, sp,
                              pg.eweight[ar, dest], pg.vmask, 0)
    dp = torch.where(sp >= 0, pg.dst_pos[ar, dest], -1)
    return msg, dp, aact, pg.dst_order[ar, dest]


def phase_run_sum(pg, seed: int) -> dict:
    """run_sum, the torch backend's ordered float sum, on one dense ring
    round of PageRank on ``pg`` (every slot of every group, in the
    partition's destination order): on the card against its plain version
    on the CPU, bit for bit, and against its plain version on the card
    (``index_add_``'s atomics: rtol 1e-5 / atol 1e-6), with times, the
    longest run (a hub's chain of dependent adds) and the bound."""
    import torch
    from repro_torch.kernels.run_sum import run_sum, run_sum_plain

    msg, dp, _, order = dense_round(pg, seed)
    n, P = pg.n_shards, pg.P
    key = torch.where(dp >= 0, dp.long() + torch.arange(
        n, device=pg.device)[:, None] * P, -1)
    n_out = n * P
    got = run_sum(key, msg, n_out, order)
    card_plain = run_sum_plain(key, msg, n_out, order)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cpu = run_sum_plain(key.cpu(), msg.cpu(), n_out, order.cpu())
    cpu_s = time.perf_counter() - t0
    check(torch.equal(got.cpu().view(torch.int32), cpu.view(torch.int32)),
          "run_sum: the card's sums differ from the CPU's in their bits")
    check(torch.allclose(got, card_plain, rtol=SUM_RTOL, atol=SUM_ATOL),
          f"run_sum: differs from its plain version on the card beyond rtol "
          f"{SUM_RTOL}")
    err = max_abs_err(got, card_plain)
    flat = key.reshape(-1)
    M = flat.numel()
    live = flat >= 0
    longest = int(torch.bincount(flat[live], minlength=n_out).max())
    lib_key, lib_msg = flat[live], msg.reshape(-1)[live]
    out = torch.zeros(n_out, device=pg.device)

    def library():  # the same sums, unordered
        out.zero_()
        out.index_add_(0, lib_key, lib_msg)

    # a key (8 B), a value (4 B) and the order (4 B) read a position, the
    # sums (4 B) written a slot; an add a position
    bound_ms, bound_by = bound(16 * M + 4 * n_out, M)
    row = dict(positions=M, slots=n_out, longest_run=longest,
               max_abs_err=err,
               ms=time_ms(lambda: run_sum(key, msg, n_out, order)),
               launch_ms=host_launch_ms(lambda: run_sum(key, msg, n_out,
                                                        order)),
               plain_ms=time_ms(lambda: run_sum_plain(key, msg, n_out,
                                                      order)),
               library_ms=time_ms(library), bound_ms=bound_ms,
               bound_by=bound_by, cpu_plain_s=cpu_s)
    print("run_sum " + json.dumps(row))
    print(f"run_sum: equal to the CPU's plain version bit for bit over "
          f"{M} positions ({int(live.sum())} messages, the padding skipped;"
          f" the longest run {longest}); within rtol "
          f"{SUM_RTOL} of index_add_ on the card")
    return dict(name="run_sum", route="cuda",
                source="src/repro_torch/kernels/csrc/run_sum.cu",
                replaces="none: src/repro/core/engine.py:130 "
                         "(_combine_scatter, a jnp scatter-add)",
                max_abs_err=err, ms=row["ms"], plain_ms=row["plain_ms"],
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=row["library_ms"])


# --------------------------------------------------------------------------
# phase 3: a small graph against references
# --------------------------------------------------------------------------

def _pagerank_numpy(n_vertices, src, dst, iters, damping=0.85):
    deg = np.bincount(src, minlength=n_vertices).astype(np.float64)
    a = np.full(n_vertices, 1.0 / n_vertices)
    for _ in range(iters):
        share = damping * a[src] / deg[src]
        a = np.full(n_vertices, 0.15 / n_vertices)
        np.add.at(a, dst, share)
    return a


def _bfs_numpy(n_vertices, src, dst, source):
    level = np.full(n_vertices, np.inf)
    level[source] = 0
    frontier = np.array([source])
    d = 0
    while frontier.size:
        d += 1
        hit = np.isin(src, frontier)
        nxt = np.unique(dst[hit])
        nxt = nxt[np.isinf(level[nxt])]
        level[nxt] = d
        frontier = nxt
    return level


def edges_into(pg, dst_gids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(src gid, dst gid) of every edge of ``pg`` whose destination is in
    ``dst_gids``, read from the partition on its device."""
    import torch

    n = pg.n_shards
    srcs, dsts = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    for k in range(n):
        mine = dst_gids[dst_gids % n == k] // n
        if mine.size == 0:
            continue
        sp, dp = pg.src_pos[:, k], pg.dst_pos[:, k]
        pos = torch.from_numpy(mine.astype(np.int32)).to(pg.device)
        i, e = (torch.isin(dp, pos) & (sp >= 0)).nonzero(as_tuple=True)
        srcs.append(pg.gids[i, sp[i, e].long()].cpu().numpy())
        dsts.append(dp[i, e].long().cpu().numpy() * n + k)
    return np.concatenate(srcs), np.concatenate(dsts)


def _runs(dst_gids, keys):
    """Sorted distinct ``keys`` (dst << 32 | payload) and, per vertex of
    ``dst_gids``, where its run of keys starts and ends."""
    from repro_torch.graph.csr import sorted_unique

    keys = sorted_unique(keys)
    d = keys >> 32
    return (keys & 0xFFFFFFFF, np.searchsorted(d, dst_gids, "left"),
            np.searchsorted(d, dst_gids, "right"))


def _distinct_numpy(dst_gids, src_labels, dst):
    """Per vertex of ``dst_gids``: how many distinct labels (>= 0) its
    in-edges carry (``src_labels[j]`` on edge j into ``dst[j]``)."""
    _, lo, hi = _runs(dst_gids, (dst << 32) | src_labels.astype(np.int64))
    return hi - lo


def _second_min_numpy(dst_gids, src, dst, sentinel):
    """Per vertex of ``dst_gids``: its second-smallest distinct in-neighbour
    gid, ``sentinel`` where it has fewer than two."""
    payload, lo, hi = _runs(dst_gids, (dst << 32) | src)
    second = payload[np.minimum(lo + 1, payload.size - 1)] if payload.size \
        else np.zeros_like(lo)
    return np.where(hi - lo >= 2, second, sentinel)


def check_combinerless(pg, dst_gids: np.ndarray, where: str) -> list:
    """DistinctInLabels(rounds=2) and SecondMinLabel under ``basic`` on the
    card, held to numpy at the vertices ``dst_gids``: both supersteps of
    DistinctInLabels (its first from the recoded ids modulo 8, its second
    from the first's counts at the in-neighbours), and SecondMinLabel. Each
    superstep must count one message an edge. Returns the runs' timings."""
    import torch
    from repro_torch.core import (
        DistinctInLabels, EngineConfig, GraphDEngine, SecondMinLabel,
    )

    n = pg.n_shards
    src, dst = edges_into(pg, dst_gids)
    at = lambda v, g: v[torch.from_numpy(g % n).to(v.device),
                        torch.from_numpy(g // n).to(v.device)].cpu().numpy()
    rows, first = [], []

    def keep_first(rec, state):  # superstep 0's labels, for the check
        if rec.step == 0:
            first.append(state[0].clone())

    for name, prog in (("distinct", DistinctInLabels(n_groups=8, rounds=2)),
                       ("secondmin", SecondMinLabel())):
        eng = GraphDEngine(pg, prog, EngineConfig(mode="basic"))
        (v, _), hist, row = timed_run(eng, f"basic {name}",
                                      on_step=keep_first)
        rows.append(row)
        check([h.n_msgs for h in hist] == [pg.n_edges] * len(hist),
              f"{where} {name}: messages per superstep differ from |E|")
        if name == "distinct":
            c1 = _distinct_numpy(dst_gids, src % 8, dst)
            check(np.array_equal(at(first[0], dst_gids), c1),
                  f"{where} distinct: superstep 0 differs from numpy")
            c2 = _distinct_numpy(dst_gids, at(first[0], src), dst)
            check(np.array_equal(at(v, dst_gids), c2),
                  f"{where} distinct: superstep 1 differs from numpy")
        else:
            want = _second_min_numpy(dst_gids, src, dst, prog.SENTINEL)
            check(np.array_equal(at(v, dst_gids), want),
                  f"{where} secondmin: differs from numpy")
    print(f"{where}: DistinctInLabels (2 supersteps) and SecondMinLabel "
          f"(basic) equal numpy at {dst_gids.size} vertices "
          f"({src.size} in-edges)")
    return rows


def timed_run(eng, label: str, **kw):
    """``eng.run(**kw)`` with the card synced around it and its peak device
    memory reset before: ((values, active), history, row), printed."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, hist = eng.run(**kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    steps = len(hist)
    row = dict(run=label, supersteps=steps, seconds=secs,
               ms_per_superstep=secs * 1e3 / steps,
               edges_per_s=eng.pg.n_edges * steps / secs,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"run {label}: {steps} supersteps, {row['ms_per_superstep']:.3f} "
          f"ms per superstep, edges/s {row['edges_per_s']:.4g}, peak device "
          f"memory {row['peak_gib']:.3f} GiB")
    return out, hist, row


def programs(src: int):
    """(name, program factory) of the four algorithms on the main path."""
    from repro_torch.core import BFS, SSSP, HashMin, PageRank

    return (("pagerank", lambda: PageRank(10)), ("hashmin", HashMin),
            ("sssp", lambda: SSSP(src)), ("bfs", lambda: BFS(src)))


def phase_small(seed: int) -> None:
    """A scale-12 graph through the port on the card: PageRank against a
    numpy oracle, BFS against a numpy BFS, Hash-Min and SSSP against the
    port's plain backend on the CPU."""
    import torch
    from repro_torch.core import EngineConfig, GraphDEngine
    from repro_torch.graph import partition_graph, rmat_graph

    g = rmat_graph(scale=12, edge_factor=16, seed=seed, weights="uniform")
    pg, rmap = partition_graph(g, SHARDS)
    src = int(rmap.to_new(np.array([0]))[0])
    old = {}
    for name, prog in programs(src):
        eng = GraphDEngine(pg, prog(), EngineConfig(backend="kernel"))
        (v, a), hist = eng.run()
        check(v.shape == (pg.n_shards, pg.P), f"small {name}: shape {v.shape}")
        old[name] = eng.gather_values(v)
        if name in ("hashmin", "sssp"):
            ref = GraphDEngine(pg.to("cpu"), prog(),
                               EngineConfig(backend="torch"), device="cpu")
            (vr, ar_), hr = ref.run()
            check(torch.equal(v.cpu(), vr) and torch.equal(a.cpu(), ar_),
                  f"small {name}: differs from the plain backend on the CPU")
            check([(h.n_active, h.n_msgs) for h in hist]
                  == [(h.n_active, h.n_msgs) for h in hr],
                  f"small {name}: superstep stats differ from the CPU run")
    ids = g.vertex_ids
    pr = _pagerank_numpy(g.n_vertices, g.src, g.dst, 10)
    got = np.array([old["pagerank"][int(o)] for o in ids])
    check(np.isfinite(got).all(), "small pagerank: non-finite values")
    err = float(np.abs(got - pr).max())
    check(err < PAGERANK_TOL, f"small pagerank: {err} from the numpy oracle")
    bfs = _bfs_numpy(g.n_vertices, g.src, g.dst, 0)
    got = np.array([old["bfs"][int(o)] for o in ids])
    check(np.array_equal(got, bfs), "small bfs: levels differ from numpy BFS")
    check_combinerless(pg, pg.gids[pg.vmask].cpu().numpy(), "small")
    print(f"small graph: {pg.shape_summary}; pagerank max err {err:.3g} vs "
          f"numpy; bfs exact vs numpy; hashmin, sssp exact vs CPU plain")


# --------------------------------------------------------------------------
# phase 4: the main path at full size
# --------------------------------------------------------------------------

def run_algorithms(pg, src: int, backend: str) -> dict:
    import torch
    from repro_torch.core import EngineConfig, GraphDEngine

    out = {}
    for name, prog in programs(src):
        eng = GraphDEngine(pg, prog(), EngineConfig(backend=backend))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (v, a), hist = eng.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[name] = dict(values=v, active=a, hist=hist, seconds=secs)
        steps = len(hist)
        print(f"{backend:6s} {name:8s} supersteps {steps:3d} total "
              f"{secs * 1e3:.1f} ms, per superstep "
              f"{secs * 1e3 / steps:.2f} ms, edges/s "
              f"{pg.n_edges * steps / secs:.4g}; per-superstep ms "
              f"{[round(h.seconds * 1e3, 2) for h in hist]}")
    return out


def phase_main(pg, src: int) -> dict:
    import torch
    from repro_torch.kernels.digest import digest
    from repro_torch.kernels.edge_combine import edge_combine
    from repro_torch.kernels.run_sum import run_sum

    torch.cuda.reset_peak_memory_stats()
    edge_combine.launches = 0
    digest.launches = 0
    kern = run_algorithms(pg, src, "kernel")
    launches = dict(edge_combine=edge_combine.launches,
                    digest=digest.launches)
    peak = torch.cuda.max_memory_allocated()
    steps = sum(len(r["hist"]) for r in kern.values())
    print(f"main path launches (kernel backend, {steps} supersteps): "
          f"{launches}; peak device memory {peak / 2**30:.3f} GiB")
    run_sum.launches = 0
    plain = run_algorithms(pg, src, "torch")
    launches["run_sum"] = run_sum.launches
    print(f"main path launches (torch backend): run_sum "
          f"{run_sum.launches} (PageRank's ordered float sums)")
    for name in kern:
        k, p = kern[name], plain[name]
        if name == "pagerank":
            kv, pv = k["values"], p["values"]
            check(bool(torch.isfinite(kv).all()),
                  "main pagerank: non-finite values")
            # PageRank values are about 1/|V|, so an absolute bar alone
            # would hold nothing: hold the gap to the values' scale too
            gap = (kv - pv).abs()
            err, scale = float(gap.max()), float(pv.abs().max())
            rel = err / scale
            at_vertex = float((gap / pv.abs().clamp(min=1e-30)).max())
            print(f"main pagerank: kernel vs torch max |gap| {err:.6g}, "
                  f"over max |value| {scale:.6g}: {rel:.6g}; largest "
                  f"relative gap at a vertex {at_vertex:.6g}")
            check(err < PAGERANK_TOL, f"main pagerank: kernel vs torch {err}")
            check(rel < PAGERANK_REL_TOL,
                  f"main pagerank: kernel vs torch {rel} of the largest value")
            check(torch.allclose(kv, pv, rtol=PAGERANK_RTOL,
                                 atol=1e-6 / pg.n_vertices),
                  f"main pagerank: kernel vs torch beyond rtol "
                  f"{PAGERANK_RTOL} at a vertex ({at_vertex})")
        else:
            check(torch.equal(k["values"], p["values"]),
                  f"main {name}: kernel and torch values differ")
        check(torch.equal(k["active"], p["active"]),
              f"main {name}: kernel and torch active bitmaps differ")
        check([(h.n_active, h.n_msgs) for h in k["hist"]]
              == [(h.n_active, h.n_msgs) for h in p["hist"]],
              f"main {name}: kernel and torch superstep stats differ")
    for name, count in launches.items():
        check(count > 0, f"main path launched no {name}")
    print("main path: kernel backend == torch backend (pagerank within "
          f"{PAGERANK_REL_TOL} of its scale and rtol {PAGERANK_RTOL}, the "
          "rest exact)")
    return launches


# --------------------------------------------------------------------------
# phase 5: the other in-memory modes on the main partition
# --------------------------------------------------------------------------

def check_pagerank(v, ref, what: str, rtol: float | None = None) -> float:
    """PageRank ``v`` against ``ref``: within PAGERANK_REL_TOL of the
    largest value, or, with ``rtol``, within it at every vertex. Returns
    the gap over the largest value."""
    import torch

    check(bool(torch.isfinite(v).all()), f"{what}: non-finite values")
    gap = (v - ref).abs()
    rel = float(gap.max()) / float(ref.abs().max())
    if rtol is None:
        check(rel < PAGERANK_REL_TOL, f"{what}: {rel} of the largest value")
    else:
        at_vertex = float((gap / ref.abs().clamp(min=1e-30))[ref > 0].max())
        check(at_vertex < rtol, f"{what}: {at_vertex} relative at a vertex")
    return rel


TORCH_MODES = ("recoded", "basic", "basic_sc", "recoded_compact")
#: ms a torch-backend PageRank superstep in this phase at RMAT scale 24 in 8
#: shards on an NVIDIA H100 80GB HBM3 (700 W) when the float sums were
#: index_add_'s unordered atomics (PERF.md §5), printed beside this run's
UNORDERED_MS = {"recoded": 49.57, "basic": 56.21, "basic_sc": 68.54,
                "recoded_compact": 50.00}


def check_scatter_order(pg, seed: int) -> None:
    """The torch backend's ordered float sums on the card: one dense ring
    round's _combine_scatter against the same call on the CPU, bit for
    bit."""
    import torch
    from repro_torch.core import PageRank
    from repro_torch.core.engine import _combine_scatter

    msg, dp, aact, order = dense_round(pg, seed, round_=3)
    prog = PageRank(1)
    A, cnt = _combine_scatter(prog, pg.P, msg, dp, aact, order)
    torch.cuda.synchronize()
    A_cpu, cnt_cpu = _combine_scatter(prog, pg.P, msg.cpu(), dp.cpu(),
                                      aact.cpu())
    check(torch.equal(A.cpu().view(torch.int32), A_cpu.view(torch.int32))
          and torch.equal(cnt.cpu(), cnt_cpu),
          "order: _combine_scatter on the card differs from the CPU's bits")
    print(f"order: _combine_scatter of a dense ring round ({msg.numel()} "
          f"slots, a hub of {int(cnt.max())} messages) on the card equals "
          "the same call on the CPU bit for bit")


def phase_modes(pg, seed: int) -> dict:
    """basic, basic_sc and recoded_compact (torch backend) against the
    recoded torch run: PageRank (5 supersteps) and Hash-Min to halt, then
    the combiner-less programs under basic on a sample of destinations;
    recoded and recoded_compact PageRank run twice, bit-identical."""
    import torch
    from repro_torch.core import EngineConfig, GraphDEngine, HashMin, PageRank
    from repro_torch.kernels.digest import digest
    from repro_torch.kernels.edge_combine import edge_combine

    edge_combine.launches = digest.launches = 0
    rows, ref, gaps = [], {}, {}
    for mode in TORCH_MODES:
        for name, prog in (("pagerank", lambda: PageRank(5)),
                           ("hashmin", HashMin)):
            if mode == "recoded_compact" and name == "hashmin":
                continue  # int messages: the bf16 wire would round labels
            eng = GraphDEngine(pg, prog(), EngineConfig(mode=mode,
                                                        backend="torch"))
            (v, a), hist, row = timed_run(eng, f"{mode} {name}")
            rows.append(row)
            steps = [(h.n_active, h.n_msgs) for h in hist]
            if name == "pagerank" and mode in ("recoded", "recoded_compact"):
                (v2, a2), hist2 = eng.run()
                check(torch.equal(v2, v) and torch.equal(a2, a)
                      and [h.agg for h in hist2] == [h.agg for h in hist],
                      f"modes {mode} pagerank: two runs differ")
                print(f"modes {mode} pagerank: two runs bit-identical")
                del v2, a2
            if mode == "recoded":
                ref[name] = (v, a, steps)
                continue
            rv, ra, rsteps = ref[name]
            if name == "hashmin":
                check(torch.equal(v, rv) and torch.equal(a, ra),
                      f"modes {mode} hashmin: differs from recoded")
                check(steps == rsteps, f"modes {mode} hashmin: superstep "
                      "stats or halt step differ from recoded")
            elif mode == "recoded_compact":
                gaps[mode] = check_pagerank(v, rv, f"modes {mode} pagerank",
                                            COMPACT_RTOL)
            else:
                gaps[mode] = check_pagerank(v, rv, f"modes {mode} pagerank")
                check(steps == rsteps,
                      f"modes {mode} pagerank: message counts differ")
    gen = np.random.default_rng(seed)
    real = pg.gids[pg.vmask].cpu().numpy()
    rows += check_combinerless(pg, gen.choice(real, 256, replace=False),
                               "modes")
    print(f"modes: kernel launches {edge_combine.launches} edge_combine, "
          f"{digest.launches} digest (the torch backend runs none); "
          "hashmin exact and pagerank within "
          f"{PAGERANK_REL_TOL} of its scale against recoded "
          f"(recoded_compact: rtol {COMPACT_RTOL}); pagerank's largest gap "
          "over its largest value: "
          + ", ".join(f"{m} {g:.4g}" for m, g in gaps.items()))
    check_scatter_order(pg, seed)
    print("modes: the torch backend's ms a PageRank superstep (5 "
          "supersteps), ordered float sums against index_add_'s atomics at "
          "scale 24 before: " + ", ".join(
              f"{r['run'].split()[0]} {r['ms_per_superstep']:.3f} against "
              f"{UNORDERED_MS[r['run'].split()[0]]}"
              for r in rows if r["run"].endswith(" pagerank")))
    return dict(rows=rows, hashmin_steps=len(ref["hashmin"][2]), ref=ref)


# --------------------------------------------------------------------------
# phase 6: checkpoints, the message log and single-shard recovery
# --------------------------------------------------------------------------

def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def phase_recovery(pg, hashmin_steps: int, failed: int = 3) -> dict:
    """PageRank (5 supersteps) and Hash-Min to halt with a checkpointer and
    a message log, in a directory of this checkout that is removed after:
    the logged run against the unlogged one, shard ``failed`` recovered
    from the log against the live run, and a run resumed from the
    checkpoint (kernel backend) against the uninterrupted one."""
    import torch
    from repro_torch.core import (
        Checkpointer, EngineConfig, GraphDEngine, HashMin, MessageLog,
        PageRank, recover_shard,
    )
    from repro_torch.kernels.digest import digest
    from repro_torch.kernels.edge_combine import edge_combine

    # every 3 supersteps, or the next cadence that leaves two to replay
    # (beyond the run's length only the step-0 checkpoint lands)
    hm_every = next(e for e in range(3, hashmin_steps + 2)
                    if hashmin_steps % e >= 2 or e > hashmin_steps)
    out = {}
    root = tempfile.mkdtemp(prefix=".chip_smoke-recovery-", dir=ROOT)
    try:
        for name, prog, every in (("pagerank", lambda: PageRank(5), 3),
                                  ("hashmin", HashMin, hm_every)):
            d = os.path.join(root, name)
            ck = Checkpointer(os.path.join(d, "ckpt"), every=every)
            log = MessageLog(os.path.join(d, "log"))
            plain = GraphDEngine(pg, prog())  # the kernel backend
            (v0, a0), h0, row0 = timed_run(plain, f"unlogged {name}")
            eng = GraphDEngine(pg, prog(), message_log=log)
            ck.save(0, *eng.init())
            (v, a), hist, row = timed_run(eng, f"logged {name}",
                                          state=eng.init(), checkpointer=ck)
            steps = len(hist)
            start = ck.latest()
            check(steps == len(h0), f"recovery {name}: halt step differs")
            if name == "pagerank":
                check_pagerank(v, v0, f"recovery {name}: logged vs unlogged")
            else:
                check(torch.equal(v, v0),
                      f"recovery {name}: logged run differs from unlogged")
            check(steps - start >= 2, f"recovery {name}: only "
                  f"{steps - start} supersteps after the checkpoint")
            log_steps = sorted(os.listdir(log.dir))
            log_bytes = _dir_bytes(os.path.join(log.dir, log_steps[-1]))
            # the logged superstep alone (no file I/O) against the plain one
            vs, as_ = plain.init()
            t_logged = time_ms(lambda: eng.step_logged(vs, as_, 0), reps=3,
                               budget_ms=1.0)
            t_plain = time_ms(lambda: plain.step(vs, as_, 0), reps=3,
                              budget_ms=1.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vj, aj = recover_shard(pg, prog(), failed, ck, log, steps)
            torch.cuda.synchronize()
            rec_s = time.perf_counter() - t0
            gap = 0.0
            if name == "pagerank":
                gap = check_pagerank(vj, v[failed],
                                     f"recovery {name}: recovered shard")
            else:
                check(torch.equal(vj, v[failed]),
                      f"recovery {name}: recovered shard differs")
            check(torch.equal(aj, a[failed]),
                  f"recovery {name}: recovered active bitmap differs")
            edge_combine.launches = digest.launches = 0
            resumed = GraphDEngine(pg, prog())  # the kernel backend
            (v2, a2), h2 = resumed.run(checkpointer=ck)
            launches = (edge_combine.launches, digest.launches)
            check(h2[0].restored_from == start,
                  f"recovery {name}: did not resume from step {start}")
            check(v2.device.type == "cuda", f"recovery {name}: resumed off "
                  "the card")
            if name == "pagerank":
                check_pagerank(v2, v0, f"recovery {name}: resumed run")
            else:
                check(torch.equal(v2, v0) and torch.equal(a2, a0),
                      f"recovery {name}: resumed run differs")
            check(launches[0] > 0 and (pg.n_shards == 1 or launches[1] > 0),
                  f"recovery {name}: the resumed run launched no kernel")
            print(f"recovery {name}: checkpoint every {every}, latest at "
                  f"step {start} of {steps}; logged superstep "
                  f"{row['ms_per_superstep']:.3f} ms with its log write, "
                  f"unlogged {row0['ms_per_superstep']:.3f} ms; superstep 0 "
                  f"alone (device) logged {t_logged:.3f} ms, kernel backend "
                  f"{t_plain:.3f} ms; log {log_bytes} bytes a superstep; "
                  f"shard {failed} recovered over {steps - start} supersteps "
                  f"in {rec_s:.3f} s against the live run's "
                  f"{row['seconds']:.3f} s (gap {gap:.4g} of the largest "
                  "value); resumed run equals the "
                  f"uninterrupted one, launches {launches}")
            out[name] = dict(logged=row, unlogged=row0, recover_s=rec_s,
                             log_bytes=log_bytes)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# --------------------------------------------------------------------------
# phase 7: elastic rescale and mutation on a smaller graph
# --------------------------------------------------------------------------

def phase_elastic(seed: int) -> None:
    """Repartition 8 -> 6 -> 8 shards mid-run, and mutate the topology,
    on an RMAT graph of scale ELASTIC_SCALE; each against the run that was
    not rescaled or mutated (gid-ordered values)."""
    import torch
    from repro_torch.core import (
        GraphDEngine, HashMin, PageRank, extract_global, mutate, repartition,
    )
    from repro_torch.graph import partition_graph, rmat_graph

    t0 = time.perf_counter()
    g = rmat_graph(scale=ELASTIC_SCALE, edge_factor=16, seed=seed,
                   weights="uniform")
    pg, _ = partition_graph(g, SHARDS)
    del g
    by_gid = lambda p, v, a: torch.from_numpy(extract_global(p, v, a)[2])
    for name, prog in (("pagerank", lambda: PageRank(8)),
                       ("hashmin", HashMin)):
        (v_ref, a_ref), hist = GraphDEngine(pg, prog()).run()
        # supersteps 0-1 on 8 shards, 2-3 on 6, the rest on 8 again
        cur, state, done = pg, None, []
        for n_shards, stop in ((SHARDS, 2), (6, 4), (SHARDS, 10_000)):
            if cur.n_shards != n_shards:
                cur, *state = repartition(cur, *state, n_shards)
            if done and done[-1].n_active == 0 and name == "hashmin":
                continue  # halted: only the state moves on
            state, h = GraphDEngine(cur, prog()).run(
                state=state, start_step=len(done), max_supersteps=stop)
            done += h
        check([(h.n_active, h.n_msgs) for h in done]
              == [(h.n_active, h.n_msgs) for h in hist],
              f"elastic {name}: superstep stats or halt step differ")
        got, want = by_gid(cur, *state), by_gid(pg, v_ref, a_ref)
        if name == "pagerank":
            check_pagerank(got, want, f"elastic {name}")
        else:
            check(torch.equal(got, want), f"elastic {name}: values differ")
    # mutation: drop 1000 edges and add 3 vertices; then add the edges back
    # with a path new0 -> new1 -> new2 among the new vertices
    (v0, a0), _ = GraphDEngine(pg, HashMin()).run()
    _, _, _, _, src_g, dst_g, _ = extract_global(pg, v0, a0)
    pick = np.random.default_rng(seed).choice(src_g.size, 1000, replace=False)
    removed = np.stack([src_g[pick], dst_g[pick]], 1)
    pg1, v1, a1, new = mutate(pg, v0, a0, remove_edges=removed,
                              add_vertices=3)
    old = lambda v: v[:, : pg.P][pg.vmask]  # the existing vertices' slots
    check(pg1.n_vertices == pg.n_vertices + 3
          and pg1.n_edges == pg.n_edges - 1000, "mutate: counts")
    check(torch.equal(old(v1), old(v0)), "mutate: existing vertices moved")
    pg2, _, _, _ = mutate(pg1, v1, a1, add_edges=np.concatenate(
        [removed, np.stack([new[:2], new[1:]], 1)]))
    check(pg2.n_edges == pg.n_edges + 2, "mutate: edges not added back")
    (v2, _), _ = GraphDEngine(pg2, HashMin()).run()
    check(torch.equal(old(v2), old(v0)),
          "mutate: Hash-Min after the round trip differs from the original")
    check(int(v2[new[2] % SHARDS, new[2] // SHARDS]) == int(new.min()),
          "mutate: the new path's label is not its least id")
    print(f"elastic: RMAT scale {ELASTIC_SCALE}, PageRank and Hash-Min "
          "rescaled 8 -> 6 -> 8 mid-run equal the run that was not "
          "rescaled; mutate removed 1000 edges and added 3 vertices, the "
          "round trip gives the original components; "
          f"{time.perf_counter() - t0:.1f} s in all (host numpy)")


# --------------------------------------------------------------------------
# phase 8: the skip() prefix
# --------------------------------------------------------------------------

def phase_prefix(pg, seed: int) -> dict:
    """The flat scan of ``_active_prefix`` against the row-wise ``cumsum``
    it replaced, on the same (n, P) bitmap; both must give the same
    keep mask."""
    import torch
    from repro_torch.core.engine import _active_prefix
    from repro_torch.kernels import ops

    gen = torch.Generator(device=pg.device).manual_seed(seed)
    active = (torch.rand(pg.vmask.shape, generator=gen, device=pg.device)
              < 0.5) & pg.vmask
    n, P = active.shape
    zero = torch.zeros((n, 1), dtype=torch.int32, device=pg.device)
    rowwise = lambda: torch.cat([zero, active.cumsum(1, dtype=torch.int32)], 1)
    flat = _active_prefix(active)
    rows = rowwise()
    lo, hi = pg.blk_lo.reshape(n, -1), pg.blk_hi.reshape(n, -1)
    want = (hi >= 0) & ((rows.gather(1, (hi.long() + 1).clamp(0, P))
                         - rows.gather(1, lo.long().clamp(0, P))) > 0)
    check(torch.equal(ops.skip_keep_mask(lo, hi, flat), want),
          "prefix: the flat scan's keep mask differs from the row-wise one")
    t_row = time_ms(rowwise)
    t_flat = time_ms(lambda: _active_prefix(active))
    print(f"prefix: ({n}, {P}) bitmap, row-wise cumsum {t_row:.4f} ms, flat "
          f"scan {t_flat:.4f} ms (device time a call); keep masks equal")
    return dict(rowwise_ms=t_row, flat_ms=t_flat)


def _busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit / 1e3."""
    busy, reach = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    return busy / 1e3


def phase_profile(pg, name: str, program, steps_before: int,
                  top: int = 10) -> dict:
    """Superstep ``steps_before`` of ``program`` on the main path (kernel
    backend) under ``torch.profiler``: the ``top`` device ops by total time,
    each with its count, and the share of the superstep's wall time the
    card was idle."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import EngineConfig, GraphDEngine

    eng = GraphDEngine(pg, program, EngineConfig(backend="kernel"))
    values, active = eng.init()
    for s in range(steps_before):
        values, active, _ = eng.step(values, active, s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, st = eng.step(values, active, steps_before)
        float(st.n_msgs)  # the superstep's one host sync
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(bool(dev), "profile: the trace holds no device events")
    ops = {}
    for e in dev:
        c, t = ops.get(e.name, (0, 0.0))
        ops[e.name] = (c + 1, t + (e.time_range.end - e.time_range.start))
    busy = _busy_ms([(e.time_range.start, e.time_range.end) for e in dev])
    span = (max(e.time_range.end for e in dev)
            - min(e.time_range.start for e in dev)) / 1e3
    total = sum(t for _, t in ops.values()) / 1e3
    print(f"profile: {name} superstep {steps_before} (kernel backend): wall "
          f"{wall_ms:.3f} ms (profiler on), device busy {busy:.3f} ms, first "
          f"to last device op {span:.3f} ms, device idle "
          f"{1 - busy / wall_ms:.4f} of the wall time; {len(dev)} device ops, "
          f"{total:.3f} ms in all")
    rows = sorted(ops.items(), key=lambda kv: -kv[1][1])[:top]
    for op, (count, t) in rows:
        print(f"profile:   {t / 1e3:8.3f} ms  x{count:3d}  {op[:110]}")
    # the skip() prefix: the device scan kernels (CUB's, or PyTorch's own)
    scans = [(c, t) for op, (c, t) in ops.items()
             if "scan" in op.lower() or "cumsum" in op.lower()]
    scan_ms = sum(t for _, t in scans) / 1e3
    print(f"profile:   skip() prefix scans: {scan_ms:.4f} ms in "
          f"{sum(c for c, _ in scans)} device ops")
    return dict(wall_ms=wall_ms, busy_ms=busy, idle=1 - busy / wall_ms,
                scan_ms=scan_ms)


# --------------------------------------------------------------------------
# phases 10-11: the out-of-core streamed mode
# --------------------------------------------------------------------------

EDGE_FIELDS = ("src_pos", "dst_pos", "eweight", "blk_lo", "blk_hi")


def streamed_run(eng, label: str, **kw):
    """``eng.run(**kw)`` of a streamed engine with the card synced around
    it: ms a superstep, edges/s, blocks and bytes read off disk a
    superstep, the reader's wait against the rest of the superstep loop,
    the increment of peak device memory over what was allocated before the
    run, and the planner's ``memory_model()`` of the engine, printed.
    Edges/s is printed twice: nominal (|E| a superstep, whatever skip()
    left out) and staged (the edges in the blocks the reader staged).
    Returns ((values, active), history, row)."""
    import torch

    check(eng.pg.device.type == "cuda", f"{label}: engine off the card")
    check(all(getattr(eng.pg, f).numel() == 0 for f in EDGE_FIELDS),
          f"{label}: an edge tensor of the streamed partition is on the card")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, hist = eng.run(**kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    steps = len(hist)
    io = eng.io_history
    wait = sum(s.wait_seconds for s in io)
    read = sum(s.read_seconds for s in io)
    nbytes = sum(s.bytes_read for s in io)
    model = eng.memory_model()
    row = dict(
        run=label, supersteps=steps, seconds=secs,
        ms_per_superstep=secs * 1e3 / steps,
        edges_per_s=eng.pg.n_edges * steps / secs,
        staged_edges_per_s=sum(s.edges_staged for s in io) / secs,
        blocks_per_superstep=sum(h.blocks_read for h in hist) / steps,
        cache_hits_per_superstep=sum(h.cache_hits for h in hist) / steps,
        bytes_per_superstep=nbytes / steps,
        chunks_per_superstep=sum(s.chunks for s in io) / steps,
        reader_wait_s=wait, reader_read_s=read, loop_s=secs - wait,
        read_gb_per_s=nbytes / read / 1e9 if read else 0.0,
        peak_increment_gib=(torch.cuda.max_memory_allocated() - base) / 2**30,
        model=model,
    )
    print(f"streamed {label}: {steps} supersteps, "
          f"{row['ms_per_superstep']:.3f} ms per superstep, edges/s "
          f"{row['edges_per_s']:.4g} nominal (|E| a superstep), "
          f"{row['staged_edges_per_s']:.4g} staged; a superstep: "
          f"{row['blocks_per_superstep']:.1f} blocks and "
          f"{row['bytes_per_superstep']:.6g} bytes read off disk, "
          f"{row['cache_hits_per_superstep']:.1f} cache hits, "
          f"{row['chunks_per_superstep']:.1f} chunks; reader wait "
          f"{wait:.3f} s against {secs - wait:.3f} s of the rest of the loop "
          f"(producer reads {read:.3f} s, {row['read_gb_per_s']:.3f} GB/s); "
          f"peak device memory +{row['peak_increment_gib']:.4f} GiB over "
          f"the {base / 2**30:.3f} GiB allocated before; memory_model "
          f"{model}, fold stager {eng._stager.nbytes} bytes of host RAM "
          f"outside it")
    return out, hist, row


def capped(program, supersteps: int):
    """``program`` run for ``supersteps`` whatever its halting vote."""
    program.num_supersteps = supersteps
    return program


def check_streamed(name: str, v, a, hist, ref, what: str) -> float:
    """A streamed run against the in-memory ``recoded`` run ``ref`` =
    (values, active, [(n_active, n_msgs)]): Hash-Min exactly, PageRank
    within PAGERANK_REL_TOL of its largest value; bitmaps, message counts
    and halt step exactly. Returns PageRank's gap (0 for Hash-Min)."""
    import torch

    rv, ra, rsteps = ref
    check([(h.n_active, h.n_msgs) for h in hist] == rsteps,
          f"{what}: superstep stats or halt step differ from recoded")
    check(torch.equal(a, ra), f"{what}: active bitmap differs from recoded")
    if name.startswith("pagerank"):
        return check_pagerank(v, rv, f"{what}: pagerank")
    check(torch.equal(v, rv), f"{what}: values differ from recoded")
    return 0.0


def phase_streamed(pg, ref: dict, recoded_peak_gib: float) -> dict:
    """mode='streamed' at the main partition's full width: its edge groups
    spilled to a store in a directory of this checkout (removed after),
    then PageRank and Hash-Min (1 superstep each), unpipelined and
    through the full-duplex channel at the default StreamConfig, and
    PageRank (3) and Hash-Min through the channel at 256-block chunks; a
    semi-external Hash-Min whose hot-block cache holds some blocks, and
    both unpipelined at 256-block chunks; each against a recoded run as
    deep (phase 5's for Hash-Min)."""
    from repro_torch.core import (
        ChannelConfig, EngineConfig, GraphDEngine, HashMin, PageRank,
        StreamConfig,
    )
    from repro_torch.graph import spill_partition

    rows = []
    root = tempfile.mkdtemp(prefix=".chip_smoke-streamed-", dir=ROOT)
    try:
        t0 = time.perf_counter()
        pgs, store = spill_partition(pg, os.path.join(root, "edges"))
        spill_s = time.perf_counter() - t0
        print(f"streamed: spilled {store.disk_bytes()} bytes of edge groups "
              f"in {spill_s:.1f} s (one (src, dst) group at a time from the "
              f"card); {store.nonempty_blocks()} non-empty blocks")
        progs = (("pagerank3", lambda: PageRank(3)), ("hashmin", HashMin))
        # at the default 8-block chunks the reader's cost a chunk (~65,700
        # chunks a dense superstep) hides everything else, the channel
        # included: the channel runs again at 256-block chunks, as do the
        # semi-external run and both programs unpipelined. There PageRank
        # and Hash-Min run 1 superstep each (~15-20 s), and PageRank 3 at
        # 256-block chunks, each held to a recoded run as deep, to leave
        # phases 12-14 room in the smoke's time
        short = (("pagerank1", lambda: PageRank(1)),
                 ("hashmin1", lambda: capped(HashMin(), 1)))
        for name, prog in (*short, progs[0]):
            (vs, as_), hs = GraphDEngine(pg, prog(), EngineConfig(
                mode="recoded", backend="torch")).run()
            ref = dict(ref, **{name: (vs, as_, [(h.n_active, h.n_msgs)
                                                for h in hs])})
        big = StreamConfig(chunk_blocks=256)
        # the hot cache holds about a tenth of a shard's blocks
        cache = store.nonempty_blocks() // pg.n_shards // 10 \
            * store.block_bytes()
        runs = [(f"{label} {name}", prog, cfg)
                for label, cfg, programs in (
                    ("unpipelined", EngineConfig(mode="streamed"), short),
                    ("full-duplex", EngineConfig(
                        mode="streamed", channel=ChannelConfig(pipeline=True)),
                     short),
                    ("full-duplex chunk_blocks=256", EngineConfig(
                        mode="streamed", stream=big,
                        channel=ChannelConfig(pipeline=True)), progs))
                for name, prog in programs]
        runs.append(("semi-external chunk_blocks=256 hashmin", HashMin,
                     EngineConfig(mode="streamed", stream=StreamConfig(
                         chunk_blocks=256, cache_bytes=cache))))
        # the uncached run the semi-external one is measured against
        runs += [(f"unpipelined chunk_blocks=256 {name}", prog,
                  EngineConfig(mode="streamed", stream=big))
                 for name, prog in progs]
        gaps = {}
        for label, prog, cfg in runs:
            name = label.split()[-1]
            eng = GraphDEngine(pgs, prog(), cfg, stream_store=store)
            (v, a), hist, row = streamed_run(eng, label)
            gaps[label] = check_streamed(name, v, a, hist, ref[name],
                                         f"streamed {label}")
            check(row["peak_increment_gib"] < 1.5, f"streamed {label}: peak "
                  f"device memory +{row['peak_increment_gib']} GiB")
            check(row["peak_increment_gib"] < recoded_peak_gib / 3,
                  f"streamed {label}: peak device memory "
                  f"+{row['peak_increment_gib']} GiB, not under a third of "
                  f"recoded's {recoded_peak_gib} GiB")
            if "semi-external" in label:
                check(row["cache_hits_per_superstep"] > 0,
                      f"streamed {label}: the hot cache served no block")
            rows.append(row)
            del v, a, eng
        print("streamed: hashmin exact and pagerank within "
              f"{PAGERANK_REL_TOL} of its largest value against recoded in "
              "every run; pagerank's gaps: "
              + ", ".join(f"{k} {g:.4g}" for k, g in gaps.items()
                          if "pagerank" in k))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(rows=rows, spill_s=spill_s, signature=store.signature())


def phase_streamed_small(seed: int, main_signature: dict) -> None:
    """The host-heavy streamed paths on RMAT scale ELASTIC_SCALE, each
    against the in-memory run or numpy: Hash-Min over the compressed store
    and through the compressed full-duplex channel, DistinctInLabels and
    SecondMinLabel through the OMS spill and external merge, a GraphDJob
    whose MemoryBudget forces mode='streamed', and a streamed checkpoint and
    run-file-log drill (one shard recovered; a checkpoint refused against
    another store)."""
    import torch
    from repro_torch.core import (
        ChannelConfig, Checkpointer, DistinctInLabels, EngineConfig,
        GraphDEngine, GraphDJob, HashMin, MemoryBudget, PageRank,
        RunFileMessageLog, SecondMinLabel, StreamConfig, plan,
        recover_shard_streamed,
    )
    from repro_torch.graph import (
        partition_graph, partition_graph_streamed, rmat_graph,
    )

    t_all = time.perf_counter()
    g = rmat_graph(scale=ELASTIC_SCALE, edge_factor=16, seed=seed,
                   weights="uniform")
    pg, rmap = partition_graph(g, SHARDS)
    ref = {}
    for name, prog in (("pagerank", lambda: PageRank(5)),
                       ("hashmin", HashMin)):
        (v, a), hist = GraphDEngine(pg, prog()).run()
        ref[name] = (v, a, [(h.n_active, h.n_msgs) for h in hist])
    root = tempfile.mkdtemp(prefix=".chip_smoke-streamed-", dir=ROOT)
    try:
        stores = {}
        for label, kw in (("plain", {}),
                          ("compressed", dict(compress=True,
                                              compress_payload=True))):
            t0 = time.perf_counter()
            pgs, _, stores[label] = partition_graph_streamed(
                g, SHARDS, os.path.join(root, label), recode=rmap, **kw)
            print(f"streamed {ELASTIC_SCALE}: {label} store "
                  f"{stores[label].disk_bytes()} bytes, partitioned and "
                  f"spilled in {time.perf_counter() - t0:.1f} s")
        check(stores["compressed"].signature() == stores["plain"].signature(),
              "streamed: the compressed store's signature differs")
        # compressed edge streams, and the compressed full-duplex channel
        for label, ch in (("compressed store", ChannelConfig()),
                          ("compressed store + channel", ChannelConfig(
                              pipeline=True, compress=True,
                              compress_payload=True))):
            eng = GraphDEngine(pgs, HashMin(), EngineConfig(
                mode="streamed", channel=ch),
                stream_store=stores["compressed"])
            (v, a), hist, _ = streamed_run(
                eng, f"scale {ELASTIC_SCALE} {label} hashmin")
            check_streamed("hashmin", v, a, hist, ref["hashmin"],
                           f"streamed {ELASTIC_SCALE} {label} hashmin")
        # the combiner-less programs: OMS spill, external merge, apply_list;
        # one chunk a group (the merge runs in host Python, fragment by
        # fragment, and runs of one group need no compaction pass)
        gids = pg.gids[pg.vmask].cpu().numpy()
        sample = np.random.default_rng(seed).choice(gids, 256, replace=False)
        src_l, dst_l = edges_into(pg, sample)
        for label, ch, name, prog in (
                ("", ChannelConfig(), "distinct",
                 lambda: DistinctInLabels(16, 1)),
                (" full-duplex", ChannelConfig(pipeline=True), "secondmin",
                 SecondMinLabel)):
            eng = GraphDEngine(pgs, prog(), EngineConfig(
                mode="streamed",
                stream=StreamConfig(chunk_blocks=pgs.n_blocks), channel=ch),
                stream_store=stores["plain"])
            (v, _), hist, _ = streamed_run(
                eng, f"scale {ELASTIC_SCALE} {name}{label}")
            check([h.n_msgs for h in hist] == [pg.n_edges],
                  f"streamed {ELASTIC_SCALE} {name}: messages differ from |E|")
            at = lambda g_: torch.from_numpy(g_).to(v.device)
            got = v[at(sample % SHARDS), at(sample // SHARDS)].cpu().numpy()
            if name == "distinct":
                want = _distinct_numpy(sample, src_l % 16, dst_l)
            else:
                want = _second_min_numpy(sample, src_l, dst_l,
                                         SecondMinLabel.SENTINEL)
            check(np.array_equal(got, want), f"streamed {ELASTIC_SCALE} "
                  f"{name}{label}: differs from numpy")
        print(f"streamed {ELASTIC_SCALE}: distinct and secondmin equal numpy "
              f"at {sample.size} destinations ({src_l.size} in-edges)")
        # the job: a budget just under the in-memory plan's RAM
        loose = plan(HashMin(), g, MemoryBudget(n_shards=SHARDS))
        budget = MemoryBudget(ram_per_shard=loose.alternatives[0].ram_total
                              - 1, n_shards=SHARDS)
        t0 = time.perf_counter()
        with GraphDJob(HashMin(), g, budget=budget,
                       workdir=os.path.join(root, "job")) as job:
            print(job.plan.explain())
            check(job.plan.mode == "streamed",
                  f"job: planned {job.plan.mode}, not streamed")
            res = job.run()
        want = GraphDEngine(pg, HashMin()).gather_values(ref["hashmin"][0])
        check(res.values == want, "job: values differ from the in-memory run")
        print(f"job: {res.plan.mode} (pipeline {res.plan.pipeline}), "
              f"{res.n_supersteps} supersteps in "
              f"{time.perf_counter() - t0:.1f} s with partition and spill; "
              f"planned RAM {res.planned_ram} bytes a shard, realized "
              f"{res.realized_ram} (the model at the realized geometry, not "
              f"a measurement), plus the fold stager's {job.engine._stager.nbytes}"
              f" bytes of host RAM outside the model; values equal the "
              f"in-memory run")
        # checkpoint + run-file log, one shard recovered from them; the
        # cadence leaves two supersteps or more after the last checkpoint
        for name, prog in (("pagerank", lambda: PageRank(5)),
                           ("hashmin", HashMin)):
            steps = len(ref[name][2])
            every = next(e for e in range(3, steps + 2)
                         if steps % e >= 2 or e > steps)
            d = os.path.join(root, f"drill-{name}")
            ck = Checkpointer(os.path.join(d, "ckpt"), every=every)
            log = RunFileMessageLog(os.path.join(d, "log"))
            eng = GraphDEngine(pgs, prog(), EngineConfig(mode="streamed"),
                               stream_store=stores["plain"], message_log=log)
            ck.save(0, *eng.init(), meta=stores["plain"].signature())
            (v, a), hist, row = streamed_run(
                eng, f"scale {ELASTIC_SCALE} logged {name}", checkpointer=ck)
            check_streamed(name, v, a, hist, ref[name],
                           f"streamed {ELASTIC_SCALE} logged {name}")
            start = ck.latest()
            check(steps - start >= 2, f"drill {name}: only {steps - start} "
                  "supersteps to replay")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vj, aj = recover_shard_streamed(pgs, prog(), 3, ck, log,
                                            stores["plain"], steps)
            torch.cuda.synchronize()
            rec_s = time.perf_counter() - t0
            if name == "pagerank":
                check_pagerank(vj, v[3], f"drill {name}: recovered shard")
            else:
                check(torch.equal(vj, v[3]),
                      f"drill {name}: recovered shard differs")
            check(torch.equal(aj, a[3]),
                  f"drill {name}: recovered active bitmap differs")
            try:
                ck.restore(expected_meta=main_signature)
            except ValueError as e:
                check("different edge streams" in str(e),
                      f"drill {name}: refused for another reason: {e}")
            else:
                raise SmokeFailure(f"drill {name}: a checkpoint of another "
                                   "store was not refused")
            print(f"drill {name}: shard 3 recovered from step {start} over "
                  f"{steps - start} supersteps in {rec_s:.3f} s against the "
                  f"live logged run's {row['seconds']:.3f} s; equal to the "
                  "live row; a checkpoint of the scale-24 store refused")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"streamed {ELASTIC_SCALE}: {time.perf_counter() - t_all:.1f} s "
          "in all")


# --------------------------------------------------------------------------
# phase 12: one worker process a shard (GraphDJob(launch="processes"))
# --------------------------------------------------------------------------

PROCS_PAGERANK_TOL = 1e-6  # processes against threads, of the largest value


class ProcsWatch:
    """What a running processes job does to the host and the card, polled
    from outside it: the worker processes and any coordinator process
    (found in /proc by their command line, with their start time), each
    one's peak host RSS (``VmHWM``, else the largest ``VmRSS`` seen), each
    compute app's device memory and the card's memory in use
    (``nvidia-smi``), and the first heartbeat of each shard (the file
    transport's heartbeat files)."""

    def __init__(self, procs_dir: str):
        import threading

        self.procs_dir = procs_dir
        self.coord_dir = os.path.join(procs_dir, "coord")
        self.workers: dict[int, dict] = {}  # pid -> shard, recover, start, hwm
        self.coords: dict[int, dict] = {}  # pid -> incarnation, rss
        self.device_mib: dict[int, int] = {}  # pid -> peak used_memory
        self.card_mib = [None, 0]  # memory.used before, peak during
        self.first_beat: dict[int, float] = {}  # shard -> wall time
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._tick = os.sysconf("SC_CLK_TCK")

    def __enter__(self):
        self.card_mib[0] = self._card_used()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    @staticmethod
    def _smi(*query) -> list[list[str]]:
        try:
            out = subprocess.run(["nvidia-smi", *query,
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, timeout=10)
        except (OSError, subprocess.TimeoutExpired):
            return []
        return [[x.strip() for x in line.split(",")]
                for line in out.stdout.splitlines() if line.strip()]

    def _card_used(self):
        rows = self._smi("--query-gpu=memory.used")
        return int(rows[0][0]) if rows and rows[0][0].isdigit() else None

    def _scan_workers(self) -> None:
        for name in os.listdir("/proc"):
            if not name.isdigit():
                continue
            pid = int(name)
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    argv = f.read().decode(errors="replace").split("\0")
                if "repro_torch.launch.procs" not in argv:
                    continue
                if argv[argv.index("repro_torch.launch.procs") + 1] \
                        == "coord":
                    c = self.coords.setdefault(pid, dict(
                        incarnation=int(argv[argv.index("--incarnation")
                                             + 1]),
                        rss_kib=0, rss_source=None))
                    c["rss_kib"], c["rss_source"] = max(
                        (c["rss_kib"], c["rss_source"]), self._rss(pid))
                    continue
                if pid not in self.workers:
                    # start time: its clock ticks since boot, against the
                    # uptime read now (both to 10 ms; /proc/stat's btime
                    # is whole seconds)
                    with open(f"/proc/{pid}/stat") as f:
                        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
                    with open("/proc/uptime") as f:
                        up = float(f.read().split()[0])
                    i = argv.index("worker")
                    rec = (int(argv[argv.index("--recover-to") + 1])
                           if "--recover-to" in argv else None)
                    self.workers[pid] = dict(
                        shard=int(argv[i + 2]), recover_to=rec, rss_kib=0,
                        rss_source=None,
                        start=time.time() - (up - ticks / self._tick))
                w = self.workers[pid]
                w["rss_kib"], w["rss_source"] = max(
                    (w["rss_kib"], w["rss_source"]), self._rss(pid))
            except (OSError, ValueError, IndexError, StopIteration):
                continue  # the process ended between the list and the read

    @staticmethod
    def _rss(pid: int) -> tuple[int, str]:
        """(KiB, source): the kernel's peak RSS where /proc has it, else
        the resident set now (the poll's maximum is then the peak seen)."""
        with open(f"/proc/{pid}/status") as f:
            fields = dict(line.split(":", 1) for line in f if ":" in line)
        for key in ("VmHWM", "VmRSS"):
            if key in fields:
                return int(fields[key].split()[0]), key
        with open(f"/proc/{pid}/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") // 1024, "statm"

    def _run(self) -> None:
        last_slow = 0.0
        while not self._stop.wait(0.05):
            hb = os.path.join(self.coord_dir, "heartbeat")
            if os.path.isdir(hb):
                for name in os.listdir(hb):
                    if name.endswith(".json"):
                        self.first_beat.setdefault(int(name[:-5]),
                                                   time.time())
            if time.monotonic() - last_slow < 1.0:
                continue
            last_slow = time.monotonic()
            self._scan_workers()
            for row in self._smi("--query-compute-apps=pid,used_memory"):
                if len(row) == 2 and row[0].isdigit() and row[1].isdigit():
                    pid, mib = int(row[0]), int(row[1])
                    self.device_mib[pid] = max(self.device_mib.get(pid, 0),
                                               mib)
            used = self._card_used()
            if used is not None:
                self.card_mib[1] = max(self.card_mib[1], used)

    def first_arrival(self, shard: int):
        """The wall clock of the first arrival in shard ``shard``'s worker
        log (its first incarnation's: respawns append after it)."""
        path = os.path.join(self.procs_dir, f"shard-{shard}", "worker.log")
        try:
            with open(path, errors="replace") as f:
                for line in f:
                    m = re.match(r"worker \d+: superstep \d+ arrived at wall "
                                 r"clock ([0-9.]+)", line)
                    if m:
                        return float(m.group(1))
        except OSError:
            pass
        return None

    def report(self, label: str, planned: dict) -> dict:
        """Print one line per worker process: its start to its first
        heartbeat and first arrival, its peak RSS and device memory,
        beside the planned per-process bytes. Returns the figures."""
        rows = []
        for pid, w in sorted(self.workers.items(),
                             key=lambda kv: (kv[1]["shard"], kv[1]["start"])):
            first = w["recover_to"] is None
            # a respawn's beats continue its shard's file: not its first
            beat = self.first_beat.get(w["shard"]) if first else None
            arrive = self.first_arrival(w["shard"]) if first else None
            rows.append(dict(
                pid=pid, shard=w["shard"], recover_to=w["recover_to"],
                first_beat_s=(beat - w["start"]) if beat else None,
                first_arrival_s=(arrive - w["start"]) if arrive else None,
                rss_bytes=w["rss_kib"] * 1024, rss_source=w["rss_source"],
                device_bytes=(self.device_mib[pid] * 2**20
                              if pid in self.device_mib else None)))
        fmt = lambda x, f: "not measured" if x is None else f.format(x)
        for r in rows:
            print(f"{label}: worker pid {r['pid']} shard {r['shard']}"
                  + (f" (respawned, --recover-to {r['recover_to']})"
                     if r["recover_to"] is not None else "")
                  + f": start to first heartbeat "
                  f"{fmt(r['first_beat_s'], '{:.3f} s')}, to first arrival "
                  f"{fmt(r['first_arrival_s'], '{:.3f} s')}; peak RSS "
                  f"{r['rss_bytes']} bytes ({r['rss_source']}); device "
                  f"memory {fmt(r['device_bytes'], '{} bytes')} (nvidia-smi "
                  "by pid)")
        other = {pid: mib for pid, mib in self.device_mib.items()
                 if pid not in self.workers}
        before, peak = self.card_mib
        # where nvidia-smi cannot tell the workers apart (a pid namespace
        # of its own), the card's memory in use over what it was before the
        # job ran, shared out evenly, is the per-worker figure left
        first = [r for r in rows if r["recover_to"] is None]
        per_worker = ((peak - before) * 2**20 // len(first)
                      if before is not None and first else None)
        print(f"{label}: planned per process: ram_total "
              f"{planned['ram_total']} bytes ({planned['model']}), plus the "
              f"fold stager's {planned['stager']} bytes outside the model; "
              f"card memory in use {fmt(before, '{} MiB')} before, peak "
              f"{peak} MiB during, {fmt(per_worker, '{} bytes')} a worker "
              f"process on average; compute apps that are not workers "
              f"(pid: MiB) {other}")
        for pid, c in sorted(self.coords.items()):
            print(f"{label}: coordinator process pid {pid} incarnation "
                  f"{c['incarnation']}: peak RSS {c['rss_kib'] * 1024} bytes "
                  f"({c['rss_source']}, polled each second)")
        return dict(workers=rows, card_mib=self.card_mib, other_apps=other,
                    device_bytes_per_worker=per_worker,
                    coords=[dict(pid=pid, incarnation=c["incarnation"],
                                 rss_bytes=c["rss_kib"] * 1024)
                            for pid, c in sorted(self.coords.items())])


def procs_plan(prog, graph):
    """The planner's processes plan for ``graph`` in SHARDS shards, at
    256-block chunks (phases 12 and 13 run the same one)."""
    import dataclasses

    from repro_torch.core import MemoryBudget
    from repro_torch.core import plan as make_plan

    p = make_plan(prog, graph, MemoryBudget(n_shards=SHARDS),
                  launch="processes")
    check(p.mode == "streamed" and p.config.channel.full_duplex,
          f"processes: planned {p.mode}, not full-duplex streamed")
    stream = dataclasses.replace(p.config.stream, chunk_blocks=256)
    return dataclasses.replace(p, config=dataclasses.replace(
        p.config, stream=stream))


def planned(job) -> dict:
    """The plan's per-process bytes, and the fold stager's beside them."""
    from repro_torch.core.plan import fold_stager_bytes

    st = job.plan.config.stream
    return dict(ram_total=job.plan.ram_total, model=job.plan.model,
                stager=fold_stager_bytes(st.chunk_blocks, st.group_batch,
                                         job.plan.edge_block))


def steps_of(history) -> list:
    return [(h.n_active, h.n_msgs) for h in history]


def phase_processes(g, seed: int) -> dict:
    """GraphDJob(launch="processes") on the main graph: one worker process
    a shard on the card, Hash-Min to its halt and PageRank (3 supersteps)
    at 256-block chunks, each against the threads launch of the same job
    (its engine: the call GraphDJob.run makes under launch="threads", on
    the same spilled store and plan); then the kill -9 drill at scale
    ELASTIC_SCALE: Hash-Min with checkpoints and message logs, shard 3
    killed in superstep 2, against an undisturbed processes run. Returns
    the figures, and under ``"files"`` what phase 13 holds its socket runs
    to: each run's superstep stats, ms, values and bitmap (on the host),
    and the scale-ELASTIC_SCALE graph."""
    import torch
    from repro_torch.core import GraphDJob, HashMin, PageRank
    from repro_torch.graph import rmat_graph

    # the runtime alone, the baseline of the workers' start-up and RSS: a
    # fresh process that imports torch and opens a CUDA context
    probe = subprocess.run([sys.executable, "-c", (
        "import json, time\n"
        "t = time.perf_counter()\n"
        "import torch\n"
        "torch.zeros(1, device='cuda')\n"
        "dt = time.perf_counter() - t\n"
        "f = dict(l.split(':', 1) for l in open('/proc/self/status'))\n"
        "k = 'VmHWM' if 'VmHWM' in f else 'VmRSS'\n"
        "print(json.dumps([dt, int(f[k].split()[0]) * 1024, k]))\n")],
        capture_output=True, text=True, timeout=300)
    check(probe.returncode == 0, f"processes: the runtime probe failed: "
          f"{probe.stderr[-2000:]}")
    probe_s, probe_rss, probe_key = json.loads(probe.stdout)
    print(f"processes: a fresh process imports torch and opens a CUDA "
          f"context in {probe_s:.3f} s, then holds {probe_rss} bytes "
          f"({probe_key})")
    files: dict = {}
    out = dict(runtime=dict(seconds=probe_s, rss_bytes=probe_rss),
               files=files)
    root = tempfile.mkdtemp(prefix=".chip_smoke-procs-", dir=ROOT)
    try:
        for name, prog in (("hashmin", HashMin), ("pagerank",
                                                  lambda: PageRank(3))):
            t0 = time.perf_counter()
            job = GraphDJob(prog(), g, plan=procs_plan(prog(), g),
                            workdir=os.path.join(root, name),
                            launch="processes")
            setup_s = time.perf_counter() - t0
            check(job.device.type == "cuda", "processes: job off the card")
            procs_dir = job._dir("procs", "")
            with ProcsWatch(procs_dir) as watch:
                t0 = time.perf_counter()
                res = job.run()
                procs_s = time.perf_counter() - t0
            v_p, a_p = job._state
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (v_t, a_t), hist = job.engine.run()
            torch.cuda.synchronize()
            threads_s = time.perf_counter() - t0
            label = f"processes {name}"
            steps_p, steps_t = steps_of(res.history), steps_of(hist)
            check(steps_p == steps_t, f"{label}: superstep stats or halt "
                  f"step differ from threads ({steps_p} vs {steps_t})")
            check(torch.equal(a_p, a_t),
                  f"{label}: active bitmap differs from threads")
            if name == "pagerank":
                gap = float((v_p - v_t).abs().max()) / float(v_t.abs().max())
                check(gap < PROCS_PAGERANK_TOL, f"{label}: {gap} of the "
                      "largest value from threads")
            else:
                gap = 0.0
                check(torch.equal(v_p, v_t), f"{label}: values differ from "
                      "threads")
            check(job._last_run_recoveries == 0,
                  f"{label}: {job._last_run_recoveries} respawns")
            shards = sorted(w["shard"] for w in watch.workers.values())
            check(shards == list(range(SHARDS)),
                  f"{label}: worker processes seen for shards {shards}")
            n = len(hist)
            ms_p = [h.seconds * 1e3 for h in res.history]
            print(f"{label}: {SHARDS} worker processes, {n} supersteps; "
                  f"set-up (partition and spill) {setup_s:.1f} s; processes "
                  f"{procs_s:.3f} s in all, ms a superstep {ms_p[0]:.1f} "
                  f"(superstep 0, spawn included) then "
                  + ", ".join(f"{m:.1f}" for m in ms_p[1:])
                  + f"; threads {threads_s:.3f} s, ms a superstep "
                  + ", ".join(f"{h.seconds * 1e3:.1f}" for h in hist)
                  + ("; values equal" if name == "hashmin" else
                     f"; pagerank {gap:.4g} of its largest value from "
                     "threads")
                  + "; superstep stats, bitmaps and halt step equal")
            out[name] = dict(
                setup_s=setup_s, processes_s=procs_s, threads_s=threads_s,
                ms_processes=ms_p, ms_threads=[h.seconds * 1e3 for h in hist],
                gap=gap, watch=watch.report(label, planned(job)))
            files[name] = dict(steps=steps_p, ms=ms_p, seconds=procs_s,
                               values=v_p.cpu(), active=a_p.cpu())
            job.close(delete=True)
            del v_p, a_p, v_t, a_t, job
        # the kill -9 drill
        g20 = rmat_graph(scale=ELASTIC_SCALE, edge_factor=16, seed=seed,
                         weights="uniform")
        p = procs_plan(HashMin(), g20)
        runs = {}
        for label, opts in (("undisturbed", None),
                            ("drill", {"kill": {"shard": 3, "step": 2}})):
            job = GraphDJob(HashMin(), g20, plan=p, checkpoint_every=2,
                            workdir=os.path.join(root, f"drill-{label}"),
                            launch="processes", launch_opts=opts)
            with ProcsWatch(job._dir("procs", "")) as watch:
                t0 = time.perf_counter()
                res = job.run()
                secs = time.perf_counter() - t0
            runs[label] = (res, job._state, job._last_run_recoveries, secs,
                           watch.report(f"processes drill {label}",
                                        planned(job)))
            job.close(delete=True)
        (r0, (v0, a0), n0, s0, _), (r1, (v1, a1), n1, s1, w1) = (
            runs["undisturbed"], runs["drill"])
        respawned = sorted((w["shard"], w["recover_to"])
                           for w in w1["workers"]
                           if w["recover_to"] is not None)
        check(n0 == 0 and n1 == 1, f"drill: {n0} and {n1} respawns, not "
              "0 and 1")
        check([s for s, _ in respawned] == [3], f"drill: respawned "
              f"{respawned}, not shard 3 alone")
        check([(h.n_active, h.n_msgs) for h in r1.history]
              == [(h.n_active, h.n_msgs) for h in r0.history],
              "drill: superstep stats or halt step differ")
        check(torch.equal(v1, v0) and torch.equal(a1, a0),
              "drill: values or bitmap differ from the undisturbed run")
        print(f"processes drill (scale {ELASTIC_SCALE}, Hash-Min, "
              f"checkpoint_every 2): shard 3 SIGKILLed once its "
              f"superstep-2 outbox was announced, respawned alone with "
              f"--recover-to {respawned[0][1]}; "
              f"{len(r1.history)} supersteps in {s1:.3f} s against the "
              f"undisturbed run's {s0:.3f} s; values, bitmaps and superstep "
              "stats equal")
        out["drill"] = dict(seconds=s1, undisturbed_s=s0,
                            recover_to=respawned[0][1])
        files["undisturbed"] = dict(steps=steps_of(r0.history), seconds=s0,
                                    values=v0.cpu(), active=a0.cpu())
        files["graph"] = g20
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# --------------------------------------------------------------------------
# phase 13: the socket transport (launch_opts={"transport": "sockets"})
# --------------------------------------------------------------------------

SOCKETS = {"transport": "sockets"}


def _socket_job(prog, graph, workdir: str, label: str, opts=None,
                checkpoint_every=None):
    """Run one sockets job under a ProcsWatch; returns (result, (values,
    active) on the host, seconds, the job's audit counters, the watch's
    report). Checks the run wrote no announce marker: no shared-filesystem
    exchange."""
    from repro_torch.core import GraphDJob

    t0 = time.perf_counter()
    job = GraphDJob(prog, graph, plan=procs_plan(prog, graph),
                    workdir=workdir, launch="processes",
                    launch_opts={**SOCKETS, **(opts or {})},
                    checkpoint_every=checkpoint_every)
    setup_s = time.perf_counter() - t0
    check(job.device.type == "cuda", f"{label}: job off the card")
    procs_dir = job._dir("procs", "")
    try:
        with ProcsWatch(procs_dir) as watch:
            t0 = time.perf_counter()
            res = job.run()
            secs = time.perf_counter() - t0
        check(not os.path.exists(os.path.join(procs_dir, "announce")),
              f"{label}: the socket run wrote announce markers")
        audit = dict(recoveries=job._last_run_recoveries,
                     coord_restarts=job._last_run_coord_restarts,
                     net=dict(job._last_run_net), setup_s=setup_s)
        v, a = job._state
        state = (v.cpu(), a.cpu())
        report = watch.report(label, planned(job))
    finally:
        job.close(delete=True)
    return res, state, secs, audit, report


def phase_sockets(g, files: dict) -> dict:
    """Phase 12's two scale-24 jobs over the socket transport, 8 worker
    processes and one coordinator process, each against phase 12's
    file-transport run of the same plan (kept in memory: this phase runs
    no threads job); then, at scale ELASTIC_SCALE, an undisturbed sockets
    run and the two socket drills against phase 12's undisturbed run."""
    import torch
    from repro_torch.core import HashMin, PageRank

    out = {}
    root = tempfile.mkdtemp(prefix=".chip_smoke-procs-", dir=ROOT)
    try:
        for name, prog in (("hashmin", HashMin),
                           ("pagerank", lambda: PageRank(3))):
            label = f"sockets {name}"
            ref = files[name]
            res, (v, a), secs, audit, rep = _socket_job(
                prog(), g, os.path.join(root, name), label)
            steps = steps_of(res.history)
            check(steps == ref["steps"], f"{label}: superstep stats or halt "
                  f"step differ from files ({steps} vs {ref['steps']})")
            check(torch.equal(a, ref["active"]),
                  f"{label}: active bitmap differs from files")
            if name == "pagerank":
                gap = float((v - ref["values"]).abs().max()) \
                    / float(ref["values"].abs().max())
                check(gap < PROCS_PAGERANK_TOL, f"{label}: {gap} of the "
                      "largest value from files")
            else:
                gap = 0.0
                check(torch.equal(v, ref["values"]),
                      f"{label}: values differ from files")
            check(audit["recoveries"] == 0 and audit["coord_restarts"] == 0,
                  f"{label}: {audit['recoveries']} worker and "
                  f"{audit['coord_restarts']} coordinator respawns")
            shards = sorted(w["shard"] for w in rep["workers"])
            check(shards == list(range(SHARDS)),
                  f"{label}: worker processes seen for shards {shards}")
            check(len(rep["coords"]) == 1, f"{label}: coordinator processes "
                  f"seen {rep['coords']}")
            net = audit["net"]
            n = len(res.history)
            ms = [h.seconds * 1e3 for h in res.history]
            arrivals = [w["first_arrival_s"] for w in rep["workers"]]
            print(f"{label}: {SHARDS} worker processes and a coordinator "
                  f"process, {n} supersteps; set-up (partition and spill) "
                  f"{audit['setup_s']:.1f} s; sockets {secs:.3f} s in all "
                  f"against files {ref['seconds']:.3f} s; ms a superstep "
                  "(superstep 0, spawn included, first) sockets "
                  + ", ".join(f"{m:.1f}" for m in ms) + "; files "
                  + ", ".join(f"{m:.1f}" for m in ref["ms"])
                  + f"; start to first arrival "
                  + ("not measured" if None in arrivals else
                     f"{min(arrivals):.3f}-{max(arrivals):.3f} s")
                  + f"; on the wire {net['net_wire_bytes']:.0f} bytes in "
                  f"{net['net_frames']:.0f} frames, "
                  f"{net['net_wire_bytes'] / n:.0f} bytes a superstep; "
                  f"senders busy {net['net_send_s']:.3f} s, compute stalled "
                  f"on them {net['net_stall_s']:.3f} s; "
                  f"coordinator peak RSS "
                  f"{rep['coords'][0]['rss_bytes']} bytes"
                  + ("; values equal" if name == "hashmin" else
                     f"; pagerank {gap:.4g} of its largest value from files")
                  + "; superstep stats, bitmaps and halt step equal")
            out[name] = dict(seconds=secs, ms=ms, gap=gap, net=net,
                             first_arrival_s=arrivals,
                             coord_rss=rep["coords"][0]["rss_bytes"])
        # scale ELASTIC_SCALE: undisturbed, then the two drills
        g20, ref = files["graph"], files["undisturbed"]
        runs = {}
        for label, opts in (
                ("undisturbed", None),
                ("kill_net", {"kill_net": {"shard": 1, "step": 2,
                                           "after_frames": 1}}),
                ("coord_kill", {"coord_kill": {"step": 1,
                                               "after_arrivals": 1}})):
            what = f"sockets drill {label}"
            res, (v, a), secs, audit, rep = _socket_job(
                HashMin(), g20, os.path.join(root, f"drill-{label}"), what,
                opts=opts, checkpoint_every=2)
            check(steps_of(res.history) == ref["steps"],
                  f"{what}: superstep stats or halt step differ")
            check(torch.equal(v, ref["values"])
                  and torch.equal(a, ref["active"]),
                  f"{what}: values or bitmap differ from phase 12's "
                  "undisturbed run")
            respawned = sorted((w["shard"], w["recover_to"])
                               for w in rep["workers"]
                               if w["recover_to"] is not None)
            want = dict(undisturbed=(0, 0), kill_net=(1, 0),
                        coord_kill=(0, 1))[label]
            check((audit["recoveries"], audit["coord_restarts"]) == want,
                  f"{what}: {audit['recoveries']} worker and "
                  f"{audit['coord_restarts']} coordinator respawns, not "
                  f"{want[0]} and {want[1]}")
            if label == "kill_net":
                check([s for s, _ in respawned] == [1],
                      f"{what}: respawned {respawned}, not shard 1 alone")
            runs[label] = dict(seconds=secs, respawned=respawned,
                               coords=[c["incarnation"]
                                       for c in rep["coords"]])
        base = runs["undisturbed"]["seconds"]
        print(f"sockets drills (scale {ELASTIC_SCALE}, Hash-Min, "
              f"checkpoint_every 2, {len(ref['steps'])} supersteps, each "
              "equal to phase 12's undisturbed files run in values, bitmaps "
              f"and superstep stats): undisturbed sockets {base:.3f} s "
              f"(files {ref['seconds']:.3f} s); kill_net (shard 1 SIGKILLed "
              "with its second frame of superstep 2 half on the wire) "
              f"{runs['kill_net']['seconds']:.3f} s, "
              f"+{runs['kill_net']['seconds'] - base:.3f} s, respawned "
              f"{runs['kill_net']['respawned']}; coord_kill (the "
              "coordinator SIGKILLed in superstep 1's barrier after one "
              f"arrival) {runs['coord_kill']['seconds']:.3f} s, "
              f"+{runs['coord_kill']['seconds'] - base:.3f} s, coordinator "
              f"incarnations seen {runs['coord_kill']['coords']}, no worker "
              "respawn")
        out["drills"] = runs
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# --------------------------------------------------------------------------
# phase 14: the mesh, one process a shard over torch.distributed
# --------------------------------------------------------------------------

MESH_MAX_RANKS = 8


def machine_gpus() -> list[str]:
    """The GPUs this machine gives the smoke, as ``CUDA_VISIBLE_DEVICES``
    names them where it is set, else one index a line of ``nvidia-smi
    -L``: read before ``main`` narrows its own process to the first."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [x.strip() for x in env.split(",") if x.strip()]
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [str(i) for i, line in enumerate(
        x for x in out.splitlines() if x.startswith("GPU "))]


class CardMemory:
    """One GPU's memory in use (``nvidia-smi``, MiB): before, and the peak
    polled every half second while the ``with`` block runs."""

    def __init__(self, gpu: str):
        import threading

        self.gpu = gpu
        self.before = self.peak = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)

    def _read(self):
        rows = ProcsWatch._smi("--query-gpu=memory.used", "-i", self.gpu)
        return int(rows[0][0]) if rows and rows[0][0].isdigit() else None

    def _poll(self):
        while not self._stop.wait(0.5):
            used = self._read()
            if used is not None:
                self.peak = max(self.peak or 0, used)

    def __enter__(self):
        self.before = self.peak = self._read()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30)


def mesh_cases(src: int, wide: bool):
    """(label, program factory, EngineConfig) of phase 14 on the main
    partition; ``wide`` adds SSSP and BFS on the kernel backend and
    basic_sc."""
    from repro_torch.core import BFS, SSSP, EngineConfig, HashMin, PageRank

    cases = [("pagerank-recoded-kernel", lambda: PageRank(3),
              EngineConfig(backend="kernel")),
             ("hashmin-recoded-kernel", HashMin,
              EngineConfig(backend="kernel")),
             ("pagerank-basic-torch", lambda: PageRank(3),
              EngineConfig(mode="basic", backend="torch")),
             ("pagerank-recoded_compact-torch", lambda: PageRank(3),
              EngineConfig(mode="recoded_compact", backend="torch"))]
    if wide:
        cases += [("sssp-recoded-kernel", lambda: SSSP(src),
                   EngineConfig(backend="kernel")),
                  ("bfs-recoded-kernel", lambda: BFS(src),
                   EngineConfig(backend="kernel")),
                  ("pagerank-basic_sc-torch", lambda: PageRank(3),
                   EngineConfig(mode="basic_sc", backend="torch"))]
    return cases


def mesh_bytes(case: str, pg, backend: str) -> dict:
    """What a rank of an n-rank mesh hands its backend a superstep, from
    the partition's shape: the ring's (n-1) rounds of a value and a count
    a position; basic's one all_to_all of a payload and a destination an
    edge slot; recoded_compact's of a bf16 value and an int8 flag a slot
    and destination; the logged step's of a float32 value and an int32
    count a slot and destination; PageRank's 4-byte aggregator, gathered;
    five 8-byte reductions. Under gloo every byte goes to the host and
    back, the gather bringing n partials back."""
    n = pg.n_shards
    if n == 1:
        return dict(ring=0, all_to_all=0, gather=0, reduce=0, staged=0)
    if "-basic-" in case:
        ring, a2a = 0, n * pg.E_cap * 8
    elif "-recoded_compact-" in case:
        ring, a2a = 0, n * pg.P * 3
    elif "-logged" in case:
        ring, a2a = 0, n * pg.P * 8
    else:
        ring, a2a = (n - 1) * pg.P * 8, 0
    gather = 4 if case.startswith("pagerank") else 0
    staged = (2 * (ring + a2a) + (gather + 4 * n if gather else 0) + 2 * 40
              if backend == "gloo" else 0)
    return dict(ring=ring, all_to_all=a2a, gather=gather, reduce=40,
                staged=staged)


def check_mesh_case(what: str, case: str, cfg, res, v, a, hist, pg,
                    backend: str, launches: dict) -> float:
    """One mesh case against the emulated run of the same partition on the
    card: superstep stats, halt step and bitmaps exactly; the torch
    backend's values and the integer programs' bit for bit, the kernel
    backend's PageRank by ``check_pagerank`` (edge_combine's float atomics
    are unordered); each rank's bytes against :func:`mesh_bytes` and its
    launches (the kernel backend: n edge_combine and n-1 digest a
    superstep; the torch backend: run_sum for a float sum, neither
    kernel), added to ``launches``. Returns PageRank's gap over its largest
    value (0 where bit-identical)."""
    import torch

    n, steps = pg.n_shards, len(hist)
    check([(h.n_active, h.n_msgs) for h in res.history]
          == [(h.n_active, h.n_msgs) for h in hist],
          f"{what}: superstep stats or halt step differ from the emulated "
          "run")
    check(torch.equal(res.active, a.cpu()),
          f"{what}: active bitmap differs from the emulated run")
    gap = 0.0
    if case.startswith("pagerank") and cfg.backend == "kernel":
        gap = check_pagerank(res.values, v.cpu(), f"{what}: pagerank")
    else:
        check(torch.equal(res.values, v.cpu()),
              f"{what}: values differ from the emulated run")
    want = {k: b * steps for k, b in mesh_bytes(case, pg, backend).items()}
    for r, rank in enumerate(res.ranks):
        check(rank["bytes"] == want, f"{what}: rank {r} handed its "
              f"backend {rank['bytes']}, the byte model says {want}")
        got = rank["launches"]
        if cfg.backend == "kernel":
            check(got["edge_combine"] == n * steps
                  and got["digest"] == (n - 1) * steps,
                  f"{what}: rank {r} launched {got} in {steps} supersteps")
        else:
            check(got["edge_combine"] == got["digest"] == 0,
                  f"{what}: the torch backend launched a kernel of the "
                  "kernel backend")
            check((got["run_sum"] > 0) == case.startswith("pagerank"),
                  f"{what}: rank {r} launched run_sum {got['run_sum']} "
                  "times")
        for name, count in got.items():
            launches[name][r] += count
    return gap


def _past_ms(hist) -> float:
    """ms a superstep past the first."""
    return sum(x.seconds for x in hist[1:]) * 1e3 / max(len(hist) - 1, 1)


def run_mesh_phase(label: str, pg, src: int, backend: str, gpus: list,
                   wide: bool) -> dict:
    """Every case of :func:`mesh_cases` on one mesh of ``pg.n_shards``
    ranks, each held by :func:`check_mesh_case` against the emulated run
    of the same partition on the card. Prints ms a superstep past the
    first (the slowest rank's) against the emulated run's, start-up, the
    first GPU's memory and a rank's peak allocation."""
    import torch
    from repro_torch.core import GraphDEngine
    from repro_torch.launch.mesh import run_mesh_cases

    n = pg.n_shards
    cases = mesh_cases(src, wide)
    root = tempfile.mkdtemp(prefix=".chip_smoke-mesh-", dir=ROOT)
    try:
        with CardMemory(gpus[0]) as mem:
            run = run_mesh_cases(pg, [(make(), cfg) for _, make, cfg in cases],
                                 backend=backend, device="cuda", gpus=gpus,
                                 workdir=root, timeout=600)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {k: [0] * n for k in ("edge_combine", "digest", "run_sum")}
    for (case, make, cfg), res in zip(cases, run.results):
        what = f"mesh {label} {case}"
        (v, a), hist = GraphDEngine(pg, make(), cfg).run()
        torch.cuda.synchronize()
        gap = check_mesh_case(what, case, cfg, res, v, a, hist, pg, backend,
                              launches)
        twin = None
        if case.startswith("pagerank") and cfg.backend == "kernel":
            # the card's own run-to-run spread, beside the mesh's gap:
            # edge_combine's float atomics add in no fixed order
            (v2, _), _ = GraphDEngine(pg, make(), cfg).run()
            twin = float((v2 - v).abs().max()) / float(v.abs().max())
            del v2
        print(f"mesh {label} {case}: {len(hist)} supersteps in "
              f"{sum(h.seconds for h in res.history):.3f} s, "
              f"{_past_ms(res.history):.3f} ms a superstep past the first "
              f"(the slowest rank) against the emulated run's "
              f"{_past_ms(hist):.3f}; per-superstep ms of the slowest rank "
              f"{[round(h.seconds * 1e3, 2) for h in res.history]}, of the "
              f"emulated run {[round(h.seconds * 1e3, 2) for h in hist]}; "
              f"each rank handed its backend {mesh_bytes(case, pg, backend)}"
              " bytes a superstep, equal to the byte model; "
              + (f"pagerank gap over its largest value {gap:.4g}, and "
                 f"{twin:.4g} between two emulated runs" if twin is not None
                 else "equal to the emulated run bit for bit"))
        del v, a
    start = {k: max(s[k] for s in run.startup) for k in run.startup[0]}
    peak = max((r["peak_bytes"] for res in run.results for r in res.ranks
                if r["peak_bytes"] is not None), default=None)
    print(f"mesh {label}: {n} ranks over {backend} on CUDA_VISIBLE_DEVICES "
          f"{sorted(set(run.devices))}; slices written in "
          f"{run.slices_s:.3f} s, the ranks ran {run.seconds:.3f} s; start-up"
          f" (the slowest rank's) spawn to the first superstep "
          f"{start['spawn_to_first_s']:.3f} s: torch import "
          f"{start['import_s']:.3f} s, rendezvous {start['rendezvous_s']:.3f}"
          f" s, slice load {start['load_s']:.3f} s; GPU {gpus[0]}'s memory in "
          f"use {mem.before} MiB before, peak {mem.peak} MiB during; a "
          f"rank's peak allocated {peak} bytes")
    return dict(launches=launches, run=run)


#: the logged cases of phase 14 on the small graph: (label, program
#: factory, EngineConfig, CaseFiles fields), in order. The resumed case
#: restarts the first from its step-4 checkpoint (every 4, so that shard 3's
#: recovery replays two supersteps, as phase 6's does).
MESH_LOG_EVERY = 4


def mesh_recovery_cases():
    from repro_torch.core import (
        DistinctInLabels, EngineConfig, HashMin, PageRank, SecondMinLabel,
    )

    torch_cfg = EngineConfig(backend="torch")
    files = dict(log="log", ckpt="ckpt", every=MESH_LOG_EVERY)
    return [("pagerank-logged", lambda: PageRank(6), torch_cfg,
             dict(files, save_initial=True)),
            ("pagerank-logged-resumed", lambda: PageRank(6), torch_cfg,
             files),
            ("hashmin-recoded-kernel", HashMin,
             EngineConfig(backend="kernel"), None),
            ("hashmin-logged", HashMin, torch_cfg, dict(log="log-hm")),
            ("distinct-basic-torch",
             lambda: DistinctInLabels(n_groups=8, rounds=2),
             EngineConfig(mode="basic", backend="torch"), None),
            ("secondmin-basic-torch", SecondMinLabel,
             EngineConfig(mode="basic", backend="torch"), None)]


def _files(root: str, fields):
    from repro_torch.launch.mesh import CaseFiles

    if fields is None:
        return None
    return CaseFiles(**{k: os.path.join(root, v) if k in ("log", "ckpt")
                        else v for k, v in fields.items()})


def _emulated_logged(pg, make, cfg, files):
    """The case on the emulated engine with an unmeshed log and
    checkpointer in ``files``' directories."""
    from repro_torch.core import Checkpointer, GraphDEngine, MessageLog

    log = MessageLog(files.log) if files and files.log else None
    ck = (Checkpointer(files.ckpt, files.every, files.keep)
          if files and files.ckpt else None)
    eng = GraphDEngine(pg, make(), cfg, message_log=log)
    if ck is not None and files.save_initial:
        ck.save(0, *eng.init())
    return eng.run(checkpointer=ck)


def same_files(mesh_dir: str, emu_dir: str) -> int:
    """Every file the emulated run wrote under ``emu_dir`` exists under
    ``mesh_dir`` with the same arrays (npz) or contents; returns the
    files compared."""
    count = 0
    for d, _, fs in os.walk(emu_dir):
        for f in fs:
            rel = os.path.relpath(os.path.join(d, f), emu_dir)
            mine = os.path.join(mesh_dir, rel)
            check(os.path.exists(mine), f"mesh files: {rel} is missing")
            if f.endswith(".npz"):
                with np.load(os.path.join(d, f)) as x, np.load(mine) as y:
                    check(sorted(x.files) == sorted(y.files) and all(
                        np.array_equal(x[k], y[k]) and x[k].dtype == y[k].dtype
                        for k in x.files), f"mesh files: {rel} differs")
            else:
                with open(os.path.join(d, f)) as x, open(mine) as y:
                    check(json.load(x) == json.load(y),
                          f"mesh files: {rel} differs")
            count += 1
    return count


def run_mesh_recovery(label: str, pg, backend: str, gpus: list,
                      failed: int = 3) -> dict:
    """The mesh's logged step, message log, checkpoints and recovery, and
    combiner-less basic, on one mesh of ``pg.n_shards`` ranks: logged
    PageRank (6 supersteps, a checkpoint every MESH_LOG_EVERY after a
    step-0 one), the same resumed from its latest checkpoint, Hash-Min over
    the ring and logged, DistinctInLabels and SecondMinLabel under basic.
    Each against the emulated run (its log and checkpoints in directories of
    its own) by :func:`check_mesh_case`, the files the ranks wrote equal to
    the emulated run's; the resumed run equals the live one, ring Hash-Min
    the logged one; shard ``failed`` recovered in this process from the
    mesh's files, held to phase 6's bars; the combiner-less programs'
    emulated runs held to numpy by :func:`check_combinerless`."""
    import torch
    from repro_torch.core import (
        Checkpointer, GraphDEngine, MessageLog, PageRank, recover_shard,
    )
    from repro_torch.launch.mesh import run_mesh_cases

    n = pg.n_shards
    cases = mesh_recovery_cases()
    root = tempfile.mkdtemp(prefix=".chip_smoke-mesh-", dir=ROOT)
    mesh_root, emu_root = os.path.join(root, "mesh"), os.path.join(root, "emu")
    try:
        t0 = time.perf_counter()
        run = run_mesh_cases(
            pg, [(make(), cfg, *([_files(mesh_root, f)] if f else []))
                 for _, make, cfg, f in cases],
            backend=backend, device="cuda", gpus=gpus,
            workdir=os.path.join(root, "ranks"), timeout=600)
        mesh_s = time.perf_counter() - t0
        launches = {k: [0] * n for k in ("edge_combine", "digest",
                                         "run_sum")}
        results = {}
        t0 = time.perf_counter()
        for (case, make, cfg, f), res in zip(cases, run.results):
            (v, a), hist = _emulated_logged(pg, make, cfg,
                                            _files(emu_root, f))
            torch.cuda.synchronize()
            check([h.restored_from for h in res.history]
                  == [h.restored_from for h in hist],
                  f"mesh {label} {case}: resumed from another step")
            check_mesh_case(f"mesh {label} {case}", case, cfg, res, v, a,
                            hist, pg, backend, launches)
            results[case] = res
            r0 = res.ranks[0]
            print(f"mesh {label} {case}: {len(hist)} supersteps "
                  f"{[h.step for h in hist]} in "
                  f"{sum(h.seconds for h in res.history):.3f} s (the slowest"
                  f" rank), equal to the emulated run bit "
                  f"for bit; {_past_ms(res.history):.3f} ms a superstep past "
                  f"the first against the emulated run's {_past_ms(hist):.3f}"
                  f"; each rank handed its backend "
                  f"{mesh_bytes(case, pg, backend)} bytes a superstep"
                  + (f"; rank 0's log {r0['log_bytes']} bytes"
                     if r0["log_bytes"] is not None else "")
                  + (f"; checkpoints {max(r['ckpt_seconds'] for r in res.ranks):.3f}"
                     " s on the slowest rank"
                     if r0["ckpt_seconds"] is not None else ""))
        emu_s = time.perf_counter() - t0
        files = same_files(mesh_root, emu_root)
        live = results["pagerank-logged"]
        resumed = results["pagerank-logged-resumed"]
        latest = Checkpointer(os.path.join(mesh_root, "ckpt")).latest()
        check(resumed.history[0].restored_from == latest == MESH_LOG_EVERY
              and torch.equal(resumed.values, live.values)
              and torch.equal(resumed.active, live.active),
              f"mesh {label}: the resumed run differs from the live one")
        ring, logged = (results["hashmin-recoded-kernel"],
                        results["hashmin-logged"])
        check(torch.equal(ring.values, logged.values)
              and torch.equal(ring.active, logged.active),
              f"mesh {label}: Hash-Min over the ring differs from logged")
        steps = len(live.history)
        model = n * pg.P * 8
        for r, rank in enumerate(live.ranks):
            check(steps * model <= rank["log_bytes"]
                  < steps * (model + 1024),
                  f"mesh {label}: rank {r} logged {rank['log_bytes']} bytes"
                  f" in {steps} supersteps, the model {model} a superstep")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vj, aj = recover_shard(pg, PageRank(6), failed,
                               Checkpointer(os.path.join(mesh_root, "ckpt")),
                               MessageLog(os.path.join(mesh_root, "log")),
                               steps)
        torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        check(steps - latest >= 2, f"mesh {label}: only {steps - latest} "
              "supersteps after the checkpoint")
        gap = check_pagerank(vj.cpu(), live.values[failed],
                             f"mesh {label}: recovered shard")
        check(torch.equal(aj.cpu(), live.active[failed]),
              f"mesh {label}: recovered active bitmap differs")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    start = max(s["spawn_to_first_s"] for s in run.startup)
    print(f"mesh {label} recovery: {n} ranks over {backend}, the ranks ran "
          f"{mesh_s:.3f} s (spawn to the first superstep {start:.3f} s), the "
          f"emulated runs {emu_s:.3f} s; {files} log and checkpoint files "
          f"equal to the emulated run's; the resumed run (from step "
          f"{latest}) equals the live one; ring Hash-Min equals logged; "
          f"shard {failed} recovered from the mesh's files over "
          f"{steps - latest} supersteps in {rec_s:.3f} s, gap {gap:.4g} of "
          f"the largest value, bitmap exact; log {model} bytes a rank a "
          "superstep by the model")
    return dict(launches=launches, seconds=mesh_s + emu_s)


def phase_mesh(g, pg, src: int, seed: int, gpus: list, power: str) -> dict:
    """GraphDEngine(mesh=) through launch.mesh, one process a shard: always
    gloo with 8 ranks on the first card, on the main partition (PageRank
    3 supersteps and Hash-Min on the kernel backend, PageRank on basic and
    recoded_compact); then NCCL with one rank a GPU, up to 8, on the main
    graph partitioned for that many (the main partition itself at 8), the
    same cases and SSSP, BFS and basic_sc; on a machine with one GPU, NCCL
    with one rank at scale MESH_ONE_GPU_SCALE. Then the logged step, the
    message log, checkpoints, recovery and combiner-less basic on the small
    graph (RMAT scale ELASTIC_SCALE): gloo with 8 ranks on the first card,
    and NCCL with one rank a GPU where the machine has two or more.
    Returns each rank's launches of the gloo runs."""
    import torch
    from repro_torch.graph import partition_graph, rmat_graph

    nccl = torch.cuda.nccl.version()
    nccl = ".".join(map(str, nccl)) if isinstance(nccl, tuple) else nccl
    print(f"mesh: the machine gives {len(gpus)} GPU(s) {gpus}; NCCL {nccl};"
          f" {power}")
    gloo = run_mesh_phase(f"gloo x{pg.n_shards}", pg, src, "gloo",
                          gpus[:1], wide=False)
    n = min(len(gpus), MESH_MAX_RANKS)
    label = f"nccl x{n}"
    if n == pg.n_shards:
        pgn, srcn = pg, src
    elif n >= 2:
        t0 = time.perf_counter()
        pgn, rmap = partition_graph(g, n)
        srcn = int(rmap.to_new(np.array([0]))[0])
        print(f"mesh: the main graph partitioned for {n} ranks in "
              f"{time.perf_counter() - t0:.1f} s: {pgn.shape_summary}")
    else:
        print("mesh: one GPU on this machine: NCCL with one rank, at scale "
              f"{MESH_ONE_GPU_SCALE}; the multi-GPU check did not run")
        g1 = rmat_graph(scale=MESH_ONE_GPU_SCALE, edge_factor=16, seed=seed,
                        weights="uniform")
        pgn, rmap = partition_graph(g1, 1)
        srcn = int(rmap.to_new(np.array([0]))[0])
        label += f" (RMAT scale {MESH_ONE_GPU_SCALE})"
    run_mesh_phase(label, pgn, srcn, "nccl", gpus[:n], wide=True)
    del pgn
    t0 = time.perf_counter()
    gs = rmat_graph(scale=ELASTIC_SCALE, edge_factor=16, seed=seed,
                    weights="uniform")
    pgs, _ = partition_graph(gs, SHARDS)
    print(f"mesh: the small graph (RMAT scale {ELASTIC_SCALE}) in "
          f"{time.perf_counter() - t0:.1f} s: {pgs.shape_summary}")
    t0 = time.perf_counter()
    small = run_mesh_recovery(f"gloo x{SHARDS} (RMAT scale {ELASTIC_SCALE})",
                              pgs, "gloo", gpus[:1])
    real = pgs.gids[pgs.vmask].cpu().numpy()
    check_combinerless(pgs, np.random.default_rng(seed).choice(
        real, 256, replace=False), "mesh small-graph emulated")
    print(f"mesh: the small-graph cases took {time.perf_counter() - t0:.1f}"
          " s in all")
    if n >= 2:
        pgsn = pgs if n == SHARDS else partition_graph(gs, n)[0]
        run_mesh_recovery(f"nccl x{n} (RMAT scale {ELASTIC_SCALE})", pgsn,
                          "nccl", gpus[:n])
        del pgsn
    del pgs
    launches = {k: [a + b for a, b in zip(gloo["launches"][k],
                                          small["launches"][k])]
                for k in gloo["launches"]}
    return dict(launches_per_rank=launches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)  # progress survives a kill
    gpus = machine_gpus()  # phase 14's mesh spans them all
    print(f"machine: {len(gpus)} GPU(s) {gpus}; this process runs on the "
          "first")
    # one card for this process, whatever the machine has
    os.environ["CUDA_VISIBLE_DEVICES"] = gpus[0] if gpus else "0"

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: runs on one card, {torch.cuda.device_count()} "
              "are visible (set CUDA_VISIBLE_DEVICES)", file=sys.stderr)
        return 1
    from repro_torch.graph import partition_graph, rmat_graph

    t_start = time.perf_counter()
    built = phase_device_and_build()

    t0 = time.perf_counter()
    g = rmat_graph(scale=args.scale, edge_factor=16, seed=args.seed,
                   weights="uniform")
    t_gen = time.perf_counter() - t0
    pg, rmap = partition_graph(g, SHARDS)
    torch.cuda.synchronize()
    t_part = time.perf_counter() - t0 - t_gen
    src = int(rmap.to_new(np.array([0]))[0])  # old id 0: RMAT's hub
    del rmap  # the graph stays, for phase 12's jobs
    print(f"main graph: RMAT scale {args.scale} ef 16 seed {args.seed}: "
          f"|V| {pg.n_vertices} |E| {pg.n_edges} P {pg.P} E_cap {pg.E_cap} "
          f"blocks {pg.n_blocks}x{pg.edge_block}; host preprocessing "
          f"{t_gen + t_part:.1f} s (generate {t_gen:.1f} s, partition and "
          f"copy to the device {t_part:.1f} s)")

    kernels = phase_kernels(pg, args.seed)
    phase_small(args.seed)
    launches = phase_main(pg, src)
    modes = phase_modes(pg, args.seed)
    phase_recovery(pg, modes["hashmin_steps"])
    phase_elastic(args.seed)
    phase_prefix(pg, args.seed)
    # the dense path, and a late Hash-Min superstep: a small frontier
    from repro_torch.core import HashMin, PageRank

    phase_profile(pg, "pagerank", PageRank(10), 2)
    phase_profile(pg, "hashmin", HashMin(), 4)
    recoded_peak = max(r["peak_gib"] for r in modes["rows"]
                       if r["run"].startswith("recoded "))
    streamed = phase_streamed(pg, modes["ref"], recoded_peak)
    phase_streamed_small(args.seed, streamed["signature"])
    procs = phase_processes(g, args.seed)
    phase_sockets(g, procs["files"])
    mesh = phase_mesh(g, pg, src, args.seed, gpus, built["power"])
    for name, k in kernels.items():
        k["launches"] = launches[name]
        k["mesh_launches_per_rank"] = mesh["launches_per_rank"][name]
    print(f"total {time.perf_counter() - t_start:.1f} s; card {built['power']}")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
