#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # RMAT scale 24, 8 shards
    python3 chip_smoke.py --scale 12      # a quick run

Phases, each of which ends the run non-zero on a failure:

1. the card's name and power limit, then the kernels' build from the sources
   in this checkout (``nvcc`` for the CUDA kernel; Triton compiles at its
   first launch, timed here too);
2. each kernel against its plain PyTorch version on the card, at the shapes
   of one ring round of the graph below (edge_combine: float sum within
   rtol 1e-5 / atol 1e-6, everything else exact; digest: exact), with times
   and the least time the card could take for the same work;
3. a small graph run through the port on the card, against a numpy PageRank
   oracle, a numpy BFS, numpy oracles of the two combiner-less programs
   (``basic`` mode) and the port's plain backend on the CPU;
4. the main path: RMAT (edge factor 16, uniform weights) in 8 shards,
   PageRank (10 supersteps), Hash-Min, SSSP and BFS to quiescence, with the
   ``kernel`` backend and then the ``torch`` backend; the two must agree
   (PageRank within 1e-5 of its largest value and within rtol 1e-4 at
   every vertex, the rest exactly, superstep by superstep);
5. the other in-memory modes (``basic``, ``basic_sc``, ``recoded_compact``)
   on the same partition: PageRank (5 supersteps) and Hash-Min against the
   ``recoded`` torch run, and DistinctInLabels / SecondMinLabel under
   ``basic`` against numpy on a sample of destinations, each with its ms
   per superstep, edges/s and peak device memory;
6. recovery on the same partition: PageRank and Hash-Min with a
   checkpointer and a message log, one shard recovered from the log against
   the live run, and a run resumed from the checkpoint against the
   uninterrupted one;
7. repartitioning 8 -> 6 -> 8 shards and topology mutation on a smaller RMAT
   graph (scale 20, as the host work of rebuilding a partition grows with
   |E|), against the run that was not rescaled;
8. the skip() prefix: the flat scan against the row-wise one it replaced;
9. two supersteps of the main path under ``torch.profiler``: PageRank's
   third (dense) and Hash-Min's fifth (a small frontier), each with its
   ten costliest device ops, the prefix's scan, and the card's idle share;
10. the out-of-core ``streamed`` mode at the main partition's full width:
    its edge groups spilled from the card to a store on disk (in a
    ``.chip_smoke-streamed-*`` directory of the checkout, removed at the
    end), then PageRank (5 supersteps) and Hash-Min to quiescence,
    unpipelined at the default chunks and through the full-duplex channel
    at 256-block chunks, a semi-external Hash-Min, and PageRank unpipelined
    at 256-block chunks, each against phase 5's
    ``recoded`` run (Hash-Min exactly, PageRank within 1e-5 of its largest
    value), with its ms and edges/s, blocks and bytes read a superstep, the
    reader's wait, its peak device memory over what was allocated before
    (under 1.5 GiB and a third of ``recoded``'s peak) and the planner's
    memory model; no edge tensor of the streamed partition is on the card;
11. the streamed paths whose host work grows fastest, on RMAT scale 20:
    Hash-Min over a compressed store and through the compressed channel,
    DistinctInLabels and SecondMinLabel through the message spill and
    external merge (against numpy), a ``GraphDJob`` whose memory budget
    forces ``streamed`` (against the in-memory run), and a checkpoint and
    run-file-log drill (one shard recovered; a checkpoint refused against
    another store).

It prints the launch counts of the ``kernel`` run, and the per-kernel JSON
line and the device line last. It needs a CUDA device and the CUDA toolkit,
and runs on one card (``CUDA_VISIBLE_DEVICES`` defaults to 0).
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
ELASTIC_SCALE = 20


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
    return dict(edge_combine=ec, digest=dg)


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
    plain = run_algorithms(pg, src, "torch")
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


def phase_modes(pg, seed: int) -> dict:
    """basic, basic_sc and recoded_compact (torch backend) against the
    recoded torch run: PageRank (5 supersteps) and Hash-Min to halt, then
    the combiner-less programs under basic on a sample of destinations."""
    import torch
    from repro_torch.core import EngineConfig, GraphDEngine, HashMin, PageRank
    from repro_torch.kernels.digest import digest
    from repro_torch.kernels.edge_combine import edge_combine

    edge_combine.launches = digest.launches = 0
    rows, ref, gaps = [], {}, {}
    for mode in ("recoded", "basic", "basic_sc", "recoded_compact"):
        for name, prog in (("pagerank", lambda: PageRank(5)),
                           ("hashmin", HashMin)):
            if mode == "recoded_compact" and name == "hashmin":
                continue  # int messages: the bf16 wire would round labels
            eng = GraphDEngine(pg, prog(), EngineConfig(mode=mode,
                                                        backend="torch"))
            (v, a), hist, row = timed_run(eng, f"{mode} {name}")
            rows.append(row)
            steps = [(h.n_active, h.n_msgs) for h in hist]
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
    if name == "pagerank":
        return check_pagerank(v, rv, f"{what}: pagerank")
    check(torch.equal(v, rv), f"{what}: values differ from recoded")
    return 0.0


def phase_streamed(pg, ref: dict, recoded_peak_gib: float) -> dict:
    """mode='streamed' at the main partition's full width: its edge groups
    spilled to a store in a directory of this checkout (removed after),
    then PageRank (5 supersteps) and Hash-Min to its halt, unpipelined and
    through the full-duplex channel at the default StreamConfig, and again
    through the channel at 256-block chunks; a semi-external Hash-Min whose
    hot-block cache holds some blocks, and both unpipelined at 256-block
    chunks; each against phase 5's recoded run."""
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
        progs = (("pagerank", lambda: PageRank(5)), ("hashmin", HashMin))
        # at the default 8-block chunks the reader's cost a chunk (~65,700
        # chunks a dense superstep) hides everything else, the channel
        # included: the channel runs again at 256-block chunks, as do the
        # semi-external run and both programs unpipelined
        big = StreamConfig(chunk_blocks=256)
        # the hot cache holds about a tenth of a shard's blocks
        cache = store.nonempty_blocks() // pg.n_shards // 10 \
            * store.block_bytes()
        runs = [(f"{label} {name}", prog, cfg)
                for label, cfg in (
                    ("unpipelined", EngineConfig(mode="streamed")),
                    ("full-duplex", EngineConfig(
                        mode="streamed", channel=ChannelConfig(pipeline=True))),
                    ("full-duplex chunk_blocks=256", EngineConfig(
                        mode="streamed", stream=big,
                        channel=ChannelConfig(pipeline=True))))
                for name, prog in progs]
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)  # progress survives a kill
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")  # one card

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
    del g, rmap
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
    for name, k in kernels.items():
        k["launches"] = launches[name]
    print(f"total {time.perf_counter() - t_start:.1f} s; card {built['power']}")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
