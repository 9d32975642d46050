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
   oracle, a numpy BFS and the port's plain backend on the CPU;
4. the main path: RMAT (edge factor 16, uniform weights) in 8 shards,
   PageRank (10 supersteps), Hash-Min, SSSP and BFS to quiescence, with the
   ``kernel`` backend and then the ``torch`` backend; the two must agree
   (PageRank within 1e-5 of its largest value and within rtol 1e-4 at
   every vertex, the rest exactly, superstep by superstep);
5. two supersteps of the main path under ``torch.profiler``: PageRank's
   third (dense) and Hash-Min's fifth (a small frontier), each with its
   ten costliest device ops and the card's idle share.

It prints the launch counts of the ``kernel`` run, and the per-kernel JSON
line and the device line last. It needs a CUDA device and the CUDA toolkit,
and runs on one card (``CUDA_VISIBLE_DEVICES`` defaults to 0).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
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
SHARDS = 8


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
    return dict(wall_ms=wall_ms, busy_ms=busy, idle=1 - busy / wall_ms)


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
    # the dense path, and a late Hash-Min superstep: a small frontier
    from repro_torch.core import HashMin, PageRank

    phase_profile(pg, "pagerank", PageRank(10), 2)
    phase_profile(pg, "hashmin", HashMin(), 4)
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
