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
   could take for the same work (run_sum's: its bytes, or its longest
   run's chain of adds), and beside run_sum ``index_add_`` unordered and
   under deterministic algorithms, whose bits are held to the CPU's;
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
    end), then PageRank unpipelined at the default chunks (1 superstep),
    PageRank (2 supersteps) and Hash-Min (to quiescence) at 256-block
    chunks, unpipelined and through the full-duplex channel, and a
    semi-external Hash-Min, each against a ``recoded``
    run (Hash-Min exactly, PageRank within 1e-5 of its largest value),
    with its ms and edges/s, blocks and bytes read a superstep, the
    reader's wait, its peak device memory over what was allocated before
    (under 1.5 GiB and a third of ``recoded``'s peak), its ordered float
    folds a superstep (``run_sum`` launches) and the planner's memory
    model; no edge tensor of the streamed partition is on the card; then
    one fold call at each chunk size's stager batch (131,072 and 524,288
    slots), the ordered fold on the card equal to the CPU's bit for bit,
    timed against the same fold through ``index_add_``;
11. the streamed paths whose host work grows fastest, on RMAT scale 19:
    Hash-Min over a compressed store and through the compressed channel,
    DistinctInLabels and SecondMinLabel through the message spill and
    external merge (against numpy), a ``GraphDJob`` whose memory budget
    forces ``streamed`` (against the in-memory run), and a checkpoint and
    run-file-log drill (one shard recovered; a checkpoint refused against
    another store);
12. ``GraphDJob(launch="processes")`` on RMAT scale 19 (the main graph's
    partition and spill took a minute a job): one worker process a shard,
    each on the card, over the shared-filesystem transport,
    Hash-Min to quiescence and PageRank (3 supersteps) at 256-block chunks,
    each against the threads launch of the same job (Hash-Min exactly,
    PageRank within 1e-6 of its largest value; superstep stats, bitmaps
    and halt step exactly), with ms a superstep for both, each worker's
    start to its first heartbeat and first arrival, peak host RSS and
    device memory (polled from ``/proc`` and ``nvidia-smi`` while the job
    runs) beside the planned per-process bytes; then the kill -9 drill on
    the same graph (Hash-Min with checkpoints and message logs, shard 3
    killed in superstep 2, respawned alone, equal to an undisturbed
    processes run);
13. the same two jobs over the socket transport
    (``launch_opts={"transport": "sockets"}``: 8 worker processes and a
    coordinator process, messages over loopback TCP), each against phase
    12's file-transport run of the same plan (Hash-Min, its bitmaps,
    superstep stats and halt step exactly, PageRank within 1e-6 of its
    largest value), with ms a superstep beside the files run's, each
    worker's start to its first arrival, the bytes on the wire a superstep
    and the coordinator process's resident set; then an undisturbed
    sockets run and the two socket drills, each against phase 12's
    undisturbed run: a worker killed with a frame half on the wire
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
    partition's shape (``launch/dryrun.py``; NCCL stages none through the
    host) and its launches (n edge_combine and n-1 digest a superstep on
    the kernel backend, run_sum on the torch backend's float sums), with
    ms a superstep past the first against the emulated run's, start-up,
    the first GPU's memory and a rank's peak allocation beside the dry-run
    model's; under NCCL with two or more GPUs the ring alone
    (``launch.mesh.time_ring``: n-1 rounds of P·8 bytes, the median of 7
    reps between CUDA events on each rank), its rate, and the model's
    collective term at that rate beside the measured PageRank superstep;
    then, on the small graph (scale 19), gloo
    with 8 ranks (and NCCL with one rank a GPU where there are two or
    more): logged PageRank (6 supersteps) with a message log and a
    checkpoint every 4, the same resumed from its checkpoint, Hash-Min
    over the ring and logged, DistinctInLabels and SecondMinLabel under
    ``basic``, each bit-identical to the emulated run, the files the ranks
    wrote equal to the emulated run's, and shard 3 recovered in this
    process from the mesh's files, held to phase 6's bars;
15. the dry-run GraphD cell (``launch/dryrun.py``, host arithmetic): the
    paper's clueweb and webuk at n = 256 and 512, ``recoded`` and the
    C1-C3 variants, at phase 14's link rate (no collective term on a
    one-GPU machine); the model's resident bytes equal to the main
    partition's tensors and ``dst_order``, and its HBM term for the
    emulated 8-shard PageRank superstep at or below phase 9's measured one;
    then the reference's 80 LM cells (ten archs x four shapes x the 256-
    and 512-GPU meshes, ``run_cell``): 66 priced and the reference's 14
    declared skips, a line each, and those past the card's 80 GB;
16. LM serving (``repro_torch.serving``, no kernel of its own): (a) one
    pattern group of gemma3-12b (5 local layers, 1 global) at full width
    with the real vocab in float32, a prefill of 16 tokens and 4 decode
    steps (B = 2) on the card against the same weights on the CPU, within
    1e-4 of the largest |logit|; (b) gemma3-12b at full width and a
    quarter of its depth (12 of its 48 layers, ``LM_KIND_GROUPS``, bf16
    weights from ``--seed``) serving 4 requests of
    1,100-token prompts (past the 1,024 window, not a multiple of it) and
    32 tokens each: two greedy runs with identical tokens, each decode
    step's logits against ``forward`` over the same tokens (the bf16 gap
    printed; the same depth, width and tokens in float32 held within 1e-4
    of the largest |logit|), prefill and decode times beside their bounds
    (``launch/roofline.py``'s counts), peak device memory beside the dry
    run's one-GPU cell at this shape, whose argument bytes must be the
    weights, caches and tokens on the card (17(b) the same, Whisper
    excepted);
17. LM serving, the other layer kinds (MLA and MoE: deepseek-v2-lite-16b;
    Mamba2: mamba2-2.7b; the hybrid: hymba-1.5b; the encoder-decoder:
    whisper-large-v3; cross layers: llama-3.2-vision-90b): (a) each at full
    width with the real vocab (the VLM at ``.reduced()``), one pattern
    group plus the prologue (Whisper: 1 decoder and 1 encoder layer over
    its 1,500 frames), in float32: a prefill of 16 tokens and 4 decode
    steps (B = 2) on the card against the CPU within 1e-4 of the largest
    |logit|; (b) each in bf16 at full width and an eighth of its depth
    (``LM_KIND_GROUPS``: 4 of deepseek's 27 layers, 8 of mamba2's 64, 8
    of hymba's 32, 4 + 4 of Whisper's 32 + 32; the VLM at 1 of its 20
    pattern groups) serving 4 requests of 1,100-token prompts (Whisper:
    64 tokens, its 448-position self-cache and 1,500 frames; the VLM 1,600
    patches), 32 tokens each: two greedy runs with identical tokens, the
    tokens changed by other media, the bf16 gap of decode to ``forward``
    printed, a float32 run at the same width (the same depth under 40 GB
    of weights, else the most pattern groups under it) with decode within
    1e-4 of the largest |logit| of ``forward`` (MoE: prefill against
    ``forward`` over the prompt, whose expert capacity is the same),
    prefill and decode times beside their bounds, peak device memory;
18. LM training (``repro_torch.training``, no kernel of its own): (a)
    minitron-4b, deepseek-v2-lite-16b (MLA and the MoE dispatch) and
    mamba2-2.7b (the SSD chunk scan) at full width with the real vocab, one
    pattern group plus the prologue, in float32 with remat (B = 2, S = 16):
    the loss, grad_norm and every gradient leaf on the card within 1e-4 of
    the same weights' on the CPU (of the largest |g| of the leaf); (b)
    minitron-4b at full width, 4 of its 32 layers (``LM_TRAIN_GROUPS``,
    bf16 weights from ``--seed``, remat on) taking 5 AdamW steps on one
    batch of 2,048
    tokens: the loss finite and falling, the parameter count the config's
    and the final norm's, a second run from the same seed with the same
    loss and weight bits, ms a step (the median of steps 2-5 between CUDA
    events) and tokens/s beside a bound (``lm_train_flops``: bf16
    operations at the dense bf16 rate, float32 ones, the attention logits
    and the ``unembed``, at the float32 rate, the optimizer's bytes at the
    HBM rate; ``launch/roofline.py``'s counts), one step profiled, peak
    device memory beside the dry run's one-GPU cell, whose argument bytes
    must be the weights, moments, step and batch on the card;
19. the LM train step on a (data, model) process mesh
    (``launch/lm_mesh.py::run_train_mesh``, no kernel of its own): (a)
    gloo ×8 sharing this card as a (2, 4) mesh, minitron-4b at full width
    (bf16, remat, the first ``LM_MESH_GROUPS`` of its 32 layers) taking one
    AdamW step on 2 × 1,024 tokens, against the same step in this process:
    the loss within 1e-3 and every weight within 1e-2 (the reference's
    bars, tests/test_distributed.py:168-172), the step run twice from the
    same state on every rank with the same bits; (b) one layer at full
    width in float32 the same way: every gradient leaf within 1e-5 of its
    largest |g| and the loss within rtol 1e-6 of this process's; (c) NCCL
    ×1 at (1, 1), held to (a)'s bars. For each rank: its resident bytes,
    which must equal the dry run's argument bytes a GPU at (2, 4)
    (``run_cell``), its bytes handed to the backend a mesh axis beside the
    cell's collective bytes (a ratio, not a gate), its peak allocation, step
    seconds and start-up; (d) on (a)'s spawn, every other layer kind at
    full width and one pattern group (``with_groups(1)``), bf16, one AdamW
    step each against the same step in this process under (a)'s bars:
    deepseek-v2-lite-16b (its dense MLA prologue and one MLA/MoE layer, 64
    experts top 6 over 'model' with the global capacity, 2 shared) and
    mamba2-2.7b on 2 × 1,024 tokens, whisper-large-v3 (1 encoder and 1
    decoder layer) on 2 × 448 tokens and 1,500 frames; each MoE layer's
    dropped copies within ``LM_MESH_DROP_SLACK`` of this process's, every
    rank's resident bytes the dry run's; and deepseek's group in float32,
    its gradients within 1e-5 of a leaf's largest |g| of the same pass on
    this process's CPU (this process's pass on the card parts from the
    CPU's by more than the mesh does, ``tools/lm_mesh_f32.py``) and its
    dropped copies equal. For each MoE layer (``_moe_routing``) the mesh's
    drops equal the global capacity's over its own expert loads, a
    capacity of each data rank's tokens would drop another count on this
    process's routing, and the tokens whose routing parts, with their
    router margins, are printed.

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
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM, NVIDIA's data sheet: HBM rate, and float32 outside the tensor
# cores (the sheet gives no int32 vector rate; float32's stands in for it)
from repro_torch.launch.roofline import (  # noqa: E402
    F32_FLOPS_PER_S, HBM_BYTES_PER_S, edge_combine_work,
)

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
RING_REPS = 7  # phase 14's timed reps of the NCCL ring alone


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
    by_ops = ops / F32_FLOPS_PER_S * 1e3
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


def sm_clock_mhz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0])


def phase_run_sum(pg, seed: int) -> dict:
    """run_sum, the torch backend's ordered float sum, on one dense ring
    round of PageRank on ``pg`` (every slot of every group, in the
    partition's marked destination order, row-local keys, as
    ``_combine_scatter`` calls it): on the card against its plain version
    on the CPU, bit for bit, and against its plain version on the card
    (``index_add_``'s atomics: rtol 1e-5 / atol 1e-6), with times, the
    longest run (a hub's chain of dependent adds) and the bound: the larger
    of its bytes over HBM's rate (a value and the order's entry a position,
    a key a run, as the marked call reads them, and the sums written) and
    the longest run's chain of adds (4 cycles each at the card's highest SM
    clock). ``flat_bytes_ms`` is the bytes of the same sums over flat int64
    keys read a position (16 B a position, 4 B a slot), for comparison with
    that form. Beside it, ``index_add_`` of the same sums, unordered and
    under ``torch.use_deterministic_algorithms`` (whose bits are checked
    against the CPU's)."""
    import torch
    from repro_torch.kernels.run_sum import run_sum, run_sum_plain

    msg, dp, _, order = dense_round(pg, seed)
    n, P = pg.n_shards, pg.P
    n_out = n * P

    def call():
        return run_sum(dp, msg, n_out, order, stride=P, marked=True)

    got = call()
    card_plain = run_sum_plain(dp, msg, n_out, order, stride=P, marked=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cpu = run_sum_plain(dp.cpu(), msg.cpu(), n_out, order.cpu(), stride=P,
                        marked=True)
    cpu_s = time.perf_counter() - t0
    check(torch.equal(got.cpu().view(torch.int32), cpu.view(torch.int32)),
          "run_sum: the card's sums differ from the CPU's in their bits")
    check(torch.allclose(got, card_plain, rtol=SUM_RTOL, atol=SUM_ATOL),
          f"run_sum: differs from its plain version on the card beyond rtol "
          f"{SUM_RTOL}")
    err = max_abs_err(got, card_plain)
    flat = torch.where(dp >= 0, dp.long() + torch.arange(
        n, device=pg.device)[:, None] * P, -1).reshape(-1)
    M = flat.numel()
    live = flat >= 0
    longest = int(torch.bincount(flat[live], minlength=n_out).max())
    lib_key, lib_msg = flat[live], msg.reshape(-1)[live]
    out = torch.zeros(n_out, device=pg.device)

    def library():  # the same sums, unordered
        out.zero_()
        out.index_add_(0, lib_key, lib_msg)

    torch.use_deterministic_algorithms(True)
    try:
        library()
        det_bits = torch.equal(out.cpu().view(torch.int32),
                               cpu.view(torch.int32))
        det_ms = time_ms(library)
    finally:
        torch.use_deterministic_algorithms(False)
    # a value and the order's entry read a position, a key read a run (at
    # its marked first position), the sums written a slot, an add a
    # position; and the longest run's chain of dependent adds, 4 cycles each
    runs = int((order < 0).sum())
    nbytes = ((msg.element_size() + order.element_size()) * M
              + dp.element_size() * runs + 4 * n_out)
    clock = sm_clock_mhz()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flat_bytes_ms = (16 * M + 4 * n_out) / HBM_BYTES_PER_S * 1e3
    chain_ms = longest * 4 / (clock * 1e6) * 1e3
    bound_ms, bound_by = bound(nbytes, M)
    if chain_ms > bound_ms:
        bound_ms, bound_by = chain_ms, "operations"
    row = dict(positions=M, slots=n_out, runs=runs, longest_run=longest,
               max_abs_err=err, ms=time_ms(call),
               launch_ms=host_launch_ms(call),
               plain_ms=time_ms(lambda: run_sum_plain(
                   dp, msg, n_out, order, stride=P, marked=True)),
               library_ms=time_ms(library),
               deterministic_index_add_ms=det_ms,
               deterministic_index_add_equals_cpu=det_bits,
               bytes_ms=bytes_ms, flat_bytes_ms=flat_bytes_ms,
               chain_ms=chain_ms, sm_clock_mhz=clock,
               bound_ms=bound_ms, bound_by=bound_by, cpu_plain_s=cpu_s)
    print("run_sum " + json.dumps(row))
    print(f"run_sum: equal to the CPU's plain version bit for bit over "
          f"{M} positions ({int(live.sum())} messages, the padding skipped;"
          f" the longest run {longest}); within rtol "
          f"{SUM_RTOL} of index_add_ on the card; index_add_ under "
          f"deterministic algorithms "
          f"{'equals' if det_bits else 'differs from'} the CPU's bits")
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
    A, cnt = _combine_scatter(prog, pg.P, msg, dp, aact, order, marked=True)
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


def device_ops(prof, what: str) -> tuple[list, dict, float]:
    """Of a ``torch.profiler`` trace: its device events (failing where
    there are none), ``{op name: (count, total us)}`` and the ms the device
    was busy (the union of the events' intervals)."""
    from torch.autograd import DeviceType

    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(bool(dev), f"{what}: the trace holds no device events")
    ops = {}
    for e in dev:
        c, t = ops.get(e.name, (0, 0.0))
        ops[e.name] = (c + 1, t + (e.time_range.end - e.time_range.start))
    return dev, ops, _busy_ms([(e.time_range.start, e.time_range.end)
                               for e in dev])


def phase_profile(pg, name: str, program, steps_before: int,
                  top: int = 10) -> dict:
    """Superstep ``steps_before`` of ``program`` on the main path (kernel
    backend) under ``torch.profiler``: the ``top`` device ops by total time,
    each with its count, and the share of the superstep's wall time the
    card was idle."""
    import torch
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
    dev, ops, busy = device_ops(prof, "profile")
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
    from repro_torch.kernels.run_sum import run_sum

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sums = run_sum.launches
    t0 = time.perf_counter()
    out, hist = eng.run(**kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    steps = len(hist)
    sums = (run_sum.launches - sums) / steps
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
        ordered_sums_per_superstep=sums,
        model=model,
    )
    print(f"streamed {label}: {steps} supersteps, "
          f"{row['ms_per_superstep']:.3f} ms per superstep, edges/s "
          f"{row['edges_per_s']:.4g} nominal (|E| a superstep), "
          f"{row['staged_edges_per_s']:.4g} staged; a superstep: "
          f"{row['blocks_per_superstep']:.1f} blocks and "
          f"{row['bytes_per_superstep']:.6g} bytes read off disk, "
          f"{row['cache_hits_per_superstep']:.1f} cache hits, "
          f"{row['chunks_per_superstep']:.1f} chunks, {sums:.1f} ordered "
          f"float folds (run_sum launches); reader wait "
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
    if name.startswith("pagerank"):
        return check_pagerank(v, rv, f"{what}: pagerank")
    check(torch.equal(v, rv), f"{what}: values differ from recoded")
    return 0.0


def fold_cost(pg, slots: int, seed: int = 0) -> dict:
    """One streamed fold call at the main partition's width: the first
    ``slots`` edge slots of group (0, 1), what the fold stager hands a
    multi-chunk group's first staged batch, PageRank with every vertex
    active. StreamKernels.fold (the ordered sum: one stable sort, then
    run_sum accumulating) on the card, equal bit for bit to the same fold
    on the CPU; its device ms against the same fold through index_add_
    (the unordered atomics it replaced) and the bound of the fold's
    function, whatever its design: sp a slot, dp a message, each named
    source's flag and each active one's value and degree, A and cnt read
    and written at each distinct destination. The sort is the ordered
    design's overhead, outside the bound."""
    import torch
    from repro_torch.core import PageRank
    from repro_torch.core.engine import StreamKernels, _gen_messages

    prog = PageRank(1)
    kern = StreamKernels(prog, pg.n_shards, pg.n_vertices, pg.P)
    sp, dp, w = (getattr(pg, f)[0, 1, :slots].contiguous()
                 for f in ("src_pos", "dst_pos", "eweight"))
    gen = torch.Generator(device=pg.device).manual_seed(seed)
    values = torch.rand(pg.P, generator=gen, device=pg.device)
    args = (values, pg.degree[0], pg.vmask[0], sp, dp, w, 1)

    def fresh(dev):
        return (torch.zeros(pg.P, device=dev),
                torch.zeros(pg.P, dtype=torch.int32, device=dev))

    A, cnt = fresh(pg.device)
    kern.fold(A, cnt, *args)
    Ac, cc = fresh("cpu")
    kern.fold(Ac, cc, *(a.cpu() if torch.is_tensor(a) else a for a in args))
    torch.cuda.synchronize()
    check(torch.equal(A.cpu().view(torch.int32), Ac.view(torch.int32))
          and torch.equal(cnt.cpu(), cc),
          f"fold of {slots} slots: the card's sums differ from the CPU's")
    idx = dp.long()

    def unordered():
        msg, aact = _gen_messages(prog, values[None], pg.degree[0][None],
                                  sp[None], w[None], pg.vmask[0][None], 1)
        A.index_add_(0, idx, msg[0])
        cnt.index_add_(0, idx, aact[0].to(torch.int32))

    named = sp >= 0
    live = named & pg.vmask[0][sp.clamp(min=0).long()]
    msgs = int(live.sum())
    srcs = torch.unique(sp[named])
    act_srcs = int(pg.vmask[0][srcs.long()].sum())
    dests = int(torch.unique(dp[live]).numel())
    bound_ms, bound_by = bound(4 * slots + 4 * msgs + int(srcs.numel())
                               + 8 * act_srcs + 16 * dests, 3 * msgs)
    row = dict(slots=slots, messages=msgs, destinations=dests,
               ordered_ms=time_ms(lambda: kern.fold(A, cnt, *args)),
               index_add_ms=time_ms(unordered), bound_ms=bound_ms,
               bound_by=bound_by)
    print("fold " + json.dumps(row))
    return row


def phase_streamed(pg, ref: dict, recoded_peak_gib: float) -> dict:
    """mode='streamed' at the main partition's full width: its edge groups
    spilled to a store in a directory of this checkout (removed after),
    then PageRank (1 superstep), unpipelined at the default StreamConfig,
    and
    PageRank (2) and Hash-Min through the channel at 256-block chunks; a
    semi-external Hash-Min whose hot-block cache holds some blocks, and
    both unpipelined at 256-block chunks; each against a recoded run as
    deep (phase 5's for Hash-Min)."""
    from repro_torch.core import (
        ChannelConfig, EngineConfig, GraphDEngine, HashMin, PageRank,
        StreamConfig,
    )
    from repro_torch.core.plan import fold_stager_slots
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
        progs = (("pagerank2", lambda: PageRank(2)), ("hashmin", HashMin))
        # at the default 8-block chunks the reader's cost a chunk (~65,700
        # chunks a dense superstep) hides everything else, the channel
        # included: the channel runs at 256-block chunks, as do the
        # semi-external run and both programs unpipelined. There PageRank
        # alone runs, unpipelined and 1 superstep (~15-20 s; its ordered
        # fold is what the chunk size changes), and PageRank 2 at
        # 256-block chunks, each held to a recoded run as deep, to leave
        # phases 12-15 room in the smoke's time
        short = (("pagerank1", lambda: PageRank(1)),)
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
        # the ordered fold's cost: a call's device ms against index_add_'s
        # at each chunk size's stager batch, times its calls a superstep
        dflt = StreamConfig()
        for cb in (dflt.chunk_blocks, 256):
            slots = min(pg.E_cap, fold_stager_slots(cb, dflt.group_batch,
                                                    pg.edge_block))
            f = fold_cost(pg, slots)
            for row in rows:
                if "pagerank" not in row["run"] or (
                        ("chunk_blocks=256" in row["run"]) != (cb == 256)):
                    continue
                extra = row["ordered_sums_per_superstep"] * (
                    f["ordered_ms"] - f["index_add_ms"])
                print(f"streamed {row['run']}: "
                      f"{row['ordered_sums_per_superstep']:.1f} ordered "
                      f"folds a superstep at ~{f['ordered_ms']:.4f} ms "
                      f"against index_add_'s {f['index_add_ms']:.4f} ms a "
                      f"{slots}-slot call: ~{extra:.3f} ms of device time "
                      f"over the unordered fold, "
                      f"{extra / row['ms_per_superstep']:.5f} of its "
                      f"{row['ms_per_superstep']:.3f} ms superstep")
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


def phase_processes(seed: int) -> dict:
    """GraphDJob(launch="processes") on RMAT scale ELASTIC_SCALE (the main
    graph's partition and spill cost a minute a job, more than the smoke's
    time limit leaves): one worker process a shard on the card, Hash-Min
    to its halt and PageRank (3 supersteps) at 256-block chunks, each
    against the threads launch of the same job (its engine: the call
    GraphDJob.run makes under launch="threads", on the same spilled store
    and plan); then the kill -9 drill on the same graph: Hash-Min with
    checkpoints and message logs, shard 3 killed in superstep 2, against
    an undisturbed processes run. Returns the figures, and under
    ``"files"`` what phase 13 holds its socket runs to: each run's
    superstep stats, ms, values and bitmap (on the host), and the graph."""
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
    g = rmat_graph(scale=ELASTIC_SCALE, edge_factor=16, seed=seed,
                   weights="uniform")
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
            print(f"{label}: RMAT scale {ELASTIC_SCALE}, {SHARDS} worker "
                  f"processes, {n} supersteps; "
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
        p = procs_plan(HashMin(), g)
        runs = {}
        for label, opts in (("undisturbed", None),
                            ("drill", {"kill": {"shard": 3, "step": 2}})):
            job = GraphDJob(HashMin(), g, plan=p, checkpoint_every=2,
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
        files["graph"] = g
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


def phase_sockets(files: dict) -> dict:
    """Phase 12's two jobs over the socket transport, 8 worker processes
    and one coordinator process, each against phase 12's file-transport
    run of the same plan (kept in memory: this phase runs no threads job);
    then, on the same graph, an undisturbed sockets run and the two socket
    drills against phase 12's undisturbed run."""
    import torch
    from repro_torch.core import HashMin, PageRank

    out = {}
    g = files["graph"]
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
            print(f"{label}: RMAT scale {ELASTIC_SCALE}, {SHARDS} worker "
                  f"processes and a coordinator process, {n} supersteps; "
                  f"set-up (partition and spill) "
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
        # undisturbed, then the two drills
        ref = files["undisturbed"]
        runs = {}
        for label, opts in (
                ("undisturbed", None),
                ("kill_net", {"kill_net": {"shard": 1, "step": 2,
                                           "after_frames": 1}}),
                ("coord_kill", {"coord_kill": {"step": 1,
                                               "after_arrivals": 1}})):
            what = f"sockets drill {label}"
            res, (v, a), secs, audit, rep = _socket_job(
                HashMin(), g, os.path.join(root, f"drill-{label}"), what,
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


def case_bytes(case: str, pg, backend: str) -> dict:
    """What a rank of an n-rank mesh hands its backend a superstep in a
    phase-14 case (``<program>-<mode>-...`` or ``<program>-logged...``):
    the byte model of ``repro_torch.launch.dryrun.superstep_bytes`` from
    the partition's shape, PageRank's 4-byte aggregator gathered, every
    byte staged through the host under gloo on the card."""
    from repro_torch.launch.dryrun import superstep_bytes

    mode = "logged" if "-logged" in case else case.split("-")[1]
    return superstep_bytes(mode, pg.n_shards, pg.P, pg.E_cap,
                           gather=4 if case.startswith("pagerank") else 0,
                           staged=backend == "gloo")


def check_mesh_case(what: str, case: str, cfg, res, v, a, hist, pg,
                    backend: str, launches: dict) -> float:
    """One mesh case against the emulated run of the same partition on the
    card: superstep stats, halt step and bitmaps exactly; the torch
    backend's values and the integer programs' bit for bit, the kernel
    backend's PageRank by ``check_pagerank`` (edge_combine's float atomics
    are unordered); each rank's bytes against :func:`case_bytes` and its
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
    want = {k: b * steps for k, b in case_bytes(case, pg, backend).items()}
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
                   wide: bool, ring_reps: int = 0) -> dict:
    """Every case of :func:`mesh_cases` on one mesh of ``pg.n_shards``
    ranks, each held by :func:`check_mesh_case` against the emulated run
    of the same partition on the card. Prints ms a superstep past the
    first (the slowest rank's) against the emulated run's, start-up, the
    first GPU's memory and a rank's peak allocation (a PageRank case's
    beside the dry-run model's). With ``ring_reps``, the ring alone (``launch.mesh.time_ring``):
    its rate, and the model's collective term at that rate beside the
    measured PageRank superstep (the ring's share of it)."""
    import torch
    from repro_torch.core import GraphDEngine
    from repro_torch.launch.dryrun import run_graphd_cell
    from repro_torch.launch.mesh import run_mesh_cases

    n = pg.n_shards
    cases = mesh_cases(src, wide)
    root = tempfile.mkdtemp(prefix=".chip_smoke-mesh-", dir=ROOT)
    try:
        with CardMemory(gpus[0]) as mem:
            run = run_mesh_cases(pg, [(make(), cfg) for _, make, cfg in cases],
                                 backend=backend, device="cuda", gpus=gpus,
                                 workdir=root, timeout=600,
                                 ring_reps=ring_reps)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {k: [0] * n for k in ("edge_combine", "digest", "run_sum")}
    past = {}
    for (case, make, cfg), res in zip(cases, run.results):
        what = f"mesh {label} {case}"
        past[case] = _past_ms(res.history)
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
              f"each rank handed its backend {case_bytes(case, pg, backend)}"
              " bytes a superstep, equal to the byte model; "
              + (f"pagerank gap over its largest value {gap:.4g}, and "
                 f"{twin:.4g} between two emulated runs" if twin is not None
                 else "equal to the emulated run bit for bit")
              + (f"; a rank's peak allocated "
                 f"{max(r['peak_bytes'] for r in res.ranks)} bytes, the "
                 "dry-run model's "
                 f"{run_graphd_cell(mode=cfg.mode, pg=pg, backend=cfg.backend)['peak_bytes']}"
                 if case.startswith("pagerank") else ""))
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
    rate = None
    if run.ring:
        ms = max(statistics.median(r["ms"]) for r in run.ring)
        nbytes = run.ring[0]["bytes"]
        check(all(r["bytes"] == nbytes == (n - 1) * pg.P * 8
                  for r in run.ring),
              f"mesh {label}: the timed ring moved {run.ring} bytes")
        rate = nbytes / (ms / 1e3)
        model = run_graphd_cell(pg=pg, link_bytes_per_s=rate)
        coll_ms = model["t_collective_s"] * 1e3
        pr = past["pagerank-recoded-kernel"]
        print(f"mesh {label} ring alone: {n - 1} rounds of ring_shift, "
              f"{nbytes} bytes a rank, median of {len(run.ring[0]['ms'])} "
              f"reps {ms:.4f} ms on the slowest rank: {rate:.6g} bytes/s a "
              f"rank; the dry-run model's collective term at that rate "
              f"{coll_ms:.4f} ms ({model['collective_bytes_per_chip']} "
              f"bytes), its HBM term {model['t_memory_s'] * 1e3:.4f} ms, "
              f"against the measured PageRank superstep {pr:.3f} ms: the "
              f"ring's share {coll_ms / pr:.4f}")
    return dict(launches=launches, run=run, link_bytes_per_s=rate)


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
                  f"{case_bytes(case, pg, backend)} bytes a superstep"
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
    nccl = run_mesh_phase(label, pgn, srcn, "nccl", gpus[:n], wide=True,
                          ring_reps=RING_REPS if n >= 2 else 0)
    if nccl["link_bytes_per_s"] is None:
        print("mesh: no link rate was measured (the ring needs two GPUs); "
              "the dry-run records carry no collective term")
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
    return dict(launches_per_rank=launches,
                link_bytes_per_s=nccl["link_bytes_per_s"])


# --------------------------------------------------------------------------
# phase 15: the dry-run cell
# --------------------------------------------------------------------------

def dryrun_records(link_bytes_per_s) -> None:
    """Table 1's clueweb and webuk at n = 256 and 512, ``recoded`` and the
    reference's C1-C3 variants, each record's line (clueweb's base records
    in full), the collective term at ``link_bytes_per_s`` where given;
    each must fit the card's memory. Then the reference's 80 LM cells (ten
    archs x four shapes x both meshes): each priced, or the reference's
    declared skip, a line each, and the cells past the card's 80 GB."""
    from repro_torch.configs import ARCHS, SHAPES, cell_supported
    from repro_torch.launch.dryrun import (
        cell_line, run_cell, run_graphd_cell, summary,
    )

    variants = (("", "recoded", 4096), ("C1", "recoded_compact", 4096),
                ("C2", "recoded", 16384), ("C3", "recoded_compact", 16384))
    for scale in ("clueweb", "webuk"):
        for multi in (False, True):
            for tag, mode, block in variants:
                rec = run_graphd_cell(multi, scale, mode, block, tag,
                                      link_bytes_per_s=link_bytes_per_s)
                check(rec["fits"], f"dry run: {summary(rec)} does not fit")
                if not tag and scale == "clueweb":
                    print("dryrun " + json.dumps(rec))
                print("dry run: " + summary(rec))
    t0 = time.perf_counter()
    counts, big = {"ok": 0, "skipped": 0}, []
    for multi in (False, True):
        for arch in ARCHS:
            for shape in SHAPES:
                rec = run_cell(arch, shape, multi,
                               link_bytes_per_s=link_bytes_per_s)
                supported = cell_supported(arch, shape)[0]
                check(rec["ok"] == supported and rec.get("skipped",
                                                         False) != supported,
                      f"dry run: {cell_line(rec)}")
                counts["ok" if rec["ok"] else "skipped"] += 1
                if rec["ok"] and not rec["fits"]:
                    big.append(f"{arch} x {shape} on {rec['mesh']}")
                print("dry run LM: " + cell_line(rec))
    check(counts == {"ok": 66, "skipped": 14},
          f"dry run: LM cells {counts}, the reference's 66 ok and 14 skips")
    print(f"dry run LM: {counts['ok']} cells priced, {counts['skipped']} "
          f"declared skips in {time.perf_counter() - t0:.2f} s; past the "
          f"card's 80 GB: {', '.join(big) if big else 'none'}")


def phase_dryrun(pg, profile: dict, link_bytes_per_s, power: str) -> None:
    """The dry-run GraphD cell (``launch/dryrun.py``), host arithmetic:
    Table 1's clueweb and webuk at n = 256 and 512, ``recoded`` and the
    reference's C1-C3 variants (the compact wire, 16384-slot blocks,
    both), the collective term at the link rate phase 14 measured (none
    on a one-GPU machine). Then the model against this card: its resident
    bytes equal the main partition's tensors (dst_order too, built by the
    torch backend's runs), and its HBM term for the emulated n-shard
    superstep (n ranks' bytes on one card) is at or below phase 9's
    measured PageRank superstep."""
    from repro_torch.launch.dryrun import (
        partition_tensor_bytes, resident_bytes, run_graphd_cell,
    )

    t0 = time.perf_counter()
    rate = (f"{link_bytes_per_s:.6g} bytes/s (phase 14's NCCL ring)"
            if link_bytes_per_s else "none measured (one GPU)")
    print(f"dry run: {power}; link rate {rate}")
    dryrun_records(link_bytes_per_s)
    n, rows = pg.n_shards, pg.n_rows
    got = partition_tensor_bytes(pg)
    model = resident_bytes(n, pg.P, pg.E_cap, pg.n_blocks, dst_order=True)
    check(got["partition"] == rows * model["partition"],
          f"dry run: the partition holds {got['partition']} bytes, the "
          f"model says {rows} x {model['partition']}")
    check(got["dst_order"] == rows * model["dst_order"] > 0,
          f"dry run: dst_order holds {got['dst_order']} bytes, the model "
          f"says {rows} x {model['dst_order']}")
    rec = run_graphd_cell(pg=pg)
    emulated_ms = n * rec["t_memory_s"] * 1e3
    check(emulated_ms <= profile["wall_ms"],
          f"dry run: the model's HBM term for {n} emulated shards, "
          f"{emulated_ms:.4f} ms, exceeds the measured PageRank superstep "
          f"{profile['wall_ms']:.3f} ms")
    print(f"dry run: the main partition's {got['partition']} bytes of "
          f"tensors and {got['dst_order']} of dst_order equal the model's "
          f"{rows} x {model['partition']} and {rows} x {model['dst_order']};"
          f" its HBM term for the emulated {n}-shard PageRank superstep "
          f"({n} x {rec['bytes_per_chip']} bytes at the H100's 3.35e12 "
          f"bytes/s) {emulated_ms:.4f} ms against phase 9's measured "
          f"{profile['wall_ms']:.3f} ms wall ({profile['busy_ms']:.3f} ms "
          f"of device work): {emulated_ms / profile['wall_ms']:.4f} of the "
          f"wall, {emulated_ms / profile['busy_ms']:.4f} of the device "
          f"work; {time.perf_counter() - t0:.2f} s")


# --------------------------------------------------------------------------
# phases 16 and 17: LM serving
# --------------------------------------------------------------------------

LM_ARCH = "gemma3-12b"  # phase 16
LM_F32_BAR = 1e-4  # the card against the CPU, of the largest |logit|
LM_BATCH, LM_PROMPT, LM_GEN = 4, 1100, 32  # the prompt passes the window

#: phase 17's archs: MLA + MoE, Mamba2, the hybrid, the encoder-decoder
#: and the VLM's cross layers
LM_KIND_ARCHS = ("deepseek-v2-lite-16b", "mamba2-2.7b", "hymba-1.5b",
                 "whisper-large-v3", "llama-3.2-vision-90b")
LM_VLM = "llama-3.2-vision-90b"
LM_VLM_GROUPS = 1  # 17(b): 5 of its 100 layers; 87.7 B do not fit a card
#: 16(b)'s and 17(b)'s depth an arch, in pattern groups, cut for phase
#: 19's time: gemma3 at a quarter (12 of 48 layers), the kinds at an
#: eighth (4 of deepseek's 27 layers, 8 of mamba2's 64, 4 + 4 of
#: Whisper's 32 + 32, 5 of the VLM's 100), hymba at one group (8 of 32)
LM_KIND_GROUPS = {LM_ARCH: 2, "deepseek-v2-lite-16b": 3, "mamba2-2.7b": 8,
                  "hymba-1.5b": 1, "whisper-large-v3": 4,
                  LM_VLM: LM_VLM_GROUPS}
LM_WHISPER_PROMPT = 64
LM_WHISPER_MAX_LEN = 448  # the decoder's context: its self-cache length
LM_F32_WEIGHT_LIMIT = 40e9  # 17(b)'s float32 check: weight bytes under this
#: why an arch's bf16 decode-against-forward gap is printed and not held,
#: where it was measured
LM_BF16_NOTE = {LM_ARCH: ": bf16 rounding alone moves this model's logits "
                         "0.27-0.34 from float32's, tools/lm_precision.py"}


def lm_logits(model, tokens, S: int, dec: int, device, media=None,
              max_len: int | None = None, drops: list | None = None) -> list:
    """The logits of a prefill over ``tokens[:, :S]`` (and ``media``) and
    of ``dec`` decode steps fed ``tokens[:, S:S + dec]``, on fresh caches
    of ``max_len`` positions (``S + dec`` by default). With ``drops``, each
    call's MoE drop fractions (one a MoE layer) are appended."""
    import torch

    from repro_torch.serving.cache import make_caches
    from repro_torch.serving.engine import decode_step, prefill

    def step(logits):
        if drops is not None:
            drops.append(torch.stack([d for _, d in model.moe_stats()]))
        return logits

    caches = make_caches(model.cfg, tokens.shape[0], max_len or S + dec,
                         device=device)
    out = [step(prefill(model, tokens[:, :S], caches, media))]
    for p in range(S, S + dec):
        out.append(step(decode_step(model, caches, tokens[:, p:p + 1], p)))
    return out


def drop_counts(drops: list, B: int, S: int, topk: int) -> list:
    """``lm_logits``'s drop fractions as the copies they stand for, a list
    a call (the prefill's B·S·k copies, then a decode step's B·k) of one
    count a MoE layer."""
    return [[round(float(d) * B * (S if i == 0 else 1) * topk) for d in call]
            for i, call in enumerate(drops)]


def moved_media(media):
    """The other media of the media check: ``media * 3 + 1``."""
    return media * 3 + 1


def profile_decode_step(model, caches, token, pos: int, top: int = 8) -> dict:
    """One decode step under ``torch.profiler``: its host wall time, the
    device's busy time and idle share, its device ops (launches) and the
    ``top`` of them by total time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import decode_step

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode_step(model, caches, token, pos)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev, ops, busy = device_ops(prof, "LM profile")
    rows = sorted(ops.items(), key=lambda kv: -kv[1][1])[:top]
    return dict(wall_ms=wall_ms, busy_ms=busy, idle=1 - busy / wall_ms,
                device_ops=len(dev),
                top=[(op[:90], c, dt / 1e3) for op, (c, dt) in rows])


def tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def one_gpu_prefill_cell(cfg, B: int, S: int, max_len: int,
                         weight_bytes: int, c_bytes: int, inputs: list):
    """The dry run's prefill cell at mesh (1, 1) and the smoke's own shape
    (B x S, caches of ``max_len``): its ``argument_bytes`` must be the
    weights, caches and ``inputs`` (tokens, media) on the card. None for
    Whisper, whose reference prefill holds 448 decoder tokens, not the
    smoke's prompt."""
    from repro_torch.launch.dryrun import run_cell

    if cfg.family == "audio":
        return None
    cell = run_cell(cfg.name, f"prefill_{S}", cfg=cfg, mesh_shape=(1, 1),
                    shape_info=dict(seq_len=S, global_batch=B,
                                    kind="prefill", cache_len=max_len))
    held = weight_bytes + c_bytes + tensor_bytes(inputs)
    check(cell["argument_bytes"] == held,
          f"LM {cfg.name}: the dry run's one-GPU cell prices "
          f"{cell['argument_bytes']} bytes of arguments, the weights, caches "
          f"and inputs on the card are {held}")
    return cell


def weight_bytes_f32(cfg) -> int:
    from repro_torch.models.transformer import param_shapes

    return 4 * sum(int(np.prod(s)) for s in param_shapes(cfg).values())


def phase_lm_group(label: str, archs, seed: int, power: str) -> None:
    """16(a) and 17(a): each arch at full width with the real vocab (the
    VLM at ``.reduced()``: one group at its width is 25.5 GB of float32
    host memory), the depth cut to one pattern group plus the prologue
    (Whisper: 1 decoder and 1 encoder layer, its 1,500 frames), in float32,
    TF32 off: a prefill of 16 tokens and 4 decode steps (B = 2) on the card
    against the same weights and media on the CPU, within 1e-4 of the
    largest |logit|; for a MoE arch, each call's dropped copies equal layer
    by layer too: the same function runs on both sides."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.models.transformer import Transformer, init_params

    check(not torch.backends.cuda.matmul.allow_tf32,
          f"LM {label}: TF32 is on for float32 matmuls")
    for arch in archs:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        cfg = cfg.reduced() if arch == LM_VLM else cfg.with_groups(1)
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
        card = init_params(cfg, seed, "cuda")
        host = Transformer(cfg, {k: v.cpu() for k, v in
                                 card.state_dict().items()})
        batch = synthetic_batch(cfg, 0, 20, 2, device="cpu")
        toks, media = batch["tokens"], batch.get("media")
        moe = cfg.n_experts > 0
        gdrop, wdrop = ([], []) if moe else (None, None)
        got = torch.stack(lm_logits(
            card, toks.cuda(), 16, 4, "cuda",
            None if media is None else media.cuda(), drops=gdrop)).cpu()
        want = torch.stack(lm_logits(host, toks, 16, 4, "cpu", media,
                                     drops=wdrop))
        del card, host
        torch.cuda.empty_cache()
        err, top = max_abs_err(got, want), float(want.abs().max())
        check(bool(torch.isfinite(got).all()),
              f"LM {label} {arch}: non-finite logits")
        if moe:
            gcount = drop_counts(gdrop, 2, 16, cfg.topk)
            wcount = drop_counts(wdrop, 2, 16, cfg.topk)
        drops = ("" if not moe else
                 f"; MoE dropped copies a call and layer: card {gcount}, "
                 f"CPU {wcount}")
        print(f"LM {label}: {cfg.name} ({cfg.n_layers} layers"
              + (f" + {cfg.n_enc_layers} encoder" if cfg.n_enc_layers else "")
              + f", d_model {cfg.d_model}, vocab {cfg.vocab}"
              + (f", {media.shape[1]} media" if media is not None else "")
              + f") float32, B 2, prompt 16 + 4 decode steps: card against "
              f"CPU max |diff| {err:.6g} of max |logit| {top:.6g} "
              f"({err / top:.3g}, bar {LM_F32_BAR:g}){drops}; "
              f"{time.perf_counter() - t0:.1f} s; card {power}")
        check(err <= LM_F32_BAR * top,
              f"LM {label} {arch}: card against CPU {err:.6g} > {LM_F32_BAR} "
              f"x {top:.6g}")
        if moe:
            check(gcount == wcount,
                  f"LM {label} {arch}: the card's MoE layers dropped other "
                  f"copies than the CPU's: {gcount} against {wcount}")


def _f32_cut(cfg, limit: float | None):
    """The serving check's float32 config: ``cfg``'s depth when ``limit``
    is None or its weights are under ``limit`` bytes, else the most whole
    pattern groups under it."""
    import dataclasses

    import torch

    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    if limit is None or weight_bytes_f32(f32) < limit:
        return f32, f"its depth ({cfg.n_layers} layers)"
    k = max(g for g in range(1, cfg.n_pattern_groups)
            if weight_bytes_f32(f32.with_groups(g)) < limit)
    cut = f32.with_groups(k)
    return cut, (f"{k} of {cfg.n_pattern_groups} pattern groups "
                 f"({cut.n_layers} layers; {weight_bytes_f32(f32)} float32 "
                 f"bytes at its depth)")


def phase_lm_serve(label: str, arch: str, seed: int, power: str,
                   f32_limit: float | None = LM_F32_WEIGHT_LIMIT) -> dict:
    """16(b) and 17(b) for one arch at full width in bf16 (weights drawn
    from ``seed``; 17(b) at ``LM_KIND_GROUPS``' depth): 4 requests of
    1,100-token prompts, past a 1,024 window and not a multiple of it
    (Whisper: 64 tokens, a 448-position self-cache and 1,500 frames; the
    VLM: 1,600 patches), 32 tokens each. Two greedy runs with identical tokens, then a
    prefill and 31 decode steps between CUDA events (the same tokens
    again), the times beside their bounds, one decode step profiled, and
    the decode's logits against ``forward`` over the same tokens (printed
    in bf16); for a media arch, the tokens under other media differ. Then
    the float32 check at the same width (``_f32_cut``'s depth under
    ``f32_limit``): decode against ``forward`` within 1e-4 of the largest
    |logit|, or for MoE prefill against ``forward`` over the prompt
    (decode's gap and drop fraction printed)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.launch.roofline import (
        lm_prefill_bound_ms, lm_prefill_flops, lm_weight_bytes,
    )
    from repro_torch.models.transformer import init_params, uses_media
    from repro_torch.serving.cache import cache_bytes, make_caches
    from repro_torch.serving.engine import decode_step, greedy_generate, prefill

    t0 = time.perf_counter()
    cfg = get_config(arch)
    if arch in LM_KIND_GROUPS:
        cfg = cfg.with_groups(LM_KIND_GROUPS[arch])
    whisper = cfg.n_enc_layers > 0
    B, G = LM_BATCH, LM_GEN
    S = LM_WHISPER_PROMPT if whisper else LM_PROMPT
    max_len = LM_WHISPER_MAX_LEN if whisper else S + G
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, seed, "cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    batch = synthetic_batch(cfg, 0, S, B, device="cuda")
    prompt, media = batch["tokens"], batch.get("media")
    check((media is not None) == uses_media(cfg), f"LM {arch}: media")
    n_media = 0 if media is None else media.shape[1]

    runs = []
    for _ in range(2):
        caches = make_caches(cfg, B, max_len, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        runs.append(greedy_generate(model, prompt, caches, G, media=media))
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t1
    check(torch.equal(runs[0], runs[1]), f"LM {arch}: two greedy runs differ")
    tokens = runs[0]
    c_bytes = cache_bytes(caches)
    moved = None
    if media is not None:
        caches = make_caches(cfg, B, max_len, device="cuda")
        other = greedy_generate(model, prompt, caches, G,
                                media=moved_media(media))
        moved = int((other != tokens).sum())
        check(moved > 0, f"LM {arch}: the tokens do not change with the media")

    # the same loop between CUDA events, keeping each step's logits
    caches = make_caches(cfg, B, max_len, device="cuda")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(G + 1)]
    ev[0].record()
    logits = [prefill(model, prompt, caches, media)]
    ev[1].record()
    picked = [logits[0].argmax(-1, keepdim=True).to(torch.int32)]
    for i in range(1, G):
        logits.append(decode_step(model, caches, picked[-1], S + i - 1))
        ev[i + 1].record()
        picked.append(logits[-1].argmax(-1, keepdim=True).to(torch.int32))
    torch.cuda.synchronize()
    prefill_ms = ev[0].elapsed_time(ev[1])
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(1, G)]
    check(torch.equal(torch.cat(picked, 1), tokens),
          f"LM {arch}: the timed loop's tokens differ from greedy_generate's")
    prof = profile_decode_step(model, caches, picked[-1], S + G - 1)
    dec = torch.stack(logits, 1)  # (B, G, vocab)
    del logits
    full = torch.cat([prompt, tokens[:, :-1]], 1)  # (B, S + G - 1)
    fwd = model(full, media)[:, S - 1:]
    check(bool(torch.isfinite(dec).all()) and bool(torch.isfinite(fwd).all()),
          f"LM {arch}: non-finite logits")
    gap, top = max_abs_err(dec, fwd), float(fwd.abs().max())
    peak = torch.cuda.max_memory_allocated()
    del fwd, dec, model, caches
    torch.cuda.empty_cache()

    # the float32 check at the same width
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg32, cut = _f32_cut(cfg, f32_limit)
    model32 = init_params(cfg32, seed, "cuda")
    media32 = None if media is None else media.float()
    moe = cfg.n_experts > 0
    drop32 = [] if moe else None
    dec32 = torch.stack(lm_logits(model32, full, S, G - 1, "cuda", media32,
                                  max_len, drop32), 1)
    fwd32 = model32(full, media32)[:, S - 1:]
    gap32, top32 = max_abs_err(dec32, fwd32), float(fwd32.abs().max())
    if moe:  # prefill against forward over the prompt alone: the same T
        pre = model32(prompt, media32)[:, -1]
        held, held_top = max_abs_err(dec32[:, 0], pre), float(pre.abs().max())
        drop_dec = float(torch.stack(drop32[1:]).mean())
        del pre
    else:
        held, held_top, drop_dec = gap32, top32, None
    peak32 = torch.cuda.max_memory_allocated()
    del model32, dec32, fwd32
    torch.cuda.empty_cache()
    f32_s = time.perf_counter() - t1

    median_ms = statistics.median(step_ms)
    decode_bound_ms = (weight_bytes + c_bytes) / HBM_BYTES_PER_S * 1e3
    check(weight_bytes == lm_weight_bytes(cfg),
          f"LM {arch}: {weight_bytes} weight bytes on the card, the config's "
          f"shapes and dtypes make {lm_weight_bytes(cfg)}")
    flops = lm_prefill_flops(cfg, B, S, n_media)
    prefill_bound_ms = lm_prefill_bound_ms(cfg, B, S, n_media)
    cell = one_gpu_prefill_cell(cfg, B, S, max_len, weight_bytes, c_bytes,
                                [prompt] + ([] if media is None else [media]))
    out = dict(
        arch=cfg.name, layers=cfg.n_layers, enc_layers=cfg.n_enc_layers,
        prompt=S, media=n_media, params=n_params, weight_bytes=weight_bytes,
        cache_bytes=c_bytes, prefill_ms=prefill_ms,
        prefill_tok_s=B * S / prefill_ms * 1e3, decode_ms=median_ms,
        decode_tok_s=B / median_ms * 1e3, decode_ms_min=min(step_ms),
        decode_ms_max=max(step_ms), greedy_s=gen_s,
        decode_bound_ms=decode_bound_ms, prefill_bound_ms=prefill_bound_ms,
        prefill_flops=flops, peak_bytes=peak, base_bytes=base,
        dryrun_argument_bytes=cell and cell["argument_bytes"],
        dryrun_peak_bytes_model=cell and cell["peak_bytes_model"],
        tokens_moved_by_media=moved, bf16_gap=gap, bf16_max_logit=top,
        f32_cut=cut, f32_gap=gap32, f32_max_logit=top32, f32_held=held,
        f32_held_max_logit=held_top, f32_decode_drop=drop_dec,
        f32_peak_bytes=peak32, f32_seconds=f32_s, profile=prof, init_s=t_init,
        seconds=time.perf_counter() - t0)
    print(f"LM {label} " + json.dumps(out))
    print(f"LM {label}: {cfg.name} {cfg.n_layers} layers"
          + (f" + {cfg.n_enc_layers} encoder" if whisper else "")
          + f" bf16, {n_params} parameters, weights {weight_bytes} bytes, "
          f"caches {c_bytes} bytes (B {B}, {S} + {G} positions"
          + (f", {n_media} media" if n_media else "")
          + f"); two greedy runs identical ({gen_s:.3f} s the second, "
          f"{B * G / gen_s:.1f} tok/s)"
          + (f", {moved} of {B * G} tokens changed with the media"
             if moved is not None else "")
          + f"; prefill {prefill_ms:.3f} ms ({B * S / prefill_ms * 1e3:.0f} "
          f"tok/s) against a bound of {prefill_bound_ms:.3f} ms ({flops:.6g} "
          f"operations at the data sheet's dense bf16 rate); decode "
          f"{median_ms:.3f} ms a token, median of {G - 1} (min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}; "
          f"{B / median_ms * 1e3:.1f} tok/s) against a bound of "
          f"{decode_bound_ms:.3f} ms (weight and cache bytes at 3.35e12 "
          f"bytes/s); one decode step profiled: {prof['device_ops']} device "
          f"ops, device busy {prof['busy_ms']:.3f} ms of "
          f"{prof['wall_ms']:.3f} ms (idle {prof['idle']:.4f}); peak device "
          f"memory {peak} bytes ({base} before)"
          + (f", the dry run's one-GPU cell {cell['argument_bytes']} bytes "
             f"of arguments (the weights, caches, tokens"
             f"{' and media' if media is not None else ''} on the card), "
             f"peak_bytes_model {cell['peak_bytes_model']}" if cell else
             ", no dry-run cell (the reference's Whisper prefill holds 448 "
             "decoder tokens)")
          + f"; weights drawn in {t_init:.1f} s; card {power}")
    for op, count, ms in prof["top"]:
        print(f"LM profile:   {ms:8.3f} ms  x{count:4d}  {op}")
    what = ("prefill against forward over the prompt (the same tokens, so "
            "the same expert capacity)" if moe else "decode against forward")
    print(f"LM {label}: {cfg.name} decode against forward, bf16 max |diff| "
          f"{gap:.6g} (max |logit| {top:.6g}; printed, not held"
          f"{LM_BF16_NOTE.get(arch, '')}); float32 at {cut}: {what} max "
          f"|diff| {held:.6g} of max |logit| {held_top:.6g} "
          f"({held / held_top:.3g}, bar {LM_F32_BAR:g})"
          + (f"; decode against forward {gap32:.6g} of {top32:.6g} "
             f"(printed: a decode step's expert capacity is 1), decode drop "
             f"fraction {drop_dec:.4f}" if moe else "")
          + f" (peak device memory {peak32} bytes, {f32_s:.1f} s); "
          f"{out['seconds']:.1f} s; card {power}")
    check(held <= LM_F32_BAR * held_top,
          f"LM {arch}: float32 {what} {held:.6g} > {LM_F32_BAR} x "
          f"{held_top:.6g}")
    return out


def phase_lm(seed: int, power: str) -> dict:
    """Phase 16: gemma3-12b, 16(a) and 16(b) (at ``LM_KIND_GROUPS``'
    depth); its float32 check runs at that depth (no weight limit), and
    its parameters must be the config's count and the final norm's."""
    from repro_torch.configs import get_config

    phase_lm_group("16(a)", (LM_ARCH,), seed, power)
    out = phase_lm_serve("16(b)", LM_ARCH, seed, power, f32_limit=None)
    cfg = get_config(LM_ARCH).with_groups(LM_KIND_GROUPS[LM_ARCH])
    # the analytic count leaves out the final norm's d_model
    check(out["params"] == cfg.n_params() + cfg.d_model,
          f"LM: {out['params']} parameters, the config counts "
          f"{cfg.n_params()} and the final norm's {cfg.d_model}")
    return out


def phase_lm_kinds(seed: int, power: str) -> list:
    """Phase 17: 17(a), then 17(b) arch by arch, each model freed before
    the next."""
    import torch

    t0 = time.perf_counter()
    phase_lm_group("17(a)", LM_KIND_ARCHS, seed, power)
    out = []
    for arch in LM_KIND_ARCHS:
        out.append(phase_lm_serve("17(b)", arch, seed, power))
        torch.cuda.empty_cache()
    print(f"LM phase 17: {time.perf_counter() - t0:.1f} s; card {power}")
    return out


# --------------------------------------------------------------------------
# phase 18: LM training
# --------------------------------------------------------------------------

LM_TRAIN_ARCH = "minitron-4b"  # 18(b), the reference's training example
#: 18(a)'s archs: dense GQA, MLA with the MoE dispatch, the SSD scan
LM_TRAIN_GROUP_ARCHS = ("minitron-4b", "deepseek-v2-lite-16b", "mamba2-2.7b")
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 1, 2048, 5
#: 18(b)'s depth: minitron-4b's first 4 of 32 layers, cut for phase 19's
#: time
LM_TRAIN_GROUPS = 4


def lm_train_opt():
    """The reference's ``test_smoke_loss_decreases`` schedule."""
    from repro_torch.training.optimizer import AdamWConfig

    return AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=30)


def phase_lm_train_group(seed: int, power: str) -> None:
    """18(a): each arch's one pattern group plus the prologue at full width
    with the real vocab, float32, remat as the config has it (on), TF32
    off: ``compute_grads`` over B = 2, S = 16 on the card and over the same
    weights and tokens on the CPU; the loss and grad_norm within rtol 1e-4,
    every gradient leaf within 1e-4 of its largest |g| on the CPU. Host
    memory: the CPU's weights and gradients (13.5 GB for minitron's 1.68 B
    parameters), the card's gradients compared on the card a leaf at a
    time."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.models.transformer import Transformer, init_params
    from repro_torch.training.optimizer import global_norm
    from repro_torch.training.train import compute_grads

    check(not torch.backends.cuda.matmul.allow_tf32,
          "LM 18(a): TF32 is on for float32 matmuls")
    for arch in LM_TRAIN_GROUP_ARCHS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch).with_groups(1),
                                  dtype=torch.float32)
        card = init_params(cfg, seed, "cuda")
        host = Transformer(cfg, {k: v.cpu() for k, v in
                                 card.state_dict().items()})
        batch = synthetic_batch(cfg, 0, 16, 2, device="cpu")
        cgrads, cm = compute_grads(card, {k: v.cuda() for k, v in
                                          batch.items()})
        cgn = float(global_norm(cgrads))
        hgrads, hm = compute_grads(host, batch)
        hgn = float(global_norm(hgrads))
        del host
        worst, worst_leaf = 0.0, None
        for k in list(hgrads):
            want = hgrads.pop(k).cuda()
            gap = max_abs_err(cgrads.pop(k), want) / max(
                float(want.abs().max()), 1e-30)
            if gap > worst:
                worst, worst_leaf = gap, k
        del card, cgrads
        torch.cuda.empty_cache()
        closs, hloss = float(cm["loss"]), float(hm["loss"])
        print(f"LM 18(a): {cfg.name} ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, vocab {cfg.vocab}) float32, remat "
              f"{cfg.remat}, B 2, S 16: loss card {closs:.9g} CPU "
              f"{hloss:.9g}, grad_norm card {cgn:.9g} CPU {hgn:.9g}; worst "
              f"gradient leaf {worst_leaf} {worst:.3g} of its largest |g| "
              f"(bar {LM_F32_BAR:g}); {time.perf_counter() - t0:.1f} s; "
              f"card {power}")
        check(np.isfinite(closs) and abs(closs - hloss) <= LM_F32_BAR * abs(hloss),
              f"LM 18(a) {arch}: loss card {closs} CPU {hloss}")
        check(abs(cgn - hgn) <= LM_F32_BAR * hgn,
              f"LM 18(a) {arch}: grad_norm card {cgn} CPU {hgn}")
        check(worst <= LM_F32_BAR,
              f"LM 18(a) {arch}: {worst_leaf} card against CPU {worst:.3g}")


def _train_run(cfg, seed: int, batch: dict, steps: int) -> dict:
    """``steps`` steps from ``seed`` between CUDA events: the model, its
    state, each step's loss (host floats) and ms, the peak allocation."""
    import torch
    from repro_torch.models.transformer import init_params
    from repro_torch.training.train import init_train_state, make_train_step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, seed, "cuda")
    opt = init_train_state(cfg, model)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    step = make_train_step(cfg, lm_train_opt())
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    losses = []
    ev[0].record()
    for i in range(steps):
        model, opt, m = step(model, opt, batch)
        ev[i + 1].record()
        losses.append(m["loss"])
    torch.cuda.synchronize()
    return dict(model=model, opt=opt, step=step, init_s=t_init,
                losses=torch.stack(losses).cpu(),
                ms=[ev[i].elapsed_time(ev[i + 1]) for i in range(steps)],
                peak=torch.cuda.max_memory_allocated())


def profile_train_step(run: dict, batch: dict, top: int = 8) -> dict:
    """One more training step of ``run`` under ``torch.profiler``: host
    wall ms, device busy ms and idle share, device ops, the costliest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run["step"](run["model"], run["opt"], batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev, ops, busy = device_ops(prof, "LM 18(b) profile")
    rows = sorted(ops.items(), key=lambda kv: -kv[1][1])[:top]
    return dict(wall_ms=wall_ms, busy_ms=busy, idle=1 - busy / wall_ms,
                device_ops=len(dev),
                top=[(op[:90], c, dt / 1e3) for op, (c, dt) in rows])


def phase_lm_train(seed: int, power: str) -> dict:
    """Phase 18: 18(a), then 18(b), minitron-4b as its config has it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.roofline import (
        lm_optimizer_bytes, lm_train_bound_ms, lm_train_flops,
    )

    t_phase = time.perf_counter()
    phase_lm_train_group(seed, power)
    t0 = time.perf_counter()
    cfg = get_config(LM_TRAIN_ARCH).with_groups(LM_TRAIN_GROUPS)
    B, S, n = LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS
    batch = synthetic_batch(cfg, 0, S, B, device="cuda")
    first = _train_run(cfg, seed, batch, n)
    model = first["model"]
    n_params = sum(p.numel() for p in model.parameters())
    flops = lm_train_flops(cfg, B, S)
    opt_bytes = lm_optimizer_bytes(cfg)
    cell = run_cell(cfg.name, f"train_{S}", cfg=cfg, mesh_shape=(1, 1),
                    shape_info=dict(seq_len=S, global_batch=B, kind="train"))
    opt = first["opt"]
    held = tensor_bytes(list(model.parameters()) + list(opt["mu"].values())
                        + list(opt["nu"].values()) + [opt["step"]]
                        + list(batch.values()))
    check(cell["argument_bytes"] == held,
          f"LM 18(b): the dry run's one-GPU cell prices {cell['argument_bytes']}"
          f" bytes of arguments, the weights, moments, step and batch on the "
          f"card are {held}")
    del opt
    kept = [p.detach().cpu() for p in model.parameters()]
    del first["model"], first["opt"], first["step"], model
    torch.cuda.empty_cache()
    second = _train_run(cfg, seed, batch, n)
    same_loss = torch.equal(first["losses"], second["losses"])
    differ = [k for (k, p), q in zip(second["model"].named_parameters(), kept)
              if not torch.equal(p.detach().cpu(), q)]
    del kept
    prof = profile_train_step(second, batch)
    del second["model"], second["opt"], second["step"]
    torch.cuda.empty_cache()

    losses = first["losses"].tolist()
    median_ms = statistics.median(first["ms"][1:])
    bound = lm_train_bound_ms(cfg, B, S)
    bound_ms = sum(bound.values())
    out = dict(arch=cfg.name, layers=cfg.n_layers, params=n_params,
               batch=B, seq=S, steps=n, losses=losses,
               second_losses=second["losses"].tolist(), step_ms=first["ms"],
               second_step_ms=second["ms"], median_ms=median_ms,
               tok_s=B * S / median_ms * 1e3, bound_ms=bound_ms,
               bound_terms_ms=bound, flops=flops, optimizer_bytes=opt_bytes,
               peak_bytes=first["peak"], second_peak_bytes=second["peak"],
               dryrun_argument_bytes=cell["argument_bytes"],
               dryrun_peak_bytes_model=cell["peak_bytes_model"],
               init_s=first["init_s"], same_loss_bits=same_loss,
               leaves_differ=differ, profile=prof,
               seconds=time.perf_counter() - t0)
    print("LM 18(b) " + json.dumps(out))
    print(f"LM 18(b): {cfg.name} {cfg.n_layers} layers bf16, remat "
          f"{cfg.remat}, {n_params} parameters; {n} AdamW steps on B {B} x "
          f"S {S}: loss {' '.join(f'{x:.6f}' for x in losses)}; a step "
          f"{median_ms:.3f} ms, median of steps 2-{n} (all "
          f"{', '.join(f'{x:.1f}' for x in first['ms'])}), "
          f"{B * S / median_ms * 1e3:.0f} tok/s, against a bound of "
          f"{bound_ms:.3f} ms ({flops['low']:.6g} bf16 operations at "
          f"989e12/s {bound['low_ms']:.3f} ms + {flops['f32']:.6g} float32 "
          f"ones at 67e12/s {bound['f32_ms']:.3f} ms + {opt_bytes} optimizer "
          f"bytes at 3.35e12/s {bound['bytes_ms']:.3f} ms); one step "
          f"profiled: {prof['device_ops']} device ops, busy "
          f"{prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms (idle "
          f"{prof['idle']:.4f}); peak device memory {first['peak']} bytes "
          f"(the dry run's one-GPU cell: {cell['argument_bytes']} bytes of "
          f"arguments, the weights, moments, step and batch on the card; "
          f"peak_bytes_model {cell['peak_bytes_model']}); second run: same loss bits {same_loss}, {len(differ)} weight "
          f"leaves differ; weights drawn in {first['init_s']:.1f} s; "
          f"{out['seconds']:.1f} s; card {power}")
    for op, count, ms in prof["top"]:
        print(f"LM profile:   {ms:8.3f} ms  x{count:4d}  {op}")
    check(all(np.isfinite(losses)), f"LM 18(b): non-finite loss {losses}")
    check(losses[-1] < losses[0], f"LM 18(b): the loss did not fall {losses}")
    check(n_params == cfg.n_params() + cfg.d_model,
          f"LM 18(b): {n_params} parameters, the config counts "
          f"{cfg.n_params()} and the final norm's {cfg.d_model}")
    check(same_loss and not differ,
          f"LM 18(b): two runs from seed {seed} differ: losses "
          f"{losses} / {out['second_losses']}, leaves {differ[:8]}")
    print(f"LM phase 18: {time.perf_counter() - t_phase:.1f} s; card {power}")
    return out


# --------------------------------------------------------------------------
# phase 19: the LM train step on a (data, model) process mesh
# --------------------------------------------------------------------------

LM_MESH_SHAPE = (2, 4)
#: 19(a)'s depth: pattern groups (layers) of minitron-4b's 32
LM_MESH_GROUPS = 2
LM_MESH_BATCH, LM_MESH_SEQ = 2, 1024
#: the reference's bars for its sharded step (tests/test_distributed.py:168-172)
LM_MESH_LOSS_BAR, LM_MESH_PARAM_BAR = 1e-3, 1e-2
#: 19(b)'s float32 bars, tests/test_torch_train.py's: the loss (relative)
#: and each gradient leaf (of its largest |g|)
LM_F32_BAR_MESH, LM_MESH_GRAD_BAR = 1e-6, 1e-5
LM_MESH_TIMEOUT = 300.0
#: 19(d): every other layer kind at full width, one pattern group each
LM_MESH_KIND_ARCHS = ("deepseek-v2-lite-16b", "mamba2-2.7b",
                      "whisper-large-v3")
#: Whisper's decoder positions (the dry run's ``WHISPER_SELF_LEN``); its
#: batch carries its config's 1,500 frames
LM_MESH_WHISPER_SEQ = 448
#: 19(d)'s bf16 MoE drops: the mesh's count a layer within this share of
#: the layer's copies of this process's. The two round a layer's input
#: differently (float32 TP partials there, bf16 GEMMs here), so a token
#: whose k-th and (k+1)-th router probabilities nearly tie may route
#: otherwise and move the count (deepseek-v2-lite's group on an H100: 149
#: against 150 of 12,288). ``_moe_routing`` prints such tokens, and holds
#: the mesh's count exactly to the global capacity's over its own routing.
#: The float32 case holds the counts equal.
LM_MESH_DROP_SLACK = 1e-3


def _host(tensors) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors}


class _Routes:
    """Within the block, each call of the MoE router (``moe.route``) kept:
    ``calls`` its ``(probs, experts)`` a call, on the host."""

    def __enter__(self):
        import repro_torch.models.moe as moe

        self.calls, self._moe, self._route = [], moe, moe.route

        def route(logits, topk):
            probs, gate, eidx = self._route(logits, topk)
            self.calls.append((probs.detach().cpu(), eidx.detach().cpu()))
            return probs, gate, eidx

        moe.route = route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route

    def first_pass(self, cfg) -> list:
        """The forward's calls, a MoE layer each in stack order (a remat
        backward calls the router again after them)."""
        from repro_torch.models.transformer import layer_specs

        return self.calls[:sum(s.ffn == "moe" for s in layer_specs(cfg))]


def _one_process(cfg, seed: int, batch: dict, grads: bool) -> dict:
    """This process's run on the card from ``seed`` (the mesh's ranks draw
    the same weights from it): one AdamW step (its loss, the weights after
    it, host copies) or, with ``grads``, one gradient pass (its loss, the
    gradients); each MoE layer's dropped copies and routing."""
    import torch
    from repro_torch.models.transformer import init_params
    from repro_torch.training.train import (
        compute_grads, init_train_state, make_train_step,
    )

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, seed, "cuda")
    out = {}
    on_card = {k: v.cuda() for k, v in batch.items()}
    t0 = time.perf_counter()
    with _Routes() as routes:
        if grads:
            g, m = compute_grads(model, on_card)
            out["grads"] = _host(g.items())
            del g
        else:
            model, opt, m = make_train_step(cfg, lm_train_opt())(
                model, init_train_state(cfg, model), on_card)
            out["after"] = _host(model.named_parameters())
            del opt
        torch.cuda.synchronize()
    out.update(loss=float(m["loss"]), seconds=time.perf_counter() - t0,
               peak=torch.cuda.max_memory_allocated(),
               dropped=model.moe_dropped(), routes=routes.first_pass(cfg))
    del model, m, on_card
    torch.cuda.empty_cache()
    return out


def _cpu_grads(cfg, seed: int, batch: dict) -> dict:
    """``_one_process``'s gradient pass on this process's CPU, float32, the
    weights drawn on the card from ``seed`` (as the ranks draw them) and
    copied over: the loss, the gradients and each MoE layer's drops and
    routing."""
    import torch
    from repro_torch.models.transformer import Transformer, init_params
    from repro_torch.training.train import compute_grads

    model = init_params(cfg, seed, "cuda")
    host = {k: v.detach().cpu() for k, v in model.named_parameters()}
    del model
    torch.cuda.empty_cache()
    model = Transformer(cfg, host)
    t0 = time.perf_counter()
    with _Routes() as routes:
        g, m = compute_grads(model, batch)
    out = dict(grads={k: v.detach().clone() for k, v in g.items()},
               loss=float(m["loss"]), dropped=model.moe_dropped(),
               routes=routes.first_pass(cfg),
               seconds=time.perf_counter() - t0)
    del model, g, host
    return out


def _worst(got: dict, want: dict, relative: bool) -> tuple[float, str]:
    """The largest gap of a leaf of ``got`` to ``want`` (each over the
    leaf's largest |want| with ``relative``), compared on the card a leaf
    at a time, and its leaf."""
    worst, leaf = 0.0, None
    for k, w in want.items():
        w = w.cuda()
        gap = max_abs_err(got[k].cuda(), w)
        if relative:
            gap /= max(float(w.abs().max()), 1e-30)
        if gap > worst or leaf is None:
            worst, leaf = gap, k
    return worst, leaf


def _mesh_ranks(label: str, res, startup: list, cell: dict,
                power: str) -> None:
    """Each rank's line, and the resident bytes held to the dry run's
    argument bytes a GPU. A case of no steps reports its gradient pass's
    bytes and seconds (the step adds the norm's and the scales' scalars)."""
    coll = cell["collective_bytes_per_chip"]
    for r, rank in enumerate(res.ranks):
        steps = bool(rank["step_seconds"])
        b = rank["bytes"] if steps else rank["grads_bytes"]
        secs = rank["step_seconds"] or [rank["grads_seconds"]]
        cs = (rank["collective_seconds"] if steps
              else rank["grads_collective_seconds"])
        handed = b["data"] + b["model"] + b["world"]
        st = startup[r]
        print(f"LM 19{label} rank {r}: resident {rank['resident_bytes']} B "
              f"(the dry run's arguments a GPU {cell['argument_bytes']}); "
              f"to the backend: data {b['data']} B, model {b['model']} B, "
              f"world {b['world']} B, {handed} B in all against the cell's "
              f"{coll:.6g} collective bytes (ratio "
              f"{handed / coll if coll else float('nan'):.4g}; "
              f"{cell['collective_breakdown']}); staged {b['staged']} B; "
              f"in the collectives {cs['backend']:.3f} s in gloo, "
              f"{cs['staging']:.3f} s staging, {cs['wait']:.3f} s waiting "
              f"for the card; "
              f"peak {rank['peak_bytes']} B; "
              f"{'step' if rank['step_seconds'] else 'gradient pass'} "
              f"{', '.join(f'{x:.3f}' for x in secs)} s; "
              f"start-up {st['spawn_to_first_s']:.1f} s (interpreter and "
              f"imports {st['spawn_to_main_s']:.1f}, rendezvous "
              f"{st['rendezvous_s']:.1f}, weights drawn {rank['load_s']:.1f}"
              f"); outputs written in {rank['save_s']:.1f} s; "
              f"card {power}")
        check(rank["resident_bytes"] == cell["argument_bytes"],
              f"LM 19{label}: rank {r} holds {rank['resident_bytes']} bytes, "
              f"the dry run's cell {cell['argument_bytes']}")


def _kind_cases() -> list:
    """19(d)'s cases: ``(label, cfg, batch, grads)``, one bf16 step each of
    ``LM_MESH_KIND_ARCHS`` and deepseek's float32 gradients."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_batch

    out = []
    for arch in LM_MESH_KIND_ARCHS:
        full = get_config(arch)
        S = (LM_MESH_WHISPER_SEQ if full.family == "audio"
             else LM_MESH_SEQ)
        batch = synthetic_batch(full, 0, S, LM_MESH_BATCH, device="cpu")
        out.append((f"(d) {arch}", full.with_groups(1), batch, False))
        if full.n_experts:
            out.append((f"(d) {arch} float32",
                        dataclasses.replace(full.with_groups(1),
                                            dtype=torch.float32),
                        batch, True))
    return out


def _moe_routing(label: str, cfg, one: dict, m: dict, slack: int) -> None:
    """Each MoE layer's drops and routing on the mesh (``m``: its
    ``dropped`` and ``load``, the copies bound for each expert of the
    global batch) against this process's (``one``: its ``dropped`` and
    ``routes``). Checks: this process's count is the global capacity's
    over its routing; the mesh's count is the global capacity's over the
    mesh's own loads, exactly; and on this process's routing a capacity
    of each data rank's tokens drops another count, so a mesh that kept
    one would fail the check before (its gap to the global count printed
    beside ``slack``). Prints where the loads part and the tokens that
    explain it: a token whose k-th expert here has a copy fewer on the
    mesh and whose (k+1)-th has one more, with its router margin (the k-th
    probability less the (k+1)-th), and the batch's least margin."""
    import torch

    E, k, D = cfg.n_experts, cfg.topk, LM_MESH_SHAPE[0]
    for i, (probs, eidx) in enumerate(one["routes"]):
        T = eidx.shape[0]
        C = int(cfg.capacity_factor * k * T / E) + 1
        Tr = T // D  # the data ranks hold contiguous, equal rows
        Cr = int(cfg.capacity_factor * k * Tr / E) + 1
        here = torch.bincount(eidx.reshape(-1), minlength=E)
        mesh = torch.tensor(m["load"][i])
        ours = int((here - C).clamp(min=0).sum())
        own = int((mesh - C).clamp(min=0).sum())
        per_rank = sum(int((torch.bincount(
            eidx[r * Tr:(r + 1) * Tr].reshape(-1), minlength=E) - Cr)
            .clamp(min=0).sum()) for r in range(D))
        top = probs.sort(dim=-1, descending=True, stable=True)
        margin = top.values[:, k - 1] - top.values[:, k]
        diff = mesh - here
        moved = ((diff < 0)[top.indices[:, k - 1]]
                 & (diff > 0)[top.indices[:, k]]).nonzero()[:, 0]
        parts = {int(e): int(diff[e]) for e in diff.nonzero()[:, 0]}
        shown = ", ".join(
            f"token {int(t)}: expert {int(top.indices[t, k - 1])} -> "
            f"{int(top.indices[t, k])}, margin {float(margin[t]):.3g}"
            for t in moved[:4])
        print(f"LM 19{label} MoE layer {i}: C {C} of {T} tokens, dropped "
              f"{m['dropped'][i]} on the mesh ({own} over its loads at C), "
              f"{one['dropped'][i]} here ({ours} over this routing at C); "
              f"a capacity of each data rank's {Tr} tokens (C {Cr}) would "
              f"drop {per_rank} here (gap {per_rank - ours}, slack {slack}); "
              f"the mesh's loads less this process's {parts or 'none'}; "
              f"tokens that explain them {shown or 'none'}; the least "
              f"margin {float(margin.min()):.3g} (token "
              f"{int(margin.argmin())})")
        check(ours == one["dropped"][i],
              f"LM 19{label}: layer {i} here drops {one['dropped'][i]}, its "
              f"routing {ours} at C {C}")
        check(own == m["dropped"][i],
              f"LM 19{label}: layer {i} on the mesh drops "
              f"{m['dropped'][i]}, its loads {own} at C {C}")
        check(per_rank != ours,
              f"LM 19{label}: layer {i} drops {ours} at a data rank's "
              f"capacity too: the batch does not tell the two apart")


def _check_kind(label: str, cfg, batch: dict, grads: bool, res, one: dict,
                startup: list, power: str) -> None:
    """A 19(d) case against this process's run of it: the bf16 step's loss
    and weights, or the float32 gradients; each MoE layer's dropped copies;
    each rank's line and resident bytes (``_mesh_ranks``). The float32
    gradients are held to the pass on this process's CPU (``_cpu_grads``):
    this process's pass on the card parts from it by more than the mesh
    does (deepseek's expert bank on an H100: 1.64e-5 of its largest |g|
    against 3.95e-6 at (2, 4), ``tools/lm_mesh_f32.py``)."""
    from repro_torch.launch.dryrun import run_cell

    B, S = batch["tokens"].shape
    info = dict(kind="train", seq_len=S, global_batch=B)
    if "media" in batch:
        info["media_len"] = batch["media"].shape[1]
    cell = run_cell(cfg.name, "train", cfg=cfg, mesh_shape=LM_MESH_SHAPE,
                    shape_info=info)
    m = res.grads_metrics if grads else res.metrics[0]
    loss = m["loss"]
    gap, leaf = _worst(res.grads if grads else res.params,
                       one["grads" if grads else "after"], relative=grads)
    drops = m.get("dropped", [])
    media = (f", {batch['media'].shape[1]} frames" if "media" in batch
             else "")
    peak = "" if grads else f", peak {one['peak']} B"
    print(f"LM 19{label}: gloo x8, mesh {LM_MESH_SHAPE}, {cfg.name} "
          f"({cfg.n_layers} layers{f' + {cfg.n_enc_layers} encoder' if cfg.n_enc_layers else ''}, "
          f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, "
          f"vocab {cfg.vocab}, {cfg.n_params()} parameters) "
          f"{'float32 gradients' if grads else 'bf16 one step'}, B {B} x S "
          f"{S}{media}: loss {loss:.9g} against this process's "
          f"{one['loss']:.9g}{' on its CPU' if grads else ''} (gap "
          f"{abs(loss - one['loss']):.3g}); worst "
          f"{'gradient leaf' if grads else 'weight'} {leaf} {gap:.3g} "
          f"(bar {LM_MESH_GRAD_BAR if grads else LM_MESH_PARAM_BAR:g}); MoE "
          f"dropped copies a layer {drops} of {B * S * cfg.topk} (this "
          f"process {one['dropped']}); this process {one['seconds']:.3f} s"
          f"{peak}; card {power}")
    _mesh_ranks(label, res, startup, cell, power)
    if grads:
        check(abs(loss - one["loss"]) <= LM_F32_BAR_MESH * abs(one["loss"]),
              f"LM 19{label}: loss {loss} against {one['loss']}")
        check(gap <= LM_MESH_GRAD_BAR, f"LM 19{label}: {leaf} off by {gap}")
    else:
        check(np.isfinite(loss) and abs(loss - one["loss"]) < LM_MESH_LOSS_BAR,
              f"LM 19{label}: loss {loss} against {one['loss']}")
        check(gap < LM_MESH_PARAM_BAR, f"LM 19{label}: {leaf} off by {gap}")
    copies = B * S * cfg.topk
    slack = 0 if grads else int(LM_MESH_DROP_SLACK * copies)
    check(len(drops) == len(one["dropped"]) and all(
        abs(a - b) <= slack for a, b in zip(drops, one["dropped"])),
          f"LM 19{label}: MoE layers dropped {drops} of {copies} copies on "
          f"the mesh, {one['dropped']} in this process (slack {slack})")
    if drops:
        _moe_routing(label, cfg, one, m, slack)


def phase_lm_mesh(seed: int, power: str) -> dict:
    """Phase 19: (a), (b) and (d) on one gloo ×8 spawn, then (c)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.lm_mesh import TrainCase, run_train_mesh_cases

    t_phase = time.perf_counter()
    full = get_config(LM_TRAIN_ARCH)
    cfg_a = full.with_groups(LM_MESH_GROUPS)
    cfg_b = dataclasses.replace(full.with_groups(1), dtype=torch.float32)
    B, S = LM_MESH_BATCH, LM_MESH_SEQ
    batch = synthetic_batch(full, 0, S, B, device="cpu")
    one_a = _one_process(cfg_a, seed, batch, grads=False)
    one_b = _one_process(cfg_b, seed, batch, grads=True)
    print(f"LM 19: this process: (a) {cfg_a.name} bf16 one step, loss "
          f"{one_a['loss']:.9g}, {one_a['seconds']:.3f} s, peak "
          f"{one_a['peak']} B; (b) {cfg_b.name} float32 gradients, loss "
          f"{one_b['loss']:.9g}, {one_b['seconds']:.3f} s, peak "
          f"{one_b['peak']} B; card {power}")
    kinds = _kind_cases()
    # the float32 cases' passes run on this process's CPU after the spawn
    ones = [None if g else _one_process(cfg, seed, b, grads=False)
            for _, cfg, b, g in kinds]
    opt_cfg = lm_train_opt()
    t0 = time.perf_counter()
    run = run_train_mesh_cases(
        [TrainCase(cfg_a, seed, batch, opt_cfg=opt_cfg, repeats=2,
                   keep=("params",)),
         TrainCase(cfg_b, seed, batch, opt_cfg=opt_cfg, steps=0,
                   keep=("grads",))]
        + [TrainCase(cfg, seed, b, opt_cfg=opt_cfg, steps=0 if g else 1,
                     keep=("grads",) if g else ("params",))
           for _, cfg, b, g in kinds],
        LM_MESH_SHAPE, device="cuda", backend="gloo",
        timeout=LM_MESH_TIMEOUT)
    gloo_s = time.perf_counter() - t0
    res_a, res_b = run.results[:2]
    info = dict(kind="train", seq_len=S, global_batch=B)
    cells = [run_cell(c.name, "train", cfg=c, mesh_shape=LM_MESH_SHAPE,
                      shape_info=info) for c in (cfg_a, cfg_b)]

    loss_a = res_a.metrics[0]["loss"]
    pgap, pleaf = _worst(res_a.params, one_a["after"], relative=False)
    again = [rank["repeats"][0] for rank in res_a.ranks]
    same = all(a["differ"] == [] and a["metrics"] == res_a.metrics
               for a in again)
    print(f"LM 19(a): gloo x8 on one card, mesh {LM_MESH_SHAPE}, "
          f"{cfg_a.name} ({cfg_a.n_layers} layers, d_model {cfg_a.d_model}, "
          f"heads {cfg_a.n_heads}/{cfg_a.n_kv_heads}, ff {cfg_a.d_ff}, vocab "
          f"{cfg_a.vocab}) bf16, remat {cfg_a.remat}, B {B} x S {S}: loss "
          f"{loss_a:.9g} against this process's {one_a['loss']:.9g} (gap "
          f"{abs(loss_a - one_a['loss']):.3g}, bar {LM_MESH_LOSS_BAR:g}); "
          f"worst weight after the step {pleaf} {pgap:.3g} (bar "
          f"{LM_MESH_PARAM_BAR:g}); a second run from the same state: same "
          f"bits {same}, its step {max(a['seconds'][0] for a in again):.3f} "
          f"s on the slowest rank; the spawn {gloo_s:.1f} s (batch shards "
          f"written in {run.shards_s:.1f} s, outputs joined in "
          f"{run.gather_s:.1f} s); card {power}")
    _mesh_ranks("(a)", res_a, run.startup, cells[0], power)
    check(np.isfinite(loss_a)
          and abs(loss_a - one_a["loss"]) < LM_MESH_LOSS_BAR,
          f"LM 19(a): loss {loss_a} against {one_a['loss']}")
    check(pgap < LM_MESH_PARAM_BAR, f"LM 19(a): {pleaf} off by {pgap}")
    check(same, f"LM 19(a): a second run differs: "
          f"{[a['differ'][:4] for a in again]}")
    del res_a.params

    loss_b = res_b.grads_metrics["loss"]
    ggap, gleaf = _worst(res_b.grads, one_b["grads"], relative=True)
    print(f"LM 19(b): gloo x8, {cfg_b.name} ({cfg_b.n_layers} layer) "
          f"float32: loss {loss_b:.9g} against this process's "
          f"{one_b['loss']:.9g} (rel {abs(loss_b - one_b['loss']) / abs(one_b['loss']):.3g}, "
          f"bar {LM_F32_BAR_MESH:g}); worst gradient leaf {gleaf} {ggap:.3g} "
          f"of its largest |g| (bar {LM_MESH_GRAD_BAR:g}); card {power}")
    _mesh_ranks("(b)", res_b, run.startup, cells[1], power)
    check(abs(loss_b - one_b["loss"]) <= LM_F32_BAR_MESH * abs(one_b["loss"]),
          f"LM 19(b): loss {loss_b} against {one_b['loss']}")
    check(ggap <= LM_MESH_GRAD_BAR, f"LM 19(b): {gleaf} off by {ggap}")
    del res_b, one_b
    for (label, cfg, b, g), res, one in zip(kinds, run.results[2:], ones):
        _check_kind(label, cfg, b, g, res,
                    _cpu_grads(cfg, seed, b) if g else one, run.startup,
                    power)
    del run, ones

    t0 = time.perf_counter()
    one = run_train_mesh_cases(
        [TrainCase(cfg_a, seed, batch, opt_cfg=opt_cfg,
                   keep=("params",))], (1, 1), device="cuda",
        backend="nccl", timeout=LM_MESH_TIMEOUT)
    res_c = one.results[0]
    loss_c = res_c.metrics[0]["loss"]
    cgap, cleaf = _worst(res_c.params, one_a["after"], relative=False)
    rank = res_c.ranks[0]
    cell_c = run_cell(cfg_a.name, "train", cfg=cfg_a, mesh_shape=(1, 1),
                      shape_info=info)
    print(f"LM 19(c): NCCL x1 at (1, 1), {cfg_a.name} bf16: loss "
          f"{loss_c:.9g} against this process's {one_a['loss']:.9g}; worst "
          f"weight {cleaf} {cgap:.3g}; resident {rank['resident_bytes']} B "
          f"(the dry run's one-GPU cell {cell_c['argument_bytes']}); peak "
          f"{rank['peak_bytes']} B; step {rank['step_seconds'][0]:.3f} s; "
          f"start-up {one.startup[0]['spawn_to_first_s']:.1f} s; the spawn "
          f"{time.perf_counter() - t0:.1f} s (outputs joined in "
          f"{one.gather_s:.1f} s); card {power}")
    check(abs(loss_c - one_a["loss"]) < LM_MESH_LOSS_BAR,
          f"LM 19(c): loss {loss_c} against {one_a['loss']}")
    check(cgap < LM_MESH_PARAM_BAR, f"LM 19(c): {cleaf} off by {cgap}")
    check(rank["resident_bytes"] == cell_c["argument_bytes"],
          f"LM 19(c): {rank['resident_bytes']} bytes held, the dry run's "
          f"cell {cell_c['argument_bytes']}")
    seconds = time.perf_counter() - t_phase
    print(f"LM phase 19: {seconds:.1f} s; card {power}")
    return dict(seconds=seconds)


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
    del rmap  # the graph stays, for phase 14's partitions
    print(f"main graph: RMAT scale {args.scale} ef 16 seed {args.seed}: "
          f"|V| {pg.n_vertices} |E| {pg.n_edges} P {pg.P} E_cap {pg.E_cap} "
          f"blocks {pg.n_blocks}x{pg.edge_block}; host preprocessing "
          f"{t_gen + t_part:.1f} s (generate {t_gen:.1f} s, partition and "
          f"copy to the device {t_part:.1f} s)")

    t_lap = [t_start]

    def lap(phase: str) -> None:
        """Each phase's wall time, for the smoke's time limit."""
        now = time.perf_counter()
        print(f"time: phase {phase} {now - t_lap[0]:.1f} s, "
              f"{now - t_start:.1f} s since the start")
        t_lap[0] = now

    lap("1 and the main graph")
    kernels = phase_kernels(pg, args.seed)
    lap("2")
    phase_small(args.seed)
    lap("3")
    launches = phase_main(pg, src)
    lap("4")
    modes = phase_modes(pg, args.seed)
    lap("5")
    phase_recovery(pg, modes["hashmin_steps"])
    lap("6")
    phase_elastic(args.seed)
    lap("7")
    phase_prefix(pg, args.seed)
    lap("8")
    # the dense path, and a late Hash-Min superstep: a small frontier
    from repro_torch.core import HashMin, PageRank

    profile = phase_profile(pg, "pagerank", PageRank(10), 2)
    phase_profile(pg, "hashmin", HashMin(), 4)
    lap("9")
    recoded_peak = max(r["peak_gib"] for r in modes["rows"]
                       if r["run"].startswith("recoded "))
    streamed = phase_streamed(pg, modes["ref"], recoded_peak)
    lap("10")
    phase_streamed_small(args.seed, streamed["signature"])
    lap("11")
    procs = phase_processes(args.seed)
    lap("12")
    phase_sockets(procs["files"])
    lap("13")
    mesh = phase_mesh(g, pg, src, args.seed, gpus, built["power"])
    lap("14")
    phase_dryrun(pg, profile, mesh["link_bytes_per_s"], built["power"])
    lap("15")
    del pg, g, modes  # phase 16 holds up to 54 GB of the card
    torch.cuda.empty_cache()
    phase_lm(args.seed, built["power"])
    lap("16")
    phase_lm_kinds(args.seed, built["power"])
    lap("17")
    phase_lm_train(args.seed, built["power"])
    lap("18")
    phase_lm_mesh(args.seed, built["power"])
    lap("19")
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
