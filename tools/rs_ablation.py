#!/usr/bin/env python3
"""Time the design elements of the run_sum kernel one at a time.

    python3 tools/rs_ablation.py               # RMAT scale 24, 8 shards
    python3 tools/rs_ablation.py --scale 16    # a quick run

Builds ``src/repro_torch/kernels/csrc/run_sum.cu`` as it ships,
``tools/rs_warp_list.cu`` (the first build of this design: runs split by
length, long ones to a warp each; with its knobs ``-D RUN_SUM_LONG`` and
``RUN_SUM_KEYS_IN_ORDER``) and ``tools/rs_ablation.cu`` (the designs
before it), all with ``nvcc`` at once, then runs each variant on the main
path's two shapes:

* one dense ring round of PageRank (every slot of every group, through the
  partition's destination order, as ``_combine_scatter`` sums it);
* one streamed fold call (the first 131,072 and 524,288 slots of group
  (0, 1), accumulating, through the stable sort of its keys, as
  ``StreamKernels.fold`` sums it).

Each variant is checked bit for bit against the plain version on the CPU.
Times are device times of the launch alone (``chip_smoke.time_ms``); the
package's wrapper, the first design's wrapper (scratch allocated a call)
and what the caller builds around the call are timed beside them, with
the host's launch ms. Needs one CUDA device and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

SHIPPED = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                       "run_sum.cu")
WARP_LIST = os.path.join(ROOT, "tools", "rs_warp_list.cu")
# library name: (source, extra nvcc flags)
BUILDS = {
    "earlier": (os.path.join(ROOT, "tools", "rs_ablation.cu"), []),
    "warp_list": (WARP_LIST, []),
    "warp_list_256": (WARP_LIST, ["-DRUN_SUM_LONG=256"]),
    "warp_list_keys_in_order": (WARP_LIST, ["-DRUN_SUM_KEYS_IN_ORDER=1"]),
    "shipped": (SHIPPED, []),
}
# (name, library, call): "gather_walk" and "walk_perm" take flat int64
# keys; "flat", "local" and "sorted" are run_sum_f32 with flat int64 keys,
# row-local int32 keys and the row stride, or those keys in position order
VARIANTS = [
    ("first design: gather into scratch, then a thread a run", "earlier",
     "gather_walk"),
    ("a alone: a thread a run through the permutation, no scratch",
     "earlier", "walk_perm"),
    ("a+b as first built: tiles in shared memory, runs over 128 values to "
     "a warp each off a list in device memory", "warp_list", "local"),
    ("the same, runs over 256 values to a warp", "warp_list_256", "local"),
    ("the same (128), the keys handed over in position order: only the "
     "values read through the permutation", "warp_list_keys_in_order",
     "sorted"),
    ("shipped design (tiles claimed in order, runs carried tile to tile), "
     "flat int64 keys", "shipped", "flat"),
    ("shipped design, row-local int32 keys", "shipped", "local"),
    ("shipped design, row-local int32 keys, runs marked in the "
     "permutation (shipped: keys read a run)", "shipped", "marked"),
]


def build(out_dir: str) -> dict:
    from repro_torch.kernels import build as kbuild

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (src, flags) in BUILDS.items():
        lib = os.path.join(out_dir, f"librs_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [kbuild._nvcc(), *kbuild.NVCC_FLAGS, *flags, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = sorted({line.split("Used ")[1].split(",")[0]
                       for line in log.splitlines() if "Used " in line})
        print(f"nvcc {name}: {regs}")
        cdll = ctypes.CDLL(lib)
        if name == "earlier":
            cdll.rs_gather_walk.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 2 + [
                ctypes.c_int, ctypes.c_void_p]
            cdll.rs_walk_perm.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]
        else:
            cdll.run_sum_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + (
                [ctypes.c_int] if name.startswith("shipped") else []) + [
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            cdll.run_sum_work_bytes.argtypes = [ctypes.c_longlong]
            cdll.run_sum_work_bytes.restype = ctypes.c_longlong
        libs[name] = cdll
    return libs


class Shape:
    """One call's inputs: row-local int32 keys ``local`` (negative
    skipped) with ``stride``, flat int64 ``flat``, values, the int32
    order, and its CPU result."""

    def __init__(self, local, val, order, n_out, stride, start=None):
        import torch

        from repro_torch.kernels.run_sum import mark, run_sum_plain

        row = torch.arange(local.shape[0], device=local.device)[:, None]
        self.local, self.val, self.order = local, val, order
        self.flat = torch.where(local >= 0, local.long() + row * stride, -1)
        self.sorted = local.gather(1, order.long())
        self.marked = mark(order, self.flat)
        self.n_out, self.stride, self.start = n_out, stride, start
        self.rows, self.E = val.shape
        self.M = val.numel()
        self.cpu = run_sum_plain(
            self.flat.cpu(), val.cpu(), n_out, order.cpu(),
            None if start is None else start.cpu().clone())
        live = self.flat.reshape(-1)
        live = live[live >= 0]
        self.longest = int(torch.bincount(live, minlength=n_out).max())

    def out(self):
        import torch

        return (torch.zeros(self.n_out, device=self.val.device)
                if self.start is None else self.start.clone())


def launcher(libs, call: str, lib: str, s: Shape, out, scratch):
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    acc = int(s.start is not None)
    work = None
    if call == "gather_walk":
        args = (out.data_ptr(), s.flat.data_ptr(), s.val.data_ptr(),
                s.order.data_ptr(), s.E, s.M, scratch[0].data_ptr(),
                scratch[1].data_ptr(), acc, stream)
        fn = libs[lib].rs_gather_walk
    elif call == "walk_perm":
        args = (out.data_ptr(), s.flat.data_ptr(), s.val.data_ptr(),
                s.order.data_ptr(), s.E, s.M, acc, stream)
        fn = libs[lib].rs_walk_perm
    else:
        key, bits, stride = {"flat": (s.flat, 64, 0),
                             "local": (s.local, 32, s.stride),
                             "marked": (s.local, 32, s.stride),
                             "sorted": (s.sorted, 32, s.stride)}[call]
        work = torch.empty(libs[lib].run_sum_work_bytes(s.M),
                           dtype=torch.uint8, device=s.val.device)
        head = (out.data_ptr(), key.data_ptr(), bits, s.val.data_ptr())
        if lib.startswith("shipped"):
            perm = s.marked if call == "marked" else s.order
            head += (perm.data_ptr(), 32, int(call == "marked"))
        else:  # rs_warp_list.cu takes no marks
            head += (s.order.data_ptr(), 32)
        args = head + (s.E, s.M, stride, acc, work.data_ptr(), stream)
        fn = libs[lib].run_sum_f32

    def launch():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{lib}/{call}: launch failed ({rc})")
    launch.tensors = (out, scratch, work)  # alive while the launch is
    return launch


def kernel_times(fn, reps: int = 5) -> dict:
    """Device ms of each kernel ``fn()`` launches, the median of ``reps``
    calls under ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = next((k for k in ("run_sum_kernel", "tile_kernel",
                                     "long_kernel", "Memset")
                         if k in e.name),
                        e.name[:40])
            times.setdefault(name, []).append(
                (e.time_range.end - e.time_range.start) / 1e3)
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


def time_variants(libs, s: Shape, label: str, marked: bool) -> dict:
    import torch

    from repro_torch.kernels.run_sum import run_sum

    scratch = (torch.empty(s.M, dtype=torch.int64, device=s.val.device),
               torch.empty(s.M, device=s.val.device))
    row = dict(shape=label, positions=s.M, slots=s.n_out,
               longest_run=s.longest)
    for v, (name, lib, call) in enumerate(VARIANTS):
        out = s.out()
        launch = launcher(libs, call, lib, s, out, scratch)
        launch()
        torch.cuda.synchronize()
        if not torch.equal(out.cpu().view(torch.int32),
                           s.cpu.view(torch.int32)):
            raise RuntimeError(f"variant {v} ({name}) on {label}: differs "
                               "from the CPU's bits")
        row[f"v{v}_ms"] = chip_smoke.time_ms(launch)
    acc = s.out() if s.start is not None else None

    def package():  # as the engine calls it: marked on the dense groups
        return run_sum(s.local, s.val, s.n_out,
                       s.marked if marked else s.order, out=acc,
                       stride=s.stride, marked=marked)

    def first_wrapper():  # the first design: zeros, scratch, then the C call
        out = torch.zeros(s.n_out, device=s.val.device)
        sk = torch.empty(s.M, dtype=torch.int64, device=s.val.device)
        sv = torch.empty(s.M, device=s.val.device)
        launcher(libs, "gather_walk", "earlier", s, out, (sk, sv))()

    row["package_ms"] = chip_smoke.time_ms(package)
    row["package_kernels_ms"] = kernel_times(package)
    row["package_launch_ms"] = chip_smoke.host_launch_ms(package)
    row["pr20_wrapper_launch_ms"] = chip_smoke.host_launch_ms(first_wrapper)
    print("ablation " + json.dumps(row))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)
    import torch

    if not torch.cuda.is_available():
        print("rs_ablation: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import PageRank
    from repro_torch.core.engine import _gen_messages
    from repro_torch.graph import partition_graph, rmat_graph
    from repro_torch.kernels.run_sum import unmark

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    libs = build(os.path.join(ROOT, "src", "repro_torch", "_build"))
    t0 = time.perf_counter()
    g = rmat_graph(scale=args.scale, edge_factor=16, seed=args.seed,
                   weights="uniform")
    pg, _ = partition_graph(g, chip_smoke.SHARDS)
    del g
    print(f"graph: scale {args.scale}, P {pg.P}, E_cap {pg.E_cap}, built "
          f"in {time.perf_counter() - t0:.1f} s")
    n, P, dev = pg.n_shards, pg.P, pg.device
    rows = []
    msg, dp, _, order = chip_smoke.dense_round(pg, args.seed)
    dense = Shape(dp.contiguous(), msg.contiguous(), unmark(order), n * P, P)
    rows.append(time_variants(libs, dense, "dense ring round", True))
    ar = torch.arange(n, device=dev)[:, None]
    idx = dp.long().clamp(min=0) + ar * P
    extra = dict(
        # what _combine_scatter built a call before its keys went row-local
        caller_key_ms=chip_smoke.time_ms(
            lambda: torch.where(dp >= 0, idx, -1)),
        zeros_ms=chip_smoke.time_ms(lambda: torch.zeros(n * P, device=dev)))
    del dense, msg, dp, order, idx
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    values = torch.rand(P, generator=gen, device=dev)
    for slots in (131_072, 524_288):
        sp, dp, w = (getattr(pg, f)[0, 1, :slots].contiguous()
                     for f in ("src_pos", "dst_pos", "eweight"))
        msg, aact = _gen_messages(PageRank(1), values[None],
                                  pg.degree[0][None], sp[None], w[None],
                                  pg.vmask[0][None], 1)
        key32 = torch.where(aact, dp[None], -1)
        key64 = torch.where(aact, dp.long()[None], -1)
        order = torch.sort(key32, dim=-1, stable=True).indices.int()
        start = torch.rand(P, generator=gen, device=dev)
        fold = Shape(key32, msg.contiguous(), order, P, 0, start)
        row = time_variants(libs, fold, f"fold {slots}", False)
        row["sort_int64_ms"] = chip_smoke.time_ms(
            lambda: torch.sort(key64, dim=-1, stable=True))
        row["sort_int32_ms"] = chip_smoke.time_ms(
            lambda: torch.sort(key32, dim=-1, stable=True))
        rows.append(row)
        print(f"fold {slots}: sort int64 {row['sort_int64_ms']:.4f} ms, "
              f"int32 {row['sort_int32_ms']:.4f} ms")
    print("variants: " + json.dumps({f"v{v}": name for v, (name, _, _)
                                     in enumerate(VARIANTS)}))
    print("rs_ablation " + json.dumps(dict(card=smi, rows=rows, **extra)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
