#!/usr/bin/env python3
"""Time the design elements of the edge_combine kernel one at a time.

    python3 tools/ec_ablation.py               # RMAT scale 24, 8 shards
    python3 tools/ec_ablation.py --scale 16    # a quick run

Builds ``tools/ec_ablation.cu`` with ``nvcc`` and runs each of its variants
(div_deg/sum, PageRank's messages) on the main path's graph, for every ring
round at density 1 and for round 0 at densities 0.02 and 0, beside the
package's ``edge_combine``. Times are device times (``chip_smoke.time_ms``)
of the launch alone: the outputs are pre-filled once, outside the timing.
Each variant that computes the full function is checked against the plain
version. Needs one CUDA device and the CUDA toolkit.
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

# index in ec_ablation.cu's VARIANTS: (name, result layout), where the
# layout is "split" (A_s and cnt), "pairs" (float2), "a_only" (A_s without
# counts) or None (timing only: stores, or masked destinations)
VARIANTS = [
    ("first port: CTA per block, 1 edge/thread, 2 atomics", "split"),
    ("first port, A_s atomic only (no count)", "a_only"),
    ("first port, plain stores (no atomics)", None),
    ("first port, one float2 atomic", "pairs"),
    ("CTA per block, 4 edges/thread, 2 atomics", "split"),
    ("persistent, 4 edges/thread, 2 atomics", "split"),
    ("persistent, 4/thread, staged sources, 2 atomics", "split"),
    ("persistent, 4/thread, float2 atomic", "pairs"),
    ("persistent, 4/thread, staged, float2 atomic", "pairs"),
    ("persistent, 4/thread, float2, warp-aggregated", "pairs"),
    ("persistent, 4/thread, plain stores", None),
    ("persistent, 1 edge/thread (512), 2 atomics", "split"),
    ("persistent, 1/thread (512), float2", "pairs"),
    ("persistent, 4/thread strided, 2 atomics", "split"),
    ("persistent, 4/thread strided, float2", "pairs"),
    ("persistent, 1/thread (256), float2", "pairs"),
    ("persistent, 1/thread (512), float2, streaming loads", "pairs"),
    ("persistent, 2/thread strided (256), float2, streaming", "pairs"),
    ("v16 with destinations in a 512 KB window (timing only)", None),
    ("v16 with destinations in a 4 MB window (timing only)", None),
    ("persistent, 1/thread (512), 2 atomics, streaming loads", "split"),
]


def build(out_dir: str) -> ctypes.CDLL:
    from repro_torch.kernels import build as kbuild

    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libec_ablation.so")
    src = os.path.join(ROOT, "tools", "ec_ablation.cu")
    log = subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", lib, src],
                         capture_output=True, text=True)
    if log.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{log.stdout}{log.stderr}")
    cdll = ctypes.CDLL(lib)
    cdll.ec_variant.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 12
                                + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    cdll.ec_variant.restype = ctypes.c_int
    cdll.ec_variant_occupancy.argtypes = [ctypes.c_int]
    cdll.ec_variant_occupancy.restype = ctypes.c_int
    cdll.ec_split.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    cdll.ec_digest_pairs.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    return cdll


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)
    import torch

    if not torch.cuda.is_available():
        print("ec_ablation: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.engine import _active_prefix
    from repro_torch.graph import partition_graph, rmat_graph
    from repro_torch.kernels import ops
    from repro_torch.kernels.edge_combine import (
        edge_combine, edge_combine_plain,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    lib = build(os.path.join(ROOT, "src", "repro_torch", "_build"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t0 = time.perf_counter()
    g = rmat_graph(scale=args.scale, edge_factor=16, seed=args.seed,
                   weights="uniform")
    pg, _ = partition_graph(g, chip_smoke.SHARDS)
    del g
    print(f"graph: scale {args.scale}, P {pg.P}, E_cap {pg.E_cap}, "
          f"{pg.n_blocks}x{pg.edge_block}, built in "
          f"{time.perf_counter() - t0:.1f} s")
    n, P, NB, B = pg.n_shards, pg.P, pg.n_blocks, pg.edge_block
    dev = pg.device
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    values = torch.rand((n, P), generator=gen, device=dev)
    blocks = lambda a: a.view(n, n, NB, B)
    sp, dp, w = blocks(pg.src_pos), blocks(pg.dst_pos), blocks(pg.eweight)
    out = torch.empty((n, P), device=dev)
    cnt = torch.empty((n, P), dtype=torch.int32, device=dev)
    out2 = torch.empty((n, P, 2), device=dev)
    staged = torch.zeros(1, dtype=torch.int32, device=dev)
    ar = torch.arange(n, device=dev)
    results = []
    cases = [(r, 1.0) for r in range(n)] + [(0, 0.02), (0, 0.0)]
    for r, dens in cases:
        dest = ((ar + n - 1 - r) % n).to(torch.int32)
        active = (torch.rand((n, P), generator=gen, device=dev) < dens) \
            & pg.vmask
        keep = ops.skip_keep_mask(pg.blk_lo[ar, dest.long()],
                                  pg.blk_hi[ar, dest.long()],
                                  _active_prefix(active))
        ids, n_keep = ops.compact_blocks(keep)
        ec_args = (values, pg.degree, active, sp, dp, w, dest, ids, n_keep)
        A_p, c_p = edge_combine_plain(*ec_args, msg_kind="div_deg",
                                      combiner="sum")
        row = dict(round=r, density=dens, kept_blocks=int(n_keep.sum()),
                   messages=int(c_p.sum()),
                   package_ms=chip_smoke.time_ms(lambda: edge_combine(
                       *ec_args, msg_kind="div_deg", combiner="sum")))
        for v, (name, layout) in enumerate(VARIANTS):
            ctas = sms * lib.ec_variant_occupancy(v)
            ptrs = [t.data_ptr() for t in (values, pg.degree, active, sp, dp,
                                           dest, ids, n_keep, out, cnt, out2,
                                           staged)]
            stream = torch.cuda.current_stream().cuda_stream

            def launch():
                rc = lib.ec_variant(v, *ptrs, n, P, NB, B, ctas, stream)
                if rc != 0:
                    raise RuntimeError(f"variant {v}: launch failed ({rc})")

            out.zero_()
            cnt.zero_()
            out2.zero_()
            staged.zero_()
            launch()
            torch.cuda.synchronize()
            n_staged = int(staged)
            if layout == "pairs":
                A_k, c_k = out2[..., 0], out2[..., 1].to(torch.int32)
            else:
                A_k, c_k = out, cnt
            ok = ((layout is None
                   or torch.allclose(A_k, A_p, rtol=1e-5, atol=1e-6))
                  and (layout in (None, "a_only") or torch.equal(c_k, c_p)))
            if not ok:
                raise RuntimeError(f"variant {v} ({name}) round {r} density "
                                   f"{dens}: differs from the plain version")
            row[f"v{v}_ms"] = chip_smoke.time_ms(launch)
            if n_staged:
                row[f"v{v}_staged_blocks"] = n_staged
        results.append(row)
        print("ablation " + json.dumps(row))
    # the pairs' split in the wrapper, then the ring's digest, against a
    # digest that reads the pairs itself
    from repro_torch.kernels.digest import digest

    stream = torch.cuda.current_stream().cuda_stream
    A_r = torch.rand((n, P), generator=gen, device=dev)
    c_r = torch.randint(0, 64, (n, P), generator=gen, device=dev,
                        dtype=torch.int32)
    o, oc = torch.empty_like(A_r), torch.empty_like(c_r)
    split = chip_smoke.time_ms(lambda: lib.ec_split(
        out2.data_ptr(), out.data_ptr(), cnt.data_ptr(), n * P, sms * 8,
        stream))
    dg = chip_smoke.time_ms(lambda: digest(A_r, c_r, out, cnt,
                                           combiner="sum"))
    dp_ms = chip_smoke.time_ms(lambda: lib.ec_digest_pairs(
        A_r.data_ptr(), c_r.data_ptr(), out2.data_ptr(), o.data_ptr(),
        oc.data_ptr(), n * P, sms * 8, stream))
    lib.ec_digest_pairs(A_r.data_ptr(), c_r.data_ptr(), out2.data_ptr(),
                        o.data_ptr(), oc.data_ptr(), n * P, sms * 8, stream)
    lib.ec_split(out2.data_ptr(), out.data_ptr(), cnt.data_ptr(), n * P,
                 sms * 8, stream)
    ref = digest(A_r, c_r, out, cnt, combiner="sum")
    if not (torch.equal(o, ref[0]) and torch.equal(oc, ref[1])):
        raise RuntimeError("digest of the pairs differs from split + digest")
    print(f"consumer: split {split:.4f} ms + digest {dg:.4f} ms = "
          f"{split + dg:.4f} ms; digest reading the pairs {dp_ms:.4f} ms")
    print("variants: " + json.dumps({f"v{v}": name for v, (name, _)
                                     in enumerate(VARIANTS)}))
    print("card: " + smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
