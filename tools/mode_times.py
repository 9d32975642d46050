#!/usr/bin/env python3
"""ms a PageRank superstep of each torch-backend in-memory mode, or of the
streamed mode, for the port in a given source tree (card only).

    python3 tools/mode_times.py                      # this checkout's src/
    python3 tools/mode_times.py --src OTHER/src      # another tree's
    python3 tools/mode_times.py --streamed --graph-cache DIR

Builds that tree's kernels, partitions RMAT (edge factor 16, uniform
weights, seed 0) in 8 shards, and for ``recoded``, ``basic``, ``basic_sc``
and ``recoded_compact`` on the torch backend times superstep 1 from the
initial state: host clock around one ``step`` ending in a sync, the median
of ``--reps`` after one warm-up, with the peak device memory from the
engine's creation on (the partition included; ``dst_order`` in the first
mode that builds it). With ``--streamed`` it spills the
partition to a store in a ``.mode_times-*`` directory of the checkout
(removed after) and runs unpipelined streamed PageRank (3 supersteps) at
the default 8-block chunks and at 256-block chunks, each superstep
timed by the engine (host clock ending in a sync); ``--graph-cache`` keeps
the generated graph in a directory, so that a second tree's run loads it.
Two trees are compared on one card by running them in turns in one call
(a, b, b, a). Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("recoded", "basic", "basic_sc", "recoded_compact")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--scale", type=int, default=24)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--streamed", action="store_true")
    ap.add_argument("--graph-cache", default=None)
    ap.add_argument("--chunk-blocks", type=int, nargs="*", default=None,
                    help="streamed: the chunk sizes to run (default: the "
                         "default chunks and 256)")
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mode_times: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import EngineConfig, GraphDEngine, PageRank
    from repro_torch.graph import partition_graph
    from repro_torch.kernels import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    build.build_all()
    t0 = time.perf_counter()
    g = cached_graph(args.graph_cache, args.scale)
    pg, _ = partition_graph(g, 8)
    del g
    torch.cuda.synchronize()
    print(f"graph {time.perf_counter() - t0:.1f} s {pg.shape_summary}")
    out = dict(src=src, card=card, scale=args.scale)
    if args.streamed:
        out.update(streamed_times(pg, args.chunk_blocks))
        print(json.dumps(out))
        return 0
    for mode in MODES:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng = GraphDEngine(pg, PageRank(5), EngineConfig(mode=mode,
                                                         backend="torch"))
        values, active = eng.init()
        times = []
        for _ in range(args.reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.step(values, active, 1)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[mode] = dict(median_ms=float(np.median(times[1:])),
                         ms=times[1:],
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        print(f"{mode}: {out[mode]['median_ms']:.3f} ms a superstep "
              f"(runs {[round(t, 3) for t in times[1:]]}), peak device "
              f"memory {out[mode]['peak_gib']:.3f} GiB")
    print(json.dumps(out))
    return 0


def cached_graph(cache, scale: int):
    """RMAT (edge factor 16, uniform weights, seed 0) at ``scale``, kept in
    ``cache`` (a directory) after its first generation."""
    import numpy as np
    from repro_torch.graph import Graph, rmat_graph

    path = cache and os.path.join(cache, f"rmat{scale}.npz")
    if path and os.path.exists(path):
        with np.load(path) as z:
            return Graph(z["src"], z["dst"], z["weight"],
                         vertex_ids=z["vertex_ids"])
    g = rmat_graph(scale=scale, edge_factor=16, seed=0, weights="uniform")
    if path:
        os.makedirs(cache, exist_ok=True)
        np.savez(path, src=g.src, dst=g.dst, weight=g.weight,
                 vertex_ids=g.vertex_ids)
    return g


def streamed_times(pg, chunk_blocks=None, supersteps: int = 3) -> dict:
    """Unpipelined streamed PageRank at each of ``chunk_blocks`` (the
    default chunks and 256-block chunks unless given): each superstep's
    ms."""
    from repro_torch.core import (
        EngineConfig, GraphDEngine, PageRank, StreamConfig,
    )
    from repro_torch.graph import spill_partition

    root = tempfile.mkdtemp(prefix=".mode_times-", dir=ROOT)
    out = {}
    try:
        pgs, store = spill_partition(pg, os.path.join(root, "edges"))
        for cb in chunk_blocks or (StreamConfig().chunk_blocks, 256):
            eng = GraphDEngine(pgs, PageRank(supersteps), EngineConfig(
                mode="streamed", stream=StreamConfig(chunk_blocks=cb)),
                stream_store=store)
            _, hist = eng.run()
            ms = [h.seconds * 1e3 for h in hist]
            out[f"streamed chunk_blocks={cb}"] = dict(ms=ms)
            print(f"streamed chunk_blocks={cb}: ms a superstep "
                  f"{[round(t, 3) for t in ms]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
