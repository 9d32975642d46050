#!/usr/bin/env python3
"""ms a PageRank superstep of each torch-backend in-memory mode, for the
port in a given source tree (card only).

    python3 tools/mode_times.py                      # this checkout's src/
    python3 tools/mode_times.py --src OTHER/src      # another tree's

Builds that tree's kernels, partitions RMAT (edge factor 16, uniform
weights, seed 0) in 8 shards, and for ``recoded``, ``basic``, ``basic_sc``
and ``recoded_compact`` on the torch backend times superstep 1 from the
initial state: host clock around one ``step`` ending in a sync, the median
of ``--reps`` after one warm-up. Two trees are compared on one card by
running them in turns in one call (a, b, b, a). Prints the card's name and
power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("recoded", "basic", "basic_sc", "recoded_compact")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--scale", type=int, default=24)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mode_times: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import EngineConfig, GraphDEngine, PageRank
    from repro_torch.graph import partition_graph, rmat_graph
    from repro_torch.kernels import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    build.build_all()
    t0 = time.perf_counter()
    g = rmat_graph(scale=args.scale, edge_factor=16, seed=0,
                   weights="uniform")
    pg, _ = partition_graph(g, 8)
    del g
    torch.cuda.synchronize()
    print(f"graph {time.perf_counter() - t0:.1f} s {pg.shape_summary}")
    out = dict(src=src, card=card, scale=args.scale)
    for mode in MODES:
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
                         ms=times[1:])
        print(f"{mode}: {out[mode]['median_ms']:.3f} ms a superstep "
              f"(runs {[round(t, 3) for t in times[1:]]})")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
