#!/usr/bin/env python3
"""chip_smoke.py's OR rows of phase 5 and its phase 20, alone, on one GPU.

    python3 tools/twins_phase.py [--scale 24] [--seed 0]

Narrows its own process to the first GPU the machine gives it, as the smoke
does, builds the kernels (phase 1), partitions RMAT at ``--scale`` (edge
factor 16, 8 shards), runs the main path (phase 4), then the OR
reachability program in the four in-memory modes against ``recoded`` and
phase 4's BFS (phase 5's OR rows, ``phase_or``), then the two example
twins on the card against their CPU runs and quickstart at RMAT scale 20
(phase 20, ``phase_twins``). Prints each part's seconds.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)
    import chip_smoke as cs

    gpus = cs.machine_gpus()
    if not gpus:
        print("twins_phase: no GPU on this machine", file=sys.stderr)
        return 1
    os.environ["CUDA_VISIBLE_DEVICES"] = gpus[0]
    import torch

    if not torch.cuda.is_available():
        print("twins_phase: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.graph import partition_graph, rmat_graph

    built = cs.phase_device_and_build()
    t0 = time.perf_counter()
    g = rmat_graph(scale=args.scale, edge_factor=16, seed=args.seed,
                   weights="uniform")
    pg, rmap = partition_graph(g, cs.SHARDS)
    src = int(rmap.to_new(np.array([0]))[0])
    del g, rmap
    torch.cuda.synchronize()
    print(f"main graph at scale {args.scale}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    main_path = cs.phase_main(pg, src)
    print(f"phase 4 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cs.phase_or(pg, src, main_path)
    print(f"phase 5's OR rows {time.perf_counter() - t0:.1f} s; card "
          f"{built['power']}")
    del pg, main_path
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cs.phase_twins(built["power"])
    print(f"phase 20 {time.perf_counter() - t0:.1f} s; card {built['power']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
