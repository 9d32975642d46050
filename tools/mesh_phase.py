#!/usr/bin/env python3
"""chip_smoke.py's phase 14 (the mesh) alone, on the machine's GPUs.

    python3 tools/mesh_phase.py               # RMAT scale 22, 8 shards
    python3 tools/mesh_phase.py --scale 24    # the smoke's main graph

Narrows its own process to the first GPU the machine gives it, as the smoke
does, builds the kernels, partitions an RMAT graph (edge factor 16, uniform
weights, seed 0) in 8 shards, and calls ``chip_smoke.phase_mesh``: gloo with
8 ranks on the first card, then NCCL with one rank a GPU where there are two
or more (else NCCL with one rank at scale 20), each against the emulated
run of the same partition; then the logged step, message log, checkpoints,
recovery and combiner-less cases on RMAT scale 19, under gloo with 8 ranks
and NCCL with one rank a GPU where there are two or more.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=22)
    args = ap.parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)
    import chip_smoke as cs

    gpus = cs.machine_gpus()
    if not gpus:
        print("mesh_phase: no GPU on this machine", file=sys.stderr)
        return 1
    os.environ["CUDA_VISIBLE_DEVICES"] = gpus[0]
    import numpy as np
    import torch
    from repro_torch.graph import partition_graph, rmat_graph

    if not torch.cuda.is_available():
        print("mesh_phase: no CUDA device", file=sys.stderr)
        return 1
    built = cs.phase_device_and_build()
    t0 = time.perf_counter()
    g = rmat_graph(scale=args.scale, edge_factor=16, seed=0,
                   weights="uniform")
    pg, rmap = partition_graph(g, cs.SHARDS)
    src = int(rmap.to_new(np.array([0]))[0])
    print(f"graph {time.perf_counter() - t0:.1f} s {pg.shape_summary}")
    t0 = time.perf_counter()
    out = cs.phase_mesh(g, pg, src, 0, gpus, built["power"])
    print(f"phase 14 {time.perf_counter() - t0:.1f} s; launches a rank "
          f"{out['launches_per_rank']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
