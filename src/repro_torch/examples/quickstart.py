"""Quickstart: PageRank with the declarative job API.

One call owns the whole lifecycle — the planner picks the execution mode
(in-memory recoded vs out-of-core streamed vs §4 pipelined) and sizes every
staging/window knob from the memory budget; the job partitions (spilling
edge streams to disk when the plan says so), runs, and hands back a
structured result.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
        [--scale 12] [--ram-per-shard 262144]

It runs on CUDA unless ``--device`` names another device; without a card
and without ``--device cpu`` it raises. ``main(argv)`` returns what it
printed, with the graph, the ranks and the job's history.
"""

from __future__ import annotations

import argparse

from repro_torch.core import GraphDJob, MemoryBudget, PageRank, plan
from repro_torch.device import resolve_device
from repro_torch.graph import rmat_graph


def _args(argv):
    ap = argparse.ArgumentParser(prog="repro_torch.examples.quickstart")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    ap.add_argument("--scale", type=int, default=12,
                    help="RMAT scale: 2^scale vertices, 16 edges a vertex")
    ap.add_argument("--ram-per-shard", type=int, default=256 << 10,
                    help="the budget's RAM a machine, in bytes")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = _args(argv)
    device = resolve_device(args.device)

    # 1. load a graph (here: generated; loaders accept any edge list with
    #    arbitrary 64-bit vertex ids — the recoding pass densifies them)
    graph = rmat_graph(scale=args.scale, edge_factor=16, seed=0,
                       sparse_ids=True)
    print(f"graph: |V|={graph.n_vertices:,} |E|={graph.n_edges:,}")

    # 2. describe the machines, not the physical plan: 8 "machines", 256 KiB
    #    of RAM each. The planner chooses the mode and derives the knobs —
    #    ask it to explain itself before committing anything to disk.
    budget = MemoryBudget(ram_per_shard=args.ram_per_shard, n_shards=8)
    p = plan(PageRank(supersteps=10), graph, budget)
    explain = p.explain()
    print(explain, "\n")

    # 3. run the job (partition -> spill if needed -> engine -> supersteps)
    with GraphDJob(PageRank(supersteps=10), graph, budget=budget,
                   device=device) as job:
        result = job.run(verbose=True)

    # 4. results, keyed by the original vertex ids, plus the audit trail
    ranks = result.values
    top = sorted(ranks.items(), key=lambda kv: -kv[1])[:5]
    print("top-5 vertices by PageRank:")
    for vid, r in top:
        print(f"  vertex {vid}: {r:.6f}")
    mass = sum(ranks.values())
    print(f"rank mass: {mass:.4f}")
    s = result.summary()  # JSON-able: what was planned, what actually ran
    print(f"mode={s['mode']} planned_ram={s['planned']['ram']}B "
          f"realized_ram={s['realized']['ram']}B "
          f"({s['n_supersteps']} supersteps)")
    return dict(
        graph=graph, n_vertices=graph.n_vertices, n_edges=graph.n_edges,
        explain=explain,
        mode=p.mode, pipeline=p.pipeline,
        knobs=next(c for c in p.alternatives if c.chosen).knobs,
        top=top, mass=mass, summary=s, values=ranks,
        history=result.history,
    )


if __name__ == "__main__":
    main()
