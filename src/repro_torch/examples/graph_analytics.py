"""End-to-end GraphD run (the paper's full job lifecycle), declarative:

  describe the job -> the planner picks the physical plan -> one GraphDJob
  per analysis owns partition/spill, checkpoints + message logs, the
  superstep loop, single-shard fast recovery ([19]) and elastic rescale.

The last section shows the expert path: typed configs + the raw engine,
for when you want to pin the physical plan yourself.

    PYTHONPATH=src python -m repro_torch.examples.graph_analytics [--device cpu]

It runs on CUDA unless ``--device`` names another device; without a card
and without ``--device cpu`` it raises. ``main(argv)`` returns what it
printed, with the PageRank values.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from repro_torch.core import (
    SSSP, ChannelConfig, EngineConfig, GraphDEngine, GraphDJob, HashMin,
    MemoryBudget, PageRank, StreamConfig, plan,
)
from repro_torch.device import resolve_device
from repro_torch.graph import partition_graph_streamed, recode_ids, rmat_graph

N_MACHINES = 8  # one machine count for budgets AND id recoding below


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.graph_analytics")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    device = resolve_device(ap.parse_args(argv).device)
    out = {}

    graph = rmat_graph(scale=12, edge_factor=8, seed=42, directed=False,
                       sparse_ids=True)
    print(f"graph: |V|={graph.n_vertices:,} |E|={graph.n_edges:,}")
    out.update(n_vertices=graph.n_vertices, n_edges=graph.n_edges)

    with tempfile.TemporaryDirectory() as work:
        # --- PageRank, out-of-core, with checkpoints + message logs --------
        # A tight RAM budget forces the planner out-of-core: edge streams
        # spill to <workdir>/edges automatically, and checkpoint_every=3
        # wires the Checkpointer + message log (the persisted OMSs of §3.4)
        # under the same workdir.
        budget = MemoryBudget(ram_per_shard=96 << 10, n_shards=N_MACHINES)
        prog = PageRank(supersteps=9)
        p = plan(prog, graph, budget)
        out["explain"] = p.explain()
        print(out["explain"], "\n")
        job = GraphDJob(prog, graph, budget=budget,
                        workdir=os.path.join(work, "pagerank"),
                        checkpoint_every=3, device=device)
        print(f"planned mode: {job.plan.mode}"
              + (" + §4 pipeline" if job.plan.pipeline else ""))
        out.update(mode=job.plan.mode, pipeline=job.plan.pipeline,
                   knobs=next(c for c in job.plan.alternatives
                              if c.chosen).knobs)
        res = job.run()
        print(f"pagerank: {res.n_supersteps} supersteps, "
              f"final delta={res.history[-1].agg:.2e}, "
              f"planned/realized ram="
              f"{res.planned_ram}/{res.realized_ram} B")
        out.update(pagerank_supersteps=res.n_supersteps,
                   final_delta=res.history[-1].agg,
                   planned_ram=res.planned_ram, realized_ram=res.realized_ram,
                   values=res.values)

        # --- machine 5 dies; only IT recomputes, replaying logged messages -
        v5, a5 = job.recover_shard(5)
        # check the recovered rows against the completed run's public
        # values, mapping shard 5's positions back to original ids via the
        # partition
        vmask5 = job.pg.vmask[5].cpu().numpy()
        ids5 = job.pg.old_ids[5].cpu().numpy()[vmask5]
        ref5 = np.array([res.values[int(i)] for i in ids5])
        err = float(np.abs(v5.cpu().numpy()[vmask5] - ref5).max())
        print(f"fast recovery of shard 5: max err {err:.2e} "
              "(no global rerun)")
        out["recovery_err"] = err
        job.close()

        # --- HashMin with an elastic rescale 8 -> 12 mid-job ---------------
        with GraphDJob(HashMin(), graph,
                       budget=MemoryBudget(n_shards=N_MACHINES),
                       device=device) as job2:
            job2.run(max_supersteps=4)
            r2 = job2.rescale(12).run()  # absorb 4 machines, continue
            comps = len(set(r2.values.values()))
            print(f"hash-min after 8->12 elastic rescale: {comps} components "
                  f"(halted at superstep {r2.history[-1].step})")
        out.update(components=comps, hashmin_halt=r2.history[-1].step)

        # --- SSSP: quiescence-driven, sparse skip() path -------------------
        # SSSP sources are recoded ids; the recode map is deterministic per
        # (vertex_ids, n_shards) — N_MACHINES keeps it in lockstep with the
        # budget. (After construction the job's own map is public as
        # job.rmap.)
        src = int(recode_ids(graph.vertex_ids, N_MACHINES)
                  .to_new(np.array([int(graph.vertex_ids[0])]))[0])
        with GraphDJob(SSSP(src), graph,
                       budget=MemoryBudget(n_shards=N_MACHINES),
                       device=device) as job3:
            r3 = job3.run()
            reached = sum(1 for d in r3.values.values() if d < float("inf"))
            print(f"sssp: reached {reached:,}/{graph.n_vertices:,} vertices "
                  f"in {r3.n_supersteps} supersteps")
        out.update(sssp_reached=reached, sssp_supersteps=r3.n_supersteps)

        # --- expert path: typed configs + the raw engine -------------------
        # When you want to pin the physical plan instead of budgeting for
        # it: partition + spill by hand and hand the engine an explicit
        # EngineConfig (the knobs the planner would otherwise derive).
        pgs, rmap, store = partition_graph_streamed(
            graph, n_shards=N_MACHINES,
            spill_dir=os.path.join(work, "expert"), device=device,
        )
        eng = GraphDEngine(
            pgs, PageRank(supersteps=5),
            config=EngineConfig(
                mode="streamed",
                stream=StreamConfig(chunk_blocks=4, depth=2),
                channel=ChannelConfig(pipeline=True),  # §4 full duplex
            ),
            device=device, stream_store=store,
        )
        (values, active), hist = eng.run()
        st = eng.channel_stats
        print(f"expert path (raw engine, full-duplex streamed): "
              f"{len(hist)} supersteps, "
              f"sender overlap {st.sender_overlap_seconds()*1e3:.1f} ms, "
              f"receiver overlap {st.receiver_overlap_seconds()*1e3:.1f} ms")
        out["expert_supersteps"] = len(hist)

    print("done.")
    return out


if __name__ == "__main__":
    main()
