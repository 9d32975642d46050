#!/usr/bin/env python3
"""Where a streamed superstep's host time goes, on one CUDA device.

    python3 tools/stream_diag.py               # RMAT scale 22, 8 shards
    python3 tools/stream_diag.py --scale 18    # a quick run

Partitions an RMAT graph and spills its edge groups into a
``.chip_smoke-streamed-*`` directory of this checkout (removed at the end),
then times, at the default 8-block chunks over every block: a sequential
read of one channel file (twice, for the page cache), the store's
``read_blocks`` in a loop, the ``StreamReader`` alone (its thread and
queues, nothing consuming), and PageRank supersteps at the default chunks,
through the full-duplex channel and at 256-block chunks; then Hash-Min
with a hot-block cache of a tenth of a shard's blocks, and one superstep of
DistinctInLabels at 64-block chunks (the combiner-less spill and external
merge). Ends with a ``cProfile`` of one Hash-Min superstep, by own time.
"""

from __future__ import annotations

import argparse
import cProfile
import os
import pstats
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=22)
    args = ap.parse_args(argv)

    import torch

    import repro_torch.core as tc
    from repro_torch.graph import partition_graph_streamed, rmat_graph
    from repro_torch.streams.reader import StreamReader
    from repro_torch.streams.schedule import plan_stream_schedule

    if not torch.cuda.is_available():
        print("stream_diag: no CUDA device", file=sys.stderr)
        return 1
    root = tempfile.mkdtemp(prefix=".chip_smoke-streamed-", dir=ROOT)
    try:
        t = time.time()
        g = rmat_graph(scale=args.scale, edge_factor=16, seed=0,
                       weights="uniform")
        pgs, _, store = partition_graph_streamed(g, 8,
                                                 os.path.join(root, "e"))
        print("partition+spill", time.time() - t, "bytes",
              store.disk_bytes(), flush=True)
        for _ in range(2):
            t, n = time.time(), 0
            with open(os.path.join(store.dir, "sp.bin"), "rb") as f:
                while True:
                    b = f.read(1 << 22)
                    if not b:
                        break
                    n += len(b)
            print("sequential read sp.bin", n / (time.time() - t) / 1e9,
                  "GB/s", flush=True)
        act = np.ones((8, pgs.P), bool)
        sched, _, _ = plan_stream_schedule(store, act)
        bufs = [np.empty((8, 512), np.int32), np.empty((8, 512), np.int32),
                np.empty((8, 512), np.float32)]
        t, n = time.time(), 0
        for i, k, ids in sched:
            for off in range(0, len(ids), 8):
                store.read_blocks(i, k, ids[off:off + 8], *bufs)
                n += 1
        print("read_blocks loop", n, "chunks",
              (time.time() - t) / n * 1e6, "us/chunk", flush=True)
        reader = StreamReader(store, chunk_blocks=8, depth=2)
        t, n = time.time(), 0
        for _ in reader.stream(sched):
            n += 1
        print("reader thread only", (time.time() - t) / n * 1e6,
              "us/chunk; read_s", reader.stats.read_seconds, flush=True)
        for label, cfg in (
                ("default", tc.EngineConfig(mode="streamed")),
                ("full-duplex", tc.EngineConfig(
                    mode="streamed", channel=tc.ChannelConfig(pipeline=True))),
                ("chunk256", tc.EngineConfig(
                    mode="streamed",
                    stream=tc.StreamConfig(chunk_blocks=256)))):
            eng = tc.GraphDEngine(pgs, tc.PageRank(2), cfg,
                                  stream_store=store)
            torch.cuda.synchronize()
            t = time.time()
            _, hist = eng.run()
            torch.cuda.synchronize()
            dt = time.time() - t
            io = eng.io_history
            print(label, "pagerank ms/superstep", dt / len(hist) * 1e3,
                  "chunks", sum(s.chunks for s in io) / len(hist),
                  "wait", sum(s.wait_seconds for s in io),
                  "read", sum(s.read_seconds for s in io), flush=True)
        cache = store.nonempty_blocks() // 8 // 10 * store.block_bytes()
        eng = tc.GraphDEngine(pgs, tc.HashMin(), tc.EngineConfig(
            mode="streamed", stream=tc.StreamConfig(cache_bytes=cache)),
            stream_store=store)
        torch.cuda.synchronize()
        t = time.time()
        _, hist = eng.run(max_supersteps=3)
        torch.cuda.synchronize()
        print("semi-external hashmin ms/superstep",
              (time.time() - t) / len(hist) * 1e3,
              [(h.blocks_read, h.cache_hits, h.cache_evictions)
               for h in hist], flush=True)
        eng = tc.GraphDEngine(pgs, tc.DistinctInLabels(16, 1), tc.EngineConfig(
            mode="streamed", stream=tc.StreamConfig(chunk_blocks=64)),
            stream_store=store)
        t = time.time()
        eng.run()
        print("distinct chunk64 s", time.time() - t, flush=True)
        eng = tc.GraphDEngine(pgs, tc.HashMin(),
                              tc.EngineConfig(mode="streamed"),
                              stream_store=store)
        prof = cProfile.Profile()
        prof.enable()
        eng.run(max_supersteps=1)
        prof.disable()
        pstats.Stats(prof).sort_stats("tottime").print_stats(15)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
