"""Per-superstep read planning for the streamed engine (skip() before I/O)."""

from __future__ import annotations

import numpy as np

from repro_torch.streams.store import EdgeStreamStore


def plan_stream_schedule(store: EdgeStreamStore, active: np.ndarray, *,
                         by_dest: bool = False):
    """skip()-filtered sequential read plan for one streamed superstep.

    ``active`` is the (n, P) host active bitmap. Returns
    ``(schedule, density, max_grp)``:

    * ``schedule`` — list of ``(src_shard, dst_shard, block_ids)``;
      destination-major (each destination's accumulator completes as early
      as possible, mirroring the ring's one-destination-at-a-time order) and
      ascending block ids within a group, so every group scan is one
      sequential read of the group-aligned on-disk layout;
    * ``density`` — fraction of nonempty blocks that are active (the same
      dispatch signal the in-memory engine derives from ``StepStats``);
    * ``max_grp`` — max active blocks in any group (Table-style accounting).

    With ``by_dest=True`` the first element is instead a length-n list whose
    entry k is dest shard k's slice of the same destination-major schedule
    (possibly empty). The combiner-less streamed path consumes this shape:
    it finishes one destination's message spill, merge-applies it, and frees
    its runs before the next destination's edges are even read — peak
    message-spill disk is the largest single destination, not the whole
    superstep's traffic.

    Blocks failing the §3.2 skip() test never appear in the schedule, so the
    reader never touches them on disk.
    """
    n = store.geom.n_shards
    prefixes = [
        np.concatenate([[0], np.cumsum(active[i].astype(np.int64))])
        for i in range(n)
    ]
    grouped: list[list] = [[] for _ in range(n)]
    total_active = 0
    max_grp = 0
    for k in range(n):
        for i in range(n):
            ids = store.active_blocks(i, k, prefixes[i])
            if ids.size:
                grouped[k].append((i, k, ids))
                total_active += int(ids.size)
                max_grp = max(max_grp, int(ids.size))
    density = total_active / max(store.nonempty_blocks(), 1)
    if by_dest:
        return grouped, density, max_grp
    return [entry for per_dest in grouped for entry in per_dest], density, max_grp
