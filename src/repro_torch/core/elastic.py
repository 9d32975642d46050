"""Elastic scaling: repartition a running job from n to n' shards.

Port of ``repro/core/elastic.py``. The ID-recoding invariant (paper §5)
makes this an index transform: a global recoded id ``g`` maps to
``(shard, pos) = (g mod n', g // n')`` for any shard count, so vertex state
migrates with two integer ops per vertex and no re-recoding. The edge groups
are rebuilt on the host with the assembler of the loading pass
(``graph.partition.build_partition``), and the job resumes at the same
superstep. The host work is numpy; the results are tensors on the
partition's device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.checkpoint import _numpy
from repro_torch.graph.partition import PartitionedGraph, build_partition


def extract_global(pg: PartitionedGraph, values, active):
    """Flatten a partitioned job to global-id-indexed host arrays:
    (gids, old ids, values, active) of the real vertices ascending by gid,
    and (src, dst, weight) of every edge over gids."""
    n = pg.n_shards
    gids, vmask, old_ids = _numpy(pg.gids), _numpy(pg.vmask), _numpy(pg.old_ids)
    vals, act = _numpy(values), _numpy(active)

    g_real = gids[vmask]  # (V,)
    order = np.argsort(g_real)
    g_real = g_real[order]
    old_real = old_ids[vmask][order]
    val_real = vals[vmask][order]
    act_real = act[vmask][order]

    # edges: translate (shard, pos) -> global id via the gid table
    sp, dp, w = _numpy(pg.src_pos), _numpy(pg.dst_pos), _numpy(pg.eweight)
    srcs, dsts, ws = [], [], []
    for i in range(n):
        for k in range(n):
            m = sp[i, k] >= 0
            srcs.append(gids[i, sp[i, k][m]])
            dsts.append(gids[k, dp[i, k][m]])
            ws.append(w[i, k][m])
    src_g = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    dst_g = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
    w_g = np.concatenate(ws) if ws else np.zeros(0, np.float32)
    return g_real, old_real, val_real, act_real, src_g, dst_g, w_g


def place_state(g_real, val_real, act_real, n: int, P: int, device):
    """(values, active) ``(n, P)`` tensors with each vertex at
    ``(g mod n, g // n)``."""
    vals = np.zeros((n, P), dtype=val_real.dtype)
    act = np.zeros((n, P), dtype=bool)
    vals[g_real % n, g_real // n] = val_real
    act[g_real % n, g_real // n] = act_real
    return torch.from_numpy(vals).to(device), torch.from_numpy(act).to(device)


def repartition(pg: PartitionedGraph, values, active, n_new: int,
                edge_block: int | None = None, vertex_pad: int = 8):
    """Rebuild the layout for ``n_new`` shards, migrating live vertex state.
    Returns (pg', values', active') on ``pg``'s device."""
    edge_block = edge_block or pg.edge_block
    g_real, old_real, val_real, act_real, src_g, dst_g, w_g = extract_global(
        pg, values, active
    )
    pg2 = build_partition(n_new, src_g, dst_g, w_g, g_real, old_real,
                          edge_block=edge_block, vertex_pad=vertex_pad,
                          device=pg.device)
    return (pg2, *place_state(g_real, val_real, act_real, n_new, pg2.P,
                              pg.device))

