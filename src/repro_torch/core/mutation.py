"""Topology mutation (paper §3.4), between supersteps.

Port of ``repro/core/mutation.py``. Edge mutations rewrite the edge groups
for the next superstep; new vertices are appended with fresh recoded ids, so
existing vertices keep their (shard, position), the invariant the paper's
recoding maintains. The partition is flattened to global ids, edited and
reassembled with the loading pass's assembler.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.elastic import extract_global, place_state
from repro_torch.graph.partition import PartitionedGraph, build_partition


def _edge_keys(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    return (src.astype(np.int64) << 32) | dst.astype(np.int64)


def mutate(pg: PartitionedGraph, values, active, *, add_edges=None,
           remove_edges=None, add_vertices: int = 0, new_vertex_value=0):
    """Returns (pg', values', active', new_gids).

    ``add_edges`` rows are (src_gid, dst_gid[, weight]) over recoded ids,
    ``remove_edges`` rows (src_gid, dst_gid): every copy of such an edge
    goes. Positions of existing vertices are preserved (same gids give the
    same shard and position for the same n)."""
    n = pg.n_shards
    g_real, old_real, val_real, act_real, src_g, dst_g, w_g = extract_global(
        pg, values, active
    )

    if remove_edges is not None and len(remove_edges):
        rem = np.asarray(remove_edges, dtype=np.int64).reshape(-1, 2)
        rem = np.sort(_edge_keys(rem[:, 0], rem[:, 1]))
        keys = _edge_keys(src_g, dst_g)
        at = np.minimum(np.searchsorted(rem, keys), rem.shape[0] - 1)
        keep = rem[at] != keys
        src_g, dst_g, w_g = src_g[keep], dst_g[keep], w_g[keep]

    new_gids = np.zeros(0, dtype=np.int64)
    if add_vertices:
        # fresh ids continue each shard's position sequence (new vertices
        # are appended to A; id = n*pos + i keeps holding)
        per_shard_next = np.zeros(n, dtype=np.int64)
        shards = g_real % n
        for i in range(n):
            mine = g_real[shards == i]
            per_shard_next[i] = (mine.max() // n + 1) if mine.size else 0
        outs = []
        for j in range(add_vertices):
            i = j % n  # round-robin like hash assignment
            outs.append(n * per_shard_next[i] + i)
            per_shard_next[i] += 1
        new_gids = np.asarray(outs, dtype=np.int64)
        g_real = np.concatenate([g_real, new_gids])
        old_real = np.concatenate(
            [old_real, -2 - np.arange(add_vertices, dtype=np.int64)]
        )  # synthetic old ids for dumped output
        val_real = np.concatenate(
            [val_real, np.full(add_vertices, new_vertex_value, val_real.dtype)]
        )
        act_real = np.concatenate([act_real, np.ones(add_vertices, dtype=bool)])

    if add_edges is not None and len(add_edges):
        ae = np.asarray(add_edges)
        src_g = np.concatenate([src_g, ae[:, 0].astype(np.int64)])
        dst_g = np.concatenate([dst_g, ae[:, 1].astype(np.int64)])
        w_new = (ae[:, 2].astype(np.float32) if ae.shape[1] > 2
                 else np.ones(len(ae), np.float32))
        w_g = np.concatenate([w_g, w_new])

    order = np.argsort(g_real)
    pg2 = build_partition(n, src_g, dst_g, w_g, g_real[order], old_real[order],
                          edge_block=pg.edge_block, device=pg.device)
    return (pg2, *place_state(g_real, val_real, act_real, n, pg2.P,
                              pg.device), new_gids)
