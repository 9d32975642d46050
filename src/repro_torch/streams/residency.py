"""Tiered block residency — the adaptive semi-external tier.

GraphD's streamed mode proves the O(|V|/n) bound by reading *every* active
edge block from disk every superstep. GraphMP/GraphH (PAPERS.md) show that a
machine with spare RAM above that floor can do 2-5x better by pinning the
hot part of the edge stream in memory and streaming only the cold tail.
This module is that tier: a :class:`BlockResidency` sits between the
prefetching reader and the ``EdgeStreamStore`` and decides, per edge block,
*where* the bytes come from — the bounded in-RAM hot cache or the memmap.

Three invariants make the cache invisible to the computation:

* **bit-identity** — a cached block is a byte-exact copy of what
  ``read_blocks`` produced for it, taken the moment it was read; serving it
  later fills the same staging rows with the same values, so every result
  (including reassociation-sensitive float sums) is bit-identical to pure
  streaming at ANY budget, 0 included (``tests/test_equivalence.py`` pins
  this for all 8 algorithms);
* **bounded RAM** — admission is refused beyond ``capacity_bytes``; the
  planner sizes that budget as the ``hot_cache`` tier of
  ``estimate_memory()``, so the resident footprint stays within the
  ``MemoryBudget`` like every other tier;
* **stable copies** — the reader's staging buffers are recycled (the
  consumer may alias them); cached rows are copied out before the buffer is
  returned to the pool, never referenced.

Ranking: per-block *activity metadata* (access count across supersteps,
real-edge count as the density tiebreak) persists for the engine's lifetime
— blocks touched every superstep outrank one-off reads, and among equally
hot blocks the denser one yields more served edges per cached byte. The
same metadata feeds the selective-scheduling counters: blocks the §3.2
skip() test never scheduled are tallied as ``skipped`` (late SSSP/HashMin
rounds skip nearly everything), so residency behavior is observable from
``SuperstepRecord`` / ``JobResult.summary()`` without a profiler.

The port makes the same decisions as the JAX package's module with less
host work, which a superstep of half a million blocks needs: a cache of
capacity 0 reads straight through (no block can ever be admitted, so no
activity metadata is kept), and the coldest cached block comes off a heap
instead of a scan of the whole cache on every miss. The heap orders by
rank, then by admission order, which is the order in which a scan of the
cache met the blocks, so every admission and eviction is the reference's.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

from repro_torch.streams.store import EdgeStreamStore


@dataclass
class ResidencyStats:
    """Cumulative residency accounting (per-superstep deltas are taken by
    the engine via :meth:`BlockResidency.counters`)."""

    hits: int = 0  # blocks served from the hot cache (no disk I/O)
    misses: int = 0  # blocks that fell through to the memmap store
    admissions: int = 0  # blocks copied into the cache
    evictions: int = 0  # cached blocks dropped for hotter ones
    skipped: int = 0  # blocks never scheduled at all (skip() selective I/O)

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class BlockResidency:
    """Bounded hot-block cache over one :class:`EdgeStreamStore` geometry.

    ``capacity_bytes`` bounds the decoded bytes pinned (each block costs
    ``edge_block * EDGE_SLOT_BYTES``); 0 degenerates to a pass-through that
    only counts misses — pure streaming with observability.
    """

    def __init__(self, store: EdgeStreamStore, capacity_bytes: int):
        self.capacity_bytes = max(int(capacity_bytes), 0)
        self.block_bytes = store.block_bytes()
        self.stats = ResidencyStats()
        # (src_shard, dst_shard, block_id) -> (sp, dp, w) stable row copies
        self._cache: dict[tuple[int, int, int], tuple] = {}
        # persisted activity metadata: key -> [access count, real edges]
        self._heat: dict[tuple[int, int, int], list] = {}
        self._bytes = 0
        # cached key -> its admission number, and a min-heap of (access
        # count, real edges, admission number, key); an entry whose rank or
        # admission number is no longer the key's is stale, dropped on sight
        self._admitted: dict[tuple[int, int, int], int] = {}
        self._heap: list = []
        self._n_admitted = 0

    # -- observability -------------------------------------------------------
    @property
    def cached_bytes(self) -> int:
        return self._bytes

    @property
    def cached_blocks(self) -> int:
        return len(self._cache)

    def counters(self) -> tuple[int, int, int, int]:
        """(hits, misses, evictions, skipped) — snapshot for delta-taking."""
        s = self.stats
        return (s.hits, s.misses, s.evictions, s.skipped)

    def note_skipped(self, n_blocks: int) -> None:
        """Record blocks the skip() test kept off the schedule entirely —
        the selective-scheduling win the cache rides on top of."""
        self.stats.skipped += int(n_blocks)

    # -- the read path -------------------------------------------------------
    def read_blocks(self, store: EdgeStreamStore, i: int, k: int, ids,
                    out_sp: np.ndarray, out_dp: np.ndarray,
                    out_w: np.ndarray) -> tuple[int, int]:
        """Fill the staging rows for ``ids`` of group (i, k) — cached blocks
        from RAM, the rest via ``store.read_blocks`` — and pad the tail
        exactly like the store does. Returns ``(n_blocks, n_disk_blocks)``
        so the reader's byte accounting counts only real I/O."""
        c = len(ids)
        if self.block_bytes > self.capacity_bytes:
            # pass-through: no block is ever admitted, so there is no
            # activity metadata to keep
            store.read_blocks(i, k, ids, out_sp, out_dp, out_w)
            self.stats.misses += c
            return c, c
        cache = self._cache
        heat = self._heat
        keys = [(i, k, int(b)) for b in ids]
        miss = []
        for j, key in enumerate(keys):
            h = heat.get(key)
            if h is None:
                heat[key] = h = [0, -1]
            h[0] += 1
            if key in cache:
                sp, dp, w = cache[key]
                out_sp[j] = sp
                out_dp[j] = dp
                out_w[j] = w
                self._push(key)  # its rank rose
            else:
                miss.append(j)
        # read contiguous runs of misses straight into their staging rows
        # (a view of exactly the run's rows: the store pads only past its
        # own c, which is empty for an exact-length view)
        r = 0
        while r < len(miss):
            j0 = miss[r]
            r1 = r + 1
            while r1 < len(miss) and miss[r1] == miss[r1 - 1] + 1:
                r1 += 1
            j1 = miss[r1 - 1] + 1
            store.read_blocks(i, k, ids[j0:j1], out_sp[j0:j1],
                              out_dp[j0:j1], out_w[j0:j1])
            r = r1
        for j in miss:
            key = keys[j]
            h = heat[key]
            if h[1] < 0:  # first sight: record block density for ranking
                h[1] = int((out_sp[j] >= 0).sum())
            self._admit(key, out_sp[j], out_dp[j], out_w[j])
        out_sp[c:] = -1
        out_dp[c:] = 0
        out_w[c:] = 0.0
        self.stats.hits += c - len(miss)
        self.stats.misses += len(miss)
        return c, len(miss)

    # -- admission / eviction ------------------------------------------------
    def _rank(self, key) -> tuple[int, int]:
        h = self._heat.get(key)
        return (h[0], h[1]) if h is not None else (0, 0)

    def _push(self, key) -> None:
        """Record a cached key's current rank on the heap."""
        h = self._heat[key]
        heapq.heappush(self._heap, (h[0], h[1], self._admitted[key], key))
        if len(self._heap) > 4 * len(self._admitted) + 1024:
            # drop the stale entries: one current entry per cached key
            self._heap = [(*self._rank(k), n, k)
                          for k, n in self._admitted.items()]
            heapq.heapify(self._heap)

    def _coldest(self):
        """The cached key a scan of the cache in admission order would
        find first among those of least rank."""
        heap = self._heap
        while True:
            count, dens, n, key = heap[0]
            if (self._admitted.get(key) == n
                    and self._rank(key) == (count, dens)):
                return key
            heapq.heappop(heap)

    def _admit(self, key, sp, dp, w) -> None:
        if self.block_bytes > self.capacity_bytes:
            return  # budget 0 (or sub-block): pure pass-through
        if key in self._cache:
            return
        while self._bytes + self.block_bytes > self.capacity_bytes:
            # evict the coldest resident block — but only for a strictly
            # hotter newcomer, so equal-heat blocks never thrash
            cold = self._coldest()
            if self._rank(cold) >= self._rank(key):
                return
            del self._cache[cold]
            del self._admitted[cold]
            self._bytes -= self.block_bytes
            self.stats.evictions += 1
        self._cache[key] = (sp.copy(), dp.copy(), w.copy())
        self._admitted[key] = self._n_admitted
        self._n_admitted += 1
        self._push(key)
        self._bytes += self.block_bytes
        self.stats.admissions += 1
