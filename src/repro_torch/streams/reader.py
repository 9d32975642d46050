"""Double-buffered prefetching stream reader — the paper's U_c ∥ U_s overlap
(C3) reproduced at the host/device boundary.

A background thread stages the next chunk of edge blocks from the
``EdgeStreamStore`` memmaps into a small pool of preallocated host buffers
while the device digests the current chunk. With ``depth=2`` this is classic
double buffering: one buffer in flight to the device, one being filled from
disk, so stream I/O hides behind compute whenever compute is the bottleneck
(and vice versa — exactly the full overlap GraphD argues for).

The schedule handed to :meth:`StreamReader.stream` is a list of
``(src_shard, dst_shard, block_ids)`` entries — typically the skip()-filtered
active blocks of every group for one superstep (see
``streams.schedule.plan_stream_schedule``). Blocks are staged in ``chunk_blocks``
groups so every chunk has ONE static shape: the jitted combine compiles once,
and partial chunks are padded with compute-neutral slots (``src = -1``).
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.streams.store import EdgeStreamStore


@dataclass
class StagedChunk:
    """One staged group-chunk: host arrays of shape (chunk_blocks*edge_block,)."""

    src_shard: int
    dst_shard: int
    sp: np.ndarray
    dp: np.ndarray
    w: np.ndarray
    n_real_blocks: int
    _buf_id: int = -1  # pool slot, returned to the free list after consumption


@dataclass
class StreamStats:
    """Per-stream() accounting (surfaced by benchmarks)."""

    chunks: int = 0
    blocks_read: int = 0
    edges_staged: int = 0
    bytes_read: int = 0
    read_seconds: float = 0.0  # producer time spent filling buffers
    wait_seconds: float = 0.0  # consumer time spent blocked on the producer

    def throughput_edges_per_s(self) -> float:
        return self.edges_staged / self.read_seconds if self.read_seconds else 0.0


_DONE = object()


def prefetch_iter(iterable, depth: int = 2, *, on_item=None, on_wait=None,
                  wrap_exc=None, thread_name: str = "stream-prefetch"):
    """Run ``iterable`` in a background thread, ``depth`` items ahead — the
    same bounded-queue producer/consumer machinery :class:`StreamReader` uses
    for edge chunks, reusable for any staged stream (the msgstore external
    merge prefetches its destination-sorted apply slices through this, so
    merge-read I/O hides behind the apply compute exactly like edge reads
    hide behind the fold). Items must own their memory (no recycled buffers:
    the producer is ``depth`` items ahead of the consumer).

    Hooks (all optional — ``streams.channel.receive_iter`` is this function
    with receiver accounting and crash injection plugged in, so the tricky
    shutdown scaffolding exists exactly once):

    * ``on_item(seconds)`` — called on the PRODUCER thread after each item
      is produced, with the time producing it took; may raise to kill the
      producer (deterministic fault injection);
    * ``on_wait(seconds)`` — called on the consumer thread with the time it
      spent blocked waiting for each queue entry;
    * ``wrap_exc(exc) -> Exception`` — wraps a producer-side error before
      it is re-raised on the consumer (the original rides as __cause__).
    """
    if depth < 1:
        raise ValueError("depth must be >= 1")
    full: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                full.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def _produce():
        try:
            it = iter(iterable)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    _put(_DONE)
                    return
                if on_item is not None:
                    on_item(time.perf_counter() - t0)
                if not _put(item):
                    return
        except BaseException as e:  # surface producer errors to the consumer
            _put(e)

    worker = threading.Thread(target=_produce, name=thread_name,
                              daemon=True)
    worker.start()
    try:
        while True:
            t0 = time.perf_counter()
            item = full.get()
            if on_wait is not None:
                on_wait(time.perf_counter() - t0)
            if item is _DONE:
                break
            if isinstance(item, BaseException):
                if wrap_exc is not None:
                    raise wrap_exc(item) from item
                raise item
            yield item
    finally:
        stop.set()
        while True:  # unblock a producer waiting on a full queue, then drain
            try:
                full.get_nowait()
            except queue.Empty:
                break
        worker.join(timeout=5.0)
        if worker.is_alive() and sys.exc_info()[1] is None:
            # a silent join-timeout here leaked the producer thread (and
            # whatever it holds open); stay quiet only when an exception is
            # already propagating — raising then would mask it
            raise RuntimeError(
                "prefetch producer thread did not stop within 5s"
            )


class StreamReader:
    """Background-thread prefetcher over an :class:`EdgeStreamStore`."""

    def __init__(self, store: EdgeStreamStore, chunk_blocks: int = 8,
                 depth: int = 2, owner_views: bool = False, residency=None):
        if depth < 1:
            raise ValueError("depth must be >= 1 (2 = double buffering)")
        self.store = store
        self.chunk_blocks = chunk_blocks
        self.depth = depth
        # optional BlockResidency (streams/residency.py): the producer asks
        # it for every chunk, so hot blocks are served from the bounded RAM
        # cache and only the cold tail costs disk I/O — the stats below then
        # count REAL reads, not staged blocks
        self.residency = residency
        self.stats = StreamStats()
        self._worker: threading.Thread | None = None
        self._stop = threading.Event()
        # owner_views: read each source shard's blocks through a view that
        # maps ONLY that shard's store row (manifest-driven row ownership —
        # the per-machine access pattern of a multi-process deployment,
        # exercised in-process by the pipelined engine)
        self._views: dict[int, EdgeStreamStore] | None = (
            {} if owner_views else None
        )

    def _reader_for(self, i: int) -> EdgeStreamStore:
        if self._views is None:
            return self.store
        view = self._views.get(i)
        if view is None:
            view = self._views[i] = self.store.owner_view(i)
        return view

    def staging_bytes(self) -> int:
        """Resident bytes pinned by one pass's buffer pool (a compiled-in
        constant — part of the O(1) streaming overhead, NOT a function of
        |E|): (depth+1) buffers of chunk_blocks*edge_block slots, 12 B each."""
        B = self.store.geom.edge_block
        return (self.depth + 1) * self.chunk_blocks * B * 12

    # -- the streaming loop --------------------------------------------------
    def stream(self, schedule):
        """Yield :class:`StagedChunk`s for ``schedule`` (list of
        ``(i, k, block_ids)``), prefetched ``depth`` chunks ahead by a
        background thread. The yielded buffers are only valid until the next
        iteration (the engine copies them to device on consumption)."""
        # guard against a producer left over from an aborted pass: stop it
        # before starting a new one, and never share buffers with it
        prev = self._worker
        if prev is not None and prev.is_alive():
            self._stop.set()
            prev.join(timeout=5.0)
            if prev.is_alive():
                raise RuntimeError(
                    "previous edge-stream prefetch thread did not stop; "
                    "refusing to start another pass"
                )
        self.stats = StreamStats()
        stats = self.stats
        CB = self.chunk_blocks
        B = self.store.geom.edge_block
        shape = (CB, B)
        # per-pass buffer pool (depth in-flight + 1 being consumed): a stale
        # producer from an earlier, abandoned pass can only ever touch its
        # own pass's buffers, never this one's
        pool = [
            (np.empty(shape, np.int32), np.empty(shape, np.int32),
             np.empty(shape, np.float32))
            for _ in range(self.depth + 1)
        ]
        full: queue.Queue = queue.Queue(maxsize=self.depth)
        free: queue.Queue = queue.Queue()
        for bid in range(len(pool)):
            free.put(bid)
        stop = self._stop = threading.Event()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    full.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def _produce():
            try:
                for i, k, ids in schedule:
                    for off in range(0, len(ids), CB):
                        bid = free.get()
                        if stop.is_set():
                            return
                        sp, dp, w = pool[bid]
                        t0 = time.perf_counter()
                        if self.residency is not None:
                            c, disk = self.residency.read_blocks(
                                self._reader_for(i), i, k,
                                ids[off:off + CB], sp, dp, w
                            )
                        else:
                            c = self._reader_for(i).read_blocks(
                                i, k, ids[off:off + CB], sp, dp, w
                            )
                            disk = c
                        stats.read_seconds += time.perf_counter() - t0
                        stats.chunks += 1
                        stats.blocks_read += disk
                        stats.bytes_read += disk * B * 12  # i32+i32+f32/edge
                        stats.edges_staged += int((sp[:c] >= 0).sum())
                        if not _put(StagedChunk(
                            src_shard=i, dst_shard=k,
                            sp=sp.reshape(-1), dp=dp.reshape(-1),
                            w=w.reshape(-1), n_real_blocks=c, _buf_id=bid,
                        )):
                            return
                _put(_DONE)
            except BaseException as e:  # surface disk errors to the consumer
                _put(e)

        worker = threading.Thread(target=_produce, name="edge-stream-prefetch",
                                  daemon=True)
        self._worker = worker
        worker.start()
        held: StagedChunk | None = None
        try:
            while True:
                t0 = time.perf_counter()
                item = full.get()
                stats.wait_seconds += time.perf_counter() - t0
                # the consumer has moved past the previous chunk — its buffer
                # can be refilled. The consumer MUST have finished reading it
                # (torch.from_numpy aliases these arrays on CPU; the engine
                # finishes with, or copies out of, a chunk before advancing)
                if held is not None:
                    free.put(held._buf_id)
                    held = None
                if item is _DONE:
                    break
                if isinstance(item, BaseException):
                    raise item
                held = item
                yield item
        finally:
            stop.set()
            # unblock a producer waiting on a free buffer, then drain
            free.put(0)
            worker.join(timeout=5.0)
            if worker.is_alive() and sys.exc_info()[1] is None:
                # same leak guard as prefetch_iter: a staging thread that
                # outlives its pass keeps store FDs (and mmap views) open
                raise RuntimeError(
                    "edge-stream staging thread did not stop within 5s"
                )
