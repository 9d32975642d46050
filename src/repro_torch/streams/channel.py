"""Per-destination outbox→inbox message channels — the paper's §4 parallel
pipeline (U_s ∥ U_c ∥ U_r), reproduced at the host-thread boundary, in BOTH
directions: a background sender transmits finished groups while the fold
still computes, and a background receiver (:class:`ChannelReceiver` /
:func:`receive_iter`) densifies and digests the runs that have already
landed — full duplex, the "fully overlaps computation with communication"
of the paper's headline claim.

GraphD's headline design is that every worker "fully overlaps computation
with communication": while the compute thread is still folding edge blocks
for one destination group, the message groups that are already combined are
being serialized, optionally varint-delta compressed, and *transmitted* in
parallel by a dedicated sender. In this reproduction "transmission" is an
append to the destination shard's **inbox run files** (a
``streams.msgstore.MessageRunStore`` — one sorted run per transmitted group,
tagged with the producing source shard), which is exactly what a remote
GraphD machine would do with the bytes on arrival, and doubles as the
persisted-OMS message log of §3.4 when a ``RunFileMessageLog`` backs it.

:class:`ShardChannels` is that pipeline:

* ``send`` / ``send_raw`` enqueue one outgoing packet (a combined ``A_s``
  group, or one edge chunk's raw messages) onto a **bounded** in-flight
  queue — the producer blocks once ``inflight`` packets are queued, so the
  channel adds only a compiled-in constant to the engine's O(|V|/n) resident
  budget (each packet is at most one sparse group / one staged chunk);
* one background sender thread drains the queue in FIFO order: serializes,
  sorts raw packets by destination, appends to the inbox store, and runs the
  enqueued §3.3.1 compaction ops — all strictly in send order, so the inbox
  run table evolves exactly as the unpipelined engine's did (results can
  never depend on thread timing);
* ``flush`` is the per-destination barrier (all packets sent before the
  receiver digests an inbox), ``close`` the end-of-superstep join;
* :class:`ChannelStats` measures the overlap: ``send_seconds`` the sender
  spent transmitting vs ``stall_seconds`` the compute thread spent blocked
  on the channel — ``overlap_seconds`` (their difference) is transmit time
  hidden under compute, the quantity the paper's full-overlap claim is
  about (surfaced by ``benchmarks/bench_memory.py``);
* :class:`FaultPoint` is deterministic crash injection for fault drills: the
  sender thread dies after exactly N packets, mid-superstep, and the error
  surfaces on the next channel call — ``tests/test_fault.py`` drives
  recovery through it.

A sender crash can never publish a torn run: packets are appended atomically
at the Python level and the inbox index is only written at ``close_step``,
so recovery (``MessageRunStore`` re-``create`` on rerun, or
``recover_shard_streamed`` replay) starts from a consistent store.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.streams.msgstore import MessageRunStore


class ChannelError(RuntimeError):
    """The sender thread died; the original error is the ``__cause__``."""


@dataclass
class FaultPoint:
    """Deterministic fault injection: kill the sender thread once it has
    fully transmitted ``after_packets`` packets (barriers and compaction ops
    do not count). The count is cumulative across channels — i.e. across
    supersteps of one engine run, since packets flow in FIFO program order —
    so a single integer pins the crash to an exact packet of an exact
    superstep. Used by the crash drills in tests/test_fault.py.

    .. deprecated:: Kept only for the in-process (threads) sender drills.
       Everything process-level — socket sends/recvs, spill/store/checkpoint
       writes, coordinator kills — is driven by ``repro_torch.fault``'s
       site-scoped :class:`~repro_torch.fault.FaultSchedule` (the
       ``launch_opts["faults"]`` knob), which subsumes this single-counter
       hook; new drills should use that layer."""

    after_packets: int
    message: str = "injected sender fault"
    fired: bool = field(default=False)
    _count: int = field(default=0, repr=False)

    def record(self) -> None:
        self._count += 1
        if self._count >= self.after_packets:
            self.fired = True
            raise RuntimeError(self.message)


@dataclass
class ChannelStats:
    """Per-superstep channel accounting, both directions (surfaced by
    bench_memory's ``pipeline_overlap`` section)."""

    packets: int = 0
    messages: int = 0
    payload_bytes: int = 0  # pre-serialization bytes handed to the sender
    wire_bytes: int = 0  # bytes actually appended to the inbox files
    send_seconds: float = 0.0  # sender busy (serialize/compress/append)
    stall_seconds: float = 0.0  # compute thread blocked on the channel
    recv_runs: int = 0  # inbox runs digested by the background receiver
    recv_seconds: float = 0.0  # receiver busy (densify + digest / merge)
    recv_stall_seconds: float = 0.0  # compute thread blocked on the receiver
    # compress_payload="auto" verdict, e.g. "cnt=lossless(0.31) msg=raw(0.97)"
    # — per-channel scheme picked from the first-superstep sample's measured
    # codec ratios ("" until decided / when the knob is not "auto")
    payload_choice: str = ""

    def sender_overlap_seconds(self) -> float:
        """Transmit time hidden under compute: the sender was busy for
        ``send_seconds`` but only ``stall_seconds`` of it ever held the
        compute thread up — the rest ran under the fold (U_c ∥ U_s)."""
        return max(self.send_seconds - self.stall_seconds, 0.0)

    # pre-full-duplex name; ChannelStats used to account the sender only
    overlap_seconds = sender_overlap_seconds

    def receiver_overlap_seconds(self) -> float:
        """Digest time hidden under compute — the receiver-side dual
        (U_r ∥ U_c): the receiver was busy ``recv_seconds`` but only
        ``recv_stall_seconds`` of it held the compute thread at a collect
        barrier."""
        return max(self.recv_seconds - self.recv_stall_seconds, 0.0)

    def wire_ratio(self) -> float:
        """Pre-serialization payload bytes per byte actually put on the
        wire — the payload-codec shrink factor (1.0 when uncompressed)."""
        return self.payload_bytes / self.wire_bytes if self.wire_bytes else 1.0


_CLOSE = object()


class ShardChannels:
    """Outbox→inbox channels over one inbox store, one sender thread, and a
    bounded in-flight budget."""

    # cross-thread fields relying on GIL-atomic access instead of a lock:
    # _exc is write-once (sender thread) then read-only after _dead is set;
    # stats scalars are monotonic counters where a torn read is at worst a
    # stale-by-one report, never a control-flow input
    _LOCKED_FIELDS = frozenset({"_exc", "stats"})

    @staticmethod
    def packet_bytes(*, P: int, msg_itemsize: int, combined: bool,
                     chunk_slots: int = 0, compress: bool = False,
                     compress_payload=False) -> int:
        """Worst-case bytes of ONE in-flight packet — the unit of the §4
        channel RAM budget (``inflight * packet_bytes``), shared with the
        engine's memory_model and the resource planner. Combiner packets are
        one sparse combined group (<= P slots of dp+msg+cnt); raw packets one
        staged edge chunk (dp+msg+valid per slot). In-flight packets hold
        DECODED arrays (the sender encodes as it appends), so the RAM unit
        ignores the codecs; ``compress``/``compress_payload`` scale the
        *wire* estimate instead (see :func:`wire_bytes_per_message`)."""
        if combined:
            return P * (4 + msg_itemsize + 4)
        return chunk_slots * (4 + msg_itemsize + 1)

    @staticmethod
    def wire_bytes_per_message(*, msg_itemsize: int, combined: bool,
                               compress: bool = False,
                               compress_payload=False) -> float:
        """Estimated bytes ONE message costs on the wire — the unit of the
        planner's per-superstep network model. dp shrinks by the varint
        estimate under ``compress``; the msg (+ cnt) payload channels shrink
        by the payload-codec estimate under ``compress_payload`` (bf16
        additionally halves the msg channel before the codec)."""
        from repro_torch.streams.codec import PAYLOAD_RATIO_ESTIMATE
        from repro_torch.streams.store import COMPRESS_RATIO_ESTIMATE

        dp = 4 * COMPRESS_RATIO_ESTIMATE if compress else 4.0
        payload = msg_itemsize + (4 if combined else 0)  # msg (+ cnt)
        if compress_payload:
            if compress_payload == "bf16":
                payload = msg_itemsize / 2 + (4 if combined else 0)
            payload *= PAYLOAD_RATIO_ESTIMATE
        return dp + payload

    def __init__(self, inbox: MessageRunStore, inflight: int = 4,
                 fault: FaultPoint | None = None,
                 receiver: "ChannelReceiver | None" = None):
        if inflight < 1:
            raise ValueError("inflight budget must be >= 1")
        self.inbox = inbox
        self.inflight = inflight
        self.stats = ChannelStats()
        self._fault = fault
        # full-duplex mode: the sender notifies the receiver of every run it
        # lands, in append order, so digest order == transmit order
        self._receiver = receiver
        if receiver is not None and receiver.stats is None:
            receiver.stats = self.stats
        self._q: queue.Queue = queue.Queue(maxsize=inflight)
        self._exc: BaseException | None = None
        self._dead = threading.Event()
        self._aborting = threading.Event()
        self._worker = threading.Thread(
            target=self._run, name="channel-sender", daemon=True
        )
        self._worker.start()

    # -- producer side (the compute thread) ----------------------------------
    def send(self, dest: int, dp: np.ndarray, msg: np.ndarray,
             cnt: np.ndarray | None = None, tag: int = -1) -> None:
        """Transmit one already-combined, destination-sorted group (the
        sparse A_s(tag→dest) of §5): appended to ``dest``'s inbox as one
        tagged run. The arrays must be owned by the caller (they cross a
        thread boundary)."""
        self._put(("run", dest, dp, msg, cnt, tag))

    def send_combined(self, dest: int, A: np.ndarray, cnt: np.ndarray,
                      tag: int = -1) -> None:
        """Transmit one dense combined group A_s(tag→dest) (§5): the sender
        sparsifies (positions with cnt == 0 hold the combiner identity and
        are dropped on the wire) and appends one tagged run — serialization
        moves off the compute thread."""
        self._put(("combined", dest, A, cnt, tag))

    def send_raw(self, dest: int, dp: np.ndarray, msg: np.ndarray,
                 valid: np.ndarray, tag: int = -1) -> None:
        """Transmit one edge chunk's raw messages (combiner-less path): the
        sender filters invalid lanes, destination-sorts, and appends — the
        spill sort itself moves off the compute thread."""
        self._put(("raw", dest, dp, msg, valid, tag))

    def compact(self, dest: int, tag: int, fanin: int,
                read_chunk: int) -> None:
        """Enqueue a §3.3.1 bounded-fan-in compaction of ``tag``'s inbox
        runs; runs in send order like every other op."""
        self._put(("compact", dest, tag, fanin, read_chunk))

    def flush(self) -> None:
        """Barrier: returns once every previously enqueued op has been
        applied to the inbox (the receiver may digest after this). Raises
        if the sender died first — a barrier released by the death-path
        drain does NOT mean the ops before it landed."""
        done = threading.Event()
        self._put(("barrier", done))
        t0 = time.perf_counter()
        while not done.wait(timeout=0.05):
            if self._dead.is_set():
                break
        self.stats.stall_seconds += time.perf_counter() - t0
        if self._dead.is_set():
            # the sender processes ops FIFO and this thread is the only
            # producer, so a dead sender at this point means the barrier was
            # drained, not executed — ops before it may be missing
            self._raise()
            raise ChannelError("channel sender died before the barrier")

    def close(self) -> None:
        """Flush, stop the sender, and surface any sender error."""
        if self._worker.is_alive():
            self._offer_close()
            self._worker.join(timeout=10.0)
            self._check_stopped()
        self._raise()

    def abort(self) -> None:
        """Stop the sender WITHOUT surfacing its error — the crash-path
        cleanup (the superstep already failed; a second raise would mask
        the original). The sender discards any queued backlog (it is all
        destined for a store the caller is about to drop) instead of
        transmitting it, so abort returns promptly. A sender that still
        will not stop — hung mid-op — is the one exception that stays
        loud, or a rerun would truncate files a zombie thread keeps
        appending to."""
        self._aborting.set()
        self._offer_close()
        self._worker.join(timeout=10.0)
        self._check_stopped()

    def _offer_close(self) -> None:
        """Try to hand the sender a _CLOSE, giving up after 10s: a sender
        hung mid-op behind a full queue must fall through to join +
        _check_stopped (the loud hang report), not spin here forever."""
        deadline = time.monotonic() + 10.0
        while (self._worker.is_alive() and not self._dead.is_set()
               and time.monotonic() < deadline):
            try:
                self._q.put((_CLOSE,), timeout=0.05)
                return
            except queue.Full:
                pass

    def _check_stopped(self) -> None:
        if self._worker.is_alive():
            # python cannot kill a thread: surface the hang rather than let
            # the caller truncate/republish files the sender still writes
            raise ChannelError(
                "channel sender did not stop within 10s; its open file "
                "handles make the inbox store unsafe to reuse"
            )

    # -- internals ------------------------------------------------------------
    def _raise(self) -> None:
        if self._exc is not None:
            raise ChannelError("channel sender thread died") from self._exc

    def _put(self, item) -> None:
        t0 = time.perf_counter()
        while True:
            if self._dead.is_set():
                self.stats.stall_seconds += time.perf_counter() - t0
                self._raise()
                raise ChannelError("channel is closed")
            try:
                self._q.put(item, timeout=0.05)
                break
            except queue.Full:
                pass
        self.stats.stall_seconds += time.perf_counter() - t0

    def _run(self) -> None:
        try:
            while True:
                item = self._q.get()
                op = item[0]
                if op is _CLOSE or self._aborting.is_set():
                    return
                if op == "barrier":
                    item[1].set()
                    continue
                t0 = time.perf_counter()
                if op == "run":
                    _, dest, dp, msg, cnt, tag = item
                    seg = self.inbox.append_run(dest, dp, msg, cnt=cnt,
                                                tag=tag)
                    self._account(dp, msg, cnt, seg)
                    self._notify_receiver(dest, seg)
                elif op == "combined":
                    _, dest, A, cnt, tag = item
                    seg = self.inbox.append_combined(dest, A, cnt, tag=tag)
                    self._account_n(seg.length,
                                    seg.length * (4 + A.itemsize + 4), seg)
                    self._notify_receiver(dest, seg)
                elif op == "raw":
                    _, dest, dp, msg, valid, tag = item
                    seg = self.inbox.append_raw(dest, dp, msg, valid, tag=tag)
                    n = seg.length if seg is not None else 0
                    per = dp.itemsize + msg.itemsize
                    self._account_n(n, n * per, seg)
                elif op == "compact":
                    _, dest, tag, fanin, read_chunk = item
                    self.inbox.compact_tag(dest, tag, fanin, read_chunk)
                    self.stats.send_seconds += time.perf_counter() - t0
                    continue
                self.stats.send_seconds += time.perf_counter() - t0
                if self._fault is not None:
                    self._fault.record()
        except BaseException as e:
            self._exc = e
        finally:
            self._dead.set()
            # unblock producers waiting on a full queue; drained barriers
            # are set only to wake their waiters fast — flush() re-checks
            # _dead and refuses to treat a drained barrier as success
            while True:
                try:
                    leftover = self._q.get_nowait()
                    if leftover[0] == "barrier":
                        leftover[1].set()
                except queue.Empty:
                    break

    def _notify_receiver(self, dest: int, seg) -> None:
        if self._receiver is not None and seg is not None and seg.length:
            self._receiver.enqueue_digest(dest, seg)

    def _seg_wire_bytes(self, seg) -> int:
        """Bytes this run actually occupies in the inbox files (codec
        output for blob channels, fixed width otherwise)."""
        if seg is None or not seg.length:
            return 0
        inbox = self.inbox
        b = seg.dp_nbytes if seg.dp_nbytes >= 0 else seg.length * 4
        b += (seg.msg_nbytes if seg.msg_nbytes >= 0
              else seg.length * inbox.msg_dtype.itemsize)
        if inbox.with_counts:
            b += seg.cnt_nbytes if seg.cnt_nbytes >= 0 else seg.length * 4
        return b

    def _account(self, dp, msg, cnt, seg=None) -> None:
        self._account_n(int(dp.size), int(
            dp.nbytes + msg.nbytes + (cnt.nbytes if cnt is not None else 0)
        ), seg)

    def _account_n(self, messages: int, payload_bytes: int,
                   seg=None) -> None:
        self.stats.packets += 1
        self.stats.messages += messages
        self.stats.payload_bytes += payload_bytes
        self.stats.wire_bytes += self._seg_wire_bytes(seg)


class ChannelReceiver:
    """Background receiver — the U_r half of the §4 full overlap.

    The sender notifies it of every inbox run it lands (in append order);
    the receiver densifies the run back to a dense ``(A, cnt)`` pair
    (:meth:`MessageRunStore.read_combined`) and folds it into that
    destination's accumulator with the engine's jitted digest — all while
    the compute thread is still folding the NEXT group's edge chunks.
    Because digest order equals append order equals transmit order, the
    accumulated result is the exact per-position sequence of the
    half-duplex (digest-after-flush) path: full duplex is purely a
    scheduling change and results stay bit-identical.

    ``collect(dest)`` is the receiver-side barrier: it returns ``dest``'s
    finished accumulator once every digest enqueued before it has run
    (call it after the sender's ``flush()`` so all of ``dest``'s runs have
    been both appended and announced). The compute thread's wait there is
    ``recv_stall_seconds``; the receiver's total busy time minus it is the
    receiver overlap — digest time hidden under compute.

    ``fault`` is the receiver-side :class:`FaultPoint`: the thread dies
    after exactly N digested runs, mid-superstep; the error surfaces at the
    next ``collect``/``close`` and a torn inbox is never published
    (tests/test_fault.py drives recovery through it).
    """

    # same contract as ShardChannels: _exc write-once before _dead, stats
    # monotonic report-only counters — GIL-atomic by review
    _LOCKED_FIELDS = frozenset({"_exc", "stats"})

    def __init__(self, inbox: MessageRunStore, digest, identity, e0,
                 stats: ChannelStats | None = None,
                 fault: FaultPoint | None = None):
        self.inbox = inbox
        self._digest = digest  # (A, cnt, A_d, c_d) -> (A, cnt), blocking
        self._identity = identity  # () -> fresh (A, cnt)
        self._e0 = e0
        self.stats = stats
        self._fault = fault
        self._acc: dict[int, tuple] = {}
        self._q: queue.Queue = queue.Queue()
        self._exc: BaseException | None = None
        self._dead = threading.Event()
        self._worker = threading.Thread(
            target=self._run, name="channel-receiver", daemon=True
        )
        self._worker.start()

    # -- sender-thread side ---------------------------------------------------
    def enqueue_digest(self, dest: int, seg) -> None:
        """Announce one appended run (called by the channel sender; ops are
        descriptors only — the run data itself stays in the inbox files, so
        the queue never holds message payloads)."""
        self._q.put(("digest", dest, seg))

    # -- compute-thread side --------------------------------------------------
    def collect(self, dest: int):
        """Barrier + result: (A, cnt) for ``dest`` after every digest
        announced before this call has been folded in; the identity pair
        when no runs arrived (an all-skipped destination)."""
        box: list = [None]
        done = threading.Event()
        self._q.put(("collect", dest, box, done))
        t0 = time.perf_counter()
        while not done.wait(timeout=0.05):
            if self._dead.is_set():
                break
        if self.stats is not None:
            self.stats.recv_stall_seconds += time.perf_counter() - t0
        if self._dead.is_set() and not done.is_set():
            self._raise()
            raise ChannelError("channel receiver died before the collect")
        if self._exc is not None:
            self._raise()
        return box[0] if box[0] is not None else self._identity()

    def close(self) -> None:
        if self._worker.is_alive():
            self._q.put((_CLOSE,))
            self._worker.join(timeout=10.0)
            if self._worker.is_alive():
                raise ChannelError(
                    "channel receiver did not stop within 10s"
                )
        self._raise()

    def abort(self) -> None:
        """Crash-path stop WITHOUT surfacing the receiver's error (the
        superstep already failed; a second raise would mask the original).
        A receiver that will not stop — hung mid-digest — stays loud like
        the sender's: a zombie thread keeps the inbox run files open and
        would race any rerun that truncates them."""
        if self._worker.is_alive():
            self._q.put((_CLOSE,))
            self._worker.join(timeout=10.0)
            if self._worker.is_alive():
                raise ChannelError(
                    "channel receiver did not stop within 10s (aborting)"
                )

    # -- internals ------------------------------------------------------------
    def _raise(self) -> None:
        if self._exc is not None:
            raise ChannelError("channel receiver thread died") from self._exc

    def _run(self) -> None:
        try:
            while True:
                item = self._q.get()
                op = item[0]
                if op is _CLOSE:
                    return
                if op == "collect":
                    _, dest, box, done = item
                    box[0] = self._acc.pop(dest, None)
                    done.set()
                    continue
                _, dest, seg = item
                t0 = time.perf_counter()
                A_d, c_d = self.inbox.read_combined(dest, seg, self._e0)
                acc = self._acc.get(dest)
                if acc is None:
                    acc = self._identity()
                self._acc[dest] = self._digest(acc[0], acc[1], A_d, c_d)
                if self.stats is not None:
                    self.stats.recv_seconds += time.perf_counter() - t0
                    self.stats.recv_runs += 1
                if self._fault is not None:
                    self._fault.record()
        except BaseException as e:
            self._exc = e
        finally:
            self._dead.set()
            # wake collect() waiters fast; they re-check _dead and refuse
            # to treat a drained collect as success
            while True:
                try:
                    leftover = self._q.get_nowait()
                    if leftover[0] == "collect":
                        leftover[3].set()
                except queue.Empty:
                    break


def receive_iter(iterable, *, stats: ChannelStats | None = None,
                 fault: FaultPoint | None = None, depth: int = 2):
    """Receiver-thread prefetch over any staged stream — the combiner-less
    dual of :class:`ChannelReceiver`.

    ``streams.reader.prefetch_iter`` (the producer runs ``depth`` items
    ahead on a background thread) with the producer made an *accounted
    receiver*: its busy time lands in ``ChannelStats.recv_seconds``, the
    consumer's waits in ``recv_stall_seconds`` — so the OMS path's
    merge-read I/O hidden under apply compute shows up as receiver overlap —
    and a :class:`FaultPoint` kills the thread deterministically after N
    produced items (mid-merge crash drills). Producer errors surface on the
    consumer as :class:`ChannelError`.
    """
    from repro_torch.streams.reader import prefetch_iter

    def on_item(seconds: float) -> None:
        if stats is not None:
            stats.recv_seconds += seconds
            stats.recv_runs += 1
        if fault is not None:
            fault.record()

    def on_wait(seconds: float) -> None:
        if stats is not None:
            stats.recv_stall_seconds += seconds

    return prefetch_iter(
        iterable, depth=depth, on_item=on_item, on_wait=on_wait,
        wrap_exc=lambda e: ChannelError("channel receiver thread died"),
        thread_name="channel-receiver",
    )
