"""TCP socket transport for the multi-process launch (paper §4's network).

A copy of ``repro/launch/net.py`` (stdlib and numpy only), its imports
pointed at the port: the same frames, the same run codec, the same
write-ahead-log records and file names, so either package's peers, senders,
coordinator servers and clients talk to the other's.

The file transport exchanges messages through shared-filesystem run
files, so "network" cost is really disk cost. This layer ships the SAME run
wire format — per-destination runs in the sender's canonical spill/combine
transform, received in ascending source order — over persistent per-peer
TCP connections, and multiplexes the coordinator protocol (barrier
arrivals, commits, heartbeats, abort) onto one coordinator connection per
worker instead of polled files. Equivalence is structural: every run still
round-trips through a :class:`MessageRunStore` on both ends (sender-side
per-step outbox = the replay log, receiver-side inbox = the digest source),
so the 8-algorithm matrix stays bit-identical to the file transport and the
threaded driver on the CPU — float programs included.

Framing: ``>IBII`` header (magic, kind, payload length, CRC32 of payload),
then the payload. A short read or EOF mid-frame raises :class:`TornFrame`;
a CRC/magic mismatch raises :class:`FrameError`. Receivers treat both as
"this connection is dead": the torn frame is discarded and the reader waits
for the sender to reconnect — no partial run ever reaches an inbox.

Reconnect-with-resume: each sender keeps the step's outgoing runs in a
local outbox store (``shard-w/outbox/step-S``, deleted only after the
step's commit). A (re)connecting sender opens with ``HELLO{src, step}``;
the receiver replies ``RESUME{step, have, ended}`` where ``have`` counts
the runs it already appended from that source. The sender replays
``runs[have:]`` from its outbox — run index IS the sequence number, so
duplicates (``seq < have``) are discarded and the append order the digest
depends on is preserved across any number of connection drops, sender
respawns, or receiver respawns.

Deadlock-freedom of the ascending-source reader: worker w's reader drains
source 0 first while w's own sends proceed on the background transmit
thread, so source 0's transmissions always complete; induction on the
source index does the rest. TCP backpressure (bounded kernel buffers)
bounds the memory of not-yet-read sources.

Fault tolerance: every reconnect path (peer connect, coordinator
reconnect) runs under one :class:`repro_torch.fault.RetryPolicy` — bounded
attempts, exponential backoff with deterministic jitter, an overall
deadline — degrading to a loud :class:`repro_torch.fault.RetryExhausted`
with a structured summary instead of hanging forever or dying on first
error. The chaos layer's :class:`repro_torch.fault.FaultInjector` hooks the
three transport sites (``net.send`` in the data-plane sender, ``net.recv``
in the data-plane reader, ``coord.send`` in the coordinator client), and
the :class:`CoordServer` write-ahead-logs barrier commits, peer addresses
and aborts under ``wal_dir`` so a respawned coordinator process resumes the
run exactly where the dead one left it.
"""

from __future__ import annotations

import json
import os
import queue
import select
import socket
import struct
import threading
import time
import zlib

import numpy as np

import repro_torch.fault as _fault
from repro_torch.core.coordinator import (
    FileCoordinator, RunAborted, atomic_write_json,
)
from repro_torch.fault import RetryExhausted, RetryPolicy
from repro_torch.streams.codec import (
    decode_payload,
    decode_varint_delta,
    encode_payload,
    encode_varint_delta,
)

# Default tunables; each is a documented ``launch_opts`` knob (validated in
# core/config.py) threaded through the worker spec to the constructors below.
HANDSHAKE_TIMEOUT = 5.0  # bound on HELLO/CHELLO frames from a fresh accept
CONNECT_TIMEOUT = 5.0  # per-attempt TCP connect bound, data plane
SEND_TIMEOUT = 60.0  # data-plane sendall bound (a wedged receiver)
COORD_CONNECT_TIMEOUT = 10.0  # per-attempt TCP connect bound, coord plane

# -- framing -------------------------------------------------------------------

MAGIC = 0x47445052  # "GDPR"(aph-D): run-frame magic
_HEADER = struct.Struct(">IBII")  # magic, kind, payload nbytes, payload crc32
MAX_FRAME = 1 << 30  # sanity cap: a length beyond this is stream garbage

# data plane (worker <-> worker)
K_HELLO = 1  # sender handshake: {src, step}
K_RESUME = 2  # receiver reply: {step, have, ended}
K_RUN = 3  # one message run (json subheader + channel blobs)
K_END = 4  # sender finished the step toward this destination: {step, n_runs}
# coordinator plane (worker <-> launcher)
K_CHELLO = 10  # worker registration: {shard, addr}
K_PEERS = 11  # launcher reply: {addrs, last_commit, abort}
K_PEER_UPDATE = 12  # a shard respawned at a new address: {shard, addr}
K_BEAT = 13  # heartbeat: {shard, seq}
K_ARRIVE = 14  # barrier arrival: the full per-shard stats record
K_COMMIT = 15  # commit broadcast: the commit record
K_ABORT = 16  # poison pill broadcast: {reason}


class TornFrame(ConnectionError):
    """EOF or short read mid-frame: the peer died with a frame in flight.
    The partial bytes are discarded — never fed to an inbox."""


class FrameError(ConnectionError):
    """Magic or CRC mismatch: the stream is corrupt past recovery; the
    connection is dropped and the resume handshake re-delivers."""


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise TornFrame(f"connection closed after {len(buf)}/{n} bytes")
        buf += chunk
    return bytes(buf)


def send_frame(conn: socket.socket, kind: int, payload: bytes) -> int:
    """One length-prefixed CRC'd frame; returns bytes put on the wire."""
    hdr = _HEADER.pack(MAGIC, kind, len(payload), zlib.crc32(payload))
    conn.sendall(hdr + payload)
    return _HEADER.size + len(payload)


def recv_frame(conn: socket.socket) -> tuple[int, bytes]:
    """The inverse: blocks for one complete frame, verifies magic + CRC."""
    magic, kind, length, crc = _HEADER.unpack(_recv_exact(conn, _HEADER.size))
    if magic != MAGIC or length > MAX_FRAME:
        raise FrameError(f"bad frame header (magic={magic:#x} len={length})")
    payload = _recv_exact(conn, length)
    if zlib.crc32(payload) != crc:
        raise FrameError("frame CRC mismatch")
    return kind, payload


def _send_json(conn: socket.socket, kind: int, obj) -> int:
    return send_frame(conn, kind, json.dumps(obj).encode())


# -- run frame codec -----------------------------------------------------------

_RUN_HLEN = struct.Struct(">I")


def encode_run(*, step: int, seq: int, tag: int, dp: np.ndarray,
               msg: np.ndarray, cnt: np.ndarray | None,
               compress: bool = False, scheme: str | None = None) -> bytes:
    """One run -> one RUN frame payload.

    The channel blobs reuse the store codecs (varint-delta on the sorted
    destination column, the payload codec on the value column) so the wire
    carries the same compressed representation as the disk exchange it
    replaces. ``cnt`` (combine counts) stays raw — exactness is its job.
    """
    dp = np.ascontiguousarray(dp, np.int32)
    n = int(dp.size)
    dp_b = encode_varint_delta(dp) if (compress and n) else dp.tobytes()
    marr = np.ascontiguousarray(msg)
    msg_b = encode_payload(marr, scheme) if (scheme and n) else marr.tobytes()
    cnt_b = b""
    if cnt is not None:
        cnt_b = np.ascontiguousarray(cnt, np.int32).tobytes()
    hdr = json.dumps(dict(
        step=int(step), seq=int(seq), tag=int(tag), n=n,
        dp_nb=len(dp_b), msg_nb=len(msg_b), cnt_nb=len(cnt_b),
        dp_enc=bool(compress and n),
        scheme=scheme if (scheme and n) else None,
        msg_dtype=marr.dtype.name, cnt=cnt is not None,
    )).encode()
    return b"".join((_RUN_HLEN.pack(len(hdr)), hdr, dp_b, msg_b, cnt_b))


def decode_run(payload: bytes):
    """Inverse of :func:`encode_run` -> ``(hdr, dp, msg, cnt)``."""
    (hlen,) = _RUN_HLEN.unpack_from(payload)
    hdr = json.loads(payload[_RUN_HLEN.size:_RUN_HLEN.size + hlen])
    off = _RUN_HLEN.size + hlen
    n = hdr["n"]
    dp_b = payload[off:off + hdr["dp_nb"]]
    off += hdr["dp_nb"]
    msg_b = payload[off:off + hdr["msg_nb"]]
    off += hdr["msg_nb"]
    cnt_b = payload[off:off + hdr["cnt_nb"]]
    if hdr["dp_enc"]:
        dp = np.asarray(decode_varint_delta(dp_b), np.int32)
    else:
        dp = np.frombuffer(dp_b, np.int32)
    dtype = np.dtype(hdr["msg_dtype"])
    if hdr["scheme"]:
        msg = np.asarray(decode_payload(msg_b, dtype, n, hdr["scheme"]))
    else:
        msg = np.frombuffer(msg_b, dtype)
    cnt = np.frombuffer(cnt_b, np.int32) if hdr["cnt"] else None
    return hdr, dp, msg, cnt


def _force_close(sock: socket.socket) -> None:
    """Close a socket another thread may be blocked on. ``close()`` alone
    does NOT interrupt a thread parked in ``accept()`` or ``recv()`` on
    Linux — it stays in the syscall until traffic arrives, which is never
    at teardown; ``shutdown()`` forces accept to return EINVAL and recv to
    return EOF first. Every cross-thread close must go through here, or
    the join-with-timeout discipline in the ``close()`` methods turns a
    silently parked thread into a hard RuntimeError."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


# -- data plane: receiver ------------------------------------------------------

class PeerServer:
    """One per worker: accepts the n persistent inbound connections (one
    per source, self included via loopback) and hands complete runs to the
    step's reader in ascending source order.

    The accept thread performs the HELLO/RESUME handshake and swaps the
    per-source connection slot; :meth:`read_source` owns all data-frame
    reading, so runs from source j are appended exactly in sequence order —
    the append order the combiner-less merge's cursor tie-break depends on.
    """

    def __init__(self, n_shards: int, start_step: int,
                 host: str = "127.0.0.1", *,
                 handshake_timeout: float = HANDSHAKE_TIMEOUT):
        self.n = int(n_shards)
        self.handshake_timeout = float(handshake_timeout)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, 0))
        self._sock.listen(self.n + 8)
        self.addr = self._sock.getsockname()
        self._cv = threading.Condition()
        self._conns: list[socket.socket | None] = [None] * self.n
        self._step = int(start_step)
        self._have = [0] * self.n  # runs appended per source, this step
        self._ended = [False] * self.n
        self._closed = False
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="peer-accept", daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed
            try:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                # a wedged peer must not pin the accept loop past close():
                # bound the handshake, then restore blocking for data frames
                conn.settimeout(self.handshake_timeout)
                kind, payload = recv_frame(conn)
                if kind != K_HELLO:
                    raise FrameError(f"expected HELLO, got kind={kind}")
                src = int(json.loads(payload)["src"])
                with self._cv:
                    reply = dict(step=self._step, have=self._have[src],
                                 ended=self._ended[src])
                    old, self._conns[src] = self._conns[src], conn
                    self._cv.notify_all()
                _send_json(conn, K_RESUME, reply)
                conn.settimeout(None)
                if old is not None:
                    _force_close(old)
            except (ConnectionError, OSError, KeyError, ValueError):
                try:
                    conn.close()
                except OSError:
                    pass

    def begin_step(self, step: int) -> None:
        with self._cv:
            self._step = int(step)
            self._have = [0] * self.n
            self._ended = [False] * self.n

    def read_source(self, step: int, src: int, on_run, check_abort) -> int:
        """Drain source ``src`` for ``step``: calls ``on_run(hdr, dp, msg,
        cnt)`` per fresh run, returns the run count once END arrives.

        Stale frames (an earlier step, replayed after a commit the sender
        had not seen) and duplicates (``seq < have``, replayed by the
        resume handshake) are discarded; a torn/corrupt connection is
        dropped and the loop waits for the sender to reconnect."""
        while True:
            with self._cv:
                conn = self._conns[src]
            if conn is None:
                check_abort()
                with self._cv:
                    if self._conns[src] is None:
                        self._cv.wait(0.1)
                continue
            try:
                ready, _, _ = select.select([conn], [], [], 0.25)
                if not ready:
                    check_abort()
                    continue
                inj = _fault.active()
                if inj is not None:  # chaos: drop/reset/delay this receive
                    inj.net_recv(conn, step=step, src=src)
                kind, payload = recv_frame(conn)
            except (ConnectionError, OSError):
                self._drop(src, conn)
                check_abort()
                continue
            if kind == K_RUN:
                hdr, dp, msg, cnt = decode_run(payload)
                if hdr["step"] < step:
                    continue  # pre-reconnect leftovers of a committed step
                if hdr["step"] > step:
                    raise RuntimeError(
                        f"source {src} ran ahead: frame step {hdr['step']} "
                        f"while reading step {step}")
                if hdr["seq"] < self._have[src]:
                    continue  # resume-handshake replay duplicate
                if hdr["seq"] > self._have[src]:
                    raise RuntimeError(
                        f"sequence gap from source {src}: got {hdr['seq']}, "
                        f"expected {self._have[src]}")
                on_run(hdr, dp, msg, cnt)
                with self._cv:
                    self._have[src] += 1
            elif kind == K_END:
                if json.loads(payload)["step"] < step:
                    continue
                with self._cv:
                    self._ended[src] = True
                return self._have[src]
            else:
                raise RuntimeError(f"unexpected data frame kind={kind}")

    def _drop(self, src: int, conn: socket.socket) -> None:
        with self._cv:
            if self._conns[src] is conn:
                self._conns[src] = None
        try:
            conn.close()
        except OSError:
            pass

    def close(self) -> None:
        """Close the listener and every source connection, then join the
        accept thread — raising if it leaks (the ChannelSender contract:
        a thread we cannot stop keeps sockets open and makes this worker's
        inbox unsafe to reuse, so it must be an error, not a warning)."""
        self._closed = True
        _force_close(self._sock)
        with self._cv:  # the accept thread swaps slots under this lock
            conns = list(self._conns)
        for conn in conns:
            if conn is not None:
                _force_close(conn)
        if self._thread is not None and self._thread.ident is not None:
            self._thread.join(timeout=10.0)
            if self._thread.is_alive():
                raise RuntimeError(
                    "peer-accept thread failed to stop within 10s; "
                    "thread leaked")


# -- data plane: sender --------------------------------------------------------

class _Stop(Exception):
    """Internal: the sender was closed mid-wait."""


class PeerSender:
    """One per worker: a single transmit thread drains a FIFO op queue so
    runs leave in exactly the fold's emission order, overlapping the fold
    (§4's U_s ∥ U_c) the same way the threaded channel's sender does.

    Every run is appended to the step's local outbox store FIRST (the
    canonical spill/combine transform — same bytes as the file exchange)
    and the framed wire bytes are read back from it, so what is replayable
    is exactly what was sent. ``inflight`` bounds the queue the way the
    channel's sender does: the compute thread blocks (stall-accounted)
    when the network falls behind. Reconnects run under ``retry`` (a
    :class:`RetryPolicy`): exhausting the budget surfaces a
    :class:`RetryExhausted` through :meth:`check_failed` instead of
    waiting on an unreachable peer forever.
    """

    # GIL-atomic by review: _exc is write-once (transmit thread) and only
    # read after it is set; _stats scalars are monotonic stall/byte
    # counters — a torn read is a stale report, never a control decision
    _LOCKED_FIELDS = frozenset({"_exc", "_stats"})

    def __init__(self, me: int, n_shards: int, make_store, *,
                 inflight: int = 4, stats=None, check_abort=None,
                 connect_timeout: float = CONNECT_TIMEOUT,
                 send_timeout: float = SEND_TIMEOUT,
                 retry: RetryPolicy | None = None):
        self.me = int(me)
        self.n = int(n_shards)
        self._make_store = make_store  # step -> fresh MessageRunStore
        self._stats = stats
        self._check_abort = check_abort or (lambda: None)
        self.connect_timeout = float(connect_timeout)
        self.send_timeout = float(send_timeout)
        self._retry = retry if retry is not None else RetryPolicy()
        self._addrs: list[tuple | None] = [None] * self.n
        self._conns: list[socket.socket | None] = [None] * self.n
        self._q: queue.Queue = queue.Queue()
        self._slots = threading.BoundedSemaphore(max(1, int(inflight)))
        self._sent = [0] * self.n  # runs appended (== next seq) per dest
        self._end_sent = [False] * self.n
        # per-dest consecutive send-failure episode: (episode t0, count).
        # Transmit-thread confined.
        self._send_fail: dict[int, tuple[float, int]] = {}
        self._step: int | None = None
        self._store = None
        self._stores: dict[int, object] = {}  # kept until the step commits
        self._exc: BaseException | None = None
        self._closed = False
        self._thread = threading.Thread(target=self._loop, name="peer-send",
                                        daemon=True)

    # -- compute-thread surface ----------------------------------------------
    def set_addrs(self, addrs) -> None:
        self._addrs = [tuple(a) for a in addrs]

    def start(self) -> None:
        self._thread.start()

    def update_addr(self, shard: int, addr) -> None:
        """PEER_UPDATE arrived: shard respawned at a new address. The
        transmit thread reconnects and the RESUME handshake replays the
        outbox backlog."""
        self._addrs[int(shard)] = tuple(addr)
        self._q.put(("resync", int(shard)))

    def begin_step(self, step: int) -> None:
        """Synchronous: returns once the transmit thread swapped in the
        step's fresh outbox store (all prior-step ops drained first)."""
        ev = threading.Event()
        self._q.put(("begin", int(step), ev))
        self._wait(ev)

    def send_combined(self, dest: int, A, cnt, tag: int) -> None:
        self._acquire_slot()
        self._q.put(("comb", int(dest), A, cnt, int(tag)))

    def send_raw(self, dest: int, dp, msg, valid, tag: int) -> None:
        self._acquire_slot()
        self._q.put(("raw", int(dest), dp, msg, valid, int(tag)))

    def end_step(self) -> None:
        """Queue the END fan-out: ensures every destination's backlog is
        fully delivered (reconnecting + replaying as needed) before END."""
        ev = threading.Event()
        self._q.put(("end", ev))
        self._wait(ev)

    def finish_step(self, step: int) -> None:
        """The step committed: every receiver has everything, the outbox
        log is dead weight — delete it."""
        self._q.put(("drop", int(step)))

    def check_failed(self) -> None:
        if self._exc is not None:
            raise RuntimeError("socket sender failed") from self._exc

    def close(self) -> None:
        """Stop and JOIN the transmit thread, raising if it leaks. The quit
        op tears down connections and outbox stores from inside the thread
        (its own teardown path); ``_closed`` breaks any reconnect wait."""
        self._closed = True
        self._q.put(("quit",))
        if self._thread.ident is not None:
            self._thread.join(timeout=10.0)
            if self._thread.is_alive():
                raise RuntimeError(
                    "peer-send thread failed to stop within 10s; thread "
                    "leaked (outbox stores and sockets still held)")

    # -- plumbing --------------------------------------------------------------
    def _acquire_slot(self) -> None:
        self.check_failed()
        t0 = time.perf_counter()
        while not self._slots.acquire(timeout=0.5):
            self.check_failed()
            self._check_abort()
        if self._stats is not None:
            self._stats.stall_seconds += time.perf_counter() - t0

    def _wait(self, ev: threading.Event) -> None:
        while not ev.wait(0.5):
            self.check_failed()
            self._check_abort()

    # -- transmit thread -------------------------------------------------------
    def _loop(self) -> None:
        while True:
            op = self._q.get()
            if op[0] == "quit":
                self._teardown()
                return
            try:
                t0 = time.perf_counter()
                busy = self._dispatch(op)
                if busy and self._stats is not None:
                    self._stats.send_seconds += time.perf_counter() - t0
            except (_Stop, RunAborted):
                self._teardown()
                return
            except BaseException as e:  # surfaced via check_failed()
                self._exc = e
                self._teardown()
                return

    def _dispatch(self, op) -> bool:
        kind = op[0]
        if kind == "begin":
            _, step, ev = op
            self._step = step
            self._store = self._make_store(step)
            self._stores[step] = self._store
            self._sent = [0] * self.n
            self._end_sent = [False] * self.n
            ev.set()
            return False
        if kind == "comb":
            _, dest, A, cnt, tag = op
            seg = self._store.append_combined(dest, A, cnt, tag=tag)
            self._transmit_seg(dest, seg)
            self._slots.release()
            return True
        if kind == "raw":
            _, dest, dp, msg, valid, tag = op
            seg = self._store.append_raw(dest, dp, msg, valid, tag=tag)
            if seg is not None:  # all-invalid chunks never become runs
                self._transmit_seg(dest, seg)
            self._slots.release()
            return True
        if kind == "end":
            _, ev = op
            self._store.save_index()  # outbox becomes a valid replay log
            for dest in range(self.n):
                self._ensure_conn(dest)
                self._send_end(dest)
            ev.set()
            return True
        if kind == "resync":
            _, dest = op
            conn = self._conns[dest]
            self._conns[dest] = None
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass
            if self._step is not None:
                self._ensure_conn(dest)
                if self._end_sent[dest]:
                    self._send_end(dest, resend=True)
            return True
        if kind == "drop":
            store = self._stores.pop(op[1], None)
            if store is not None:
                store.delete()
            return False
        raise RuntimeError(f"unknown sender op {kind!r}")

    def _teardown(self) -> None:
        for conn in self._conns:
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass
        for store in self._stores.values():
            try:
                store.close()
            except OSError:
                pass

    def _transmit_seg(self, dest: int, seg) -> None:
        """Frame one just-appended run and send it; run index == seq."""
        seq = self._sent[dest]
        self._sent[dest] += 1
        if self._conns[dest] is None:
            self._ensure_conn(dest)
            return  # the handshake replay just delivered runs[have:], incl. this one
        self._send_run(dest, seq, seg)

    def _send_run(self, dest: int, seq: int, seg) -> None:
        conn = self._conns[dest]
        if conn is None:
            return  # dead conn: the run waits in the outbox for resync
        parts = self._store.read_run(dest, seg)
        cnt = parts[2] if self._store.with_counts else None
        payload = encode_run(step=self._step, seq=seq, tag=seg.tag,
                             dp=parts[0], msg=parts[1], cnt=cnt,
                             compress=self._store.compress,
                             scheme=self._store.payload_scheme)
        try:
            inj = _fault.active()
            if inj is not None:  # chaos: torn_kill/drop/reset/delay this frame
                hdr = _HEADER.pack(MAGIC, K_RUN, len(payload),
                                   zlib.crc32(payload))
                inj.net_send(conn, hdr, payload, step=self._step, dest=dest)
            wire = send_frame(conn, K_RUN, payload)
        except OSError as e:
            self._kill_conn(dest, conn)
            self._note_send_failure(dest, e)
            return
        self._send_fail.pop(dest, None)
        if self._stats is not None:
            self._stats.wire_bytes += wire
            self._stats.packets += 1
            self._stats.payload_bytes += sum(
                p.nbytes for p in parts if p is not None)

    def _send_end(self, dest: int, resend: bool = False) -> None:
        while True:
            conn = self._conns[dest]
            if conn is None and not resend:
                # END must land: a receiver blocked on this source would hang
                self._ensure_conn(dest)
                conn = self._conns[dest]
                if conn is None:
                    # the handshake replay itself failed (and noted the
                    # failure): giving up here would let the step "finish"
                    # with runs undelivered and the receiver parked forever
                    continue
            if conn is None:
                return
            try:
                wire = _send_json(
                    conn, K_END,
                    dict(step=self._step, n_runs=self._sent[dest]))
                if self._stats is not None and not resend:
                    self._stats.wire_bytes += wire
                    self._stats.packets += 1
            except OSError as e:
                self._kill_conn(dest, conn)
                self._note_send_failure(dest, e)
                if not resend:
                    continue  # reconnect (budget-bounded) and retry END
            else:
                self._send_fail.pop(dest, None)
            self._end_sent[dest] = True
            return

    def _kill_conn(self, dest: int, conn: socket.socket) -> None:
        if self._conns[dest] is conn:
            self._conns[dest] = None
        try:
            conn.close()
        except OSError:
            pass

    def _note_send_failure(self, dest: int, err: OSError) -> None:
        """Bound the send-failure EPISODE. A peer that keeps accepting
        connections but never takes a frame would otherwise livelock the
        reconnect->replay->fail cycle forever: every successful connect
        resets ``_ensure_conn``'s retry episode, so the connect-path
        budget never accumulates. Sends to a dest that have failed
        consecutively past the same policy's attempt/deadline budget
        surface the same loud :class:`RetryExhausted`; any delivered
        frame resets the episode."""
        site = f"peer-send:{self.me}->{dest}"
        t0, n = self._send_fail.get(dest, (time.monotonic(), 0))
        n += 1
        self._send_fail[dest] = (t0, n)
        elapsed = time.monotonic() - t0
        if (self._retry.max_attempts and n >= self._retry.max_attempts) \
                or elapsed > self._retry.deadline:
            raise RetryExhausted(site, self._retry, err,
                                 attempts=n, elapsed=elapsed)
        # back off before the caller's next attempt — sliced so close()
        # never waits behind a long sleep
        remaining = self._retry.delay_for(site, n)
        while remaining > 0 and not self._closed:
            step = min(remaining, 0.25)
            time.sleep(step)
            remaining -= step

    def _ensure_conn(self, dest: int) -> None:
        """Connect + HELLO/RESUME handshake + backlog replay. Retries under
        the :class:`RetryPolicy` while the destination is unreachable (a
        respawning worker) — the outbox store makes the wait safe — and
        raises :class:`RetryExhausted` when the budget runs out, so an
        unreachable peer becomes a loud structured failure, not a hang."""
        if self._conns[dest] is not None:
            return
        site = f"peer-connect:{self.me}->{dest}"
        stopped = False
        last: BaseException | None = None
        attempts = 0
        t0 = time.monotonic()

        def _stop() -> bool:
            nonlocal stopped
            if self._closed:
                stopped = True
                return True
            self._check_abort()  # RunAborted propagates through the generator
            return False

        for attempt in self._retry.attempts(site, should_stop=_stop):
            attempts = attempt
            if self._closed:
                raise _Stop()
            self._check_abort()
            addr = self._addrs[dest]
            try:
                conn = socket.create_connection(addr,
                                                timeout=self.connect_timeout)
            except OSError as e:
                last = e
                continue
            try:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn.settimeout(self.send_timeout)
                _send_json(conn, K_HELLO, dict(src=self.me, step=self._step))
                kind, payload = recv_frame(conn)
                if kind != K_RESUME:
                    raise FrameError(f"expected RESUME, got kind={kind}")
                reply = json.loads(payload)
            except (ConnectionError, OSError, ValueError) as e:
                last = e
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            break
        else:
            if stopped or self._closed:
                raise _Stop()
            raise RetryExhausted(site, self._retry, last, attempts=attempts,
                                 elapsed=time.monotonic() - t0)
        self._conns[dest] = conn
        if reply["step"] == self._step:
            have = int(reply["have"])
        elif reply["step"] > self._step:
            # receiver already past our step (it saw the commit; we have
            # not yet) — it needs nothing more from this step
            have = self._sent[dest]
        else:
            # receiver behind (respawned, or between steps): it holds
            # nothing of our current step yet
            have = 0
        for seq, seg in enumerate(self._store.runs(dest)[have:self._sent[dest]],
                                  start=have):
            self._send_run(dest, seq, seg)


# -- coordinator plane ---------------------------------------------------------

class CoordServer:
    """The coordinator's side of the coordinator plane: one listener, one
    persistent connection per worker, the FileCoordinator surface
    (wait_arrivals / reduce_arrivals / publish_commit / abort / stale)
    backed by in-memory state fed by per-connection reader threads —
    commits and aborts are PUSHED to workers, so their barrier waits are
    event-driven instead of polled files.

    With ``wal_dir`` set, barrier commits, the peer address table, and any
    abort are write-ahead-logged (the tmp→fsync→replace idiom) BEFORE they
    take effect in memory, and a fresh server restores all three at
    construction — so a SIGKILLed coordinator process can be respawned and
    the run resumes from the last committed superstep instead of dying
    with it. A restarted server also grants every not-yet-reconnected
    worker a boot grace period: ``stale()`` only condemns a never-seen
    shard once ``heartbeat_timeout + boot_grace`` has elapsed since this
    server booted, so live workers mid-reconnect are not false-killed.
    """

    def __init__(self, n_shards: int, *, heartbeat_timeout: float = 10.0,
                 host: str = "127.0.0.1",
                 handshake_timeout: float = HANDSHAKE_TIMEOUT,
                 wal_dir: str | None = None,
                 boot_grace: float | None = None):
        self.n = int(n_shards)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.handshake_timeout = float(handshake_timeout)
        self.boot_grace = (float(boot_grace) if boot_grace is not None
                           else self.heartbeat_timeout)
        self.wal_dir = wal_dir
        self._boot = time.monotonic()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, 0))
        self._sock.listen(self.n + 8)
        self.addr = self._sock.getsockname()
        self._cv = threading.Condition()
        self._conns: dict[int, socket.socket] = {}
        self._send_lock = threading.Lock()
        self._addrs: dict[int, tuple] = {}  # shard -> data-plane addr
        self._seen: set[int] = set()
        self._beats: dict[int, tuple] = {}  # shard -> (seq, monotonic recv)
        self._grace: dict[int, float] = {}  # shard -> monotonic stale waiver
        self._arrivals: dict[int, dict[int, dict]] = {}
        self._commits: dict[int, dict] = {}
        self._last_commit: dict | None = None
        self._abort: str | None = None
        self._closed = False
        self._threads: list[threading.Thread] = []  # accept + serve threads
        if wal_dir:
            os.makedirs(wal_dir, exist_ok=True)
            self._restore_wal()

    def _restore_wal(self) -> None:
        """Reload commits, peer addresses and any abort a predecessor
        coordinator logged. Every WAL record was published atomically, so
        a file either parses or does not exist — but a half-written
        leftover from a dead tmp is still skipped defensively."""
        for name in sorted(os.listdir(self.wal_dir)):
            if not (name.startswith("commit-") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.wal_dir, name)) as f:
                    rec = json.load(f)
                self._commits[int(rec["step"])] = rec
                self._last_commit = rec
            except (OSError, ValueError, KeyError):
                continue
        try:
            with open(os.path.join(self.wal_dir, "addrs.json")) as f:
                addrs = json.load(f)
            self._addrs = {int(w): tuple(a) for w, a in addrs.items()}
            # every restored shard counts as seen: its re-CHELLO is a
            # respawn, so peers get a PEER_UPDATE even if its data-plane
            # address survived the coordinator outage unchanged
            self._seen = set(self._addrs)
        except (OSError, ValueError):
            pass
        try:
            with open(os.path.join(self.wal_dir, "abort.json")) as f:
                self._abort = str(json.load(f)["reason"])
        except (OSError, ValueError, KeyError):
            pass

    def start(self) -> None:
        t = threading.Thread(target=self._accept_loop, name="coord-accept",
                             daemon=True)
        with self._cv:
            self._threads.append(t)
        t.start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="coord-conn", daemon=True)
            with self._cv:
                # prune finished serve threads so reconnect churn does not
                # grow the join list unboundedly
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        shard = None
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # pre-CHELLO the conn is untracked, so close() cannot unblock
            # this recv — bound it instead, then restore blocking once the
            # conn is registered in _conns (close() closes those)
            conn.settimeout(self.handshake_timeout)
            kind, payload = recv_frame(conn)
            conn.settimeout(None)
            if kind != K_CHELLO:
                raise FrameError(f"expected CHELLO, got kind={kind}")
            msg = json.loads(payload)
            shard = int(msg["shard"])
            addr = tuple(msg["addr"])
            with self._cv:
                respawn = shard in self._seen
                self._seen.add(shard)
                self._addrs[shard] = addr
                old = self._conns.get(shard)
                self._conns[shard] = conn
                self._cv.notify_all()
                if self.wal_dir:
                    snap = {str(w): list(a) for w, a in self._addrs.items()}
            if self.wal_dir:
                atomic_write_json(os.path.join(self.wal_dir, "addrs.json"),
                                  snap)
            if old is not None:
                _force_close(old)
            if respawn:
                self._broadcast(K_PEER_UPDATE,
                                dict(shard=shard, addr=list(addr)),
                                exclude=shard)
            with self._cv:  # first launch: PEERS only once everyone is in
                while (len(self._addrs) < self.n and self._abort is None
                       and not self._closed):
                    self._cv.wait(0.1)
                if self._closed:
                    return
                reply = dict(
                    addrs=[list(self._addrs[j]) for j in range(self.n)]
                    if len(self._addrs) == self.n else None,
                    last_commit=self._last_commit, abort=self._abort)
            with self._send_lock:
                _send_json(conn, K_PEERS, reply)
            while True:
                kind, payload = recv_frame(conn)
                msg = json.loads(payload)
                if kind == K_BEAT:
                    with self._cv:  # heartbeat_age reads under the same lock
                        self._beats[shard] = (msg.get("seq"),
                                              time.monotonic())
                elif kind == K_ARRIVE:
                    with self._cv:
                        step = int(msg["step"])
                        self._arrivals.setdefault(step, {})[shard] = msg
                        self._cv.notify_all()
        except (ConnectionError, OSError, ValueError, KeyError):
            pass
        finally:
            with self._cv:
                if shard is not None and self._conns.get(shard) is conn:
                    del self._conns[shard]
            try:
                conn.close()
            except OSError:
                pass

    def _broadcast(self, kind: int, obj, exclude: int | None = None) -> None:
        with self._cv:
            conns = {w: c for w, c in self._conns.items() if w != exclude}
        for conn in conns.values():
            try:
                with self._send_lock:
                    _send_json(conn, kind, obj)
            except OSError:
                pass  # a dead worker's conn; liveness handles it

    # -- FileCoordinator surface (launcher side) -------------------------------
    def arrivals(self, step: int) -> dict[int, dict]:
        with self._cv:
            return dict(self._arrivals.get(int(step), {}))

    def wait_arrivals(self, step: int, on_wait=None) -> dict[int, dict]:
        step = int(step)
        while True:
            with self._cv:
                got = dict(self._arrivals.get(step, {}))
                if len(got) == self.n:
                    return got
                if on_wait is None:
                    self._cv.wait(0.25)
                    continue
            on_wait(got)  # liveness hook runs outside the lock
            with self._cv:
                if len(self._arrivals.get(step, {})) != len(got):
                    continue
                self._cv.wait(0.05)

    # identical shard-ascending reduction — totals stay bit-identical
    reduce_arrivals = staticmethod(FileCoordinator.reduce_arrivals)

    def publish_commit(self, step: int, totals: dict, *, halt: bool,
                       ckpt_landed: bool, extra: dict | None = None) -> dict:
        """Log the commit record (WAL first — a successor coordinator must
        never un-commit a barrier workers already advanced past), then
        publish it in memory and push it to every worker. ``extra`` rides
        extra launcher state (e.g. per-step seconds) into the record."""
        rec = dict(step=int(step), halt=bool(halt),
                   ckpt_landed=bool(ckpt_landed), **totals)
        if extra:
            rec.update(extra)
        if self.wal_dir:
            atomic_write_json(
                os.path.join(self.wal_dir, f"commit-{int(step):06d}.json"),
                rec)
        with self._cv:
            self._commits[int(step)] = rec
            self._last_commit = rec
        self._broadcast(K_COMMIT, rec)
        return rec

    def commit(self, step: int) -> dict | None:
        with self._cv:
            return self._commits.get(int(step))

    def last_commit_step(self) -> int:
        """The newest committed superstep (WAL-restored ones included), or
        -1 before any barrier has committed."""
        with self._cv:
            return int(self._last_commit["step"]) if self._last_commit else -1

    def abort(self, reason: str) -> None:
        if self.wal_dir:
            atomic_write_json(os.path.join(self.wal_dir, "abort.json"),
                              dict(reason=str(reason)))
        with self._cv:
            self._abort = str(reason)
            self._cv.notify_all()
        self._broadcast(K_ABORT, dict(reason=str(reason)))

    def aborted(self) -> str | None:
        return self._abort

    def check_abort(self) -> None:
        if self._abort is not None:
            raise RunAborted(f"run aborted by coordinator: {self._abort}")

    def heartbeat_age(self, shard: int) -> float:
        with self._cv:
            beat = self._beats.get(int(shard))
        if beat is None:
            return float("inf")
        return time.monotonic() - beat[1]

    def grant_grace(self, shard: int, seconds: float) -> None:
        """Waive staleness for ``shard`` until ``seconds`` from now — the
        liveness loop grants this to a worker it just respawned (or that
        must reconnect after a coordinator restart) so import/recovery
        time is not judged as heartbeat silence."""
        until = time.monotonic() + float(seconds)
        with self._cv:
            self._grace[int(shard)] = max(self._grace.get(int(shard), 0.0),
                                          until)

    def stale(self, shard: int) -> bool:
        now = time.monotonic()
        with self._cv:
            beat = self._beats.get(int(shard))
            grace_until = self._grace.get(int(shard), 0.0)
        if now < grace_until:
            return False
        if beat is None:
            # never heard from since THIS server booted: after a
            # coordinator restart every live worker looks beat-less until
            # its reconnect lands, so a fresh server grants the full
            # timeout plus boot_grace from boot before condemning anyone
            return now - self._boot > self.heartbeat_timeout + self.boot_grace
        return now - beat[1] > self.heartbeat_timeout

    def gc_steps(self, before: int) -> None:
        with self._cv:
            for s in [s for s in self._arrivals if s < before]:
                del self._arrivals[s]
            for s in [s for s in self._commits if s < before]:
                del self._commits[s]

    def close(self) -> None:
        """Close the listener and every worker connection, wake PEERS
        waiters, then join accept + serve threads — raising if any leak."""
        self._closed = True
        _force_close(self._sock)
        with self._cv:
            conns = list(self._conns.values())
            threads = list(self._threads)
            self._cv.notify_all()  # release any serve thread in PEERS wait
        for conn in conns:
            _force_close(conn)
        leaked = []
        for t in threads:
            if t.ident is None:
                continue
            t.join(timeout=10.0)
            if t.is_alive():
                leaked.append(t.name)
        if leaked:
            raise RuntimeError(
                f"coordinator threads failed to stop within 10s: "
                f"{', '.join(leaked)}; threads leaked")


class CoordClient:
    """The worker's side: stdlib-only (it starts BEFORE the heavy torch
    import, exactly like the file heartbeat, so liveness covers import
    time), one socket, a reader thread that turns pushed COMMIT/ABORT/
    PEER_UPDATE frames into event-driven barrier wakeups, and a heartbeat
    thread whose sequence numbers feed the coordinator's staleness
    judgement.

    Reconnect-with-resume: a lost coordinator connection is no longer a
    poison pill. The reader re-resolves the coordinator address (from
    ``addr_file`` when given — a respawned coordinator publishes a new
    port there), reconnects under ``retry``, re-sends CHELLO, and replays
    the one arrival that may be stranded un-committed; the coordinator's
    K_PEERS reply carries its WAL-restored ``last_commit`` so a commit
    broadcast lost in the outage is recovered too. Only an exhausted retry
    budget aborts the worker — with a structured summary in ``failure``.
    """

    def __init__(self, addr=None, shard: int = 0, *,
                 heartbeat_interval: float = 0.25,
                 addr_file: str | None = None,
                 connect_timeout: float = COORD_CONNECT_TIMEOUT,
                 retry: RetryPolicy | None = None):
        if addr is None and addr_file is None:
            raise ValueError("CoordClient needs addr or addr_file")
        self.shard = int(shard)
        self.heartbeat_interval = float(heartbeat_interval)
        self.connect_timeout = float(connect_timeout)
        self.retry = retry if retry is not None else RetryPolicy()
        self._addr = tuple(addr) if addr is not None else None
        self._addr_file = addr_file
        self.failure: dict | None = None  # RetryExhausted summary, if any
        self._wlock = threading.Lock()
        self._cv = threading.Condition()
        self._commits: dict[int, dict] = {}
        self._peers: dict | None = None
        self._abort: str | None = None
        self._closed = False
        self._stop = threading.Event()
        self._hello = threading.Event()  # beats must not precede CHELLO
        self._data_addr: list | None = None  # remembered for re-CHELLO
        self._pending_arrival: dict | None = None  # un-committed, replayable
        self.on_peer_update = None  # set by the worker once the sender exists
        self._threads: list[threading.Thread] = []
        self._sock = self._connect(f"coord-connect:{self.shard}")

    def _resolve_addr(self) -> tuple:
        """The coordinator's current address: re-read from ``addr_file``
        each attempt (a respawned coordinator listens on a new port), else
        the static address given at construction."""
        if self._addr_file is not None:
            with open(self._addr_file) as f:
                rec = json.load(f)
            return tuple(rec["addr"])
        return self._addr

    def _connect(self, site: str) -> socket.socket:
        last: BaseException | None = None
        attempts = 0
        t0 = time.monotonic()
        for attempt in self.retry.attempts(site,
                                           should_stop=self._stop.is_set):
            attempts = attempt
            try:
                sock = socket.create_connection(self._resolve_addr(),
                                                timeout=self.connect_timeout)
            except (OSError, ValueError, KeyError) as e:
                last = e  # incl. a missing/NOT-yet-republished addr_file
                continue
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return sock
        raise RetryExhausted(site, self.retry, last, attempts=attempts,
                             elapsed=time.monotonic() - t0)

    def _send(self, kind: int, obj) -> None:
        payload = json.dumps(obj).encode()
        with self._wlock:
            inj = _fault.active()
            if inj is not None:  # chaos: drop/reset/delay the coord plane
                hdr = _HEADER.pack(MAGIC, kind, len(payload),
                                   zlib.crc32(payload))
                inj.net_send(self._sock, hdr, payload, site="coord.send")
            send_frame(self._sock, kind, payload)

    def start(self) -> None:
        self._threads = [
            threading.Thread(target=self._reader, name="coord-read",
                             daemon=True),
            threading.Thread(target=self._beats, name="coord-beat",
                             daemon=True),
        ]
        for t in self._threads:
            t.start()

    def register(self, data_addr) -> list[tuple]:
        """CHELLO with our data-plane address; blocks for PEERS (all n
        registered). Returns the peer address table; any commit the run
        already published is seeded into the local commit cache (by the
        reader's K_PEERS handler) so a respawned worker sees its recovery
        baseline immediately."""
        self._data_addr = list(data_addr)
        try:
            self._send(K_CHELLO, dict(shard=self.shard,
                                      addr=self._data_addr))
        except OSError:
            pass  # the reader's reconnect replays the CHELLO
        self._hello.set()  # heartbeats may flow now that CHELLO framed first
        with self._cv:
            while self._peers is None and self._abort is None:
                self._cv.wait(0.2)
            self.check_abort()
            peers = self._peers
        return [tuple(a) for a in peers["addrs"]]

    def _reconnect(self) -> bool:
        """Swap in a fresh coordinator connection and resume: re-CHELLO
        (the K_PEERS reply then triggers the pending-arrival replay).
        Returns False — with the abort flagged and a structured summary in
        ``failure`` — only when the retry budget is exhausted."""
        site = f"coord-reconnect:{self.shard}"
        try:
            sock = self._connect(site)
        except RetryExhausted as e:
            with self._cv:
                if not self._closed:
                    self._abort = self._abort or str(e)
                    self.failure = e.summary()
                self._cv.notify_all()
            return False
        with self._wlock:
            old, self._sock = self._sock, sock
        if old is not None:
            _force_close(old)
        if self._data_addr is not None:
            try:
                self._send(K_CHELLO, dict(shard=self.shard,
                                          addr=self._data_addr))
            except OSError:
                pass  # dead again already: the next recv fails and we loop
        return True

    def _replay_pending(self) -> None:
        """Re-send the arrival a coordinator outage may have stranded; the
        server's ``setdefault(...)[shard] = msg`` makes duplicates
        idempotent, and a commit that landed meanwhile already cleared it."""
        with self._cv:
            pending = self._pending_arrival
        if pending is not None:
            try:
                self._send(K_ARRIVE, pending)
            except OSError:
                pass  # still down: replayed again after the next reconnect

    def _reader(self) -> None:
        while True:
            try:
                kind, payload = recv_frame(self._sock)
                msg = json.loads(payload)
            except (ConnectionError, OSError, ValueError):
                with self._cv:
                    if self._closed:
                        self._cv.notify_all()
                        return
                if not self._reconnect():
                    return  # budget exhausted; abort already flagged
                continue
            if kind == K_COMMIT:
                with self._cv:
                    self._commits[int(msg["step"])] = msg
                    pa = self._pending_arrival
                    if pa is not None and int(msg["step"]) >= int(pa["step"]):
                        self._pending_arrival = None
                    self._cv.notify_all()
            elif kind == K_PEERS:
                with self._cv:
                    if msg.get("abort"):
                        self._abort = msg["abort"]
                    self._peers = msg
                    last = msg.get("last_commit")
                    if last is not None:
                        self._commits[int(last["step"])] = last
                        pa = self._pending_arrival
                        if pa is not None and \
                                int(last["step"]) >= int(pa["step"]):
                            self._pending_arrival = None
                    self._cv.notify_all()
                self._replay_pending()
            elif kind == K_PEER_UPDATE:
                cb = self.on_peer_update
                if cb is not None:
                    cb(int(msg["shard"]), tuple(msg["addr"]))
            elif kind == K_ABORT:
                with self._cv:
                    self._abort = msg["reason"]
                    self._cv.notify_all()

    def _beats(self) -> None:
        while not self._hello.is_set():
            if self._stop.wait(0.01):
                return
        seq = 0
        while not self._stop.is_set():
            seq += 1
            try:
                self._send(K_BEAT, dict(shard=self.shard, seq=seq))
            except OSError:
                pass  # mid-reconnect: the reader owns recovery; keep going
            self._stop.wait(self.heartbeat_interval)

    # -- FileCoordinator surface (worker side) ---------------------------------
    def arrive(self, step: int, shard: int, stats: dict) -> None:
        msg = dict(shard=int(shard), step=int(step), **stats)
        with self._cv:
            # cached until its commit lands, so a coordinator outage
            # between arrive and commit can replay it after reconnect
            self._pending_arrival = msg
        try:
            self._send(K_ARRIVE, msg)
        except OSError:
            pass  # cached above; replayed after the reconnect handshake

    def wait_commit(self, step: int, shard: int) -> dict:
        """Event-driven: sleeps on the condition the reader notifies when
        the commit frame lands — no polling loop, no stat syscalls."""
        step = int(step)
        with self._cv:
            while True:
                rec = self._commits.get(step)
                if rec is not None:
                    return rec
                if self._abort is not None:
                    raise RunAborted(
                        f"run aborted by coordinator: {self._abort}")
                self._cv.wait(1.0)

    def commit(self, step: int) -> dict | None:
        with self._cv:
            return self._commits.get(int(step))

    def aborted(self) -> str | None:
        with self._cv:
            return self._abort

    def check_abort(self) -> None:
        reason = self.aborted()
        if reason is not None:
            raise RunAborted(f"run aborted by coordinator: {reason}")

    def close(self) -> None:
        """Stop the beat thread, unblock the reader by closing the socket,
        and join both — raising if either leaks. ``_closed`` is set under
        the condition so the reader's its-not-an-abort check can't race."""
        with self._cv:
            self._closed = True
        self._stop.set()
        _force_close(self._sock)
        leaked = [t.name for t in self._threads
                  if t.ident is not None
                  and (t.join(timeout=10.0) or t.is_alive())]
        if leaked:
            raise RuntimeError(
                f"coordinator client threads failed to stop within 10s: "
                f"{', '.join(leaked)}; threads leaked")


# -- link probes (planner calibration) -----------------------------------------

def probe_link_throughput(n_bytes: int = 8 << 20,
                          chunk: int = 256 << 10) -> float:
    """Measured per-link throughput (bytes/s) through the REAL frame path:
    a loopback TCP connection, framed+CRC'd chunks, a concurrent reader —
    so the number the planner consumes includes framing and checksum cost
    and the pipelining a live link gets (send overlaps receive), which the
    old disk-bandwidth proxy could not express."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    got = [0]

    def drain(conn):
        try:
            while got[0] < n_bytes:
                _, payload = recv_frame(conn)
                got[0] += len(payload)
        except ConnectionError:
            pass

    out = socket.create_connection(srv.getsockname())
    out.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    inn, _ = srv.accept()
    t = threading.Thread(target=drain, args=(inn,), daemon=True)
    t.start()
    blob = b"\xa5" * chunk
    t0 = time.perf_counter()
    sent = 0
    while sent < n_bytes:
        send_frame(out, K_RUN, blob)
        sent += chunk
    t.join(timeout=30.0)
    elapsed = max(time.perf_counter() - t0, 1e-9)
    drain_leaked = t.is_alive()
    for s in (out, inn, srv):
        try:
            s.close()
        except OSError:
            pass
    if drain_leaked:
        raise RuntimeError("link-probe drain thread failed to stop within "
                           "30s; thread leaked")
    return sent / elapsed


def probe_file_throughput(directory: str, n_bytes: int = 8 << 20,
                          chunk: int = 256 << 10) -> float:
    """The file-exchange baseline the socket transport replaces — the full
    round trip a delivered byte used to make (launch/procs.py's outbox/
    announce/inbox exchange): the sender writes the outbox run and fsyncs
    before the atomic announce rename (a crashed sender must not announce
    garbage), then the receiver reads the announced run, copies it into its
    own local inbox store, and reads it back for the digest.  Two writes,
    two reads and a durability barrier per delivered byte, where the socket
    path frames each byte exactly once."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "probe.bin")
    inbox = os.path.join(directory, "probe-inbox.bin")
    marker = os.path.join(directory, "probe.ok")
    blob = b"\xa5" * chunk
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        written = 0
        while written < n_bytes:
            f.write(blob)
            written += chunk
        f.flush()
        os.fsync(f.fileno())
    with open(marker + ".tmp", "w") as f:
        f.write("ok")
    os.replace(marker + ".tmp", marker)
    with open(path, "rb") as rd, open(inbox, "wb") as wr:
        while True:
            buf = rd.read(chunk)
            if not buf:
                break
            wr.write(buf)
    with open(inbox, "rb") as f:
        while f.read(chunk):
            pass
    elapsed = max(time.perf_counter() - t0, 1e-9)
    for p in (path, inbox, marker):
        os.unlink(p)
    return written / elapsed
