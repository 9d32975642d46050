"""Seed-driven fault schedules and the per-process injector runtime.

A :class:`FaultSchedule` is a JSON-able ``{"seed": int, "events": [...]}``
payload carried in ``launch_opts["faults"]`` and written into the worker
spec, so every process in a multi-process launch arms the same schedule.
Each :class:`FaultEvent` scopes one deterministic fault to a *site* (an
instrumented code location) with optional filters, and an ``after``
count: the event lets ``after`` matching occurrences pass, then fires on
the next one. Events are one-shot by default and the whole schedule is
disarmed on worker respawn, so a drill fires in exactly one incarnation.

Sites and the kinds they accept:

===============  =============================================  ==========================================
site             instrumented where                             kinds
===============  =============================================  ==========================================
``net.send``     ``PeerSender`` data-plane frame sends          torn_kill, kill, drop, reset, delay
``net.recv``     ``PeerServer.read_source`` frame receives      kill, drop, reset, delay
``coord.send``   ``CoordClient`` coordinator-plane sends        kill, drop, reset, delay
``io.write.spill``  ``MessageRunStore`` blob writes             enospc, eio, short, bitflip, kill
``io.write.store``  ``EdgeStreamStore.create`` channel writes   enospc, eio, short, bitflip, kill
``io.write.ckpt``   worker checkpoint shard dump                enospc, eio, kill
===============  =============================================  ==========================================

Filters: ``shard`` (only this worker), ``step`` (only this superstep),
``dest`` (only frames/blobs for this destination shard), ``where`` (only
paths containing this substring — e.g. ``"logs/"`` to target the inbox
message log rather than the outbox). Only occurrences matching *all*
present filters advance the event's counter, which keeps schedules
deterministic even when several stores write concurrently.

The bit flipped by ``bitflip`` and all other pseudo-random choices derive
from ``crc32(seed: ...)`` — replaying a schedule replays the fault.
"""

from __future__ import annotations

import errno as _errno
import os
import signal
import threading
import time
import zlib
from dataclasses import dataclass, field

_SITES = {
    "net.send": {"torn_kill", "kill", "drop", "reset", "delay"},
    "net.recv": {"kill", "drop", "reset", "delay"},
    "coord.send": {"kill", "drop", "reset", "delay"},
    "io.write.spill": {"enospc", "eio", "short", "bitflip", "kill"},
    "io.write.store": {"enospc", "eio", "short", "bitflip", "kill"},
    "io.write.ckpt": {"enospc", "eio", "kill"},
}

_EVENT_KEYS = {"site", "kind", "after", "shard", "step", "dest", "where", "seconds", "once"}

_ERRNOS = {"enospc": _errno.ENOSPC, "eio": _errno.EIO}


class InjectedFault(OSError):
    """An injected I/O or transport fault (``errno`` set for disk kinds)."""


class TierFault(RuntimeError):
    """A storage-tier write failed; names the tier for structured reporting."""

    def __init__(self, tier: str, step: int | None = None, cause: BaseException | None = None):
        self.tier = tier
        self.step = step
        at = f" at superstep {step}" if step is not None else ""
        super().__init__(f"{tier} tier write failed{at}: {cause}")

    def summary(self) -> dict:
        return {
            "kind": "disk-fault",
            "tier": self.tier,
            "step": self.step,
            "error": str(self),
        }


class BlobCorruption(RuntimeError):
    """Stored bytes no longer match the CRC recorded at write time.

    Raised by read-path verification in ``streams/msgstore.py`` (run
    blobs), ``streams/store.py`` (edge channel files), and checkpoint
    restore. Workers quarantine ``directory`` and exit for replay rather
    than consuming the corrupt bytes.
    """

    def __init__(self, path: str, detail: str, directory: str | None = None):
        self.path = path
        self.detail = detail
        self.directory = directory if directory is not None else os.path.dirname(path)
        super().__init__(f"blob corruption detected in {path}: {detail}")

    def summary(self) -> dict:
        return {
            "kind": "corruption",
            "path": self.path,
            "directory": self.directory,
            "detail": self.detail,
        }


@dataclass
class FaultEvent:
    """One site-scoped deterministic fault (see module docstring)."""

    site: str
    kind: str
    after: int = 0
    shard: int | None = None
    step: int | None = None
    dest: int | None = None
    where: str | None = None
    seconds: float = 0.05
    once: bool = True
    # runtime state (not serialized)
    count: int = field(default=0, compare=False)
    fired: bool = field(default=False, compare=False)

    def __post_init__(self) -> None:
        if self.site not in _SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; known: {sorted(_SITES)}"
            )
        if self.kind not in _SITES[self.site]:
            raise ValueError(
                f"fault kind {self.kind!r} not valid at site {self.site!r}; "
                f"valid: {sorted(_SITES[self.site])}"
            )
        if self.after < 0:
            raise ValueError("after must be >= 0")

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        unknown = set(d) - _EVENT_KEYS
        if unknown:
            raise ValueError(
                f"unknown fault event keys {sorted(unknown)}; known: {sorted(_EVENT_KEYS)}"
            )
        if "site" not in d or "kind" not in d:
            raise ValueError("fault event needs at least 'site' and 'kind'")
        return cls(**d)

    def to_dict(self) -> dict:
        out = {"site": self.site, "kind": self.kind, "after": self.after, "once": self.once}
        for k in ("shard", "step", "dest", "where"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        if self.kind == "delay":
            out["seconds"] = self.seconds
        return out

    def matches(self, site: str, *, shard=None, step=None, dest=None, path="") -> bool:
        if self.site != site or self.fired:
            return False
        if self.shard is not None and shard != self.shard:
            return False
        if self.step is not None and step != self.step:
            return False
        if self.dest is not None and dest != self.dest:
            return False
        if self.where is not None and self.where not in (path or ""):
            return False
        return True


@dataclass
class FaultSchedule:
    """A deterministic, JSON-able set of fault events plus the chaos seed."""

    seed: int = 0
    events: list = field(default_factory=list)

    def __post_init__(self) -> None:
        self.events = [
            e if isinstance(e, FaultEvent) else FaultEvent.from_dict(dict(e))
            for e in self.events
        ]

    @classmethod
    def from_opts(cls, opts) -> "FaultSchedule":
        """Build from ``launch_opts['faults']``: a dict or a bare event list."""
        if opts is None:
            return cls()
        if isinstance(opts, list):
            return cls(events=list(opts))
        if isinstance(opts, dict):
            unknown = set(opts) - {"seed", "events"}
            if unknown:
                raise ValueError(
                    f"unknown fault schedule keys {sorted(unknown)}; known: ['events', 'seed']"
                )
            return cls(seed=int(opts.get("seed", 0)), events=list(opts.get("events", ())))
        raise ValueError("faults must be a {'seed', 'events'} dict or a list of events")

    def to_opts(self) -> dict:
        return {"seed": self.seed, "events": [e.to_dict() for e in self.events]}


def _sigkill() -> None:
    os.kill(os.getpid(), signal.SIGKILL)


class FaultInjector:
    """Per-process runtime that arms a schedule at the instrumented sites.

    Install with :func:`install`; sites consult :func:`active` and pay a
    single ``is None`` check when chaos is off. ``shard`` filters the
    schedule to this worker; :meth:`set_step` supplies step context for
    sites (file writes) that do not know the superstep themselves.
    """

    def __init__(self, schedule: FaultSchedule, shard: int | None = None):
        self.schedule = schedule
        self.shard = shard
        self._lock = threading.Lock()
        self._step = None

    def set_step(self, step: int) -> None:
        with self._lock:
            self._step = step

    def _fire(self, site: str, *, step=None, dest=None, path="") -> FaultEvent | None:
        """Advance matching events; return the first that reaches its trigger."""
        with self._lock:
            if step is None:
                step = self._step
            for ev in self.schedule.events:
                if not ev.matches(site, shard=self.shard, step=step, dest=dest, path=path):
                    continue
                ev.count += 1
                if ev.count > ev.after:
                    if ev.once:
                        ev.fired = True
                    else:
                        ev.count = 0
                    return ev
            return None

    # -- net sites ---------------------------------------------------------

    def net_send(self, conn, header: bytes, payload: bytes, *, site="net.send",
                 step=None, dest=None) -> None:
        """Consult before sending one data-plane frame; may not return."""
        ev = self._fire(site, step=step, dest=dest)
        if ev is None:
            return
        if ev.kind == "torn_kill":
            # The socket-transport drill, generalized: land the header plus half the
            # payload so the receiver holds a torn frame, then die hard.
            try:
                conn.sendall(header + payload[: max(1, len(payload) // 2)])
            except OSError:
                pass
            _sigkill()
        self._net_common(conn, ev, site)

    def net_recv(self, conn, *, site="net.recv", step=None, src=None) -> None:
        """Consult after receiving one frame; may raise or not return."""
        ev = self._fire(site, step=step, dest=src)
        if ev is None:
            return
        self._net_common(conn, ev, site)

    def _net_common(self, conn, ev: FaultEvent, site: str) -> None:
        if ev.kind == "kill":
            _sigkill()
        if ev.kind == "delay":
            time.sleep(ev.seconds)
            return
        # drop / reset: sever the socket so both ends observe the loss,
        # then surface a connection error to the calling path.
        try:
            conn.shutdown(2)  # SHUT_RDWR
        except OSError:
            pass
        if ev.kind == "reset":
            raise InjectedFault(_errno.ECONNRESET, f"injected: {site} socket reset")
        raise InjectedFault(_errno.EPIPE, f"injected: {site} socket dropped")

    # -- file sites --------------------------------------------------------

    def file_write(self, fh, data, *, site: str, path: str = "", step=None) -> None:
        """Perform (or sabotage) one blob write on behalf of the caller."""
        ev = self._fire(site, step=step, path=path)
        if ev is None:
            fh.write(data)
            return
        if ev.kind == "kill":
            _sigkill()
        if ev.kind == "bitflip":
            data = bytes(data)
            bit = zlib.crc32(f"{self.schedule.seed}:{site}:{ev.count}".encode()) % max(
                1, len(data) * 8
            )
            buf = bytearray(data)
            buf[bit // 8] ^= 1 << (bit % 8)
            fh.write(bytes(buf))
            return
        if ev.kind == "short":
            # Tear the write: land a prefix, then fail as if the disk filled.
            fh.write(bytes(data)[: max(1, len(data) // 2)])
            fh.flush()
            raise InjectedFault(
                _errno.ENOSPC, f"injected: short write ({site}, {path or '?'})"
            )
        raise InjectedFault(
            _ERRNOS[ev.kind], f"injected: {ev.kind} on write ({site}, {path or '?'})"
        )

    def check(self, site: str, *, step=None, path="") -> None:
        """Dataless site check (e.g. before a checkpoint dump); may raise."""
        ev = self._fire(site, step=step, path=path)
        if ev is None:
            return
        if ev.kind == "kill":
            _sigkill()
        raise InjectedFault(
            _ERRNOS[ev.kind], f"injected: {ev.kind} on write ({site}, {path or '?'})"
        )


_ACTIVE: FaultInjector | None = None


def install(injector: FaultInjector | None) -> None:
    """Install the process-wide injector (None clears)."""
    global _ACTIVE
    _ACTIVE = injector


def active() -> FaultInjector | None:
    """The process-wide injector, or None when chaos is off (the hot path)."""
    return _ACTIVE


def clear() -> None:
    install(None)
