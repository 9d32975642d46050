"""Unified bounded-retry discipline for every reconnect/respawn path.

Before this module each reconnect loop in the tree hand-rolled its own
policy: ``PeerSender._ensure_conn`` polled forever, ``CoordClient`` gave
up on the first error, and neither had a deadline. A fault-tolerant
control plane needs the opposite invariant everywhere: *bounded* retries
with backoff and jitter, degrading to a clean loud abort that names the
site, the attempt count, and the elapsed budget.

Jitter is deterministic — derived from ``crc32(seed:site:attempt)``, not
``random`` — so a chaos drill replayed with the same ``FaultSchedule``
seed observes the same retry timeline. Deadlines use the monotonic clock
(the ``liveness-clock`` analysis pass forbids wall clocks here).

Canonical call shape (the ``retry-discipline`` analysis pass looks for
this instead of bare ``while True:`` reconnect loops)::

    policy = RetryPolicy(deadline=120.0)
    for attempt in policy.attempts("coord-reconnect", should_stop=...):
        try:
            sock = socket.create_connection(addr, timeout=5.0)
            break
        except OSError as e:
            last = e
    else:
        raise RetryExhausted("coord-reconnect", policy, last)

``attempts`` yields 1, 2, 3, ... sleeping the backoff *between* yields;
it stops (exhausting the ``for``) when the attempt budget or deadline
runs out, or when ``should_stop()`` turns true — callers distinguish
"stopped" from "exhausted" by checking their own flag in the ``else``.
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field


def _jitter_frac(seed: int, site: str, attempt: int) -> float:
    """Deterministic pseudo-random fraction in [0, 1) for backoff jitter."""
    h = zlib.crc32(f"{seed}:{site}:{attempt}".encode())
    return (h % 10_000) / 10_000.0


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry budget: attempts x exponential backoff x deadline.

    ``max_attempts=0`` means unbounded attempts (the deadline governs).
    ``deadline`` is the overall per-episode budget in seconds, measured
    on the monotonic clock from the first ``attempts()`` call. ``jitter``
    is the +/- fraction applied to each backoff delay, derived
    deterministically from ``seed`` and the site name.
    """

    max_attempts: int = 0
    base_delay: float = 0.1
    max_delay: float = 2.0
    deadline: float = 120.0
    jitter: float = 0.5
    seed: int = 0

    def __post_init__(self) -> None:
        if self.max_attempts < 0:
            raise ValueError("max_attempts must be >= 0 (0 = unbounded)")
        if self.base_delay <= 0 or self.max_delay < self.base_delay:
            raise ValueError("need 0 < base_delay <= max_delay")
        if self.deadline <= 0:
            raise ValueError("deadline must be > 0 seconds")
        if not (0.0 <= self.jitter <= 1.0):
            raise ValueError("jitter must be in [0, 1]")

    @classmethod
    def from_opts(cls, opts: dict | None, **overrides) -> "RetryPolicy":
        """Build from a ``launch_opts['retry']``-style dict (JSON-borne)."""
        merged = dict(opts or {})
        merged.update(overrides)
        return cls(**merged)

    def to_opts(self) -> dict:
        return {
            "max_attempts": self.max_attempts,
            "base_delay": self.base_delay,
            "max_delay": self.max_delay,
            "deadline": self.deadline,
            "jitter": self.jitter,
            "seed": self.seed,
        }

    def delay_for(self, site: str, attempt: int) -> float:
        """Backoff to sleep after failed attempt number ``attempt`` (1-based)."""
        raw = min(self.base_delay * (2.0 ** (attempt - 1)), self.max_delay)
        frac = _jitter_frac(self.seed, site, attempt)
        return raw * (1.0 + self.jitter * (2.0 * frac - 1.0))

    def attempts(self, site: str, should_stop=None):
        """Yield attempt numbers 1..N, sleeping backoff between yields.

        The generator ends (so a ``for/else`` falls through) when the
        attempt or deadline budget is exhausted, or when ``should_stop()``
        returns true during a backoff sleep. Sleeps are sliced to at most
        0.25 s so a closing owner is never blocked behind a long backoff.
        """
        start = time.monotonic()
        attempt = 0
        while True:
            attempt += 1
            if self.max_attempts and attempt > self.max_attempts:
                return
            if time.monotonic() - start > self.deadline:
                return
            yield attempt
            # Attempt failed (a success breaks out of the caller's loop):
            # back off before the next one, watching for stop requests.
            remaining = self.delay_for(site, attempt)
            while remaining > 0:
                if should_stop is not None and should_stop():
                    return
                step = min(remaining, 0.25)
                time.sleep(step)
                remaining -= step
            if should_stop is not None and should_stop():
                return

    def elapsed_since(self, start_monotonic: float) -> float:
        return time.monotonic() - start_monotonic


class RetryExhausted(ConnectionError):
    """A retry episode ran out of budget: the clean, loud, structured abort.

    Subclasses ``ConnectionError`` so transport-level handlers that
    already treat connection loss as fatal propagate it unchanged.
    """

    def __init__(self, site: str, policy: RetryPolicy, last: BaseException | None = None,
                 attempts: int = 0, elapsed: float = 0.0):
        self.site = site
        self.policy = policy
        self.last = last
        self.attempts = attempts
        self.elapsed = elapsed
        detail = f": last error: {last}" if last is not None else ""
        super().__init__(
            f"retry budget exhausted at {site} "
            f"({attempts} attempts over {elapsed:.1f}s, "
            f"deadline {policy.deadline:.1f}s){detail}"
        )

    def summary(self) -> dict:
        """Structured failure summary (JSON-able) for failure records."""
        return {
            "kind": "retry-exhausted",
            "site": self.site,
            "attempts": self.attempts,
            "elapsed_seconds": round(self.elapsed, 3),
            "deadline_seconds": self.policy.deadline,
            "max_attempts": self.policy.max_attempts,
            "last_error": repr(self.last) if self.last is not None else None,
        }
