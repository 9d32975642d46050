"""Structured failure summaries: how a fault becomes a diagnosable record.

When the retry budget is exhausted, a storage tier faults, or read-path
CRC verification catches corruption, the failing process writes a small
JSON record (atomically: tmp -> fsync -> replace) before exiting. The
launcher folds these into the ``WorkerFailed`` it raises and into the
run-level ``failure-summary.json`` that the CI chaos-soak job uploads as
an artifact — so a chaos failure is a named, machine-readable event, not
a stack trace to spelunk.

Stdlib-only on purpose: both the pre-heartbeat worker path and the
coordinator process import this before any heavy dependency loads.
"""

from __future__ import annotations

import json
import os


def failure_record(kind: str, *, shard=None, step=None, message="", **extra) -> dict:
    """A normalized failure record; ``extra`` keys ride along verbatim."""
    rec = {"kind": kind, "shard": shard, "step": step, "message": message}
    rec.update(extra)
    return rec


def write_record(path: str, record: dict) -> None:
    """Atomically publish one failure record (tmp -> fsync -> replace)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def find_in_chain(exc: BaseException, *types) -> BaseException | None:
    """Walk ``__cause__``/``__context__`` for the first exception of ``types``.

    Fault classification has to see through wrapping: a ``BlobCorruption``
    may surface as ``ChannelError(cause=...)``, an injected ``ENOSPC`` as a
    ``TierFault``. Bounded walk; cycles cannot occur in practice but the
    depth cap keeps this total.
    """
    seen = 0
    node: BaseException | None = exc
    while node is not None and seen < 50:
        if isinstance(node, types):
            return node
        node = node.__cause__ if node.__cause__ is not None else node.__context__
        seen += 1
    return None
