"""Deterministic fault injection + unified retry discipline (chaos layer).

GraphD's premise is commodity hardware, where sockets reset, disks fill,
processes die, and bits rot. Before this package the repo had two ad-hoc
injection knobs — ``FaultPoint`` (streams/channel.py, kill the pipelined
sender thread after N packets) and ``kill_net`` (launch/procs.py, SIGKILL a
worker mid-frame) — each wired by hand into one code path. This package
subsumes both behind one deterministic, seed-driven layer that CI can soak
against:

* :class:`FaultSchedule` — a JSON-able list of site-scoped events ("on the
  3rd spill write of shard 1's superstep 2, fail with ENOSPC"; "after 1 RUN
  frame of step 2, tear the frame and SIGKILL"; "flip one seed-chosen bit
  in the 2nd inbox blob"). Schedules ride through ``launch_opts["faults"]``
  into worker processes and are disarmed on respawn, so a drill fires in
  exactly one incarnation.
* :class:`FaultInjector` — the per-process runtime. Install one with
  :func:`install`; instrumented sites (``launch/net.py`` frame sends/
  receives, ``streams/msgstore.py``/``streams/store.py`` blob writes, the
  worker checkpoint dump) consult :func:`active` and stay zero-cost when
  nothing is installed.
* :class:`RetryPolicy` — bounded reconnect discipline (max attempts,
  exponential backoff with *deterministic* jitter, overall monotonic-clock
  deadline) shared by peer reconnect, coordinator reconnect, and respawn
  paths. Exhaustion raises :class:`RetryExhausted`, which carries a
  structured summary — the clean loud abort the chaos drills assert on.
  The ``retry-discipline`` analysis pass flags bare ``while True:``
  reconnect loops that bypass it.
* :class:`BlobCorruption` — raised by read-path CRC verification
  (msgstore run blobs, edge-store channel files, checkpoint shards) when
  stored bytes no longer match the checksum recorded at write time; the
  worker quarantines the blob and recovery replays it from the sender's
  outbox log or the checkpoint lineage. An injected bit-flip is therefore
  always a detected, recoverable event — never silent corruption.

Everything here is pure stdlib: the package is importable from the
pre-heartbeat worker path, the coordinator process, and the streams layer
without dependency cycles.
"""

from repro_torch.fault.retry import RetryExhausted, RetryPolicy
from repro_torch.fault.schedule import (
    BlobCorruption,
    FaultEvent,
    FaultInjector,
    FaultSchedule,
    InjectedFault,
    TierFault,
    active,
    clear,
    install,
)
from repro_torch.fault.summary import failure_record, find_in_chain, write_record

__all__ = [
    "BlobCorruption",
    "FaultEvent",
    "FaultInjector",
    "FaultSchedule",
    "InjectedFault",
    "RetryExhausted",
    "RetryPolicy",
    "TierFault",
    "active",
    "clear",
    "failure_record",
    "find_in_chain",
    "install",
    "write_record",
]
