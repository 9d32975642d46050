"""Typed engine configuration (the declarative half of the job API).

Port of ``repro/core/config.py``: small dataclasses that own their
validation, composed into one :class:`EngineConfig`:

* :class:`StreamConfig`       — the out-of-core edge tier (reader staging),
* :class:`MessageSpillConfig` — the combiner-less OMS tier (merge windows),
* :class:`ChannelConfig`      — the §4 sender pipeline (overlap/compression),
* :class:`RecoveryConfig`     — checkpoint cadence + message logging policy
  (consumed by :class:`repro_torch.core.job.GraphDJob`).

Field-local checks live in each ``validate()``; cross-config invariants live
in :meth:`EngineConfig.finalize`. The validation messages are the JAX
package's. Two fields differ from it: the backends are the port's own
(``"torch"`` and ``"kernel"``, resolved per mode when left None), and
``kernel_windows`` is not ported: the JAX kernel backend needs SRC_WIN/DST_WIN
windows because Mosaic has no vector gather, and the port's kernel gathers and
scatters natively on the partition's own blocks, so it has no windows to
size.

Checks that need the partition or a live object (edge groups in memory, the
store's geometry, a message log) stay in the engine. The backend is the one
choice that reads the program: ``finalize(program)`` resolves an unset
backend from what the program declares (:func:`kernel_refusal`), and
refuses ``backend="kernel"`` for a program the kernels cannot compute.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

#: engine execution modes (mirrors GraphDEngine's; kept here so configs can
#: validate without importing the engine)
MODES = ("recoded", "recoded_compact", "basic", "basic_sc", "streamed")
#: "torch" = plain PyTorch ops; "kernel" = the hand-written CUDA/Triton
#: kernels (on CPU tensors the kernel wrappers run their plain versions)
BACKENDS = ("torch", "kernel")


class ConfigError(ValueError):
    """A config field (or a combination of fields) is invalid."""


def kernel_refusal(program) -> str | None:
    """Why the hand-written kernels cannot compute ``program``, or None when
    they can. It reads only what the program declares: a ``msg_kind`` that
    ``kernels/edge_combine.py`` knows and a combiner that both kernels
    compute (``sum``, ``min`` or ``max``)."""
    # the kernel modules import torch; a program already did
    from repro_torch.kernels import digest, edge_combine

    kind, comb = program.msg_kind, program.combiner
    if kind is None:
        return "a program.msg_kind (this program has none)"
    if kind not in edge_combine.MSG_KINDS:
        return (f"a program.msg_kind in {edge_combine.MSG_KINDS} (this "
                f"program's is {kind!r})")
    names = tuple(c for c in edge_combine.COMBINERS if c in digest.COMBINERS)
    if comb is None or comb.name not in names:
        got = "none" if comb is None else repr(comb.name)
        return f"a combiner in {names} (this program's is {got})"
    return None


#: documented ``launch_opts`` surface for ``launch="processes"``. One row per
#: key: (default, doc). Timeouts/poll intervals are seconds. Everything here
#: used to be a hard-coded constant in ``launch/net.py``; promoting the knobs
#: lets chaos drills and slow CI machines tune them without editing source.
LAUNCH_OPT_FIELDS = {
    "transport": ("files", "message exchange: 'files' (shared-FS run files) "
                  "or 'sockets' (the TCP transport)"),
    "heartbeat_interval": (0.25, "worker heartbeat cadence"),
    "heartbeat_timeout": (10.0, "heartbeat silence before a worker is "
                          "presumed dead (> heartbeat_interval)"),
    "handshake_timeout": (5.0, "socket timeout on HELLO/CHELLO handshakes "
                          "(PeerServer accept + CoordServer serve)"),
    "connect_timeout": (5.0, "per-attempt peer data-socket connect timeout"),
    "send_timeout": (60.0, "blocking-send cap on established data sockets"),
    "coord_connect_timeout": (10.0, "per-attempt worker -> coordinator "
                              "connect timeout"),
    "retry": (None, "RetryPolicy overrides for every reconnect/respawn path:"
              " dict of max_attempts/base_delay/max_delay/deadline/jitter/"
              "seed (see repro_torch.fault.RetryPolicy)"),
    "faults": (None, "deterministic chaos schedule: {'seed': int, 'events': "
               "[...]} (see repro_torch.fault.FaultSchedule); disarmed on respawn"),
    "coord_restart_limit": (3, "max coordinator respawns before the launcher "
                            "aborts the run (sockets transport)"),
    "coord_kill": (None, "drill: SIGKILL the coordinator process mid-barrier "
                   "at {'step': s[, 'after_arrivals': m]} (sockets "
                   "transport; fires in incarnation 0 only)"),
    "kill": (None, "drill: SIGKILL a worker whole-process at "
             "{'shard': w, 'step': s} (files transport)"),
    "kill_net": (None, "deprecated alias for a faults= net.send torn_kill "
                 "event: {'shard': w, 'step': s, 'after_frames': k} "
                 "(sockets transport)"),
}


def validate_launch_opts(opts: dict | None, launch: str = "processes") -> dict:
    """Validate a ``launch_opts`` dict against the documented surface.

    Returns a shallow copy. Unknown keys, wrong types, and incoherent
    combinations raise :class:`ConfigError` *at job construction* — not ten
    minutes into a multi-process launch. Sub-structures (``retry``,
    ``faults``) are validated by constructing their ``repro_torch.fault`` types.
    """
    opts = dict(opts or {})
    if not opts:
        return opts
    if launch != "processes":
        raise ConfigError(
            f"launch_opts apply to launch='processes' (got launch={launch!r})"
        )
    unknown = set(opts) - set(LAUNCH_OPT_FIELDS)
    if unknown:
        raise ConfigError(
            f"unknown launch_opts keys {sorted(unknown)}; known: "
            f"{sorted(LAUNCH_OPT_FIELDS)}"
        )
    transport = opts.get("transport", "files")
    if transport not in ("files", "sockets"):
        raise ConfigError(
            f"launch_opts['transport'] must be 'files' or 'sockets', "
            f"got {transport!r}"
        )
    for key in ("heartbeat_interval", "heartbeat_timeout", "handshake_timeout",
                "connect_timeout", "send_timeout", "coord_connect_timeout"):
        if key in opts:
            try:
                val = float(opts[key])
            except (TypeError, ValueError):
                raise ConfigError(
                    f"launch_opts[{key!r}] must be seconds (a number), "
                    f"got {opts[key]!r}"
                ) from None
            if val <= 0:
                raise ConfigError(f"launch_opts[{key!r}] must be > 0 seconds")
            opts[key] = val
    hb_i = opts.get("heartbeat_interval", LAUNCH_OPT_FIELDS["heartbeat_interval"][0])
    hb_t = opts.get("heartbeat_timeout", LAUNCH_OPT_FIELDS["heartbeat_timeout"][0])
    if hb_t <= hb_i:
        raise ConfigError(
            f"launch_opts['heartbeat_timeout'] ({hb_t}) must exceed "
            f"heartbeat_interval ({hb_i}) or every worker looks dead"
        )
    if "coord_restart_limit" in opts:
        if not isinstance(opts["coord_restart_limit"], int) or \
                opts["coord_restart_limit"] < 0:
            raise ConfigError(
                "launch_opts['coord_restart_limit'] must be an int >= 0"
            )
    if opts.get("retry") is not None:
        from repro_torch.fault import RetryPolicy

        try:
            RetryPolicy.from_opts(opts["retry"])
        except (TypeError, ValueError) as e:
            raise ConfigError(f"launch_opts['retry']: {e}") from None
    if opts.get("faults") is not None:
        from repro_torch.fault import FaultSchedule

        try:
            FaultSchedule.from_opts(opts["faults"])
        except (TypeError, ValueError) as e:
            raise ConfigError(f"launch_opts['faults']: {e}") from None
    for drill, need in (("kill", "files"), ("kill_net", "sockets"),
                        ("coord_kill", "sockets")):
        if opts.get(drill) is not None and transport != need:
            raise ConfigError(
                f"launch_opts[{drill!r}] is a {need}-transport drill "
                f"(transport={transport!r})"
            )
    if opts.get("coord_kill") is not None:
        ck = opts["coord_kill"]
        if not isinstance(ck, dict) or "step" not in ck or \
                set(ck) - {"step", "after_arrivals"}:
            raise ConfigError(
                "launch_opts['coord_kill'] must be "
                "{'step': s[, 'after_arrivals': m]}"
            )
    return opts


@dataclass
class StreamConfig:
    """Out-of-core edge tier: the prefetching reader's staging pool.

    RAM cost: ``(depth + 1) * chunk_blocks * edge_block`` staged slots —
    a compiled-in constant, never O(|E|).
    """

    chunk_blocks: int = 8  # edge blocks staged per chunk
    depth: int = 2  # prefetch depth (2 = double buffering)
    # small destination groups (<= one staged chunk) are folded in padded
    # multi-group jitted dispatches of this many lanes, amortizing the
    # Python/dispatch overhead on graphs with many small groups; 1 disables
    group_batch: int = 4
    # adaptive semi-external tier (streams/residency.py): per-shard byte
    # budget for pinning hot edge blocks in RAM; 0 = pure streaming. The
    # planner sizes this from the MemoryBudget's leftover RAM (the
    # ``hot_cache`` tier of estimate_memory()); results are bit-identical
    # at any budget — the cache changes where a block is read FROM, never
    # what is computed
    cache_bytes: int = 0

    def validate(self) -> None:
        if self.chunk_blocks < 1:
            raise ConfigError("stream.chunk_blocks must be >= 1")
        if self.depth < 1:
            raise ConfigError("stream.depth must be >= 1 (2 = double buffering)")
        if self.group_batch < 1:
            raise ConfigError("stream.group_batch must be >= 1 (1 disables)")
        if self.cache_bytes < 0:
            raise ConfigError("stream.cache_bytes must be >= 0 (0 disables)")


@dataclass
class MessageSpillConfig:
    """Combiner-less OMS tier (§3.3.1): merge-window and apply-slice sizing.

    RAM cost: ``max(merge_fanin, n_shards) * read_chunk`` merge-cursor slots
    plus one ``slice_cap`` apply slice — the dominant term of the measured
    combiner-less ceiling, which the planner now sizes from the budget
    instead of these compiled-in defaults.
    """

    slice_cap: int = 4096  # messages per destination-aligned apply slice
    read_chunk: int = 4096  # messages staged per merge-cursor refill
    merge_fanin: int = 16  # max runs held open by the external merge
    spill_dir: str | None = None  # OMS spill dir (default: <store>/oms)

    def validate(self) -> None:
        if self.slice_cap < 1 or self.read_chunk < 1:
            raise ConfigError(
                "spill.slice_cap and spill.read_chunk must be >= 1"
            )
        if self.merge_fanin < 2:
            raise ConfigError("spill.merge_fanin must be >= 2")


@dataclass
class ChannelConfig:
    """§4 full-duplex pipeline: background transmit + receiver digest
    channels, plus wire compression for both the position and the payload
    columns."""

    pipeline: bool = False  # overlap transmit with the next group's fold
    compress: bool = False  # varint-delta the message runs' dp channel
    # payload codec on the wire: False off; True/"lossless" byte-shuffle +
    # DEFLATE on the msg (+cnt) channels (bit-exact round-trip); "bf16"
    # additionally rounds float32 messages to bfloat16 on the wire
    # (recoded_compact's trick — float-message programs only); "auto" spills
    # the first superstep raw, measures the lossless codec on a sample of
    # those runs, and picks lossless vs raw PER CHANNEL for the rest of the
    # run (streams/codec.PayloadAutoPicker; the choice is recorded in
    # ChannelStats.payload_choice)
    compress_payload: Any = False
    # overlap the receiver digest with the next group's fold (U_r ∥ U_c);
    # only meaningful with pipeline=True (False = the sender-only
    # half-duplex pipeline, kept for A/B benchmarking)
    full_duplex: bool = True
    inflight: int = 4  # bounded in-flight packets (O(1) RAM budget)
    fault: Any = None  # sender-side FaultPoint (fault drills only)
    recv_fault: Any = None  # receiver-side FaultPoint (fault drills only)

    def validate(self) -> None:
        from repro_torch.streams.codec import normalize_payload_scheme

        if self.inflight < 1:
            raise ConfigError("channel.inflight must be >= 1")
        try:
            normalize_payload_scheme(self.compress_payload, allow_auto=True)
        except ValueError as e:
            raise ConfigError(f"channel.compress_payload: {e}") from None

    @property
    def payload_scheme(self) -> str | None:
        """None when off, else the codec scheme name — or "auto", which the
        engine resolves from a first-superstep sample (the codec's
        normalization is the single source of truth)."""
        from repro_torch.streams.codec import normalize_payload_scheme

        return normalize_payload_scheme(self.compress_payload,
                                        allow_auto=True)


@dataclass
class RecoveryConfig:
    """Checkpoint cadence and message-log policy (paper §3.4).

    The engine itself does not consume this — checkpointers are passed to
    ``run()`` — but :class:`repro_torch.core.job.GraphDJob` builds the
    ``Checkpointer`` / ``MessageLog`` wiring from it, and the planner carries
    it through so a plan fully describes a job.
    """

    checkpoint_every: int = 0  # supersteps between checkpoints; 0 = off
    keep: int = 2  # checkpoints retained
    log_messages: bool = False  # persist OMSs for single-shard fast recovery

    def validate(self) -> None:
        if self.checkpoint_every < 0:
            raise ConfigError("recovery.checkpoint_every must be >= 0")
        if self.keep < 1:
            raise ConfigError("recovery.keep must be >= 1")
        if self.log_messages and not self.checkpoint_every:
            raise ConfigError(
                "recovery.log_messages needs a checkpoint cadence: message "
                "logs are replayed from the latest checkpoint (§3.4) and "
                "GC'd when a newer one lands — without checkpoints they "
                "would grow forever"
            )


@dataclass
class EngineConfig:
    """Everything the engine needs to know that is not the program, the
    partition, or a live object (store / log)."""

    mode: str = "recoded"
    #: None resolves in ``finalize()``: "kernel" for ``recoded`` (the one
    #: mode the kernels serve) when the program is one the kernels compute
    #: (:func:`kernel_refusal`), "torch" otherwise
    backend: str | None = None
    sparse_cap_frac: float = 0.25  # skip(): max gathered blocks fraction
    adapt_threshold: float = 0.125  # dense->sparse dispatch density
    stream: StreamConfig = field(default_factory=StreamConfig)
    spill: MessageSpillConfig = field(default_factory=MessageSpillConfig)
    channel: ChannelConfig = field(default_factory=ChannelConfig)
    recovery: RecoveryConfig = field(default_factory=RecoveryConfig)

    # -- validation ----------------------------------------------------------
    def finalize(self, program=None) -> "EngineConfig":
        """Validate every sub-config, then the cross-config invariants.
        Returns the config with its backend resolved (``self`` when it was
        given). With a ``program``, an unset backend is "kernel" only for a
        ``recoded`` program the kernels compute, and ``backend="kernel"``
        with any other raises; without one, ``recoded`` resolves to
        "kernel"."""
        if self.mode not in MODES:
            raise ConfigError(
                f"unknown mode={self.mode!r}; pick one of {MODES}"
            )
        if self.backend is not None and self.backend not in BACKENDS:
            raise ConfigError(
                f"unknown backend={self.backend!r}; pick one of {BACKENDS}"
            )
        for sub in (self.stream, self.spill, self.channel, self.recovery):
            sub.validate()
        if not 0 < self.sparse_cap_frac <= 1:
            raise ConfigError("sparse_cap_frac must be in (0, 1]")
        if not 0 <= self.adapt_threshold <= 1:
            raise ConfigError("adapt_threshold must be in [0, 1]")
        ch = self.channel
        if self.mode != "streamed" and (
            ch.pipeline or ch.compress or ch.compress_payload
            or ch.fault is not None or ch.recv_fault is not None
        ):
            raise ConfigError(
                "pipeline=/compress=/compress_payload=/channel faults are "
                "streamed-mode knobs (the in-memory modes already overlap "
                "on-device, §5/C3)"
            )
        if self.mode != "streamed" and self.stream.cache_bytes:
            raise ConfigError(
                "stream.cache_bytes is a streamed-mode knob: the hot-block "
                "cache is the semi-external tier between RAM and the edge "
                "stream; the in-memory modes are fully resident already"
            )
        if ch.payload_scheme == "auto" and self.recovery.log_messages:
            # a run-file message log fixes its wire format at configure();
            # the auto-pick resolves the codec only after the first
            # superstep's sample, and a recovery replay could not re-derive
            # the same mid-run switch point
            raise ConfigError(
                "channel.compress_payload='auto' conflicts with "
                "recovery.log_messages=True: the auto-pick resolves the "
                "wire codec from a first-superstep sample, but a message "
                "log needs a fixed wire format for bit-identical replay — "
                "pass 'lossless' (or False) explicitly"
            )
        if self.backend == "kernel" and self.mode != "recoded":
            # this refuses mode='streamed' too: it is host-driven, torch only
            raise ConfigError("backend='kernel' needs mode='recoded'")
        refusal = None if program is None else kernel_refusal(program)
        if self.backend == "kernel" and refusal is not None:
            raise ConfigError(f"backend='kernel' needs {refusal}")
        if self.backend is None:
            kernel = self.mode == "recoded" and refusal is None
            return dataclasses.replace(
                self, backend="kernel" if kernel else "torch")
        return self

    # -- serialization -------------------------------------------------------
    def to_json(self) -> dict:
        """JSON-able dict. The channel fault points (live objects) are
        recorded only by presence — fault injection is a test harness, not
        job state."""
        out = dataclasses.asdict(self)
        out["channel"]["fault"] = (
            None if self.channel.fault is None else "<FaultPoint>"
        )
        out["channel"]["recv_fault"] = (
            None if self.channel.recv_fault is None else "<FaultPoint>"
        )
        return out

    @classmethod
    def from_json(cls, d: dict) -> "EngineConfig":
        d = dict(d)
        ch = dict(d.get("channel", {}))
        for key in ("fault", "recv_fault"):
            if ch.get(key) is not None:
                ch[key] = None  # fault points do not round-trip
        return cls(
            mode=d.get("mode", "recoded"),
            backend=d.get("backend"),
            sparse_cap_frac=d.get("sparse_cap_frac", 0.25),
            adapt_threshold=d.get("adapt_threshold", 0.125),
            stream=StreamConfig(**d.get("stream", {})),
            spill=MessageSpillConfig(**d.get("spill", {})),
            channel=ChannelConfig(**ch),
            recovery=RecoveryConfig(**d.get("recovery", {})),
        )
