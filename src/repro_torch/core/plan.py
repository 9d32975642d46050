"""Resource-aware job planning: from a logical job description to a plan.

Port of ``repro/core/plan.py``, pointed at the port's config. The paper's
pitch is that GraphD processes very large graphs "with ordinary computing
resources" without the user thinking about memory. :func:`plan` takes a
vertex program, the graph's size and a :class:`MemoryBudget`, runs the
engine's memory-model algebra *predictively* over every execution mode, and
returns an :class:`ExecutionPlan`: the chosen mode plus every
staging/window/fan-in knob derived from the budget. A plan that picks
``recoded`` runs it on the port's default backend for the program: the
kernels where they compute it, plain PyTorch otherwise
(``config.kernel_refusal``).

The algebra (:func:`estimate_memory`) is the SAME function the engine's
``memory_model()`` reports after construction, parameterized by estimated
vs realized partition geometry. The per-format byte units live next to the
formats they describe (``streams.store.EDGE_SLOT_BYTES``,
``MessageRunStore.fixed_bytes_per_message``, ``ShardChannels.packet_bytes``).

Mode preference (first feasible wins, all alternatives reported):

* combiner programs:   ``recoded`` → ``recoded_compact`` → ``streamed`` →
  ``streamed+pipeline`` — in-memory combining is fastest; the out-of-core
  tier engages when the edge groups stop fitting; the §4 pipeline engages
  when even the n destination accumulators of the unpipelined streamed fold
  stop fitting (the pipelined fold keeps ONE group + ONE receiver
  accumulator and spills finished groups to inbox runs);
* combiner-less:       ``basic`` → ``streamed`` (OMS spill) →
  ``streamed+pipeline``.

``compress`` (positions) and ``compress_payload`` (message payloads) are
engaged per streamed candidate when the disk or network budget demands
them — the net ladder flips positions first, then payloads, before giving
up; the full-duplex receiver staging and the batched-dispatch lanes sit on
the RAM knob ladder and are shed under pressure. An over-constrained
budget raises :class:`PlanInfeasible` carrying the most frugal candidate's
per-tier byte breakdown.

``launch="processes"`` plans for the multi-process deployment
(``launch/procs.py``): every "per-shard" figure in the model then reads
as per-PROCESS — ``ram_total`` is what ONE worker process keeps resident
(its owner view of the edge streams is on disk, its state rows are O(P)),
and ``net_total`` is what one process's NIC carries per superstep over the
shared-filesystem transport. Only the full-duplex streamed pipeline runs
across processes (the transport IS the inbox-run-file channel), so the
in-memory modes and the unpipelined streamed fold are vetoed rather than
silently rewritten.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.config import (
    ChannelConfig, EngineConfig, MessageSpillConfig, RecoveryConfig,
    StreamConfig, validate_launch_opts,
)
from repro_torch.streams.channel import ShardChannels
from repro_torch.streams.msgstore import MessageRunStore
from repro_torch.streams.store import (
    COMPRESS_RATIO_ESTIMATE, EDGE_SLOT_BYTES, estimate_edge_disk_bytes,
)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _fmt(b: int | None) -> str:
    if b is None:
        return "unbounded"
    b = int(b)
    if b >= 1 << 30:
        return f"{b / (1 << 30):.2f} GiB"
    if b >= 1 << 20:
        return f"{b / (1 << 20):.2f} MiB"
    if b >= 1 << 10:
        return f"{b / (1 << 10):.1f} KiB"
    return f"{b} B"


# --------------------------------------------------------------------------
# the shared memory-model algebra (Lemma 1 / Theorem 1 accounting)
# --------------------------------------------------------------------------

#: model keys that live in RAM for every mode; ``streamed`` is the big tier
#: (device memory for in-memory modes, local disk for mode="streamed").
#: ``hot_cache`` is the adaptive semi-external tier: hot edge blocks pinned
#: in RAM by streams/residency.py, sized from the budget's leftover
RAM_KEYS = ("resident", "buffers", "staging", "msg_staging", "channel",
            "receiver_staging", "codec", "wire", "hot_cache")


def estimate_memory(
    *,
    mode: str,
    n_shards: int,
    P: int,
    E_cap: int,
    edge_block: int,
    value_itemsize: int,
    msg_itemsize: int,
    combined: bool,
    pipeline: bool = False,
    compress: bool = False,
    compress_payload=False,
    full_duplex: bool = True,
    chunk_blocks: int = 8,
    depth: int = 2,
    group_batch: int = 1,
    slice_cap: int = 4096,
    read_chunk: int = 4096,
    merge_fanin: int = 16,
    inflight: int = 4,
    cache_bytes: int = 0,
    disk_bytes_per_shard: int | None = None,
) -> dict[str, int]:
    """Per-shard bytes by tier for one (mode, geometry, knobs) point.

    This is the engine's ``memory_model()`` algebra factored out so the
    planner can run it over *candidate* geometries before anything is
    partitioned. Keys: ``resident`` (state array A), ``buffers`` (combine
    accumulators), ``staging`` (edge-reader pool + batched-dispatch
    copies), ``msg_staging`` (combiner-less merge/slice windows),
    ``channel`` (§4 in-flight budget), ``receiver_staging`` (the
    full-duplex background receiver: its accumulator + densified-run /
    queued-slice buffers), ``codec`` (payload-codec encode/decode scratch),
    ``wire`` (mode="basic" raw exchange buffers), ``streamed`` (the big
    tier: device edge groups, or on-disk streams for mode="streamed").
    """
    from repro_torch.streams.codec import PAYLOAD_BLOCK

    resident = P * (value_itemsize + 1 + 4 + 1 + 8)  # values, active, degree, vmask, old
    per_slot = msg_itemsize + 4  # message + count, the A_s/A_r unit (§5)
    if mode != "streamed":
        out = dict(
            resident=resident,
            buffers=P * per_slot * 2,  # A_s + A_r, two in flight (§5)
            staging=0,
            streamed=n_shards * E_cap * EDGE_SLOT_BYTES,  # edge groups in HBM
        )
        if mode == "basic":
            # raw (dst, payload) all_to_all: E-sized send + receive buffers
            out["wire"] = 2 * n_shards * E_cap * (4 + msg_itemsize)
        return out
    chunk_slots = chunk_blocks * edge_block
    staging = (depth + 1) * chunk_slots * EDGE_SLOT_BYTES
    if combined and group_batch > 1:
        # batched group dispatch holds up to G copied single-chunk groups
        # on the way in AND the (G, P) accumulator/count stacks on the way
        # out (vs the ONE group accumulator already counted in ``buffers``)
        staging += group_batch * chunk_slots * EDGE_SLOT_BYTES
        staging += (group_batch - 1) * P * (msg_itemsize + 4)
    if combined:
        if pipeline:
            # one group accumulator folding + one receiver accumulator
            buffers = 2 * P * per_slot
        else:
            # all n destination accumulators resident until apply, plus the
            # group accumulator when a message log splits the fold per group
            buffers = (n_shards + 1) * P * per_slot
    else:
        # double-buffered (values, active) rows for the slice overwrite
        # merge, plus the per-position message counts
        buffers = 2 * P * (value_itemsize + 1) + P * 4
    out = dict(
        resident=resident,
        buffers=buffers,
        staging=staging,
        streamed=(
            disk_bytes_per_shard
            if disk_bytes_per_shard is not None
            else estimate_edge_disk_bytes(n_shards, E_cap, compress,
                                          bool(compress_payload))
        ),
    )
    if cache_bytes:
        # the semi-external hot-block tier: decoded edge blocks pinned in
        # RAM by BlockResidency, a hard byte budget (admission is refused
        # beyond it) — so the model term IS the bound, not an estimate
        out["hot_cache"] = int(cache_bytes)
    if pipeline:
        out["channel"] = inflight * ShardChannels.packet_bytes(
            P=P, msg_itemsize=msg_itemsize, combined=combined,
            chunk_slots=chunk_slots,
        )
        if full_duplex:
            # the background receiver's resident slice of the §4 budget:
            # combiner path — one densified (A, cnt) run beside the
            # accumulator already counted in ``buffers``; OMS path — the
            # receive_iter queue of up to ``depth`` decoded apply slices
            out["receiver_staging"] = (
                P * per_slot if combined
                else depth * slice_cap * (4 + msg_itemsize)
            )
    if compress_payload:
        # payload-codec scratch: one encode + one decode buffer of the
        # largest unit the engine feeds it (a combined run is <= P slots, a
        # raw spill chunk <= chunk_slots), capped by the codec's own block
        # bound. (The varint codec's scratch is byte-windowed and noise.)
        unit = min(PAYLOAD_BLOCK, P if combined else chunk_slots)
        out["codec"] = 2 * unit * per_slot
    if not combined:
        # the disk message tier (§3.3): merge cursor windows (fan-in bounded
        # by compaction), one destination-aligned apply slice, and the
        # spill-sort staging for one staged edge chunk (all DECODED widths —
        # the wire codecs never change resident windows)
        per_msg = MessageRunStore.fixed_bytes_per_message(msg_itemsize)
        fanin = max(merge_fanin, n_shards)
        out["msg_staging"] = (
            fanin * read_chunk * per_msg
            + slice_cap * per_msg
            + chunk_slots * per_msg
        )
    return out


def ram_total(model: dict[str, int], mode: str) -> int:
    """What one machine must keep in RAM under ``model``. For the in-memory
    modes the edge groups (the ``streamed`` tier) are device-resident and
    count; for ``mode="streamed"`` they are on local disk and do not."""
    total = sum(model.get(k, 0) for k in RAM_KEYS)
    if mode != "streamed":
        total += model.get("streamed", 0)
    return int(total)


#: edge slots one streamed fold takes: the engine's fold stager gathers a
#: group's staged chunks (or one batch of single-chunk groups) into one
#: buffer until it holds this many, and keeps ``FOLD_RING`` such buffers
FOLD_SLOTS = 1 << 17
FOLD_RING = 3


def fold_stager_slots(chunk_blocks: int, group_batch: int,
                      edge_block: int) -> int:
    """Edge slots of one buffer of the streamed engine's fold stager."""
    return max(FOLD_SLOTS, group_batch * chunk_blocks * edge_block)


def fold_stager_bytes(chunk_blocks: int, group_batch: int,
                      edge_block: int) -> int:
    """Host RAM of the streamed engine's fold stager (one per engine, so
    per process). It lies outside :func:`estimate_memory`'s tiers, which
    are the JAX package's algebra: a process of the port holds the model's
    RAM plus this."""
    return FOLD_RING * fold_stager_slots(chunk_blocks, group_batch,
                                         edge_block) * EDGE_SLOT_BYTES


def estimate_net(mode: str, *, n_shards: int, P: int, E_cap: int,
                 msg_itemsize: int, combined: bool, compress: bool = False,
                 compress_payload=False) -> int:
    """Bytes one shard puts on the wire per superstep (the Table 2-8 axis).
    For the streamed channel the per-message unit is
    :meth:`ShardChannels.wire_bytes_per_message`, so the ``compress`` /
    ``compress_payload`` knobs shrink the estimate exactly where they
    shrink the stream."""
    if mode == "recoded_compact":
        return n_shards * P * 3  # bf16 value + 1-byte has-msg flag
    if mode in ("recoded", "basic_sc"):
        return n_shards * P * (msg_itemsize + 4)  # combined A_s + counts
    if mode == "basic":
        return n_shards * E_cap * (4 + msg_itemsize)  # raw (dst, payload)
    per_msg = ShardChannels.wire_bytes_per_message(
        msg_itemsize=msg_itemsize, combined=combined, compress=compress,
        compress_payload=compress_payload,
    )
    if not combined:
        return int(n_shards * E_cap * per_msg)  # raw runs, one per chunk
    return int(n_shards * P * per_msg)  # sparse combined groups


def estimate_net_seconds(net_bytes: int, link_bytes_per_s: float) -> float:
    """Seconds one shard spends transmitting per superstep at a MEASURED
    per-link throughput — the time axis the byte model alone cannot give.
    Pair with :func:`measured_link_throughput` (or any bytes/s figure)."""
    if link_bytes_per_s <= 0:
        raise ValueError("link_bytes_per_s must be positive")
    return net_bytes / float(link_bytes_per_s)


def measured_link_throughput(n_bytes: int = 8 << 20) -> float:
    """Probe the actual link (loopback TCP through the socket transport's
    frame path, framing + CRC included) instead of proxying network cost
    with disk bandwidth. Lazy import: the planner stays importable without
    the launch layer."""
    from repro_torch.launch.net import probe_link_throughput

    return probe_link_throughput(n_bytes)


# --------------------------------------------------------------------------
# budget / metadata inputs
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class MemoryBudget:
    """What one machine may spend. ``None`` = unconstrained tier."""

    ram_per_shard: int | None = None
    n_shards: int = 4
    disk_per_shard: int | None = None
    net_per_superstep: int | None = None

    def validate(self) -> "MemoryBudget":
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        for name in ("ram_per_shard", "disk_per_shard", "net_per_superstep"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be positive (or None)")
        return self

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class GraphMeta:
    """The logical facts the planner needs about a graph.

    When built from an already-partitioned graph the exact per-shard
    geometry rides along (``max_shard_vertices``/``for_n_shards``), making
    the plan's P — and with it every P-proportional tier — exact instead of
    the ``ceil(|V|/n)`` estimate (the hash partition is near-balanced but
    not perfect; Lemma 1 only bounds the skew by 2)."""

    n_vertices: int
    n_edges: int
    max_shard_vertices: int | None = None  # realized P (pre-padding) if known
    for_n_shards: int | None = None  # shard count that P was realized for

    @classmethod
    def of(cls, graph) -> "GraphMeta":
        """Accepts a ``graph.csr.Graph``, a ``PartitionedGraph``, or an
        existing GraphMeta."""
        if isinstance(graph, cls):
            return graph
        return cls(n_vertices=int(graph.n_vertices),
                   n_edges=int(graph.n_edges),
                   max_shard_vertices=getattr(graph, "P", None),
                   for_n_shards=getattr(graph, "n_shards", None))

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class PlanInfeasible(RuntimeError):
    """No execution mode fits the budget; ``breakdown`` holds the budget and
    every candidate's per-tier byte model (also formatted into the message,
    so the failure is actionable from the log line alone)."""

    def __init__(self, message: str, breakdown: dict):
        super().__init__(message)
        self.breakdown = breakdown


# --------------------------------------------------------------------------
# plan artifacts
# --------------------------------------------------------------------------

@dataclass
class Candidate:
    """One evaluated (mode, knobs) alternative — kept on the plan so
    ``explain()`` can say why everything NOT chosen was rejected."""

    name: str
    mode: str
    pipeline: bool
    compress: bool
    feasible: bool
    chosen: bool
    reason: str
    model: dict[str, int]
    ram_total: int
    disk_total: int
    net_total: int
    knobs: dict[str, int]
    compress_payload: bool = False
    # net_total priced at a measured per-link throughput (seconds/superstep);
    # 0.0 when the plan was made without a link probe
    net_seconds: float = 0.0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclass
class ExecutionPlan:
    """The planner's output: a finalized EngineConfig plus the partition-time
    knobs, the predicted byte model, and the full audit trail."""

    config: EngineConfig
    budget: MemoryBudget
    meta: GraphMeta
    n_shards: int
    edge_block: int
    vertex_pad: int
    model: dict[str, int]
    ram_total: int
    disk_total: int
    net_total: int
    alternatives: list[Candidate] = field(default_factory=list)
    #: "threads" (single-process emulation) or "processes" (one worker
    #: process per shard over the shared-filesystem transport); with
    #: "processes" the per-shard model IS the per-process RAM/NIC budget
    launch: str = "threads"
    #: deployment knobs for launch="processes" (transport, timeouts, retry
    #: budget, chaos schedule — the surface documented by
    #: config.LAUNCH_OPT_FIELDS), validated at plan time so a serialized
    #: plan fully describes a runnable deployment; GraphDJob merges its own
    #: launch_opts over these
    launch_opts: dict = field(default_factory=dict)

    @property
    def mode(self) -> str:
        return self.config.mode

    @property
    def pipeline(self) -> bool:
        return self.config.channel.pipeline

    @property
    def compress(self) -> bool:
        return self.config.channel.compress

    @property
    def compress_payload(self):
        return self.config.channel.compress_payload

    def explain(self) -> str:
        """Human-readable plan audit: the per-tier byte model of the chosen
        mode and why each alternative was rejected (or not preferred)."""
        b = self.budget
        chosen = next(c for c in self.alternatives if c.chosen)
        lines = [
            f"ExecutionPlan: {chosen.name} for |V|={self.meta.n_vertices:,} "
            f"|E|={self.meta.n_edges:,} on n_shards={self.n_shards} "
            f"(edge_block={self.edge_block})",
            f"budget: ram/shard={_fmt(b.ram_per_shard)} "
            f"disk/shard={_fmt(b.disk_per_shard)} "
            f"net/superstep={_fmt(b.net_per_superstep)}",
            f"predicted: ram={_fmt(self.ram_total)} "
            f"disk={_fmt(self.disk_total)} net={_fmt(self.net_total)}/step",
            "model/shard: "
            + " ".join(f"{k}={_fmt(v)}" for k, v in self.model.items()),
        ]
        if self.mode == "streamed":
            st = self.config.stream
            lines.append(
                "port host RAM outside this model: fold stager "
                + _fmt(fold_stager_bytes(st.chunk_blocks, st.group_batch,
                                         self.edge_block))
                + " a process")
        if chosen.knobs:
            lines.append(
                "knobs: "
                + " ".join(f"{k}={v}" for k, v in chosen.knobs.items())
            )
        lines.append("alternatives:")
        for c in self.alternatives:
            if c.chosen:
                verdict = "CHOSEN"
            elif c.feasible:
                verdict = "FEASIBLE"
            else:
                verdict = "REJECTED"
            line = (f"  {c.name:<20} {verdict:<8} ram={_fmt(c.ram_total)} "
                    f"disk={_fmt(c.disk_total)} net={_fmt(c.net_total)}/step")
            if c.net_seconds:
                line += f" ({c.net_seconds * 1e3:.2f} ms at measured link)"
            if c.reason:
                line += f" — {c.reason}"
            lines.append(line)
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps(dict(
            config=self.config.to_json(),
            budget=self.budget.to_json(),
            meta=self.meta.to_json(),
            n_shards=self.n_shards,
            edge_block=self.edge_block,
            vertex_pad=self.vertex_pad,
            model=self.model,
            ram_total=self.ram_total,
            disk_total=self.disk_total,
            net_total=self.net_total,
            alternatives=[c.to_json() for c in self.alternatives],
            launch=self.launch,
            launch_opts=self.launch_opts,
        ))

    @classmethod
    def from_json(cls, s: str) -> "ExecutionPlan":
        d = json.loads(s)
        return cls(
            config=EngineConfig.from_json(d["config"]),
            budget=MemoryBudget(**d["budget"]),
            meta=GraphMeta(**d["meta"]),
            n_shards=d["n_shards"],
            edge_block=d["edge_block"],
            vertex_pad=d["vertex_pad"],
            model=d["model"],
            ram_total=d["ram_total"],
            disk_total=d["disk_total"],
            net_total=d["net_total"],
            alternatives=[Candidate(**c) for c in d["alternatives"]],
            launch=d.get("launch", "threads"),
            launch_opts=d.get("launch_opts", {}),
        )


# --------------------------------------------------------------------------
# the planner
# --------------------------------------------------------------------------

# knob ladders, most preferred (fastest / default) first; the floor of each
# ladder is the most frugal configuration the engine still runs correctly
# (slice_cap auto-bumps to the max in-degree at runtime, the Pregel floor)
_CHUNK_LADDER = (8, 4, 2, 1)
_INFLIGHT_LADDER = (4, 2, 1)
_READ_LADDER = (4096, 1024, 256, 64)
_SLICE_LADDER = (4096, 1024, 512, 128)
_BATCH_LADDER = (4, 2, 1)  # batched group dispatch lanes (RAM: G chunk copies)


def plan(
    program,
    graph_meta,
    budget: MemoryBudget | None = None,
    *,
    edge_block: int = 512,
    vertex_pad: int = 8,
    depth: int = 2,
    skew: float = 1.5,
    recovery: RecoveryConfig | None = None,
    launch: str = "threads",
    launch_opts: dict | None = None,
    link_bytes_per_s: float | None = None,
) -> ExecutionPlan:
    """Choose an execution mode and derive every knob from the budget.

    ``graph_meta`` is a :class:`GraphMeta`, a ``Graph``, or a
    ``PartitionedGraph``; ``skew`` models the max/mean per-group padding
    overhead of the hash partition (Lemma 1 bounds it by 2).
    ``link_bytes_per_s`` prices every candidate's ``net_total`` in seconds
    (``Candidate.net_seconds``) at a measured per-link throughput — pass
    :func:`measured_link_throughput` for a real probe of the socket
    transport's frame path instead of a disk-bandwidth proxy.
    ``launch="processes"`` restricts the candidate set to what the
    multi-process deployment can actually execute — on-disk edge streams
    (each worker maps only its owner view) and the full-duplex pipelined
    channel (the shared-filesystem transport speaks the inbox-run-file
    format) — and frames the model as per-process RAM / per-NIC bytes.
    ``launch_opts`` pins deployment knobs (transport, net timeouts, retry
    budget — the surface of ``config.LAUNCH_OPT_FIELDS``) into the plan,
    validated here so a serialized plan is a runnable deployment spec.
    """
    if launch not in ("threads", "processes"):
        raise ValueError(
            f"launch must be 'threads' or 'processes', got {launch!r}"
        )
    launch_opts = validate_launch_opts(launch_opts, launch)
    meta = GraphMeta.of(graph_meta)
    budget = (budget or MemoryBudget()).validate()
    n = budget.n_shards
    combined = program.combiner is not None
    vdt = program.value_dtype.itemsize
    mdt = program.msg_dtype.itemsize
    float_msgs = program.msg_dtype.is_floating_point and mdt <= 4

    if meta.max_shard_vertices is not None and meta.for_n_shards == n:
        P = max(_round_up(meta.max_shard_vertices, vertex_pad), vertex_pad)
    else:
        P = max(_round_up(-(-meta.n_vertices // n), vertex_pad), vertex_pad)
    mean_group = meta.n_edges / (n * n)
    E_cap = max(_round_up(int(mean_group * skew), edge_block), edge_block)
    geom = dict(n_shards=n, P=P, E_cap=E_cap, edge_block=edge_block,
                value_itemsize=vdt, msg_itemsize=mdt, combined=combined)

    def in_memory(name: str, mode: str, reason_veto: str = "") -> Candidate:
        if launch == "processes" and not reason_veto:
            reason_veto = (
                "launch='processes' needs mode='streamed': workers exchange "
                "messages through on-disk inbox run files and map only "
                "their owner view of the edge streams"
            )
        model = estimate_memory(mode=mode, **geom)
        ram = ram_total(model, mode)
        net = estimate_net(mode, n_shards=n, P=P, E_cap=E_cap,
                           msg_itemsize=mdt, combined=combined)
        disk = 0
        feasible, reason = True, ""
        if reason_veto:
            feasible, reason = False, reason_veto
        elif budget.ram_per_shard is not None and ram > budget.ram_per_shard:
            feasible = False
            reason = (f"ram {_fmt(ram)} > budget "
                      f"{_fmt(budget.ram_per_shard)} (edge groups resident: "
                      f"{_fmt(model['streamed'])})")
        elif (budget.net_per_superstep is not None
              and net > budget.net_per_superstep):
            feasible = False
            reason = (f"net {_fmt(net)}/superstep > budget "
                      f"{_fmt(budget.net_per_superstep)}")
        return Candidate(name=name, mode=mode, pipeline=False, compress=False,
                         feasible=feasible, chosen=False, reason=reason,
                         model=model, ram_total=ram, disk_total=disk,
                         net_total=net, knobs={})

    def streamed(pipeline: bool) -> Candidate:
        name = "streamed+pipeline" if pipeline else "streamed"
        # disk tier first: engage compression only when the budget demands it
        compress = False
        compress_payload = False
        per_msg_spill = MessageRunStore.fixed_bytes_per_message(mdt)

        def disk_for(compress: bool, compress_payload: bool) -> int:
            d = estimate_edge_disk_bytes(n, E_cap, compress,
                                         compress_payload)
            spill_per_msg = ShardChannels.wire_bytes_per_message(
                msg_itemsize=mdt, combined=combined, compress=compress,
                compress_payload=compress_payload,
            ) if (compress or compress_payload) else (
                per_msg_spill if not combined else (4 + mdt + 4)
            )
            if not combined:
                d += int(E_cap * spill_per_msg)  # peak OMS: one dest's runs
            elif pipeline:
                d += int(P * spill_per_msg)  # peak inbox: one dest's groups
            return d

        disk = disk_for(False, False)
        if budget.disk_per_shard is not None and disk > budget.disk_per_shard:
            compress = True
            disk = disk_for(True, False)
            if disk > budget.disk_per_shard:
                compress_payload = True
                disk = disk_for(True, True)

        def net_for(compress: bool, compress_payload: bool) -> int:
            return estimate_net(
                "streamed", n_shards=n, P=P, E_cap=E_cap, msg_itemsize=mdt,
                combined=combined, compress=compress,
                compress_payload=compress_payload,
            )

        # network tier next: a shrinking net budget flips the wire codecs
        # on (positions first, then the payload channel) before anything is
        # declared infeasible
        net = net_for(compress, compress_payload)
        if budget.net_per_superstep is not None:
            if net > budget.net_per_superstep and not compress:
                compress = True
                net = net_for(compress, compress_payload)
            if net > budget.net_per_superstep and not compress_payload:
                compress_payload = True
                net = net_for(compress, compress_payload)
            disk = disk_for(compress, compress_payload)
        # knob ladders, first fit wins; ordering shrinks the cheap knobs
        # first (merge fan-in, then read/slice windows, then the in-flight
        # budget and batch width, then the edge staging chunk)
        fanin_ladder = sorted({16, max(2, n)}, reverse=True)
        infl_ladder = _INFLIGHT_LADDER if pipeline else (4,)
        # full duplex preferred; shedding it drops the receiver-staging
        # tier, so it sits between the batch ladder (cheapest to give up)
        # and the window/in-flight ladders. The multi-process transport IS
        # the full-duplex channel (workers digest peer runs as they land),
        # so launch='processes' pins the knob instead of laddering it
        if launch == "processes":
            duplex_ladder = (True,)
        else:
            duplex_ladder = (True, False) if pipeline else (True,)
        if combined:
            combos = itertools.product(
                _CHUNK_LADDER, infl_ladder, (4096,), (4096,), (16,),
                duplex_ladder, _BATCH_LADDER,
            )
        else:
            combos = itertools.product(
                _CHUNK_LADDER, infl_ladder, _SLICE_LADDER, _READ_LADDER,
                fanin_ladder, duplex_ladder, (1,),
            )
        chosen_model = chosen_knobs = None
        ram = 0
        for cb, infl, sc, rc, fanin, fd, gb in combos:
            model = estimate_memory(
                mode="streamed", pipeline=pipeline, compress=compress,
                compress_payload=compress_payload, full_duplex=fd,
                chunk_blocks=cb, depth=depth, group_batch=gb, slice_cap=sc,
                read_chunk=rc, merge_fanin=fanin, inflight=infl, **geom,
            )
            ram = ram_total(model, "streamed")
            chosen_model = model
            chosen_knobs = dict(chunk_blocks=cb, depth=depth, inflight=infl,
                                group_batch=gb, full_duplex=fd,
                                slice_cap=sc, read_chunk=rc,
                                merge_fanin=fanin)
            if budget.ram_per_shard is None or ram <= budget.ram_per_shard:
                break
        feasible, reason = True, ""
        if launch == "processes" and not pipeline:
            feasible = False
            reason = ("launch='processes' runs the pipelined full-duplex "
                      "channel only (the shared-filesystem transport is the "
                      "inbox-run-file channel; the unpipelined fold keeps "
                      "all n accumulators in one address space)")
        elif budget.ram_per_shard is not None and ram > budget.ram_per_shard:
            feasible = False
            reason = (f"ram {_fmt(ram)} > budget "
                      f"{_fmt(budget.ram_per_shard)} even at floor knobs "
                      + " ".join(f"{k}={_fmt(v)}"
                                 for k, v in chosen_model.items()
                                 if k != "streamed"))
        elif (budget.disk_per_shard is not None
              and disk > budget.disk_per_shard):
            feasible = False
            reason = (f"disk {_fmt(disk)} > budget "
                      f"{_fmt(budget.disk_per_shard)} even compressed")
        elif (budget.net_per_superstep is not None
              and net > budget.net_per_superstep):
            # inbox appends are local disk in emulation, but they model
            # cross-machine traffic in deployment — the budget applies
            feasible = False
            reason = (f"net {_fmt(net)}/superstep > budget "
                      f"{_fmt(budget.net_per_superstep)} even with the "
                      "position and payload codecs engaged")
        if feasible and budget.ram_per_shard is not None:
            # per-shard tier assignment: the RAM the floor knobs left unused
            # becomes this shard's hot_cache tier (streams/residency.py) —
            # capped at the decoded edge stream, past which the whole graph
            # fits and more cache is waste. Re-run the algebra so the tier
            # is modeled exactly where the engine will realize it.
            spare = int(budget.ram_per_shard) - ram
            cache = max(0, min(spare, n * E_cap * EDGE_SLOT_BYTES))
            if cache:
                ck = chosen_knobs
                chosen_model = estimate_memory(
                    mode="streamed", pipeline=pipeline, compress=compress,
                    compress_payload=compress_payload,
                    full_duplex=ck["full_duplex"],
                    chunk_blocks=ck["chunk_blocks"], depth=depth,
                    group_batch=ck["group_batch"],
                    slice_cap=ck["slice_cap"], read_chunk=ck["read_chunk"],
                    merge_fanin=ck["merge_fanin"], inflight=ck["inflight"],
                    cache_bytes=cache, **geom,
                )
                ram = ram_total(chosen_model, "streamed")
                chosen_knobs = dict(chosen_knobs, cache_bytes=cache)
        if compress:
            name += "+compress"
        if compress_payload:
            name += "+payload"
        return Candidate(name=name, mode="streamed", pipeline=pipeline,
                         compress=compress, feasible=feasible, chosen=False,
                         reason=reason, model=chosen_model,
                         ram_total=ram, disk_total=disk, net_total=net,
                         knobs=chosen_knobs,
                         compress_payload=compress_payload)

    candidates: list[Candidate] = []
    if combined:
        candidates.append(in_memory("recoded", "recoded"))
        candidates.append(in_memory(
            "recoded_compact", "recoded_compact",
            reason_veto="" if float_msgs
            else "needs float messages (bf16 wire rounds integers)",
        ))
        candidates.append(in_memory(
            "basic", "basic",
            reason_veto="dominated by recoded for combiner programs "
                        "(network and buffers ∝ |E| instead of |V|)",
        ))
    else:
        candidates.append(in_memory("basic", "basic"))
    candidates.append(streamed(pipeline=False))
    candidates.append(streamed(pipeline=True))

    if link_bytes_per_s is not None:
        for c in candidates:
            c.net_seconds = estimate_net_seconds(c.net_total,
                                                 link_bytes_per_s)

    winner = next((c for c in candidates if c.feasible), None)
    if winner is None:
        frugal = candidates[-1]
        breakdown = dict(budget=budget.to_json(), meta=meta.to_json(),
                         candidates=[c.to_json() for c in candidates])
        raise PlanInfeasible(
            f"no execution mode fits {budget}: the most frugal plan "
            f"({frugal.name} at floor knobs) still needs "
            f"{_fmt(frugal.ram_total)} RAM/shard ("
            + " ".join(f"{k}={_fmt(v)}" for k, v in frugal.model.items()
                       if k != "streamed")
            + f") and {_fmt(frugal.disk_total)} disk/shard; raise "
            f"ram_per_shard, add shards, or relax the disk budget.",
            breakdown,
        )
    winner.chosen = True
    for c in candidates:
        if c.feasible and not c.chosen and not c.reason:
            c.reason = f"feasible, but {winner.name} preferred (listed order)"

    k = winner.knobs
    cfg = EngineConfig(
        mode=winner.mode,
        stream=StreamConfig(chunk_blocks=k.get("chunk_blocks", 8),
                            depth=k.get("depth", depth),
                            group_batch=k.get("group_batch", 1),
                            cache_bytes=k.get("cache_bytes", 0)),
        spill=MessageSpillConfig(slice_cap=k.get("slice_cap", 4096),
                                 read_chunk=k.get("read_chunk", 4096),
                                 merge_fanin=k.get("merge_fanin", 16)),
        channel=ChannelConfig(pipeline=winner.pipeline,
                              compress=winner.compress,
                              compress_payload=winner.compress_payload,
                              full_duplex=bool(k.get("full_duplex", True)),
                              inflight=k.get("inflight", 4)),
        recovery=recovery or RecoveryConfig(),
    ).finalize(program)
    return ExecutionPlan(
        config=cfg, budget=budget, meta=meta, n_shards=n,
        edge_block=edge_block, vertex_pad=vertex_pad,
        model=winner.model, ram_total=winner.ram_total,
        disk_total=winner.disk_total, net_total=winner.net_total,
        alternatives=candidates, launch=launch, launch_opts=launch_opts,
    )
