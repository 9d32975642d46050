"""`GraphDJob`: the one-call session facade over the full job lifecycle.

Port of ``repro/core/job.py``:

    from repro_torch.core import GraphDJob, MemoryBudget, PageRank

    result = GraphDJob(
        PageRank(supersteps=10), graph,
        budget=MemoryBudget(ram_per_shard=64 << 10, n_shards=8),
        workdir="/data/job",
    ).run()

The job owns, under one ``workdir``:

* the plan (``core.plan.plan``, or an explicit ``plan=``),
* the partition, spilling edge groups to ``workdir/edges`` when the plan
  picked the out-of-core mode (``partition_for_plan``),
* the recovery wiring (``workdir/ckpt`` checkpoints + ``workdir/logs``
  message logs, built from the plan's RecoveryConfig),
* the engine, the superstep loop, single-shard fast recovery, and elastic
  rescaling (state migrates by original vertex id, so it works for every
  mode including vertex-only streamed partitions),

and returns a :class:`JobResult` with the final values, the superstep
history, and the realized-vs-planned memory model. The job runs on
``device`` (CUDA unless the caller names another). ``launch="threads"``
runs the n shards in this process; ``launch="processes"`` runs one worker
process per shard (``launch/procs.py``), each on ``device``, over the
shared-filesystem transport or, with ``launch_opts={"transport":
"sockets"}``, over loopback TCP with a coordinator process of its own.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from dataclasses import dataclass

import numpy as np

import torch

from repro_torch.convert import numpy_dtype
from repro_torch.core.checkpoint import (
    Checkpointer, MessageLog, RunFileMessageLog, recover_shard,
    recover_shard_streamed,
)
from repro_torch.core.config import RecoveryConfig, validate_launch_opts
from repro_torch.core.engine import GraphDEngine, SuperstepRecord
from repro_torch.core.plan import (
    ExecutionPlan, GraphMeta, MemoryBudget, plan as make_plan, ram_total,
)
from repro_torch.device import resolve_device
from repro_torch.graph.partition import partition_for_plan


@dataclass
class JobResult:
    """What a run produced, plus the audit trail: what was planned and what
    it actually cost. ``summary()`` is JSON-able for benchmarks/CI artifacts."""

    values: dict[int, object]  # {original vertex id: final value}
    history: list[SuperstepRecord]
    plan: ExecutionPlan
    realized_model: dict[str, int]
    realized_ram: int
    workdir: str

    @property
    def planned_ram(self) -> int:
        return self.plan.ram_total

    @property
    def n_supersteps(self) -> int:
        return len(self.history)

    def summary(self) -> dict:
        """JSON-able record of the run (values excluded — they are the
        payload, not the audit trail; ``values`` stays on the object)."""
        ratio = (self.planned_ram / self.realized_ram
                 if self.realized_ram else float("inf"))
        return dict(
            mode=self.plan.mode,
            pipeline=self.plan.pipeline,
            compress=self.plan.compress,
            n_shards=self.plan.n_shards,
            n_vertices=len(self.values),
            n_supersteps=self.n_supersteps,
            halted_at=self.history[-1].step if self.history else None,
            planned=dict(ram=self.planned_ram, model=self.plan.model),
            realized=dict(ram=self.realized_ram, model=self.realized_model),
            planned_over_realized_ram=ratio,
            # semi-external residency behavior, observable without a
            # profiler: disk reads vs hot-cache hits vs skip()-elided blocks
            residency=dict(
                cache_bytes=self.plan.config.stream.cache_bytes,
                blocks_read=sum(r.blocks_read for r in self.history),
                cache_hits=sum(r.cache_hits for r in self.history),
                cache_evictions=sum(r.cache_evictions
                                    for r in self.history),
                blocks_skipped=sum(r.blocks_skipped for r in self.history),
            ),
            history=[dataclasses.asdict(r) for r in self.history],
        )

    def to_json(self) -> str:
        return json.dumps(self.summary())


class GraphDJob:
    """Plan → partition → run → recover/rescale, one object, one workdir.

    ``budget`` drives the planner; pass ``plan=`` instead to pin an exact
    physical plan (mutually exclusive — a plan already embeds its budget).
    ``checkpoint_every`` overrides the plan's RecoveryConfig and turns on
    message logging, enabling :meth:`recover_shard`. Without a ``workdir``
    the job creates (and owns) a temporary one; use the job as a context
    manager or call :meth:`close` to release it. ``device=None`` runs on
    CUDA and raises without it.
    """

    def __init__(
        self,
        program,
        graph,
        *,
        budget: MemoryBudget | None = None,
        plan: ExecutionPlan | None = None,
        workdir: str | None = None,
        checkpoint_every: int | None = None,
        edge_block: int = 512,
        vertex_pad: int = 8,
        launch: str = "threads",
        launch_opts: dict | None = None,
        device=None,
    ):
        if plan is not None and budget is not None:
            raise ValueError(
                "pass budget= (to plan) or plan= (pre-planned), not both — "
                "an ExecutionPlan already embeds the budget it was made for"
            )
        if launch not in ("threads", "processes"):
            raise ValueError(
                f"launch must be 'threads' or 'processes', got {launch!r}"
            )
        self.device = resolve_device(device)
        self.program = program
        self.graph = graph
        self.launch = launch
        # launch_opts tunes the deployment, not the plan: the message
        # transport ("files" | "sockets"), net timeouts, the coordinator's
        # liveness clock, retry budgets and chaos schedules — the documented
        # surface of config.LAUNCH_OPT_FIELDS, validated here (and merged
        # over any opts the plan itself pinned, job args winning)
        self.launch_opts = validate_launch_opts(launch_opts, launch)
        # expert plans are materialized verbatim; only budget-derived plans
        # get their knobs re-derived against the realized geometry
        self._auto_planned = plan is None
        if plan is None:
            plan = make_plan(program, GraphMeta.of(graph), budget,
                             edge_block=edge_block, vertex_pad=vertex_pad,
                             launch=launch)
        elif launch == "processes" and plan.mode != "streamed":
            raise ValueError(
                "launch='processes' needs a mode='streamed' plan (workers "
                f"stream their owner view from disk); got mode={plan.mode!r}"
                " — re-plan with plan(..., launch='processes')"
            )
        if (launch == "processes"
                and plan.config.channel.payload_scheme == "auto"):
            # the auto-pick's first-superstep sample is engine-local state:
            # n worker processes would each decide independently and their
            # wire formats could diverge. Downgrade to the fixed lossless
            # codec (keeping compression!) instead of rejecting the plan —
            # the planner-layer resolution of the conflict that
            # EngineConfig.finalize()/run_processes raise ConfigError for.
            plan = dataclasses.replace(plan, config=dataclasses.replace(
                plan.config, channel=dataclasses.replace(
                    plan.config.channel, compress_payload="lossless"),
            ))
        if plan.launch_opts:
            # plan-pinned deployment knobs are defaults; job args override
            self.launch_opts = {**plan.launch_opts, **self.launch_opts}
        if checkpoint_every is not None:
            # message logging (=> single-shard fast recovery) needs either a
            # combined A_s log or the streamed OMS run files; a combiner-less
            # in-memory plan has neither, so it gets checkpoints only
            log_ok = (plan.mode == "streamed"
                      or program.combiner is not None)
            plan = dataclasses.replace(plan, config=dataclasses.replace(
                plan.config,
                recovery=RecoveryConfig(
                    checkpoint_every=checkpoint_every,
                    log_messages=checkpoint_every > 0 and log_ok,
                ),
            ))
            plan.config.finalize()
        self.plan = plan
        self.budget = plan.budget
        self._tmp = workdir is None
        self.workdir = workdir or tempfile.mkdtemp(prefix="graphd-job-")
        os.makedirs(self.workdir, exist_ok=True)
        self._guard_workdir_identity()
        self._state = None  # (values, active) after a run / rescale
        self._next_step = 0
        self._closed = False
        try:
            self._build(tag="")
        except BaseException:
            # a failure between partition-spill and engine wiring must not
            # strand the workdir the job itself created: mark the job closed
            # and drop the temp dir (an explicit user workdir is kept, with
            # whatever partial spill is in it, for post-mortem)
            self._closed = True
            if self._tmp:
                shutil.rmtree(self.workdir, ignore_errors=True)
            raise

    def _guard_workdir_identity(self) -> None:
        """A reused workdir may hold another job's checkpoints; silently
        restoring them would hand this program a different program's state.
        The identity file pins (program, graph); a mismatch is an error, a
        match means resume is intended."""
        ident = dict(
            program=type(self.program).__name__,
            value_dtype=str(numpy_dtype(self.program.value_dtype)),
            n_vertices=self.plan.meta.n_vertices,
            n_edges=self.plan.meta.n_edges,
        )
        path = os.path.join(self.workdir, "job.json")
        if os.path.exists(path):
            with open(path) as f:
                existing = json.load(f)
            if existing != ident:
                raise ValueError(
                    f"workdir {self.workdir!r} belongs to a different job "
                    f"({existing}) than this one ({ident}); its checkpoints "
                    "would be restored as this program's state — use a "
                    "fresh workdir (or delete the old one)"
                )
        else:
            with open(path, "w") as f:
                json.dump(ident, f)

    # -- wiring ---------------------------------------------------------------
    def _dir(self, name: str, tag: str) -> str:
        return os.path.join(self.workdir, name + tag)

    def _build(self, tag: str) -> None:
        """Partition (spilling if planned) and wire store/log/ckpt/engine
        under ``workdir``; ``tag`` namespaces the layout after a rescale (the
        shard count changed, so checkpoints/logs/streams are a new lineage)."""
        self._tag = tag
        plan = self.plan
        self.pg, self.rmap, self.store = partition_for_plan(
            self.graph, plan, self._dir("edges", tag), device=self.device
        )
        plan = self.plan = self._refine_plan(plan)
        rec = plan.config.recovery
        self.checkpointer = (
            Checkpointer(self._dir("ckpt", tag), every=rec.checkpoint_every,
                         keep=rec.keep)
            if rec.checkpoint_every else None
        )
        if rec.log_messages:
            if plan.mode != "streamed" and self.program.combiner is None:
                raise ValueError(
                    "recovery.log_messages needs combined A_s buffers (a "
                    "program combiner) or the streamed OMS tier; a "
                    "combiner-less in-memory plan has neither — tighten the "
                    "budget so the plan goes streamed, or drop log_messages "
                    "(checkpoint-only restarts still work)"
                )
            log_dir = self._dir("logs", tag)
            self.message_log = (RunFileMessageLog(log_dir)
                                if plan.mode == "streamed"
                                else MessageLog(log_dir))
        else:
            self.message_log = None
        self.engine = GraphDEngine(
            self.pg, self.program, config=plan.config, device=self.device,
            stream_store=self.store, message_log=self.message_log,
        )

    def _refine_plan(self, plan: ExecutionPlan) -> ExecutionPlan:
        """Re-run the knob ladder against the REALIZED partition geometry.

        The pre-partition plan estimates P as ceil(|V|/n); the hash
        partition's imbalance can realize a bigger max shard, and a ladder
        that spent the whole budget on optional knobs (batch lanes, the
        full-duplex receiver staging) against the estimate would overshoot
        it in realized bytes. Planning again with ``GraphMeta.of(pg)`` (the
        exact P rides along) re-derives the knobs the budget actually
        affords. Only adopted when the physical layout already on disk
        still matches (same mode/pipeline/codecs — the spill happened under
        the original plan); an infeasibility against the exact geometry
        falls back to the original best-effort plan."""
        from repro_torch.core.plan import PlanInfeasible

        b = plan.budget
        if not self._auto_planned or plan.mode != "streamed" or (
            b.ram_per_shard is None and b.disk_per_shard is None
            and b.net_per_superstep is None
        ):
            return plan
        try:
            refined = make_plan(
                self.program, GraphMeta.of(self.pg), b,
                edge_block=plan.edge_block, vertex_pad=plan.vertex_pad,
                recovery=plan.config.recovery, launch=self.launch,
            )
        except PlanInfeasible:
            return plan
        same_layout = (
            refined.mode == plan.mode
            and refined.pipeline == plan.pipeline
            and refined.compress == plan.compress
            and bool(refined.compress_payload) == bool(plan.compress_payload)
        )
        return refined if same_layout else plan

    # -- lifecycle ------------------------------------------------------------
    def run(self, max_supersteps: int = 10_000, *,
            verbose: bool = False, on_step=None) -> JobResult:
        """Run (or continue, after :meth:`rescale`) to completion and return
        the structured result. With recovery enabled a step-0 checkpoint is
        saved before the first superstep so single-shard recovery always has
        a base to replay from. Re-running a job whose workdir already holds
        a finished run's checkpoint is a RESUME: the state restores and the
        result carries zero new supersteps (the identity file written at
        construction guards against resuming a different job's state)."""
        self._check_open()
        if (self.checkpointer is not None and self._state is None
                and self.checkpointer.latest() is None):
            meta = (self.store.signature()
                    if self.store is not None else None)
            self.checkpointer.save(0, *self.engine.init(), meta=meta)
        try:
            if self.launch == "processes":
                from repro_torch.launch.procs import run_processes

                (values, active), history = run_processes(
                    self, max_supersteps, verbose=verbose, on_step=on_step,
                )
            else:
                (values, active), history = self.engine.run(
                    max_supersteps=max_supersteps, state=self._state,
                    start_step=self._next_step, verbose=verbose,
                    checkpointer=self.checkpointer, on_step=on_step,
                )
        finally:
            # success or failure, leave no half-written superstep scratch
            # (inbox runs, OMS spills, outbox/announce records) behind
            self._sweep_scratch()
        self._state = (values, active)
        if history:
            self._next_step = history[-1].step + 1
        realized = self.engine.memory_model()
        return JobResult(
            values=self.engine.gather_values(values),
            history=history,
            plan=self.plan,
            realized_model=realized,
            realized_ram=ram_total(realized, self.plan.mode),
            workdir=self.workdir,
        )

    def recover_shard(self, failed: int, target_step: int | None = None):
        """Single-shard fast recovery ([19]/§3.4): only ``failed`` recomputes
        from the latest checkpoint + peers' logged messages. Returns that
        shard's ``(values_row, active_row)`` at ``target_step`` (default: the
        last completed superstep)."""
        self._check_open()
        if self.checkpointer is None or self.message_log is None:
            raise RuntimeError(
                "recovery needs checkpoints + message logs: construct the "
                "job with checkpoint_every= (or a RecoveryConfig on the "
                "plan) before run()"
            )
        target = self._next_step if target_step is None else target_step
        if self.plan.mode == "streamed":
            log = self.message_log
            if self.launch == "processes":
                # each worker process logs into its own lineage
                # (logs/shard-w) — one run-file index per writer. The failed
                # shard's log holds every run addressed to it (its own
                # included: the transport routes w→w through the outbox
                # too), so replay reads just that lineage
                comb = self.program.combiner
                ch = self.plan.config.channel
                log = RunFileMessageLog(
                    os.path.join(self._dir("logs", self._tag),
                                 f"shard-{failed}"))
                log.configure(
                    self.pg.n_shards, self.pg.P,
                    numpy_dtype(self.program.msg_dtype),
                    e0=comb.e0 if comb is not None else 0,
                    combined=comb is not None, compress=ch.compress,
                    compress_payload=ch.compress_payload,
                )
            return recover_shard_streamed(
                self.pg, self.program, failed, self.checkpointer,
                log, self.store, target,
            )
        return recover_shard(self.pg, self.program, failed,
                             self.checkpointer, self.message_log, target)

    def rescale(self, n_shards: int) -> "GraphDJob":
        """Elastic rescale: re-plan for ``n_shards`` under the same budget,
        rebuild the physical layout (respilling edge streams when streamed),
        and migrate live vertex state by original id — works for every mode,
        including vertex-only spilled partitions. The job then continues
        from the same superstep: ``job.rescale(12).run()``."""
        self._check_open()
        if self._state is None:
            raise RuntimeError("rescale() needs a prior run(): no live state")
        old_vals = self._state[0].cpu().numpy()
        old_act = self._state[1].cpu().numpy()
        vmask = self.pg.vmask.cpu().numpy()
        old_ids = self.pg.old_ids.cpu().numpy()[vmask]
        vals_real = old_vals[vmask]
        act_real = old_act[vmask]

        self.plan = make_plan(
            self.program, GraphMeta.of(self.graph),
            dataclasses.replace(self.budget, n_shards=n_shards),
            edge_block=self.plan.edge_block,
            vertex_pad=self.plan.vertex_pad,
            recovery=self.plan.config.recovery,
            launch=self.launch,
        )
        self.budget = self.plan.budget
        self._build(tag=f"-n{n_shards}")
        # migrate by original id: the new recode map decides (shard, pos)
        g_new = np.asarray(self.rmap.to_new(old_ids))
        vals2 = np.zeros((n_shards, self.pg.P), dtype=old_vals.dtype)
        act2 = np.zeros((n_shards, self.pg.P), dtype=bool)
        vals2[g_new % n_shards, g_new // n_shards] = vals_real
        act2[g_new % n_shards, g_new // n_shards] = act_real
        self._state = (torch.from_numpy(vals2).to(self.device),
                       torch.from_numpy(act2).to(self.device))
        # seed the new lineage with the migrated state: recovery replays
        # from the latest checkpoint, and the rescaled ckpt dir would
        # otherwise stay empty until a cadence boundary happens to be
        # crossed — recover_shard() right after a rescale must still work
        if self.checkpointer is not None:
            meta = self.store.signature() if self.store is not None else None
            self.checkpointer.save(self._next_step, *self._state, meta=meta)
        return self

    # -- teardown -------------------------------------------------------------
    def _sweep_scratch(self) -> None:
        """Drop per-superstep scratch (NOT checkpoints, logs, or streams):
        the engine's inbox/OMS step dirs and the multi-process transport's
        outbox/announce/per-worker-inbox dirs. Run on both the success and
        the failure path so a crash mid-superstep cannot strand half-written
        run files in a user-owned workdir."""
        eng = getattr(self, "engine", None)
        for d in (getattr(eng, "_inbox_dir", None),
                  getattr(eng, "msg_spill_dir", None)):
            if d and os.path.isdir(d):
                for name in os.listdir(d):
                    if name.startswith(("step-", "recover-")):
                        shutil.rmtree(os.path.join(d, name),
                                      ignore_errors=True)
        procs_dir = self._dir("procs", getattr(self, "_tag", ""))
        if os.path.isdir(procs_dir):
            # the finished launch's exchange dirs. Post-mortem artifacts
            # survive until the NEXT run's pre-spawn sweep:
            # failure-summary.json, failures/, worker logs and quarantined
            # (.quarantine) stores stay readable after a failed run returns.
            for sub in ("outbox", "announce"):
                shutil.rmtree(os.path.join(procs_dir, sub),
                              ignore_errors=True)
            for name in os.listdir(procs_dir):
                if name.startswith("shard-"):
                    shutil.rmtree(os.path.join(procs_dir, name, "inbox"),
                                  ignore_errors=True)

    def close(self, delete: bool | None = None) -> None:
        """Release the workdir. ``delete`` defaults to True only when the
        job created a temporary one; an explicit user workdir is kept."""
        if self._closed:
            return
        self._closed = True
        if delete if delete is not None else self._tmp:
            shutil.rmtree(self.workdir, ignore_errors=True)
        else:
            self._sweep_scratch()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("job is closed (workdir released)")

    def __enter__(self) -> "GraphDJob":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
