"""The in-memory superstep engine (paper §3.3, §5), on one device.

Port of the in-memory half of ``repro/core/engine.py``. The n shards are
emulated on one device: the shard axis is the leading dimension of every
tensor and ``core/collectives.py`` stands in for the ``lax`` collectives, so
an exchange round runs all n shards in one batch.

Modes (the JAX package's, minus ``streamed``):

* ``recoded`` (§5, IO-Recoded): each shard scatter-combines its messages for
  one destination at a time into ``A_s`` (U_c), the accumulators travel the
  ring of n shards and are digested into ``A_r`` (U_r), then the program
  applies and votes to halt. Ring order follows the JAX package: at round r
  shard i folds in its contribution for ``dest = (i + n-1-r) mod n`` and
  forwards the accumulator to shard i+1, so float sums reassociate the same
  way.
* ``basic_sc`` (IO-Basic with a combiner): the same ring, but each group is
  sorted by destination before it is combined (the OMS merge-sort).
* ``basic`` (§3.3.2, IO-Basic): raw ``(dst, payload)`` messages go through
  ``all_to_all`` uncombined; each receiver sorts them by destination (the
  IMS) and either scatter-combines, or, for a program with no combiner,
  hands the sorted runs to ``apply_list``.
* ``recoded_compact``: every shard's ``A_s`` for all n destinations in one
  ``all_to_all`` hop, on a bfloat16 wire with int8 has-message flags,
  digested in float32 (float messages only).

A ``message_log`` replaces any of these by the logged step, which hands
every shard's ``A_s`` for all destinations back to the host loop (§3.4).

Backends:

* ``"torch"``: plain PyTorch ops. Dense scan, or, when the frontier is thin
  (``recoded`` and ``basic_sc``), skip() gathers at most ``sparse_cap``
  active blocks per group.
* ``"kernel"`` (``recoded`` only): ``kernels/edge_combine`` (CUDA) and
  ``kernels/digest`` (Triton) on CUDA tensors, their plain versions on CPU
  tensors. skip() is always on in the kernel (a dense frontier keeps every
  block).

A superstep syncs with the host once, when ``run()`` reads its stats.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.core import collectives as coll
from repro_torch.core.api import ShardContext, VertexProgram
from repro_torch.core.config import EngineConfig
from repro_torch.device import resolve_device
from repro_torch.graph.partition import PartitionedGraph
from repro_torch.kernels import ops as kops
from repro_torch.kernels.digest import digest as kernel_digest
from repro_torch.kernels.edge_combine import edge_combine


def _shard_ctx(pg: PartitionedGraph) -> ShardContext:
    return ShardContext(
        shard=coll.axis_index(pg.n_shards, pg.device),
        n_shards=pg.n_shards,
        n_vertices=pg.n_vertices,
        P=pg.P,
        degree=pg.degree,
        vmask=pg.vmask,
        old_ids=pg.old_ids,
        gids=pg.gids,
    )


def _active_prefix(active: torch.Tensor) -> torch.Tensor:
    """Flat ``(n*P + 1,)`` inclusive prefix of the ``(n, P)`` active bitmap:
    block [lo, hi] of shard i has an active source iff
    prefix[i*P + hi+1] - prefix[i*P + lo] > 0 (skip() test, §3.2). One
    scan over the flattened bitmap: a one-dimensional ``cumsum`` is a
    device-wide scan, where a row-wise one over ``(n, P)`` runs PyTorch's
    innermost-dimension scan (3.36 ms against 0.14 ms a call for an
    (8, 2.1 M) bitmap on an H100)."""
    flat = active.reshape(-1)
    if flat.shape[0] >= 2**31:
        raise ValueError(f"n*P = {flat.shape[0]} overflows the int32 prefix")
    prefix = torch.empty(flat.shape[0] + 1, dtype=torch.int32,
                         device=active.device)
    prefix[0] = 0
    torch.cumsum(flat, 0, dtype=torch.int32, out=prefix[1:])
    return prefix


def _block_active(prefix: torch.Tensor, lo: torch.Tensor,
                  hi: torch.Tensor) -> torch.Tensor:
    """skip() test for block ranges ``lo/hi`` of shape (n, ...) whose sources
    lie on shard i of row i."""
    n = lo.shape[0]
    keep = kops.skip_keep_mask(lo.reshape(n, -1), hi.reshape(n, -1), prefix)
    return keep.view(lo.shape)


# --------------------------------------------------------------------------
# local combine (U_c): messages for one destination group per shard -> A_s
# --------------------------------------------------------------------------

def _gen_messages(program, values, degree, sp, w, active, step):
    """Gather source state, evaluate program.message, mask invalid and
    inactive edges to the identity (0 without a combiner). All (n, E) but
    values/degree/active."""
    spc = sp.clamp(min=0).long()
    aact = (sp >= 0) & active.gather(1, spc)
    msg = program.message(values.gather(1, spc), degree.gather(1, spc), w,
                          step).to(program.msg_dtype)
    e0 = program.combiner.e0 if program.combiner is not None else 0
    return torch.where(aact, msg, e0), aact


def _combine_scatter(program, P_dest, msg, dp, aact):
    """IO-Recoded: direct in-memory scatter-combine into A_s (paper §5)."""
    n = msg.shape[0]
    comb = program.combiner
    ar = torch.arange(n, device=msg.device)[:, None]
    idx = (dp.long() + ar * P_dest).reshape(-1)
    A_s = comb.identity((n * P_dest,), program.msg_dtype, msg.device)
    comb.scatter(A_s, idx, msg.reshape(-1))
    cnt = torch.zeros(n * P_dest, dtype=torch.int32, device=msg.device)
    cnt.index_add_(0, idx, aact.reshape(-1).to(torch.int32))
    return A_s.view(n, P_dest), cnt.view(n, P_dest)


def _combine_sort(program, P_dest, msg, dp, aact):
    """IO-Basic with a combiner: sort each row by destination, then combine
    (the merge-sort of §3.3.1). Invalid entries sort to the tail at key P."""
    key = torch.where(aact, dp, P_dest)
    skey, order = torch.sort(key, dim=-1, stable=True)
    smsg, sact = msg.gather(1, order), aact.gather(1, order)
    # _gen_messages already set the invalid entries to e0
    return _combine_scatter(program, P_dest, smsg, torch.where(sact, skey, 0),
                            sact)


def _contrib_dense(program, pg, values, active, step, dest,
                   combine=_combine_scatter):
    ar = torch.arange(pg.n_shards, device=pg.device)
    sp, dp, w = pg.src_pos[ar, dest], pg.dst_pos[ar, dest], pg.eweight[ar, dest]
    msg, aact = _gen_messages(program, values, pg.degree, sp, w, active, step)
    return combine(program, pg.P, msg, dp, aact)


def _contrib_all(program, pg, values, active, step):
    """Every shard's A_s and counts for all n destinations:
    ``(n_src, n_dest, P)`` each."""
    n = pg.n_shards
    parts = [_contrib_dense(program, pg, values, active, step,
                            torch.full((n,), d, device=pg.device))
             for d in range(n)]
    return (torch.stack([A for A, _ in parts], 1),
            torch.stack([c for _, c in parts], 1))


def _contrib_sparse(program, pg, values, active, prefix, step, dest, cap,
                    combine=_combine_scatter):
    """skip(): gather only the first ``cap`` active edge blocks per group."""
    n, B, nb = pg.n_shards, pg.edge_block, pg.n_blocks
    ar = torch.arange(n, device=pg.device)[:, None]
    act_blk = _block_active(prefix, pg.blk_lo[ar[:, 0], dest],
                            pg.blk_hi[ar[:, 0], dest])
    idx, n_act = kops.compact_blocks(act_blk)
    idx = idx[:, :cap].long()
    live = (torch.arange(idx.shape[1], device=pg.device)[None, :]
            < n_act[:, None])[..., None]
    take = lambda a, fill: torch.where(
        live, a.view(n, n, nb, B)[ar, dest[:, None], idx], fill
    ).reshape(n, -1)
    sp, dp, w = take(pg.src_pos, -1), take(pg.dst_pos, 0), take(pg.eweight, 0.0)
    msg, aact = _gen_messages(program, values, pg.degree, sp, w, active, step)
    return combine(program, pg.P, msg, dp, aact)


def _contrib_kernel(program, pg, values, active, prefix, dest):
    """The hand-written edge_combine on the partition's own blocks, with the
    skip-compacted block list always on."""
    n, B, nb = pg.n_shards, pg.edge_block, pg.n_blocks
    ar = torch.arange(n, device=pg.device)
    keep = kops.skip_keep_mask(pg.blk_lo[ar, dest], pg.blk_hi[ar, dest], prefix)
    ids, n_keep = kops.compact_blocks(keep)
    blocks = lambda a: a.view(n, n, nb, B)
    return edge_combine(
        values, pg.degree, active, blocks(pg.src_pos), blocks(pg.dst_pos),
        blocks(pg.eweight), dest.to(torch.int32), ids, n_keep,
        msg_kind=program.msg_kind, combiner=program.combiner.name,
    )


# --------------------------------------------------------------------------
# exchanges
# --------------------------------------------------------------------------

def _ring_exchange(pg, contrib, digest):
    """Ring reduce-scatter of per-destination combined buffers (§4.2/§5):
    n rounds; the accumulator arriving at shard i in round r is destined for
    ``(i + n-1-r) mod n``; shard i folds in its own A_s for that destination
    and forwards."""
    n = pg.n_shards
    i = coll.axis_index(n, pg.device)[:, 0]
    acc = contrib((i + n - 1) % n)
    for r in range(1, n):
        acc = tuple(coll.ring_shift(x) for x in acc)
        A_s, cnt = contrib((i + (n - 1 - r)) % n)
        acc = digest(acc[0], acc[1], A_s, cnt)
    return acc


def _basic_exchange(program, pg, values, active, step):
    """IO-Basic: raw (dst, payload) pairs all-to-all, a receiver-side sort
    by destination into the IMS, then one combining pass (§3.3.2). Returns
    (A_r or None without a combiner, cnt, sorted dst, sorted payloads), the
    last two ``(n, n*E_cap)`` with ``P`` marking padding.

    The combining pass adds each source shard's messages into a partial of
    their own, then the n partials in ascending shard order, as the ring
    sums per-shard partials: one float32 chain over a destination's whole
    run (at an RMAT hub, hundreds of thousands of messages) drifts ~20x
    further from the ring's sum (1.3e-5 of PageRank's largest value at
    RMAT scale 24 on an H100, against 6e-7 between the ring's backends)."""
    n, P = pg.n_shards, pg.P
    msg, aact = _gen_messages(program, values, pg.degree,
                              pg.src_pos.reshape(n, -1),
                              pg.eweight.reshape(n, -1), active, step)
    dp_send = torch.where(aact, pg.dst_pos.reshape(n, -1), P)
    recv_dp = coll.all_to_all(dp_send.view(n, n, -1)).view(n, -1)
    recv_msg = coll.all_to_all(msg.view(n, n, -1)).view(n, -1)
    del msg, aact, dp_send
    sdp, order = torch.sort(recv_dp, dim=-1, stable=True)
    smsg = recv_msg.gather(1, order)
    del recv_dp, recv_msg
    valid = sdp < P
    if program.combiner is None:  # apply_list consumes the runs
        cnt = torch.zeros(n * P, dtype=torch.int32, device=pg.device)
        row = torch.arange(n, device=pg.device)[:, None] * P
        cnt.index_add_(0, (torch.where(valid, sdp, 0) + row).reshape(-1),
                       valid.reshape(-1).to(torch.int32))
        return None, cnt.view(n, P), sdp, smsg
    # slot src*P + dst of each receiver's (n_src * P) partials
    slot = order // pg.E_cap * P + torch.where(valid, sdp, 0)
    del order
    # _gen_messages already set the invalid entries to e0
    A_part, cnt_part = _combine_scatter(program, n * P, smsg, slot, valid)
    A_r = program.combiner.reduce(A_part.view(n, n, P), 1)
    return A_r, cnt_part.view(n, n, P).sum(1, dtype=torch.int32), sdp, smsg


def _compact_exchange(program, pg, values, active, step):
    """One all_to_all hop of compact combined buffers: bfloat16 message
    values and int8 has-message flags (3 B a slot against the ring's 8 B,
    one rounding per message). The receiver digests in float32; its count
    is the number of shards that sent the vertex anything."""
    A_s_all, cnt_all = _contrib_all(program, pg, values, active, step)
    recv_A = coll.all_to_all(A_s_all.to(torch.bfloat16))
    recv_h = coll.all_to_all((cnt_all > 0).to(torch.int8))
    A_r = program.combiner.reduce(recv_A.to(program.msg_dtype), 1)
    return A_r, recv_h.sum(1, dtype=torch.int32)


@dataclass
class StepStats:
    """0-dim device tensors; ``run()`` reads them with one host sync."""

    n_active: torch.Tensor  # global active vertices after apply
    n_msgs: torch.Tensor  # global messages digested this superstep
    agg: torch.Tensor  # program aggregator (psum)
    density: torch.Tensor  # fraction of edge blocks active for NEXT superstep
    max_group_blocks: torch.Tensor  # max active blocks in any group


def superstep(program: VertexProgram, pg: PartitionedGraph, values, active,
              step: int, *, mode: str = "recoded", backend: str = "kernel",
              sparse_cap: int | None = None):
    """One full superstep: scatter -> exchange -> digest -> apply -> vote.
    ``sparse_cap`` (torch backend, ``recoded``/``basic_sc``) takes skip()'s
    sparse gather."""
    comb = program.combiner
    ctx = _shard_ctx(pg)
    if mode == "recoded_compact":
        A_r, cnt = _compact_exchange(program, pg, values, active, step)
    elif mode == "basic" and comb is None:
        # general Pregel path: destination-sorted message lists (§3.3.2)
        _, cnt, sdp, smsg = _basic_exchange(program, pg, values, active, step)
        has_msg = (cnt > 0) & pg.vmask
        new_values, new_active = program.apply_list(
            values, pg.degree, sdp, smsg, has_msg, active, step, ctx)
        return _finish_superstep(program, pg, values, new_values, new_active,
                                 cnt, has_msg)
    elif mode == "basic":
        A_r, cnt, _, _ = _basic_exchange(program, pg, values, active, step)
    elif backend == "kernel":
        prefix = _active_prefix(active)
        contrib = lambda dest: _contrib_kernel(program, pg, values, active,
                                               prefix, dest)
        digest = lambda A, c, A2, c2: kernel_digest(A, c, A2, c2,
                                                    combiner=comb.name)
        A_r, cnt = _ring_exchange(pg, contrib, digest)
    else:
        combine = _combine_sort if mode == "basic_sc" else _combine_scatter
        if sparse_cap is not None:
            prefix = _active_prefix(active)
            contrib = lambda dest: _contrib_sparse(
                program, pg, values, active, prefix, step, dest, sparse_cap,
                combine)
        else:
            contrib = lambda dest: _contrib_dense(program, pg, values, active,
                                                  step, dest, combine)
        digest = lambda A, c, A2, c2: (comb.combine(A, A2), c + c2)
        A_r, cnt = _ring_exchange(pg, contrib, digest)
    has_msg = (cnt > 0) & pg.vmask
    new_values, new_active = program.apply(
        values, pg.degree, A_r, has_msg, active, step, ctx
    )
    return _finish_superstep(program, pg, values, new_values, new_active, cnt,
                             has_msg)


def superstep_logged(program: VertexProgram, pg: PartitionedGraph, values,
                     active, step: int):
    """Recoded superstep that also materializes every shard's outgoing A_s
    for all destinations, so that the host loop can persist them ("keep all
    OMSs on local disk until a new checkpoint is written", §3.4). The
    exchange is an all_to_all of the combined buffers instead of the ring.
    Returns (values, active, StepStats, A_s_all, cnt_all), the last two
    ``(n_src, n_dest, P)``."""
    A_s_all, cnt_all = _contrib_all(program, pg, values, active, step)
    A_r = program.combiner.reduce(coll.all_to_all(A_s_all), 1)
    cnt = coll.all_to_all(cnt_all).sum(1, dtype=torch.int32)
    has_msg = (cnt > 0) & pg.vmask
    new_values, new_active = program.apply(
        values, pg.degree, A_r, has_msg, active, step, _shard_ctx(pg)
    )
    return (*_finish_superstep(program, pg, values, new_values, new_active,
                               cnt, has_msg), A_s_all, cnt_all)


def _finish_superstep(program, pg, values, new_values, new_active, cnt,
                      has_msg):
    """Superstep tail: halt voting, aggregator, frontier stats."""
    new_active = new_active & pg.vmask
    n_active = coll.psum(new_active.sum(1))
    n_msgs = coll.psum(cnt.sum(1))
    agg = program.aggregate(values, new_values, has_msg)
    agg = (coll.psum(agg.to(torch.float32).sum(1)) if agg is not None
           else torch.zeros((), dtype=torch.float32, device=pg.device))
    # frontier density for the next superstep (drives dense/sparse dispatch)
    act_blk = _block_active(_active_prefix(new_active), pg.blk_lo, pg.blk_hi)
    num = coll.psum(act_blk.sum((1, 2)))
    den = coll.psum((pg.blk_hi >= 0).sum((1, 2)))
    density = num.to(torch.float32) / den.clamp(min=1).to(torch.float32)
    max_grp = coll.pmax(act_blk.sum(-1))
    return new_values, new_active, StepStats(n_active, n_msgs, agg, density,
                                             max_grp)


def init_spmd(program: VertexProgram, pg: PartitionedGraph):
    values, active = program.init(_shard_ctx(pg))
    return values.to(program.value_dtype), active & pg.vmask


# --------------------------------------------------------------------------
# host driver
# --------------------------------------------------------------------------

@dataclass
class SuperstepRecord:
    step: int
    n_active: int
    n_msgs: int
    agg: float
    density: float
    mode: str  # "dense" | "sparse" dispatch chosen for this superstep
    seconds: float
    # step a checkpoint auto-restore resumed from (first record only)
    restored_from: int | None = None


class GraphDEngine:
    """Host driver: runs the superstep loop with dense/sparse dispatch.

    ``device=None`` runs on CUDA (and raises without it); the partition is
    moved to the engine's device if it lies elsewhere. ``message_log`` (a
    ``core.checkpoint.MessageLog``) makes every superstep the logged one and
    saves its outgoing buffers, for single-shard fast recovery (§3.4)."""

    def __init__(self, pg: PartitionedGraph, program: VertexProgram,
                 config: EngineConfig | None = None, *, device=None,
                 message_log=None):
        cfg = (config or EngineConfig()).finalize()
        mode = cfg.mode
        if pg.E_cap > 0 and pg.src_pos.shape[-1] == 0:
            raise ValueError(
                "this partition is vertex-only (its edge groups were dropped "
                "by drop_edges); the in-memory modes need the edge groups"
            )
        if mode != "basic" and program.combiner is None:
            raise ValueError(f"mode={mode} requires a message combiner "
                             "(paper §5)")
        if mode == "recoded_compact" and program.msg_dtype not in (
                torch.float32, torch.bfloat16):
            # the bf16 wire rounds integers above 256: min-label programs
            # would merge distinct labels
            raise ValueError("recoded_compact needs float messages")
        if cfg.backend == "kernel" and program.msg_kind is None:
            raise ValueError("backend='kernel' needs a program.msg_kind")
        if message_log is not None and program.combiner is None:
            raise ValueError("a message log holds combined buffers: it needs "
                             "a program with a combiner")
        self.device = resolve_device(device)
        self.pg = pg if pg.device == self.device else pg.to(self.device)
        self.program = program
        self.config = cfg
        self.mode = mode
        self.backend = cfg.backend
        self.message_log = message_log
        self.adapt_threshold = cfg.adapt_threshold
        self.sparse_cap = max(1, int(pg.n_blocks * cfg.sparse_cap_frac))

    def init(self):
        return init_spmd(self.program, self.pg)

    def step(self, values, active, step: int, sparse: bool = False):
        """One superstep; returns (values, active, StepStats)."""
        return superstep(self.program, self.pg, values, active, step,
                         mode=self.mode, backend=self.backend,
                         sparse_cap=self.sparse_cap if sparse else None)

    def step_logged(self, values, active, step: int):
        """The logged superstep; returns (values, active, StepStats,
        A_s_all, cnt_all)."""
        return superstep_logged(self.program, self.pg, values, active, step)

    def run(self, max_supersteps: int = 10_000, state=None,
            start_step: int = 0, verbose: bool = False, checkpointer=None,
            on_step=None):
        """Superstep loop; returns ((values, active), [SuperstepRecord]).

        With a ``checkpointer`` and no ``state``, the run resumes from the
        latest checkpoint; an explicit ``(state, start_step)`` wins over
        it. A checkpoint lands after superstep s when ``s + 1`` is on its
        cadence, and then the message log drops every older step.
        ``on_step(record, (values, active))`` runs after each superstep."""
        restored_from = None
        if (state is None and checkpointer is not None
                and checkpointer.latest() is not None):
            values, active, start_step = checkpointer.restore(
                device=self.device)
            restored_from = start_step
        else:
            values, active = state if state is not None else self.init()
        history: list[SuperstepRecord] = []
        budget = self.program.num_supersteps
        target = max_supersteps if budget is None else min(budget,
                                                           max_supersteps)
        density = 1.0  # step 0: unknown, assume dense
        max_grp = self.pg.n_blocks  # hard per-group bound; start pessimistic
        for s in range(start_step, target):
            use_sparse = (self.mode in ("recoded", "basic_sc")
                          and max_grp <= self.sparse_cap
                          and density < self.adapt_threshold)
            t0 = time.perf_counter()
            if self.message_log is not None:
                values, active, st, A_s_all, cnt_all = self.step_logged(
                    values, active, s)
                self.message_log.save(s, A_s_all, cnt_all)
                del A_s_all, cnt_all
            else:
                values, active, st = self.step(values, active, s, use_sparse)
            n_active, n_msgs, agg, density, max_grp = torch.stack([
                st.n_active.double(), st.n_msgs.double(), st.agg.double(),
                st.density.double(), st.max_group_blocks.double(),
            ]).tolist()  # the superstep's one host sync
            rec = SuperstepRecord(
                step=s, n_active=int(n_active), n_msgs=int(n_msgs), agg=agg,
                density=density, mode="sparse" if use_sparse else "dense",
                seconds=time.perf_counter() - t0,
                restored_from=restored_from if s == start_step else None,
            )
            history.append(rec)
            if verbose:
                print(f"  superstep {s:4d}: active={rec.n_active:>9d} "
                      f"msgs={rec.n_msgs:>10d} agg={rec.agg:.6g} "
                      f"density={rec.density:.4f} [{rec.mode}] "
                      f"{rec.seconds * 1e3:.1f} ms")
            if on_step is not None:
                on_step(rec, (values, active))
            if checkpointer is not None:
                saved = checkpointer.maybe_save(s + 1, values, active)
                if saved and self.message_log is not None:
                    # §3.4: message logs live until a newer checkpoint is
                    # durable
                    self.message_log.gc_before(s + 1)
            if budget is None and rec.n_active == 0:
                break
        return (values, active), history

    def gather_values(self, values) -> dict[int, Any]:
        """{old_id: value} for all real vertices (the paper's HDFS dump)."""
        vals = values.cpu().numpy()
        old = self.pg.old_ids.cpu().numpy()
        mask = self.pg.vmask.cpu().numpy()
        return dict(zip(old[mask].tolist(), vals[mask].tolist()))
