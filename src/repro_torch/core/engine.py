"""The superstep engine (paper §3–§5): the in-memory modes on one device,
and the out-of-core ``streamed`` mode driven from the host.

Port of ``repro/core/engine.py``. In the in-memory modes the n shards are
emulated on one device: the shard axis is the leading dimension of every
tensor and ``core/collectives.py`` stands in for the ``lax`` collectives, so
an exchange round runs all n shards in one batch.

Modes (the JAX package's):

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
* ``streamed`` (§3, Theorem 1): the device holds only the O(|V|/n) vertex
  arrays and constant-size combine buffers; the edge groups live on local
  disk in a ``streams.EdgeStreamStore`` and arrive chunk by chunk through
  the prefetching ``streams.StreamReader``. skip() runs against the store's
  block manifest before any I/O, on the active bitmap copied to the host
  once a superstep. Each chunk is folded into its destination's
  accumulator by ``StreamKernels`` (PyTorch ops). With a combiner the
  superstep folds (optionally through the §4 full-duplex channel of
  ``streams/channel.py``); without one it spills destination-sorted raw
  message runs (``streams/msgstore.py``), merges them back and applies
  destination-aligned slices.

A ``message_log`` replaces any in-memory mode by the logged step, which
hands every shard's ``A_s`` for all destinations back to the host loop
(§3.4); in ``streamed`` mode a ``RunFileMessageLog`` persists each group's
combined run (or the raw OMS runs) as it is written.

Backends:

* ``"torch"``: plain PyTorch ops. Dense scan, or, when the frontier is thin
  (``recoded`` and ``basic_sc``), skip() gathers at most ``sparse_cap``
  active blocks per group. ``streamed`` runs on it alone.
* ``"kernel"`` (``recoded`` only): ``kernels/edge_combine`` (CUDA) and
  ``kernels/digest`` (Triton) on CUDA tensors, their plain versions on CPU
  tensors. skip() is always on in the kernel (a dense frontier keeps every
  block).

An in-memory superstep syncs with the host once, when ``run()`` reads its
stats.

With ``mesh=`` (a ``core.collectives.ProcessMesh``, one process a shard,
the counterpart of the reference's ``shard_map``) the superstep functions
of every in-memory mode, the logged one too, run on one shard's rows:
every tensor's leading axis is the local rows (``pg.n_rows``, 1 there) and
``pg.n_shards`` the destinations, and the collectives reach them as the
``comm`` argument, whose default is the emulated shim.

Float sums: the torch backend adds each destination's float32 messages in
one stated order, left to right as they stand (``_combine_scatter``), on
the CPU and on the card alike, so its runs are bit-reproducible and a mesh
run equals the emulated one; the kernel backend's ``edge_combine`` adds
with atomics in no fixed order.
"""

from __future__ import annotations

import os
import shutil
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.convert import numpy_dtype
from repro_torch.core import collectives as coll
from repro_torch.core.api import ShardContext, VertexProgram
from repro_torch.core.config import ConfigError, EngineConfig
from repro_torch.core.plan import FOLD_RING, FOLD_SLOTS, fold_stager_slots
from repro_torch.device import resolve_device
from repro_torch.graph.partition import PartitionedGraph, shard_slice
from repro_torch.kernels import ops as kops
from repro_torch.kernels.digest import digest as kernel_digest
from repro_torch.kernels.edge_combine import edge_combine
from repro_torch.kernels.run_sum import run_sum


def _shard_ctx(pg: PartitionedGraph, comm=coll) -> ShardContext:
    return ShardContext(
        shard=comm.axis_index(pg.n_rows, pg.device),
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


#: ``order`` of :func:`_combine_scatter` for rows whose active messages
#: already stand in destination runs
PRESORTED = "presorted"


def _ordered_sum(program) -> bool:
    """Whether the program's combine is a float32 sum, the one whose bits
    depend on the order it adds in."""
    comb = program.combiner
    return (comb is not None and comb.name == "sum"
            and program.msg_dtype == torch.float32)


def _combine_scatter(program, P_dest, msg, dp, aact, order=None,
                     marked=False):
    """IO-Recoded: direct in-memory scatter-combine into A_s (paper §5).

    A float32 sum adds each destination slot's messages in one stated
    order, on the CPU and on the card alike: left to right from e0, as they
    stand in the flat ``(rows, E)`` message array, which is the order of
    ``index_add_`` and ``np.add.at`` on the CPU (``kernels/run_sum`` adds
    in it on the card). ``order`` says how each row reaches destination
    order: None sorts ``dp`` here (one stable sort a row); a ``(rows, E)``
    tensor is that sort already made (the dense groups'
    ``PartitionedGraph.dst_order``, whose padding, marked ``dp`` = -1 here,
    comes last, and whose sign bit marks its runs: ``marked``);
    :data:`PRESORTED` says each row's active messages already stand in one
    run a destination, and only those are added. Slots left
    out (inactive, padding) hold e0 = 0, and adding 0 changes no sum's
    bits. MIN, MAX, integer sums and the counts are exact in any order and
    keep ``scatter_reduce_`` and ``index_add_``."""
    n = msg.shape[0]
    comb = program.combiner
    ar = torch.arange(n, device=msg.device)[:, None]
    idx = dp.long().clamp(min=0) + ar * P_dest
    if _ordered_sum(program):
        # row-local keys: run_sum adds row r's destination d at r * P_dest
        # + d, and skips a negative one
        if order is PRESORTED:
            key, order = torch.where(aact, dp, -1), None
        else:
            key = dp
            if order is None:
                order = torch.sort(dp, dim=-1, stable=True).indices
        A_s = run_sum(key.contiguous(), msg, n * P_dest, order,
                      stride=P_dest, marked=marked)
    else:
        A_s = comb.identity((n * P_dest,), program.msg_dtype, msg.device)
        comb.scatter(A_s, idx.reshape(-1), msg.reshape(-1))
    cnt = torch.zeros(n * P_dest, dtype=torch.int32, device=msg.device)
    cnt.index_add_(0, idx.reshape(-1), aact.reshape(-1).to(torch.int32))
    return A_s.view(n, P_dest), cnt.view(n, P_dest)


def _combine_sort(program, P_dest, msg, dp, aact):
    """IO-Basic with a combiner: sort each row by destination, then combine
    (the merge-sort of §3.3.1). Invalid entries sort to the tail at key P."""
    key = torch.where(aact, dp, P_dest)
    skey, order = torch.sort(key, dim=-1, stable=True)
    smsg, sact = msg.gather(1, order), aact.gather(1, order)
    # _gen_messages already set the invalid entries to e0
    return _combine_scatter(program, P_dest, smsg, torch.where(sact, skey, 0),
                            sact, PRESORTED)


def _contrib_dense(program, pg, values, active, step, dest,
                   combine=_combine_scatter):
    ar = torch.arange(pg.n_rows, device=pg.device)
    sp, dp, w = pg.src_pos[ar, dest], pg.dst_pos[ar, dest], pg.eweight[ar, dest]
    msg, aact = _gen_messages(program, values, pg.degree, sp, w, active, step)
    if combine is _combine_scatter and _ordered_sum(program):
        # the padding (src_pos -1) marked, to be left out of the sums
        return _combine_scatter(program, pg.P, msg,
                                torch.where(sp >= 0, dp, -1), aact,
                                pg.dst_order[ar, dest], marked=True)
    return combine(program, pg.P, msg, dp, aact)


def _contrib_all(program, pg, values, active, step):
    """Every local shard's A_s and counts for all n destinations:
    ``(rows, n_dest, P)`` each."""
    parts = [_contrib_dense(program, pg, values, active, step,
                            torch.full((pg.n_rows,), d, device=pg.device))
             for d in range(pg.n_shards)]
    return (torch.stack([A for A, _ in parts], 1),
            torch.stack([c for _, c in parts], 1))


def _contrib_sparse(program, pg, values, active, prefix, step, dest, cap,
                    combine=_combine_scatter):
    """skip(): gather only the first ``cap`` active edge blocks per group."""
    rows, n, B, nb = pg.n_rows, pg.n_shards, pg.edge_block, pg.n_blocks
    ar = torch.arange(rows, device=pg.device)[:, None]
    act_blk = _block_active(prefix, pg.blk_lo[ar[:, 0], dest],
                            pg.blk_hi[ar[:, 0], dest])
    idx, n_act = kops.compact_blocks(act_blk)
    idx = idx[:, :cap].long()
    live = (torch.arange(idx.shape[1], device=pg.device)[None, :]
            < n_act[:, None])[..., None]
    take = lambda a, fill: torch.where(
        live, a.view(rows, n, nb, B)[ar, dest[:, None], idx], fill
    ).reshape(rows, -1)
    sp, dp, w = take(pg.src_pos, -1), take(pg.dst_pos, 0), take(pg.eweight, 0.0)
    msg, aact = _gen_messages(program, values, pg.degree, sp, w, active, step)
    return combine(program, pg.P, msg, dp, aact)


def _contrib_kernel(program, pg, values, active, prefix, dest):
    """The hand-written edge_combine on the partition's own blocks, with the
    skip-compacted block list always on."""
    rows, n, B, nb = pg.n_rows, pg.n_shards, pg.edge_block, pg.n_blocks
    ar = torch.arange(rows, device=pg.device)
    keep = kops.skip_keep_mask(pg.blk_lo[ar, dest], pg.blk_hi[ar, dest], prefix)
    ids, n_keep = kops.compact_blocks(keep)
    blocks = lambda a: a.view(rows, n, nb, B)
    return edge_combine(
        values, pg.degree, active, blocks(pg.src_pos), blocks(pg.dst_pos),
        blocks(pg.eweight), dest.to(torch.int32), ids, n_keep,
        msg_kind=program.msg_kind, combiner=program.combiner.name,
    )


# --------------------------------------------------------------------------
# exchanges
# --------------------------------------------------------------------------

def _ring_exchange(pg, contrib, digest, comm=coll):
    """Ring reduce-scatter of per-destination combined buffers (§4.2/§5):
    n rounds; the accumulator arriving at shard i in round r is destined for
    ``(i + n-1-r) mod n``; shard i folds in its own A_s for that destination
    and forwards."""
    n = pg.n_shards
    i = comm.axis_index(pg.n_rows, pg.device)[:, 0]
    acc = contrib((i + n - 1) % n)
    for r in range(1, n):
        acc = tuple(comm.ring_shift(x) for x in acc)
        A_s, cnt = contrib((i + (n - 1 - r)) % n)
        acc = digest(acc[0], acc[1], A_s, cnt)
    return acc


def _basic_exchange(program, pg, values, active, step, comm=coll):
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
    rows, n, P = pg.n_rows, pg.n_shards, pg.P
    msg, aact = _gen_messages(program, values, pg.degree,
                              pg.src_pos.reshape(rows, -1),
                              pg.eweight.reshape(rows, -1), active, step)
    dp_send = torch.where(aact, pg.dst_pos.reshape(rows, -1), P)
    recv_dp = comm.all_to_all(dp_send.view(rows, n, -1)).view(rows, -1)
    recv_msg = comm.all_to_all(msg.view(rows, n, -1)).view(rows, -1)
    del msg, aact, dp_send
    sdp, order = torch.sort(recv_dp, dim=-1, stable=True)
    smsg = recv_msg.gather(1, order)
    del recv_dp, recv_msg
    valid = sdp < P
    if program.combiner is None:  # apply_list consumes the runs
        cnt = torch.zeros(rows * P, dtype=torch.int32, device=pg.device)
        row = torch.arange(rows, device=pg.device)[:, None] * P
        cnt.index_add_(0, (torch.where(valid, sdp, 0) + row).reshape(-1),
                       valid.reshape(-1).to(torch.int32))
        return None, cnt.view(rows, P), sdp, smsg
    # slot src*P + dst of each receiver's (n_src * P) partials
    slot = order // pg.E_cap * P + torch.where(valid, sdp, 0)
    del order
    # _gen_messages already set the invalid entries to e0
    A_part, cnt_part = _combine_scatter(program, n * P, smsg, slot, valid,
                                        PRESORTED)
    A_r = program.combiner.reduce(A_part.view(rows, n, P), 1)
    return (A_r, cnt_part.view(rows, n, P).sum(1, dtype=torch.int32), sdp,
            smsg)


def _compact_exchange(program, pg, values, active, step, comm=coll):
    """One all_to_all hop of compact combined buffers: bfloat16 message
    values and int8 has-message flags (3 B a slot against the ring's 8 B,
    one rounding per message). The receiver digests in float32; its count
    is the number of shards that sent the vertex anything."""
    A_s_all, cnt_all = _contrib_all(program, pg, values, active, step)
    recv_A = comm.all_to_all(A_s_all.to(torch.bfloat16))
    recv_h = comm.all_to_all((cnt_all > 0).to(torch.int8))
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
              sparse_cap: int | None = None, comm=coll):
    """One full superstep: scatter -> exchange -> digest -> apply -> vote.
    ``sparse_cap`` (torch backend, ``recoded``/``basic_sc``) takes skip()'s
    sparse gather. ``comm`` is ``core.collectives`` (all n shards' rows) or
    a ``ProcessMesh`` (this rank's)."""
    comb = program.combiner
    ctx = _shard_ctx(pg, comm)
    if mode == "recoded_compact":
        A_r, cnt = _compact_exchange(program, pg, values, active, step, comm)
    elif mode == "basic" and comb is None:
        # general Pregel path: destination-sorted message lists (§3.3.2)
        _, cnt, sdp, smsg = _basic_exchange(program, pg, values, active, step,
                                            comm)
        has_msg = (cnt > 0) & pg.vmask
        new_values, new_active = program.apply_list(
            values, pg.degree, sdp, smsg, has_msg, active, step, ctx)
        return _finish_superstep(program, pg, values, new_values, new_active,
                                 cnt, has_msg, comm)
    elif mode == "basic":
        A_r, cnt, _, _ = _basic_exchange(program, pg, values, active, step,
                                         comm)
    elif backend == "kernel":
        prefix = _active_prefix(active)
        contrib = lambda dest: _contrib_kernel(program, pg, values, active,
                                               prefix, dest)
        digest = lambda A, c, A2, c2: kernel_digest(A, c, A2, c2,
                                                    combiner=comb.name)
        A_r, cnt = _ring_exchange(pg, contrib, digest, comm)
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
        A_r, cnt = _ring_exchange(pg, contrib, digest, comm)
    has_msg = (cnt > 0) & pg.vmask
    new_values, new_active = program.apply(
        values, pg.degree, A_r, has_msg, active, step, ctx
    )
    return _finish_superstep(program, pg, values, new_values, new_active, cnt,
                             has_msg, comm)


def superstep_logged(program: VertexProgram, pg: PartitionedGraph, values,
                     active, step: int, comm=coll):
    """Recoded superstep that also materializes every shard's outgoing A_s
    for all destinations, so that the host loop can persist them ("keep all
    OMSs on local disk until a new checkpoint is written", §3.4). The
    exchange is an all_to_all of the combined buffers instead of the ring.
    Returns (values, active, StepStats, A_s_all, cnt_all), the last two
    ``(rows, n_dest, P)``: on a mesh, this rank's row."""
    A_s_all, cnt_all = _contrib_all(program, pg, values, active, step)
    A_r = program.combiner.reduce(comm.all_to_all(A_s_all), 1)
    cnt = comm.all_to_all(cnt_all).sum(1, dtype=torch.int32)
    has_msg = (cnt > 0) & pg.vmask
    new_values, new_active = program.apply(
        values, pg.degree, A_r, has_msg, active, step, _shard_ctx(pg, comm)
    )
    return (*_finish_superstep(program, pg, values, new_values, new_active,
                               cnt, has_msg, comm), A_s_all, cnt_all)


def _finish_superstep(program, pg, values, new_values, new_active, cnt,
                      has_msg, comm=coll):
    """Superstep tail: halt voting, aggregator, frontier stats (each
    reduced over every shard, so all ranks of a mesh read the same)."""
    new_active = new_active & pg.vmask
    n_active = comm.psum(new_active.sum(1))
    n_msgs = comm.psum(cnt.sum(1))
    agg = program.aggregate(values, new_values, has_msg)
    agg = (comm.psum(agg.to(torch.float32).sum(1)) if agg is not None
           else torch.zeros((), dtype=torch.float32, device=pg.device))
    # frontier density for the next superstep (drives dense/sparse dispatch)
    act_blk = _block_active(_active_prefix(new_active), pg.blk_lo, pg.blk_hi)
    num = comm.psum(act_blk.sum((1, 2)))
    den = comm.psum((pg.blk_hi >= 0).sum((1, 2)))
    density = num.to(torch.float32) / den.clamp(min=1).to(torch.float32)
    max_grp = comm.pmax(act_blk.sum(-1))
    return new_values, new_active, StepStats(n_active, n_msgs, agg, density,
                                             max_grp)


def init_spmd(program: VertexProgram, pg: PartitionedGraph, comm=coll):
    values, active = program.init(_shard_ctx(pg, comm))
    return values.to(program.value_dtype), active & pg.vmask




# --------------------------------------------------------------------------
# streamed-mode kernels (PyTorch ops on one shard's rows)
# --------------------------------------------------------------------------

class StreamKernels:
    """The per-shard streamed-mode steps, built from the program plus the
    partition's scalars only (n_shards, n_vertices, P): every per-shard
    tensor (values, degree, vmask, ...) is a call argument. Rows are
    ``(P,)``; the programs see them as ``(1, P)`` views, their shard axis of
    length one.

    Combiner programs get ``fold``/``fold_batch``/``apply``/``digest``;
    combiner-less programs get ``msgs``/``apply_list``/``finish``. ``init``
    is always present (one row of :func:`init_spmd`).
    """

    def __init__(self, program: VertexProgram, n_shards: int,
                 n_vertices: int, P: int):
        self.program = program
        self.n_shards = int(n_shards)
        self.n_vertices = int(n_vertices)
        self.P = int(P)
        self.combined = program.combiner is not None

    def _ctx(self, shard: int, degree, vmask, old_ids, gids) -> ShardContext:
        return ShardContext(
            shard=torch.full((1, 1), int(shard), device=degree.device),
            n_shards=self.n_shards, n_vertices=self.n_vertices, P=self.P,
            degree=degree[None], vmask=vmask[None], old_ids=old_ids[None],
            gids=gids[None],
        )

    def _summary(self, values, new_values, new_active, cnt, has_msg):
        """Active count, message count and aggregator of one row, as 0-dim
        tensors (read by the host once a superstep)."""
        agg = self.program.aggregate(values[None], new_values[None],
                                     has_msg[None])
        agg = (agg.to(torch.float32).sum() if agg is not None
               else torch.zeros((), dtype=torch.float32,
                                device=values.device))
        return new_active.sum(), cnt.sum(dtype=torch.int64), agg

    def init(self, shard: int, degree, vmask, old_ids, gids):
        """One row of :func:`init_spmd`."""
        ctx = self._ctx(shard, degree, vmask, old_ids, gids)
        values, active = self.program.init(ctx)
        return (values[0].to(self.program.value_dtype),
                (active & vmask[None])[0])

    def fold(self, A, cnt, values, degree, active, sp, dp, w, step: int):
        """Fold staged edge slots (``(slots,)`` each: one chunk, or
        several chunks of one group back to back) of a source row into the
        destination accumulator ``A``/``cnt`` in place (the in-memory A_s
        combine of §5, applied to what is staged).

        A float32 sum adds in the stated order, on the CPU and on the card
        alike: each slot's messages left to right as they stand, onto what
        ``A`` holds, so a group folded over several calls is
        ``((A[k] + v_1) + v_2) + ...`` across them, the order of
        ``A.index_add_``. One stable sort of the active messages by
        destination a call, then ``kernels/run_sum`` accumulating into
        ``A``; inactive slots hold e0 = 0 and are left out (a chain from +0
        never holds -0, so adding +0 changes no bit). Other combines keep
        their scatter, exact in any order."""
        msg, aact = _gen_messages(self.program, values[None], degree[None],
                                  sp[None], w[None], active[None], step)
        idx = dp.long()
        if _ordered_sum(self.program):
            key = torch.where(aact, dp[None], -1)
            order = torch.sort(key, dim=-1, stable=True).indices
            run_sum(key, msg, self.P, order, out=A, stride=0)
        else:
            self.program.combiner.scatter(A, idx, msg[0])
        cnt.index_add_(0, idx, aact[0].to(torch.int32))
        return A, cnt

    def fold_batch(self, values, degree, active, src, sp, dp, w, step: int):
        """G small groups (one staged chunk each) folded at once, each lane
        into a fresh identity accumulator: one flattened scatter over G*P
        slots (lane g's destinations offset by g*P), so the lanes never mix
        and each lane's result is its unbatched fold's. ``values``/
        ``degree``/``active`` are the full ``(n, P)`` stacks, ``src`` the
        ``(G,)`` source shard of each lane, ``sp``/``dp``/``w`` ``(G,
        slots)``; padding lanes carry ``sp = -1`` and fold to the
        identity. Returns ``(G, P)`` accumulators and counts."""
        P = self.P
        off = src.long()[:, None] * P  # each lane reads its source row
        sp_flat = torch.where(sp >= 0, sp.long() + off, -1).reshape(1, -1)
        msg, aact = _gen_messages(
            self.program, values.reshape(1, -1), degree.reshape(1, -1),
            sp_flat, w.reshape(1, -1), active.reshape(1, -1), step)
        G = sp.shape[0]
        return _combine_scatter(self.program, P, msg.view(G, -1), dp,
                                aact.view(G, -1))

    def digest(self, A, cnt, A2, cnt2):
        """Receiver digest of one densified inbox group: the same
        per-position sequence as the unpipelined grouped fold."""
        return self.program.combiner.combine(A, A2), cnt + cnt2

    def apply(self, values, degree, vmask, old_ids, gids, A_r, cnt, active,
              step: int, shard: int):
        """Apply and vote for one row; returns (values, active, n_active,
        n_msgs, agg), the last three 0-dim tensors."""
        program = self.program
        ctx = self._ctx(shard, degree, vmask, old_ids, gids)
        has_msg = (cnt > 0) & vmask
        nv, na = program.apply(values[None], degree[None], A_r[None],
                               has_msg[None], active[None], step, ctx)
        nv, na = nv[0].to(program.value_dtype), na[0] & vmask
        return (nv, na, *self._summary(values, nv, na, cnt, has_msg))

    def msgs(self, values, degree, active, sp, dp, w, step: int):
        """Raw messages of one staged edge chunk (the combiner-less scatter
        half): ``(payload, dst_pos, valid)`` for the host to sort by
        destination and spill into an OMS run. ``dst_pos`` is ``dp``
        itself."""
        msg, aact = _gen_messages(self.program, values[None], degree[None],
                                  sp[None], w[None], active[None], step)
        return msg[0], dp, aact[0]

    def apply_list(self, values, degree, vmask, old_ids, gids, sdp, smsg,
                   cnt, active, step: int, shard: int):
        """Apply over ONE destination-aligned slice of the merged message
        stream. ``cnt`` is the full per-position message count, so
        ``has_msg`` matches mode="basic"; the caller keeps only the
        destinations whose runs lie in this slice."""
        ctx = self._ctx(shard, degree, vmask, old_ids, gids)
        has_msg = (cnt > 0) & vmask
        nv, na = self.program.apply_list(
            values[None], degree[None], sdp[None], smsg[None], has_msg[None],
            active[None], step, ctx)
        return nv[0].to(self.program.value_dtype), na[0] & vmask

    def finish(self, values, new_values, new_active, cnt, vmask):
        """Superstep tail of one row on the combiner-less path."""
        return self._summary(values, new_values, new_active, cnt,
                             (cnt > 0) & vmask)


class _ChunkStager:
    """Gathers staged edge chunks into one buffer and hands them to the
    device before the reader recycles the chunks' numpy buffers (a chunk is
    valid only until the reader advances).

    :meth:`add` copies a chunk's ``(sp, dp, w)`` into the current buffer, so
    the reader's buffer is free as soon as it returns; :meth:`take` hands
    what was added to the device as ``(sp, dp, w)`` tensors and moves on to
    the next of ``ring`` buffers. Folding many chunks in one call pays the
    per-call host cost (a pinned copy, a copy to the card, ~15 launches)
    once: at the default 8-block chunks of 512 edges, 32 chunks a call. A
    fold of the concatenated chunks is the fold of each in turn.

    On CUDA the buffers are pinned and go to the card by non-blocking
    copies; an event recorded after them guards the buffer, which is
    refilled only once the event has completed, so the host does not wait
    for the card chunk by chunk. On the CPU :meth:`take` returns views of
    the buffer, which the caller consumes before the ring comes round.

    The ring is ``core.plan.fold_stager_bytes``: 4.5 MiB of host memory at
    the default StreamConfig, 18 MiB at 256-block chunks. ``memory_model()``
    (the JAX package's algebra) does not count it, and ``plan()`` sizes no
    budget for it; ``ExecutionPlan.explain()`` names it beside the model."""

    def __init__(self, device: torch.device, slots: int = FOLD_SLOTS,
                 ring: int = FOLD_RING):
        self.device = device
        self.cuda = device.type == "cuda"
        self.slots = int(slots)
        self._bufs: list = [None] * ring
        self._done: list = [None] * ring
        self._j = 0
        self.pending = 0  # slots added since the last take()

    @property
    def nbytes(self) -> int:
        """Host bytes the ring holds now (all of it once it came round)."""
        return sum(b.numel() * b.element_size()
                   for entry in self._bufs if entry is not None
                   for b in entry[0])

    def room(self, n: int) -> bool:
        return self.pending + n <= self.slots

    def add(self, sp: np.ndarray, dp: np.ndarray, w: np.ndarray) -> None:
        """Copy one chunk (int32, int32, float32 arrays of one shape) in."""
        j, n, a = self._j, sp.size, self.pending
        if not self.room(n):
            raise ValueError(f"chunk of {n} slots overflows the "
                             f"{self.slots}-slot stager ({a} pending)")
        if a == 0 and self._done[j] is not None:
            self._done[j].synchronize()  # the card has read this buffer
            self._done[j] = None
        if self._bufs[j] is None:
            bufs = [torch.empty(self.slots, dtype=torch.int32,
                                pin_memory=self.cuda) for _ in range(3)]
            self._bufs[j] = (bufs, [b.numpy() for b in bufs])
        host = self._bufs[j][1]
        host[0][a:a + n] = sp.ravel()
        host[1][a:a + n] = dp.ravel()
        host[2][a:a + n] = w.ravel().view(np.int32)
        self.pending += n

    def take(self):
        """What was added since the last take, as ``(sp, dp, w)`` tensors
        on the device (flat)."""
        j, n = self._j, self.pending
        sp, dp, w = (buf[:n] for buf in self._bufs[j][0])
        if self.cuda:
            sp, dp, w = (x.to(self.device, non_blocking=True)
                         for x in (sp, dp, w))
            done = torch.cuda.Event()
            done.record()
            self._done[j] = done
        self._j = (j + 1) % len(self._bufs)
        self.pending = 0
        return sp, dp, w.view(torch.float32)

    def put(self, sp: np.ndarray, dp: np.ndarray, w: np.ndarray):
        """One chunk to the device on its own: ``add`` then ``take``."""
        self.add(sp, dp, w)
        return self.take()


def fold_groups(kern: StreamKernels, stager: _ChunkStager, reader,
                group_batch: int, edge_block: int, values, degree, active,
                step: int, schedule, sink, first_shard: int = 0) -> None:
    """Fold staged edge chunks into per-(src, dst) group accumulators (§5's
    A_s, one group at a time) and hand each COMPLETED group to ``sink(src,
    dst, A_g, cnt_g)`` in schedule order. Shared by the streamed engine's
    supersteps and by a worker process of the multi-process launch, so both
    fold every group in the same order of the same slots.

    ``values``/``degree``/``active`` are stacks of source rows, shard
    ``first_shard`` first (the engine's stacks hold every shard; a
    worker's, its own shard's row alone). Small groups (a
    single staged chunk) are folded ``group_batch`` at a time through one
    batched call: per lane the same ops on a fresh identity accumulator,
    so sinks see each group's unbatched result."""
    program, comb, P = kern.program, kern.program.combiner, kern.P
    dev = values.device
    row = lambda i: i - first_shard
    G = max(1, group_batch)
    CB = reader.chunk_blocks
    # chunks per (src, dst) group, known from the schedule up front
    n_chunks = {(i, k): -(-len(ids) // CB) for i, k, ids in schedule}
    slots = CB * edge_block
    pad = (np.full((slots,), -1, np.int32), np.zeros((slots,), np.int32),
           np.zeros((slots,), np.float32))
    pending: list = []  # copied single-chunk groups awaiting one call
    state = {"cur": None, "A": None, "cnt": None}

    def fold_staged():
        if stager.pending:
            r = row(state["cur"][0])
            kern.fold(state["A"], state["cnt"], values[r], degree[r],
                      active[r], *stager.take(), step)

    def close_cur():
        if state["cur"] is not None:
            fold_staged()
            sink(state["cur"][0], state["cur"][1], state["A"], state["cnt"])
            state["cur"] = None

    def flush_batch():
        if not pending:
            return
        if len(pending) == 1:
            i, k, sp, dp, w = pending[0]
            r = row(i)
            A_g, cnt_g = kern.fold(
                comb.identity((P,), program.msg_dtype, dev),
                torch.zeros(P, dtype=torch.int32, device=dev),
                values[r], degree[r], active[r], *stager.put(sp, dp, w), step,
            )
            sink(i, k, A_g, cnt_g)
        else:
            lanes = pending + [(pending[0][0], -1) + pad] * (G - len(pending))
            src = torch.tensor([row(p[0]) for p in lanes], device=dev)
            for p in lanes:
                stager.add(*p[2:])
            sp, dp, w = (x.view(G, slots) for x in stager.take())
            A_b, cnt_b = kern.fold_batch(values, degree, active, src, sp, dp,
                                         w, step)
            for g, (i, k, *_rest) in enumerate(pending):
                sink(i, k, A_b[g], cnt_b[g])
        pending.clear()

    for chunk in reader.stream(schedule):
        i, k = chunk.src_shard, chunk.dst_shard
        if state["cur"] is not None and state["cur"] != (i, k):
            close_cur()  # the previous multi-chunk group just completed
        if G > 1 and n_chunks[(i, k)] == 1:
            # copy out of the reader's recycled staging buffers; the batch
            # holds at most G chunks (modeled in the staging tier)
            pending.append((i, k, np.array(chunk.sp), np.array(chunk.dp),
                            np.array(chunk.w)))
            if len(pending) == G:
                flush_batch()
            continue
        if state["cur"] != (i, k):
            flush_batch()  # batched groups precede this one in order
            state["cur"] = (i, k)
            state["A"] = comb.identity((P,), program.msg_dtype, dev)
            state["cnt"] = torch.zeros(P, dtype=torch.int32, device=dev)
        if not stager.room(chunk.sp.size):
            fold_staged()
        stager.add(chunk.sp, chunk.dp, chunk.w)
    close_cur()
    flush_batch()


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A numpy array of ``t`` that shares no memory with it (a CPU tensor's
    ``numpy()`` does, and may alias a reader staging buffer)."""
    return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()


# --------------------------------------------------------------------------
# host driver
# --------------------------------------------------------------------------

def _mesh_slice(pg: PartitionedGraph, mesh) -> PartitionedGraph:
    """The mesh rank's rows of ``pg`` (or ``pg``, already that slice)."""
    if mesh.world_size != pg.n_shards:
        raise ValueError(f"a mesh of {mesh.world_size} ranks runs one shard "
                         f"a rank, and the partition has {pg.n_shards}")
    if pg.n_rows == pg.n_shards:
        pg = shard_slice(pg, mesh.rank)
    elif pg.n_rows != 1:
        raise ValueError(f"a rank takes the whole partition or its one-row "
                         f"slice, not {pg.n_rows} rows")
    return pg if pg.device == mesh.device else pg.to(mesh.device)


def _same_mesh(what: str, obj, mesh) -> None:
    """A message log or checkpointer writes one file a shard it holds: on a
    mesh it must know the rank (``mesh=`` the engine's), and off one it must
    not."""
    if getattr(obj, "mesh", None) is not mesh:
        raise ValueError(
            f"the {what} was made with mesh={getattr(obj, 'mesh', None)!r} "
            f"and the engine runs with mesh={mesh!r}: on a mesh, make it "
            f"with mesh= the engine's (a MessageLog or Checkpointer; each "
            f"rank writes its own shard's file)")


@dataclass
class SuperstepRecord:
    step: int
    n_active: int
    n_msgs: int
    agg: float
    density: float
    mode: str  # "dense" | "sparse" dispatch chosen, or "streamed"
    seconds: float
    # step a checkpoint auto-restore resumed from (first record only)
    restored_from: int | None = None
    # residency (streamed mode; 0 elsewhere): edge blocks read off disk this
    # superstep, blocks served from the hot cache, cache evictions, and
    # blocks the §3.2 skip() test kept off the schedule
    blocks_read: int = 0
    cache_hits: int = 0
    cache_evictions: int = 0
    blocks_skipped: int = 0


class GraphDEngine:
    """Host driver: runs the superstep loop with dense/sparse dispatch, or,
    with ``mode="streamed"``, the out-of-core loop over ``stream_store``.

    ``device=None`` runs on CUDA (and raises without it); the partition is
    moved to the engine's device if it lies elsewhere. ``message_log`` (a
    ``core.checkpoint.MessageLog``, or in ``streamed`` mode a
    ``RunFileMessageLog``) logs every superstep's outgoing buffers, for
    single-shard fast recovery (§3.4).

    ``mesh`` (a ``core.collectives.ProcessMesh``, the counterpart of the
    reference's ``shard_map`` mesh) runs this process's shard alone, on the
    mesh's device: ``pg`` is the whole partition, whose rows for the
    mesh's rank the engine takes, or that rank's slice
    (``graph.partition.shard_slice``). ``run()`` then returns this shard's
    rows, and every rank reads the same superstep stats. A message log and
    a checkpointer on a mesh are made with ``mesh=`` the engine's, and each
    rank writes its own shard's files (``core/checkpoint.py``).
    ``launch.mesh`` starts one such process a shard."""

    def __init__(self, pg: PartitionedGraph, program: VertexProgram,
                 config: EngineConfig | None = None, *, device=None,
                 message_log=None, stream_store=None, mesh=None):
        if config is not None and not isinstance(config, EngineConfig):
            raise ConfigError(
                "config must be an EngineConfig, got "
                f"{type(config).__name__}"
            )
        cfg = (config or EngineConfig()).finalize()
        mode = cfg.mode
        if mode != "streamed" and pg.E_cap > 0 and pg.src_pos.shape[-1] == 0:
            raise ValueError(
                "this partition is vertex-only (its edge groups were spilled "
                "to disk by drop_edges/partition_graph_streamed); it can only "
                "run with mode='streamed' and the matching stream_store"
            )
        if mode in ("recoded", "recoded_compact", "basic_sc") and (
                program.combiner is None):
            raise ValueError(f"mode={mode} requires a message combiner "
                             "(paper §5)")
        if mode == "recoded_compact" and program.msg_dtype not in (
                torch.float32, torch.bfloat16):
            # the bf16 wire rounds integers above 256: min-label programs
            # would merge distinct labels
            raise ValueError("recoded_compact needs float messages")
        if (cfg.channel.payload_scheme == "bf16"
                and program.msg_dtype != torch.float32):
            # the same guard as recoded_compact, applied to the wire codec
            raise ValueError(
                "compress_payload='bf16' rounds float32 messages on the "
                "wire; integer/min-label programs need the lossless scheme"
            )
        if cfg.channel.payload_scheme == "bf16" and message_log is not None:
            # logged OMSs are recovery state: a rounded log would make the
            # recovered state diverge from the live run
            raise ValueError(
                "compress_payload='bf16' is a lossy wire codec and cannot "
                "back a message log (recovery must replay bit-identically);"
                " use the lossless scheme with message logging"
            )
        if cfg.channel.payload_scheme == "auto" and message_log is not None:
            # a run-file log fixes its wire format once at configure(); the
            # auto-pick resolves it only after the first superstep's sample
            raise ValueError(
                "compress_payload='auto' resolves the codec from a "
                "first-superstep sample; a message log needs a fixed wire "
                "format — pass 'lossless' (or False) explicitly"
            )
        if cfg.backend == "kernel" and program.msg_kind is None:
            raise ValueError("backend='kernel' needs a program.msg_kind")
        if (mode != "streamed" and message_log is not None
                and program.combiner is None):
            raise ValueError("a message log holds combined buffers: it needs "
                             "a program with a combiner")
        if mode == "streamed":
            if stream_store is None:
                raise ValueError(
                    "mode='streamed' needs stream_store= (an "
                    "streams.EdgeStreamStore; see graph.partition_graph_streamed)"
                )
            if mesh is not None:
                raise ValueError(
                    "mode='streamed' is host-driven: backend='torch', "
                    "mesh=None"
                )
            if message_log is not None and not hasattr(message_log,
                                                       "save_group"):
                raise ValueError(
                    "mode='streamed' logs messages incrementally to run files;"
                    " pass a core.checkpoint.RunFileMessageLog"
                )
            geom = stream_store.geom
            if (geom.n_shards, geom.P, geom.edge_block) != (
                    pg.n_shards, pg.P, pg.edge_block):
                raise ValueError(
                    "stream store geometry does not match the partition: "
                    f"store (n={geom.n_shards}, P={geom.P}, B={geom.edge_block})"
                    f" vs pg (n={pg.n_shards}, P={pg.P}, B={pg.edge_block})"
                )
        if message_log is not None and mode != "streamed":
            _same_mesh("message log", message_log, mesh)
        if mesh is not None:
            pg = _mesh_slice(pg, mesh)
            device = mesh.device
        if message_log is not None and hasattr(message_log, "configure"):
            # run-file logs densify sparse runs back with the combiner
            # identity; they learn it (and the geometry) from the program
            message_log.configure(
                n_shards=pg.n_shards, P=pg.P,
                msg_dtype=numpy_dtype(program.msg_dtype),
                e0=program.combiner.e0 if program.combiner is not None else 0,
                combined=program.combiner is not None,
                compress=cfg.channel.compress,
                compress_payload=cfg.channel.payload_scheme,
            )
        self.device = resolve_device(device)
        self.pg = pg if pg.device == self.device else pg.to(self.device)
        self.program = program
        self.config = cfg
        self.mode = mode
        self.backend = cfg.backend
        self.message_log = message_log
        self.stream_store = stream_store
        self.adapt_threshold = cfg.adapt_threshold
        self.sparse_cap = max(1, int(pg.n_blocks * cfg.sparse_cap_frac))
        self.pipeline = bool(cfg.channel.pipeline)
        self.compress = bool(cfg.channel.compress)
        scheme = cfg.channel.payload_scheme  # None | scheme | "auto"
        # "auto": spill the first superstep raw while a PayloadAutoPicker
        # trial-encodes a sample of its runs; the end-of-superstep decision
        # fixes the codec for every later per-step store
        self._payload_auto = scheme == "auto"
        self._payload_picker = None
        self._payload_channels: tuple | None = None
        self.compress_payload = None if self._payload_auto else scheme
        self.full_duplex = bool(cfg.channel.full_duplex)
        self.mesh = mesh
        self.comm = coll if mesh is None else mesh
        if mode == "streamed":
            self._init_streamed(cfg)

    def _init_streamed(self, cfg: EngineConfig) -> None:
        from repro_torch.streams.channel import ChannelStats
        from repro_torch.streams.reader import StreamReader
        from repro_torch.streams.residency import BlockResidency

        pg, store = self.pg, self.stream_store
        # every streamed path reads through the residency tier:
        # cache_bytes=0 is pure streaming (counted pass-through). ONE
        # residency serves all n emulated shards, so its capacity is the
        # per-shard budget times n
        self._residency = BlockResidency(store,
                                         int(cfg.stream.cache_bytes) * pg.n_shards)
        self._stream_reader = StreamReader(
            store, chunk_blocks=cfg.stream.chunk_blocks,
            depth=cfg.stream.depth, owner_views=self.pipeline,
            residency=self._residency,
        )
        self._stager = _ChunkStager(self.device, fold_stager_slots(
            cfg.stream.chunk_blocks, cfg.stream.group_batch, pg.edge_block))
        self.channel_inflight = int(cfg.channel.inflight)
        self._channel_fault = cfg.channel.fault
        self._recv_fault = cfg.channel.recv_fault
        self.group_batch = int(cfg.stream.group_batch)
        # cumulative over the current run() (both pipeline directions)
        self.channel_stats = ChannelStats()
        # the reader's accounting, one StreamStats a superstep of the
        # current run() (summed over the superstep's passes)
        self.io_history: list = []
        # zombie channel threads recorded by crash-path aborts; surfaced
        # at the next run() instead of masking the original exception
        self.thread_leaks: list[Exception] = []
        self._inbox_dir = os.path.join(store.dir, "inbox")
        self.msg_spill_dir = cfg.spill.spill_dir or os.path.join(store.dir,
                                                                 "oms")
        self.msg_slice_cap = int(cfg.spill.slice_cap)
        # effective slice capacity, doubled whenever a vertex's in-degree
        # exceeds it: apply_list needs a vertex's whole list in one slice
        self._msg_slice_cap_eff = int(cfg.spill.slice_cap)
        self.msg_read_chunk = int(cfg.spill.read_chunk)
        self.msg_merge_fanin = int(cfg.spill.merge_fanin)
        kern = StreamKernels(self.program, pg.n_shards, pg.n_vertices, pg.P)
        self._kernels = kern
        if kern.combined:
            self._stream_fold = kern.fold
            self._stream_fold_batch = kern.fold_batch
            self._stream_apply = kern.apply
            self._stream_digest = kern.digest
        else:
            self._stream_msgs = kern.msgs
            self._stream_apply_list = kern.apply_list
            self._stream_finish = kern.finish

    # -- in-memory modes -------------------------------------------------------
    def init(self):
        return init_spmd(self.program, self.pg, self.comm)

    def step(self, values, active, step: int, sparse: bool = False):
        """One superstep; returns (values, active, StepStats)."""
        return superstep(self.program, self.pg, values, active, step,
                         mode=self.mode, backend=self.backend,
                         sparse_cap=self.sparse_cap if sparse else None,
                         comm=self.comm)

    def step_logged(self, values, active, step: int):
        """The logged superstep; returns (values, active, StepStats,
        A_s_all, cnt_all)."""
        return superstep_logged(self.program, self.pg, values, active, step,
                                self.comm)

    def run(self, max_supersteps: int = 10_000, state=None,
            start_step: int = 0, verbose: bool = False, checkpointer=None,
            on_step=None):
        """Superstep loop; returns ((values, active), [SuperstepRecord]).

        With a ``checkpointer`` and no ``state``, the run resumes from the
        latest checkpoint; an explicit ``(state, start_step)`` wins over
        it. A checkpoint lands after superstep s when ``s + 1`` is on its
        cadence, and then the message log drops every older step.
        ``on_step(record, (values, active))`` runs after each superstep."""
        if self.mode == "streamed":
            return self._run_streamed(max_supersteps, state, start_step,
                                      verbose, checkpointer, on_step)
        if checkpointer is not None:
            _same_mesh("checkpointer", checkpointer, self.mesh)
        restored_from = None
        if (state is None and checkpointer is not None
                and checkpointer.latest() is not None):
            values, active, start_step = checkpointer.restore(
                device=self.device)
            restored_from = start_step
        else:
            values, active = state if state is not None else self.init()
        history: list[SuperstepRecord] = []
        target = self._target(max_supersteps)
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
            if self.program.num_supersteps is None and rec.n_active == 0:
                break
        return (values, active), history

    def _target(self, max_supersteps: int) -> int:
        budget = self.program.num_supersteps
        return max_supersteps if budget is None else min(budget,
                                                         max_supersteps)

    # -- streamed mode (out-of-core, paper §3 / Theorem 1) ---------------------
    def _fold_groups(self, values, active, step: int, schedule, sink):
        """:func:`fold_groups` over this engine's stacks, reader and
        stager; the reader's pass is added to the superstep's StreamStats."""
        fold_groups(self._kernels, self._stager, self._stream_reader,
                    self.group_batch, self.pg.edge_block, values,
                    self.pg.degree, active, step, schedule, sink)
        self._note_io()

    def _note_io(self) -> None:
        """Add the reader's last pass to this superstep's StreamStats."""
        st, tot = self._stream_reader.stats, self.io_history[-1]
        tot.chunks += st.chunks
        tot.blocks_read += st.blocks_read
        tot.edges_staged += st.edges_staged
        tot.bytes_read += st.bytes_read
        tot.read_seconds += st.read_seconds
        tot.wait_seconds += st.wait_seconds

    @staticmethod
    def _sum_stats(stats):
        """(n_active, n_msgs, agg) over per-row 0-dim tensors; the
        aggregator adds up row by row in float64, as the JAX package's host
        loop does."""
        rows = torch.stack([torch.stack([a.double(), m.double(), g.double()])
                            for a, m, g in stats]).tolist()
        agg = 0.0
        for _, _, g in rows:
            agg += g
        return (sum(int(a) for a, _, _ in rows),
                sum(int(m) for _, m, _ in rows), agg)

    def _superstep_streamed_comb(self, values, active, s: int, plan):
        """One streamed superstep with a combiner: fold staged edge chunks
        group by group (§5's A_s, applied to chunk-sized staged slices) and
        digest each finished group into its destination's accumulator, in
        schedule order (ascending source for each destination). With a
        message log each combined OMS A_s(i->k) also persists to the run
        files as its group completes (§3.4).

        The JAX package folds straight into the destination accumulators
        when no log is attached; the port always folds a group into its own
        accumulator first (the one the memory model's ``buffers`` tier adds
        for the logged fold), so a float sum adds up per-source partials as
        the ring does, and not one chain of every message a destination
        gets (on an H100 at RMAT scale 24, PageRank landed 6.2e-6 of its
        largest value from ``recoded`` with the one chain, and 1.5e-6 with
        per-group partials)."""
        program, pg, comb = self.program, self.pg, self.program.combiner
        n, dev = pg.n_shards, self.device
        log = self.message_log
        A_r = [comb.identity((pg.P,), program.msg_dtype, dev)
               for _ in range(n)]
        cnt = [torch.zeros(pg.P, dtype=torch.int32, device=dev)
               for _ in range(n)]
        schedule = [entry for per_dest in plan for entry in per_dest]
        if log is not None:
            # create the step's run store up front: even an all-skipped
            # superstep must publish an (empty) index for recovery
            log.open_step(s)

        def _digest(gi, gk, A_g, cnt_g):
            A_r[gk] = comb.combine(A_r[gk], A_g)
            cnt[gk] = cnt[gk] + cnt_g
            if log is not None:
                log.save_group(s, gi, gk, A_g.cpu().numpy(),
                               cnt_g.cpu().numpy())

        # U_c || U_s: the reader thread stages chunk t+1 while chunk t folds
        self._fold_groups(values, active, s, schedule, _digest)
        if log is not None:
            log.close_step(s)  # release write handles; runs stay readable
        new_v, new_a, stats = [], [], []
        for k in range(n):
            nv, na, *st = self._stream_apply(
                values[k], pg.degree[k], pg.vmask[k], pg.old_ids[k],
                pg.gids[k], A_r[k], cnt[k], active[k], s, k)
            new_v.append(nv)
            new_a.append(na)
            stats.append(st)
        io = self.io_history[-1]
        io_note = f"{io.blocks_read}blk/{io.bytes_read >> 10}KiB"
        return (torch.stack(new_v), torch.stack(new_a),
                *self._sum_stats(stats), io_note)

    def _open_inbox(self, s: int, with_counts: bool):
        """The superstep's inbox store: the message log's per-step run store
        when a log is attached (transmitted groups ARE the persisted OMSs of
        §3.4), else a scratch store under the stream store, deleted once
        applied."""
        from repro_torch.streams.msgstore import MessageRunStore

        if self.message_log is not None:
            return self.message_log.open_step(s)
        store = MessageRunStore(
            os.path.join(self._inbox_dir, f"step-{s:06d}"),
            self.pg.n_shards, self.pg.P, numpy_dtype(self.program.msg_dtype),
            with_counts=with_counts, compress=self.compress,
            compress_payload=self.compress_payload or False,
            payload_channels=self._payload_channels,
        )
        self._attach_payload_sampler(store)
        return store

    def _attach_payload_sampler(self, store) -> None:
        """Under ``compress_payload="auto"`` (and until the decision), let
        the picker see every value column this step's store spills."""
        if self._payload_auto:
            if self._payload_picker is None:
                from repro_torch.streams.codec import PayloadAutoPicker

                self._payload_picker = PayloadAutoPicker()
            store.payload_sampler = self._payload_picker

    def _decide_payload_codec(self) -> None:
        """End-of-superstep half of the auto-pick: fix the per-channel wire
        format for every later per-step store and record the verdict in the
        run's channel stats."""
        picker = self._payload_picker
        if not self._payload_auto or picker is None or not picker.sampled:
            return
        picked = picker.choose()
        self.compress_payload = "lossless" if picked else None
        self._payload_channels = picked or None
        self.channel_stats.payload_choice = picker.summary()
        self._payload_auto = False  # decided: stop sampling
        self._payload_picker = None

    def _close_inbox(self, s: int, inbox, ok: bool) -> None:
        """Publish or delete the inbox at superstep end. On failure the step
        store is left WITHOUT an index: a rerun's ``open_step`` truncates it
        and the startup sweep removes scratch leftovers."""
        if self.message_log is not None:
            if ok:
                self.message_log.close_step(s)
        elif ok:
            inbox.delete()

    def _abort_channels(self, channel, receiver) -> None:
        """Crash-path teardown of both pipeline directions. A zombie thread
        found by abort() is recorded, not raised: the superstep's own
        exception is already propagating; the next run() raises it."""
        from repro_torch.streams.channel import ChannelError

        for part in (channel, receiver):
            if part is None:
                continue
            try:
                part.abort()
            except ChannelError as e:
                self.thread_leaks.append(e)

    def _accum_channel(self, channel) -> None:
        st, tot = channel.stats, self.channel_stats
        tot.packets += st.packets
        tot.messages += st.messages
        tot.payload_bytes += st.payload_bytes
        tot.wire_bytes += st.wire_bytes
        tot.send_seconds += st.send_seconds
        tot.stall_seconds += st.stall_seconds
        tot.recv_runs += st.recv_runs
        tot.recv_seconds += st.recv_seconds
        tot.recv_stall_seconds += st.recv_stall_seconds

    def _superstep_streamed_comb_pipelined(self, values, active, s: int,
                                           plan):
        """One pipelined streamed superstep with a combiner, the §4 compute
        || communicate overlap, full duplex: while the fold digests the
        edge chunks of the NEXT group, the background sender serializes
        each finished group A_s(i->k) into destination k's inbox run files,
        and the background receiver densifies and digests every landed run
        in transmit order. ``receiver.collect(k)`` after the flush barrier
        is the receiver side's only sync point. With ``full_duplex=False``
        the digest runs inline after the barrier. Either way the digest
        order is the transmit order, as in the unpipelined grouped fold.

        Device work: the receiver thread issues its digests on the same
        (default) CUDA stream as the compute thread, so the two threads'
        device ops are ordered by the order they are issued in: everything
        the receiver issued for destination k precedes ``collect(k)``'s
        return, and the compute thread uses the accumulator only after
        that. Groups cross to the sender as host copies."""
        from repro_torch.streams.channel import ChannelReceiver, ShardChannels

        program, pg, comb = self.program, self.pg, self.program.combiner
        n, dev = pg.n_shards, self.device
        inbox = self._open_inbox(s, with_counts=True)
        identity = lambda: (comb.identity((pg.P,), program.msg_dtype, dev),
                            torch.zeros(pg.P, dtype=torch.int32, device=dev))
        # a densified run is a fresh host array: on the CPU the digest
        # reads it before returning, on CUDA the copy is synchronous
        densified = lambda A_d, c_d: (torch.from_numpy(A_d).to(dev),
                                      torch.from_numpy(c_d).to(dev))
        receiver = None
        if self.full_duplex:
            receiver = ChannelReceiver(
                inbox, lambda A, c, A_d, c_d: self._stream_digest(
                    A, c, *densified(A_d, c_d)),
                identity, comb.e0, fault=self._recv_fault)
        channel = ShardChannels(inbox, inflight=self.channel_inflight,
                                fault=self._channel_fault, receiver=receiver)
        new_v, new_a, stats = [], [], []
        ok = False
        try:
            for k in range(n):

                def _transmit(gi, gk, A_g, cnt_g):
                    # the sender sparsifies on its own thread (the shared
                    # append_combined wire format, streams/msgstore.py)
                    # a finished group is never written again: no copy
                    channel.send_combined(gk, A_g.cpu().numpy(),
                                          cnt_g.cpu().numpy(), tag=gi)

                self._fold_groups(values, active, s, plan[k], _transmit)
                # barrier: every group for dest k has landed in its inbox
                # (and, full duplex, been announced to the receiver)
                channel.flush()
                if receiver is not None:
                    A_r, cnt = receiver.collect(k)
                else:
                    # half-duplex: digest inline, in transmit order
                    A_r, cnt = identity()
                    for seg in inbox.runs(k):
                        A_r, cnt = self._stream_digest(
                            A_r, cnt, *densified(
                                *inbox.read_combined(k, seg, comb.e0)))
                nv, na, *st = self._stream_apply(
                    values[k], pg.degree[k], pg.vmask[k], pg.old_ids[k],
                    pg.gids[k], A_r, cnt, active[k], s, k)
                new_v.append(nv)
                new_a.append(na)
                stats.append(st)
            channel.close()  # surface a late sender error before publishing
            if receiver is not None:
                receiver.close()
            ok = True
        finally:
            if not ok:
                self._abort_channels(channel, receiver)
            self._accum_channel(channel)
            self._close_inbox(s, inbox, ok)
        st, io = channel.stats, self.io_history[-1]
        io_note = (f"{io.blocks_read}blk/{io.bytes_read >> 10}KiB "
                   f"tx={st.packets}pk/{st.wire_bytes >> 10}KiB "
                   f"ov={st.sender_overlap_seconds() * 1e3:.1f}"
                   f"/{st.receiver_overlap_seconds() * 1e3:.1f}ms")
        return (torch.stack(new_v), torch.stack(new_a),
                *self._sum_stats(stats), io_note)

    def _apply_list_merged(self, mstore, dest: int, values_k, active_k,
                           step: int, channel=None):
        """Merge destination ``dest``'s spilled runs and fold destination-
        aligned apply_list slices into that shard's new (values, active)
        rows; returns them with the full per-position message count. Shared
        by the superstep loop and single-shard recovery.

        With a live ``channel`` (the full-duplex pipelined path) the merge
        runs on an accounted receiver thread (``streams.channel
        .receive_iter``); either producer yields the same slices in the
        same order."""
        from repro_torch.streams.channel import receive_iter
        from repro_torch.streams.reader import prefetch_iter

        program, pg, dev = self.program, self.pg, self.device
        counts = mstore.dest_counts(dest)
        max_run = int(counts.max()) if counts.size else 0
        while self._msg_slice_cap_eff < max_run:
            self._msg_slice_cap_eff *= 2
        cap = self._msg_slice_cap_eff
        cnt_k = torch.from_numpy(
            np.minimum(counts, np.iinfo(np.int32).max).astype(np.int32)
        ).to(dev)
        row = (pg.degree[dest], pg.vmask[dest], pg.old_ids[dest],
               pg.gids[dest])
        acc_v = acc_a = None
        slices = mstore.merged_slices(dest, cap, self.msg_read_chunk)
        if channel is not None and self.full_duplex:
            it = receive_iter(slices, stats=channel.stats,
                              fault=self._recv_fault,
                              depth=self._stream_reader.depth)
        else:
            it = prefetch_iter(slices, depth=self._stream_reader.depth)
        # slices are prefetched so merge-read I/O hides behind apply compute
        # (each slice is a fresh array)
        for sdp, smsg, covered in it:
            nv, na = self._stream_apply_list(
                values_k, *row, torch.from_numpy(sdp).to(dev),
                torch.from_numpy(smsg).to(dev), cnt_k, active_k, step, dest,
            )
            if acc_v is None:
                # any one call is already exact for every vertex without
                # messages; per-slice overwrites fix the covered rest
                acc_v, acc_a = nv, na
            else:
                cov = torch.from_numpy(covered).to(dev)
                acc_v = torch.where(cov, nv, acc_v)
                acc_a = torch.where(cov, na, acc_a)
        if acc_v is None:  # no messages at all: one padding-only call
            acc_v, acc_a = self._stream_apply_list(
                values_k, *row,
                torch.full((cap,), pg.P, dtype=torch.int32, device=dev),
                torch.zeros(cap, dtype=program.msg_dtype, device=dev),
                cnt_k, active_k, step, dest,
            )
        return acc_v, acc_a, cnt_k

    def _superstep_streamed_nocomb(self, values, active, s: int, plan):
        """One combiner-less streamed superstep (§3.3): stream edges in,
        spill destination-sorted raw-message runs to local disk, external-
        merge them back, and apply destination-aligned slices; O(|E|)
        messages flow through, never resident.

        ``plan`` is destination-grouped: destination k's spill, merge, apply
        and run cleanup all finish before destination k+1's edges are read,
        so peak spill disk is one destination's traffic. With
        ``pipeline=True`` the spill sort and run append (and the §3.3.1
        compaction passes) run on the channel's background sender in send
        order, so the run table evolves as inline; with ``full_duplex`` the
        merge feeding the apply slices runs on the receiver thread too."""
        from repro_torch.streams.channel import ShardChannels
        from repro_torch.streams.msgstore import MessageRunStore

        program, pg = self.program, self.pg
        n = pg.n_shards
        reader = self._stream_reader
        log = self.message_log
        if log is not None:
            # the run files persist under the log: the OMSs ARE the log (§3.4)
            mstore = log.open_step(s)
        else:
            mstore = MessageRunStore(
                os.path.join(self.msg_spill_dir, f"step-{s:06d}"), n, pg.P,
                numpy_dtype(program.msg_dtype), compress=self.compress,
                compress_payload=self.compress_payload or False,
                payload_channels=self._payload_channels,
            )
            self._attach_payload_sampler(mstore)
        channel = (
            ShardChannels(mstore, inflight=self.channel_inflight,
                          fault=self._channel_fault)
            if self.pipeline else None
        )
        # one compaction entry point for both paths (the channel enqueues the
        # same op in FIFO order, so the run table evolves identically)
        compact = (channel.compact if channel is not None
                   else mstore.compact_tag)
        new_v, new_a, stats = [], [], []
        ok = False
        try:
            for k in range(n):
                # -- spill: raw messages out, one sorted run per edge chunk
                cur_src = None
                for chunk in reader.stream(plan[k]):
                    i = chunk.src_shard
                    if cur_src is not None and i != cur_src:
                        # keep the merge fan-in bounded: collapse the finished
                        # source's runs down to one (multi-pass §3.3.1)
                        compact(k, cur_src, self.msg_merge_fanin,
                                self.msg_read_chunk)
                    cur_src = i
                    msg, dp, valid = self._stream_msgs(
                        values[i], pg.degree[i], active[i],
                        *self._stager.put(chunk.sp, chunk.dp, chunk.w), s,
                    )
                    # copies: dp may alias the reader's staging buffer, and
                    # the sender thread reads them after the reader advances
                    msg, dp, valid = (_host_copy(msg), _host_copy(dp),
                                      _host_copy(valid))
                    if channel is not None:
                        # sort + append move to the sender thread; the next
                        # chunk's message generation overlaps them
                        channel.send_raw(k, dp, msg, valid, tag=i)
                    else:
                        mstore.append_raw(k, dp, msg, valid, tag=i)
                self._note_io()
                if cur_src is not None:
                    compact(k, cur_src, self.msg_merge_fanin,
                            self.msg_read_chunk)
                if channel is not None:
                    channel.flush()  # dest k's runs all landed; safe to merge
                # -- merge + apply (shared with recovery)
                acc_v, acc_a, cnt_k = self._apply_list_merged(
                    mstore, k, values[k], active[k], s, channel=channel
                )
                stats.append(self._stream_finish(values[k], acc_v, acc_a,
                                                 cnt_k, pg.vmask[k]))
                new_v.append(acc_v)
                new_a.append(acc_a)
                if log is None:
                    mstore.clear_dest(k)  # applied => this OMS is dead (§3.3)
            if channel is not None:
                channel.close()
            ok = True
        finally:
            if channel is not None:
                if not ok:
                    self._abort_channels(channel, None)
                self._accum_channel(channel)
            if log is not None:
                if ok:
                    log.close_step(s)  # publish the run index, drop handles
            elif ok:
                mstore.delete()
        io = self.io_history[-1]
        io_note = f"{io.blocks_read}blk/{io.bytes_read >> 10}KiB"
        if channel is not None:
            st = channel.stats
            io_note += (f" tx={st.packets}pk/{st.wire_bytes >> 10}KiB "
                        f"ov={st.sender_overlap_seconds() * 1e3:.1f}"
                        f"/{st.receiver_overlap_seconds() * 1e3:.1f}ms")
        return (torch.stack(new_v), torch.stack(new_a),
                *self._sum_stats(stats), io_note)

    def _run_streamed(self, max_supersteps, state, start_step, verbose,
                      checkpointer, on_step):
        """Out-of-core superstep loop: edges arrive from disk group by group
        through the prefetching reader; resident per shard = vertex arrays
        + constant-size buffers. The same contract as ``run``."""
        from repro_torch.streams.channel import ChannelError, ChannelStats
        from repro_torch.streams.reader import StreamStats
        from repro_torch.streams.schedule import plan_stream_schedule

        program, store = self.program, self.stream_store
        comb = program.combiner
        if self.thread_leaks:
            # a previous failed superstep left a channel thread alive; it may
            # still hold this store's inbox run files open
            raise ChannelError(
                f"{len(self.thread_leaks)} channel thread(s) leaked by an "
                "earlier failed superstep; build a fresh engine/store "
                "instead of rerunning over their open inbox files"
            ) from self.thread_leaks[0]
        # scratch inboxes / OMS spills live under the store; a crashed
        # superstep leaves its step dir behind: sweep at run start (not at
        # construction, so a recovery engine never clobbers a live run's)
        for d in (self._inbox_dir, self.msg_spill_dir):
            if os.path.isdir(d):
                for name in os.listdir(d):
                    if name.startswith(("step-", "recover-")):
                        shutil.rmtree(os.path.join(d, name),
                                      ignore_errors=True)
        self.channel_stats = ChannelStats()  # fresh overlap accounting
        self.io_history = []
        restored_from = None
        if (state is None and checkpointer is not None
                and checkpointer.latest() is not None):
            values, active, start_step = checkpointer.restore(
                expected_meta=store.signature(), device=self.device)
            restored_from = start_step
        else:
            values, active = state if state is not None else self.init()
        history: list[SuperstepRecord] = []
        target = self._target(max_supersteps)
        # skip() against the block manifest BEFORE any disk I/O; the plan for
        # step s comes from step s's frontier (the bitmap's one trip to the
        # host), re-made after apply so rec.density is the NEXT step's
        plan, _, _ = plan_stream_schedule(store, active.cpu().numpy(),
                                          by_dest=True)
        residency = self._residency
        nonempty_total = store.nonempty_blocks()
        for s in range(start_step, target):
            t0 = time.perf_counter()
            if comb is None:
                superstep_fn = self._superstep_streamed_nocomb
            elif self.pipeline:
                superstep_fn = self._superstep_streamed_comb_pipelined
            else:
                superstep_fn = self._superstep_streamed_comb
            # selective scheduling: everything skip() left off this step's
            # plan is disk I/O that never happens
            scheduled = sum(len(ids) for per_dest in plan
                            for _, _, ids in per_dest)
            residency.note_skipped(nonempty_total - scheduled)
            hits0, miss0, evict0, _ = residency.counters()
            self.io_history.append(StreamStats())
            values, active, n_active, n_msgs, agg, io_note = superstep_fn(
                values, active, s, plan)
            hits1, miss1, evict1, _ = residency.counters()
            self._decide_payload_codec()  # no-op unless "auto" undecided
            plan, density, _ = plan_stream_schedule(
                store, active.cpu().numpy(), by_dest=True)
            dt = time.perf_counter() - t0
            rec = SuperstepRecord(
                step=s, n_active=n_active, n_msgs=n_msgs, agg=agg,
                density=density, mode="streamed", seconds=dt,
                restored_from=restored_from if s == start_step else None,
                blocks_read=miss1 - miss0, cache_hits=hits1 - hits0,
                cache_evictions=evict1 - evict0,
                blocks_skipped=nonempty_total - scheduled,
            )
            history.append(rec)
            if verbose:
                print(f"  superstep {s:4d}: active={n_active:>9d} "
                      f"msgs={n_msgs:>10d} agg={agg:.6g} "
                      f"density={density:.4f} [streamed {io_note}] "
                      f"{dt * 1e3:.1f} ms")
            if on_step is not None:
                on_step(rec, (values, active))
            if checkpointer is not None:
                saved = checkpointer.maybe_save(s + 1, values, active,
                                                meta=store.signature())
                if saved and self.message_log is not None:
                    # §3.4: OMS logs live until a newer checkpoint is durable
                    self.message_log.gc_before(s + 1)
            if program.num_supersteps is None and n_active == 0:
                break
        return (values, active), history

    # -- results and accounting ------------------------------------------------
    def gather_values(self, values) -> dict[int, Any]:
        """{old_id: value} for all real vertices (the paper's HDFS dump)."""
        vals = values.cpu().numpy()
        old = self.pg.old_ids.cpu().numpy()
        mask = self.pg.vmask.cpu().numpy()
        return dict(zip(old[mask].tolist(), vals[mask].tolist()))

    def memory_model(self) -> dict[str, int]:
        """Bytes per shard held resident vs streamed (Lemma 1 / Theorem 1
        accounting), from ``core.plan.estimate_memory``, the algebra the
        planner runs, with the realized geometry and knobs (the effective
        apply-slice cap, the actual on-disk stream bytes)."""
        from repro_torch.core.plan import estimate_memory

        pg, cfg = self.pg, self.config
        streamed = self.mode == "streamed"
        return estimate_memory(
            mode=self.mode,
            n_shards=pg.n_shards,
            P=pg.P,
            E_cap=pg.E_cap,
            edge_block=pg.edge_block,
            value_itemsize=self.program.value_dtype.itemsize,
            msg_itemsize=self.program.msg_dtype.itemsize,
            combined=self.program.combiner is not None,
            pipeline=self.pipeline,
            compress=self.compress,
            compress_payload=(self.compress_payload or False) if streamed
            else cfg.channel.compress_payload,
            full_duplex=self.full_duplex,
            chunk_blocks=(self._stream_reader.chunk_blocks if streamed
                          else cfg.stream.chunk_blocks),
            depth=(self._stream_reader.depth if streamed
                   else cfg.stream.depth),
            group_batch=(self.group_batch if streamed
                         else cfg.stream.group_batch),
            slice_cap=(self._msg_slice_cap_eff if streamed
                       else cfg.spill.slice_cap),
            read_chunk=cfg.spill.read_chunk,
            merge_fanin=cfg.spill.merge_fanin,
            inflight=cfg.channel.inflight,
            cache_bytes=cfg.stream.cache_bytes,
            disk_bytes_per_shard=(
                self.stream_store.disk_bytes() // pg.n_shards
                if streamed else None
            ),
        )
