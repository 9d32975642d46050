"""The IO-Recoded superstep engine (paper §5), in-memory, on one device.

Port of the in-memory recoded half of ``repro/core/engine.py``. Each shard
scatter-combines its messages for one destination at a time into ``A_s``
(U_c), the accumulators travel the ring of n shards and are digested into
``A_r`` (U_r), then the program applies and votes to halt. The n shards are
emulated on one device: the shard axis is the leading dimension of every
tensor and ``core/collectives.py`` stands in for the ``lax`` collectives, so
a ring round runs all n shards in one batch.

Ring order follows the JAX package: at round r shard i folds in its
contribution for ``dest = (i + n-1-r) mod n`` and forwards the accumulator
to shard i+1, so float sums reassociate the same way.

Backends:

* ``"torch"``: plain PyTorch ops. Dense scan, or, when the frontier is thin,
  skip() gathers at most ``sparse_cap`` active blocks per group.
* ``"kernel"``: ``kernels/edge_combine`` (CUDA) and ``kernels/digest``
  (Triton) on CUDA tensors, their plain versions on CPU tensors. skip() is
  always on in the kernel (a dense frontier keeps every block).

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
    """(n, P+1) inclusive prefix of the active bitmap; block [lo, hi] has an
    active source iff prefix[hi+1] - prefix[lo] > 0 (skip() test, §3.2)."""
    pad = torch.zeros((active.shape[0], 1), dtype=torch.int32,
                      device=active.device)
    return torch.cat([pad, active.cumsum(1, dtype=torch.int32)], dim=1)


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
    inactive edges to the identity. All (n, E) but values/degree/active."""
    spc = sp.clamp(min=0).long()
    aact = (sp >= 0) & active.gather(1, spc)
    msg = program.message(values.gather(1, spc), degree.gather(1, spc), w,
                          step).to(program.msg_dtype)
    return torch.where(aact, msg, program.combiner.e0), aact


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


def _contrib_dense(program, pg, values, active, step, dest):
    ar = torch.arange(pg.n_shards, device=pg.device)
    sp, dp, w = pg.src_pos[ar, dest], pg.dst_pos[ar, dest], pg.eweight[ar, dest]
    msg, aact = _gen_messages(program, values, pg.degree, sp, w, active, step)
    return _combine_scatter(program, pg.P, msg, dp, aact)


def _contrib_sparse(program, pg, values, active, prefix, step, dest, cap):
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
    return _combine_scatter(program, pg.P, msg, dp, aact)


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
# the ring exchange and the superstep
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


@dataclass
class StepStats:
    """0-dim device tensors; ``run()`` reads them with one host sync."""

    n_active: torch.Tensor  # global active vertices after apply
    n_msgs: torch.Tensor  # global messages digested this superstep
    agg: torch.Tensor  # program aggregator (psum)
    density: torch.Tensor  # fraction of edge blocks active for NEXT superstep
    max_group_blocks: torch.Tensor  # max active blocks in any group


def superstep(program: VertexProgram, pg: PartitionedGraph, values, active,
              step: int, *, backend: str = "kernel",
              sparse_cap: int | None = None):
    """One full superstep: scatter -> exchange -> digest -> apply -> vote."""
    comb = program.combiner
    if backend == "kernel":
        prefix = _active_prefix(active)
        contrib = lambda dest: _contrib_kernel(program, pg, values, active,
                                               prefix, dest)
        digest = lambda A, c, A2, c2: kernel_digest(A, c, A2, c2,
                                                    combiner=comb.name)
    else:
        if sparse_cap is not None:
            prefix = _active_prefix(active)
            contrib = lambda dest: _contrib_sparse(
                program, pg, values, active, prefix, step, dest, sparse_cap)
        else:
            contrib = lambda dest: _contrib_dense(program, pg, values, active,
                                                  step, dest)
        digest = lambda A, c, A2, c2: (comb.combine(A, A2), c + c2)
    A_r, cnt = _ring_exchange(pg, contrib, digest)
    has_msg = (cnt > 0) & pg.vmask
    new_values, new_active = program.apply(
        values, pg.degree, A_r, has_msg, active, step, _shard_ctx(pg)
    )
    return _finish_superstep(program, pg, values, new_values, new_active, cnt,
                             has_msg)


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


class GraphDEngine:
    """Host driver: runs the superstep loop with dense/sparse dispatch.

    ``device=None`` runs on CUDA (and raises without it); the partition is
    moved to the engine's device if it lies elsewhere."""

    def __init__(self, pg: PartitionedGraph, program: VertexProgram,
                 config: EngineConfig | None = None, *, device=None):
        cfg = (config or EngineConfig()).finalize()
        if program.combiner is None:
            raise ValueError(f"mode={cfg.mode} requires a message combiner "
                             "(paper §5)")
        if cfg.backend == "kernel" and program.msg_kind is None:
            raise ValueError("backend='kernel' needs a program.msg_kind")
        self.device = resolve_device(device)
        self.pg = pg if pg.device == self.device else pg.to(self.device)
        self.program = program
        self.config = cfg
        self.backend = cfg.backend
        self.adapt_threshold = cfg.adapt_threshold
        self.sparse_cap = max(1, int(pg.n_blocks * cfg.sparse_cap_frac))

    def init(self):
        return init_spmd(self.program, self.pg)

    def step(self, values, active, step: int, sparse: bool = False):
        """One superstep; returns (values, active, StepStats)."""
        return superstep(self.program, self.pg, values, active, step,
                         backend=self.backend,
                         sparse_cap=self.sparse_cap if sparse else None)

    def run(self, max_supersteps: int = 10_000, state=None,
            start_step: int = 0):
        """Superstep loop; returns ((values, active), [SuperstepRecord])."""
        values, active = state if state is not None else self.init()
        history: list[SuperstepRecord] = []
        budget = self.program.num_supersteps
        target = max_supersteps if budget is None else min(budget,
                                                           max_supersteps)
        density = 1.0  # step 0: unknown, assume dense
        max_grp = self.pg.n_blocks  # hard per-group bound; start pessimistic
        for s in range(start_step, target):
            use_sparse = (max_grp <= self.sparse_cap
                          and density < self.adapt_threshold)
            t0 = time.perf_counter()
            values, active, st = self.step(values, active, s, use_sparse)
            n_active, n_msgs, agg, density, max_grp = torch.stack([
                st.n_active.double(), st.n_msgs.double(), st.agg.double(),
                st.density.double(), st.max_group_blocks.double(),
            ]).tolist()  # the superstep's one host sync
            rec = SuperstepRecord(
                step=s, n_active=int(n_active), n_msgs=int(n_msgs), agg=agg,
                density=density, mode="sparse" if use_sparse else "dense",
                seconds=time.perf_counter() - t0,
            )
            history.append(rec)
            if self.program.num_supersteps is None and rec.n_active == 0:
                break
        return (values, active), history

    def gather_values(self, values) -> dict[int, Any]:
        """{old_id: value} for all real vertices (the paper's HDFS dump)."""
        vals = values.cpu().numpy()
        old = self.pg.old_ids.cpu().numpy()
        mask = self.pg.vmask.cpu().numpy()
        return dict(zip(old[mask].tolist(), vals[mask].tolist()))
