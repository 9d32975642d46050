"""The paper's evaluated Pregel algorithms (§6) plus extras, as VertexPrograms.

* PageRank   — dense workload, SUM combiner, fixed supersteps
* Hash-Min   — connected components, shrinking workload, MIN over int32
* SSSP / BFS — sparse frontier, the skip() stress case, MIN
* DegreeSum / LabelSpread — extra coverage for SUM and MAX (int32)

The combiner-less programs of the JAX package (DistinctInLabels,
SecondMinLabel) need the message-list path, which the port does not have yet.
"""

from __future__ import annotations

import torch

from repro_torch.core.api import (
    IMAX, IMIN, MIN, SUM, ShardContext, VertexProgram, keep_halted,
)


class PageRank(VertexProgram):
    """a(v) = 0.15/|V| + 0.85 * sum(messages); msg = a(v)/d(v) (paper §2.1)."""

    combiner = SUM
    value_dtype = torch.float32
    msg_dtype = torch.float32
    msg_kind = "div_deg"

    def __init__(self, supersteps: int = 10, damping: float = 0.85):
        self.num_supersteps = supersteps
        self.damping = damping

    def init(self, ctx: ShardContext):
        v = torch.full(ctx.degree.shape, 1.0 / ctx.n_vertices,
                       dtype=torch.float32, device=ctx.degree.device)
        return v, torch.ones_like(ctx.vmask)

    def message(self, value, degree, weight, step):
        return value / degree.clamp(min=1).to(torch.float32)

    def apply(self, value, degree, msg, has_msg, active, step, ctx):
        new = 0.15 / ctx.n_vertices + self.damping * msg
        # every vertex recomputes each superstep (dense workload)
        return new, torch.full_like(active, step + 1 < self.num_supersteps)

    def aggregate(self, value, new_value, has_msg):
        return (new_value - value).abs()  # L1 delta (convergence monitor)


class HashMin(VertexProgram):
    """Connected components by min-label flooding; label = recoded id."""

    combiner = IMIN
    value_dtype = torch.int32
    msg_dtype = torch.int32
    msg_kind = "copy"

    def init(self, ctx: ShardContext):
        return ctx.new_ids.to(torch.int32), torch.ones_like(ctx.vmask)

    def message(self, value, degree, weight, step):
        return value

    def apply(self, value, degree, msg, has_msg, active, step, ctx):
        cand = torch.where(has_msg, torch.minimum(value, msg), value)
        new = keep_halted(cand, value, active | has_msg)
        return new, new < value  # re-broadcast iff label shrank


class SSSP(VertexProgram):
    """Single-source shortest paths from a *recoded* source id."""

    combiner = MIN
    value_dtype = torch.float32
    msg_dtype = torch.float32
    msg_kind = "add_w"

    def __init__(self, source_new_id: int):
        self.source = source_new_id

    def init(self, ctx: ShardContext):
        is_src = ctx.new_ids == self.source
        dist = torch.where(is_src, 0.0, float("inf")).to(torch.float32)
        return dist, is_src

    def message(self, value, degree, weight, step):
        return value + weight

    def apply(self, value, degree, msg, has_msg, active, step, ctx):
        cand = torch.where(has_msg, torch.minimum(value, msg), value)
        return cand, cand < value  # moved vertices enter the frontier


class BFS(SSSP):
    """BFS levels = SSSP over unit weights."""

    msg_kind = "add_1"

    def message(self, value, degree, weight, step):
        return value + 1.0


class DegreeSum(VertexProgram):
    """Sum of in-neighbours' out-degrees; one superstep."""

    combiner = SUM
    value_dtype = torch.float32
    msg_dtype = torch.float32
    msg_kind = "deg"
    num_supersteps = 1

    def init(self, ctx: ShardContext):
        zeros = torch.zeros(ctx.degree.shape, dtype=torch.float32,
                            device=ctx.degree.device)
        return zeros, torch.ones_like(ctx.vmask)

    def message(self, value, degree, weight, step):
        return degree.to(torch.float32)

    def apply(self, value, degree, msg, has_msg, active, step, ctx):
        return torch.where(has_msg, msg, 0.0), torch.zeros_like(active)


class LabelSpread(VertexProgram):
    """Max-label flooding (the HashMin dual) — MAX over int32. The JAX
    package leaves it on the plain backend; the port's int32 kernel path
    takes ``copy`` with ``max`` as well."""

    combiner = IMAX
    value_dtype = torch.int32
    msg_dtype = torch.int32
    msg_kind = "copy"

    def init(self, ctx: ShardContext):
        return ctx.new_ids.to(torch.int32), torch.ones_like(ctx.vmask)

    def message(self, value, degree, weight, step):
        return value

    def apply(self, value, degree, msg, has_msg, active, step, ctx):
        cand = torch.where(has_msg, torch.maximum(value, msg), value)
        new = keep_halted(cand, value, active | has_msg)
        return new, new > value
