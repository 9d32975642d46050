"""Vertex-centric programming API (the Pregel surface of the paper, §2.1).

The port writes the shard axis out: every state tensor a program sees is
``(n, P)`` (shard, position), where the JAX package's programs see one
shard's ``(P,)`` under ``vmap``. Programs are elementwise, so the bodies read
the same. A ``VertexProgram`` specifies:

* ``init``     — superstep-0 values and active flags,
* ``message``  — the value a source vertex sends along an out-edge,
* ``apply``    — how a vertex digests its combined messages and votes to halt,
* ``combiner`` — the message combiner with identity ``e0`` (§5 needs one;
  None sends the program down ``basic`` mode's message-list path, where
  ``apply_list`` digests each vertex's destination-sorted messages),
* ``msg_kind`` — the message as the hand-written kernel knows it
  (``kernels/edge_combine.py``); None means the plain backend only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.kernels.run_sum import run_sum


@dataclass(frozen=True)
class Combiner:
    """A commutative, associative combine with identity ``e0``.

    ``"or"`` is the boolean semiring's: its messages are 0 or 1 in the
    message dtype and compare as booleans, as the JAX package's ``OR`` is
    tested. It keeps that dtype (a ring accumulator stays what it was), so
    ``combine`` is a logical or cast back, and ``scatter``/``reduce`` are
    the max, which is the or on {0, 1}. The hand-written kernels compute
    only sum, min and max; an OR program runs on the torch backend."""

    name: str  # "sum" | "min" | "max" | "or"
    e0: Any  # scalar identity, cast to the message dtype

    def identity(self, shape, dtype, device) -> torch.Tensor:
        return torch.full(shape, self.e0, dtype=dtype, device=device)

    def combine(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "sum":
            return a + b
        if self.name == "min":
            return torch.minimum(a, b)
        if self.name == "max":
            return torch.maximum(a, b)
        if self.name == "or":
            return torch.logical_or(a, b).to(torch.result_type(a, b))
        raise ValueError(self.name)

    def scatter(self, target: torch.Tensor, idx: torch.Tensor,
                msgs: torch.Tensor) -> torch.Tensor:
        """Scatter-combine ``msgs`` into the 1-D ``target`` at ``idx``, in
        place (the A_s / A_r path); ``target`` holds ``e0`` or earlier
        messages, so the reduction includes it."""
        if self.name == "sum":
            return target.index_add_(0, idx, msgs)
        if self.name in ("min", "max", "or"):
            op = "amin" if self.name == "min" else "amax"  # or = max on {0, 1}
            return target.scatter_reduce_(0, idx, msgs, op,
                                          include_self=True)
        raise ValueError(self.name)

    def reduce(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Reduce stacked message buffers along ``dim``."""
        if self.name == "sum":
            return x.sum(dim)
        if self.name == "min":
            return x.amin(dim)
        if self.name in ("max", "or"):
            return x.amax(dim)
        raise ValueError(self.name)


SUM = Combiner("sum", 0)
MIN = Combiner("min", float("inf"))
MAX = Combiner("max", float("-inf"))
IMIN = Combiner("min", 2**31 - 1)  # int messages
IMAX = Combiner("max", -(2**31))
OR = Combiner("or", 0)  # messages in {0, 1}


@dataclass
class ShardContext:
    """The state array A as programs see it: every tensor is ``(n, P)``."""

    shard: torch.Tensor  # (n, 1) int64: each row's shard index
    n_shards: int
    n_vertices: int
    P: int
    degree: torch.Tensor  # (n, P) int32
    vmask: torch.Tensor  # (n, P) bool
    old_ids: torch.Tensor  # (n, P) int64
    gids: torch.Tensor  # (n, P) int64 recoded global id (-1 for holes)

    @property
    def new_ids(self) -> torch.Tensor:
        """Dense recoded global id of every position. Holes carry a large
        sentinel so min-label algorithms never pick them."""
        return torch.where(self.gids >= 0, self.gids, 2**31 - 1)


class VertexProgram:
    """Base class. Subclasses define the per-vertex behaviour, vectorized."""

    combiner: Combiner | None = None
    value_dtype: torch.dtype = torch.float32
    msg_dtype: torch.dtype = torch.float32
    #: "div_deg" | "add_w" | "add_1" | "copy" | "deg" | None (plain only)
    msg_kind: str | None = None
    #: fixed superstep budget (e.g. PageRank); None = run to quiescence
    num_supersteps: int | None = None

    def init(self, ctx: ShardContext) -> tuple[torch.Tensor, torch.Tensor]:
        """Return (values (n, P), active (n, P) bool)."""
        raise NotImplementedError

    def message(self, value, degree, weight, step: int) -> torch.Tensor:
        """Message an active source vertex sends along one out-edge."""
        raise NotImplementedError

    def apply(self, value, degree, msg, has_msg, active, step: int,
              ctx: ShardContext) -> tuple[torch.Tensor, torch.Tensor]:
        """Digest combined messages; return (new_value, new_active).
        Vertices outside ``active | has_msg`` keep their value."""
        raise NotImplementedError

    def apply_list(self, value, degree, sorted_dst, sorted_msg, has_msg,
                   active, step: int,
                   ctx: ShardContext) -> tuple[torch.Tensor, torch.Tensor]:
        """Digest *message lists* (programs with no combiner, §3.3.2).
        ``sorted_dst``/``sorted_msg`` are ``(n, M)``: row i holds the
        messages shard i received, ascending by destination position, with
        ``P`` marking padding (the merge-sorted IMS). The segment helpers
        below turn them into per-vertex reductions."""
        raise NotImplementedError

    def aggregate(self, value, new_value, has_msg) -> torch.Tensor | None:
        return None


def keep_halted(new_value, value, compute_mask):
    """Pregel halted semantics: untouched vertices keep their value."""
    return torch.where(compute_mask, new_value, value)


# ---------------------------------------------------------------------------
# segment helpers over destination-sorted message runs (for apply_list)
# ---------------------------------------------------------------------------
# Inputs are ``(n, M)`` rows of the sorted IMS, one row a shard: runs grouped
# by destination position, ``dst == P`` for padding. Outputs are ``(n, P)``.
# Each scatters into the flat ``(n*P,)`` output at ``row*P + dst``; padding
# goes to position 0 of its row with a value that changes nothing there.

def _flat_index(dst: torch.Tensor, keep: torch.Tensor, P: int) -> torch.Tensor:
    row = torch.arange(dst.shape[0], device=dst.device)[:, None] * P
    return (torch.where(keep, dst.long(), 0) + row).reshape(-1)


def segment_count_distinct(sorted_dst, sorted_msg, P: int) -> torch.Tensor:
    """Per-destination count of DISTINCT payloads — the canonical
    not-expressible-with-a-combiner reduction. A second sort by payload
    within runs makes duplicates adjacent: ``(dst, msg)`` packs into one
    int64 key ``dst << 32 | (msg + 2^31)``, sorted once."""
    key = ((sorted_dst.long() << 32) | (sorted_msg.long() + 2**31))
    key = torch.sort(key, dim=-1, stable=True).values
    d2 = key >> 32
    valid = d2 < P
    first = valid.clone()
    first[:, 1:] &= key[:, 1:] != key[:, :-1]
    out = torch.zeros(d2.shape[0] * P, dtype=torch.int32, device=key.device)
    out.index_add_(0, _flat_index(d2, valid, P),
                   first.reshape(-1).to(torch.int32))
    return out.view(-1, P)


def segment_sum(sorted_dst, sorted_msg, P: int) -> torch.Tensor:
    """Per-destination sum of the sorted runs. A float32 sum adds each
    run left to right from 0 (``kernels/run_sum`` on the runs as they
    stand, the padding skipped), on the CPU and on the card alike; other
    types keep ``index_add_``, exact in any order."""
    valid = sorted_dst < P
    if sorted_msg.dtype == torch.float32:  # row-local keys, stride P
        return run_sum(torch.where(valid, sorted_dst, -1),
                       sorted_msg.contiguous(), sorted_dst.shape[0] * P,
                       stride=P).view(-1, P)
    idx = _flat_index(sorted_dst, valid, P)
    out = torch.zeros(sorted_dst.shape[0] * P, dtype=sorted_msg.dtype,
                      device=sorted_msg.device)
    out.index_add_(0, idx, torch.where(valid, sorted_msg, 0).reshape(-1))
    return out.view(-1, P)


def segment_second_min(sorted_dst, sorted_msg, P: int, sentinel) -> torch.Tensor:
    """Per-destination SECOND-smallest distinct payload (``sentinel`` where
    fewer than two distinct payloads arrived). Two ordered passes over the
    message list: no single commutative combiner expresses it."""
    n = sorted_dst.shape[0]
    valid = sorted_dst < P
    big = torch.full((n * P,), sentinel, dtype=sorted_msg.dtype,
                     device=sorted_msg.device)
    m1 = big.clone().scatter_reduce_(
        0, _flat_index(sorted_dst, valid, P),
        torch.where(valid, sorted_msg, sentinel).reshape(-1), "amin")
    gt = valid & (sorted_msg > m1.view(n, P).gather(
        1, sorted_dst.long().clamp(0, P - 1)))
    return big.scatter_reduce_(
        0, _flat_index(sorted_dst, gt, P),
        torch.where(gt, sorted_msg, sentinel).reshape(-1), "amin",
    ).view(n, P)
