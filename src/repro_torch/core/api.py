"""Vertex-centric programming API (the Pregel surface of the paper, §2.1).

The port writes the shard axis out: every state tensor a program sees is
``(n, P)`` (shard, position), where the JAX package's programs see one
shard's ``(P,)`` under ``vmap``. Programs are elementwise, so the bodies read
the same. A ``VertexProgram`` specifies:

* ``init``     — superstep-0 values and active flags,
* ``message``  — the value a source vertex sends along an out-edge,
* ``apply``    — how a vertex digests its combined messages and votes to halt,
* ``combiner`` — the message combiner with identity ``e0`` (§5 needs one),
* ``msg_kind`` — the message as the hand-written kernel knows it
  (``kernels/edge_combine.py``); None means the plain backend only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch


@dataclass(frozen=True)
class Combiner:
    """A commutative, associative combine with identity ``e0``."""

    name: str  # "sum" | "min" | "max"
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
        raise ValueError(self.name)

    def scatter(self, target: torch.Tensor, idx: torch.Tensor,
                msgs: torch.Tensor) -> torch.Tensor:
        """Scatter-combine ``msgs`` into the 1-D ``target`` at ``idx``, in
        place (the A_s / A_r path); ``target`` holds ``e0`` or earlier
        messages, so the reduction includes it."""
        if self.name == "sum":
            return target.index_add_(0, idx, msgs)
        if self.name in ("min", "max"):
            return target.scatter_reduce_(0, idx, msgs, "a" + self.name,
                                          include_self=True)
        raise ValueError(self.name)

    def reduce(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Reduce stacked message buffers along ``dim``."""
        if self.name == "sum":
            return x.sum(dim)
        if self.name == "min":
            return x.amin(dim)
        if self.name == "max":
            return x.amax(dim)
        raise ValueError(self.name)


SUM = Combiner("sum", 0)
MIN = Combiner("min", float("inf"))
MAX = Combiner("max", float("-inf"))
IMIN = Combiner("min", 2**31 - 1)  # int messages
IMAX = Combiner("max", -(2**31))


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

    def aggregate(self, value, new_value, has_msg) -> torch.Tensor | None:
        return None


def keep_halted(new_value, value, compute_mask):
    """Pregel halted semantics: untouched vertices keep their value."""
    return torch.where(compute_mask, new_value, value)
