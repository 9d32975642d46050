"""Activation sharding rules, the port of the JAX package's
``models/sharding.py``.

The reference pins activations at block boundaries with
``with_sharding_constraint`` under a small context the launcher sets:

    set_rules(batch=('pod', 'data'), model='model', seq=None, mesh=mesh)

The port pins nothing: one process holds every tensor whole, and a rank of
a live grid holds what its products need by construction (the collectives
at the end of this module). The rules are kept for what they decide:
:func:`act_spec` gives the spec the reference's ``act_*`` would pin a shape
to (``fit``: an axis that does not divide its dimension, or of size 1, is
dropped), and the dry run (``launch/dryrun.py``) divides its activation,
attention and MoE work by it. A spec is a plain tuple of None, a mesh axis
name, or a tuple of names.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

_RULES: dict | None = None

#: the logical axes each ``act_*`` pins, by its suffix (``logits`` by ndim)
ACT_AXES = {
    "btd": ("batch", "seq", None),  # (B, S, d) residual-stream activations
    "bshd": ("batch", None, "model", None),  # (B, S, H, hd) per head
    "bsf": ("batch", None, "model"),  # (B, S, ff) FFN hidden
    "logits3": ("batch", None, "model"),  # (B, S, V)
    "logits2": ("batch", "model"),  # (B, V)
    "ecd": ("model", None, None),  # (E, C, d) MoE expert buffers
}


@contextmanager
def rules(batch, model, seq=None, mesh=None):
    """The reference's ``set_rules`` for the ``with`` block."""
    global _RULES
    old = _RULES
    _RULES = dict(batch=batch, model=model, seq=seq, mesh=mesh)
    try:
        yield
    finally:
        _RULES = old


def fit(spec, shape, mesh=None) -> tuple:
    """The reference's ``_fit``: each axis of ``spec`` kept where it is
    larger than 1 and divides its dimension, else None. ``mesh``: the
    rules' by default (every axis dropped without one)."""
    if mesh is None:
        mesh = _RULES.get("mesh") if _RULES else None
    out = []
    for dim, ax in zip(shape, spec):
        size = 1 if mesh is None or ax is None else mesh.axis_size(ax)
        out.append(ax if size > 1 and dim % size == 0 else None)
    return tuple(out)


def logical_spec(shape, *axes) -> tuple:
    """The spec the reference's ``constrain(x, *axes)`` pins a tensor of
    ``shape`` to under the current rules (all None without rules)."""
    if _RULES is None:
        return (None,) * len(shape)
    return fit(tuple(_RULES.get(a) if a else None for a in axes), shape)


def act_spec(kind: str, shape) -> tuple:
    """The spec the reference's ``act_<kind>`` pins ``shape`` to; ``kind`` a key of
    ``ACT_AXES`` or ``logits`` (3-d or 2-d by the shape)."""
    if kind == "logits":
        kind = f"logits{len(shape)}"
    return logical_spec(shape, *ACT_AXES[kind])


# ---------------------------------------------------------------------------
# collectives that autograd passes through, over a live process grid
# ---------------------------------------------------------------------------
#
# On a live grid (``launch/lm_mesh.py::ProcessGrid``) a rank holds its shards
# and the products run where the specs put them: FSDP gathers over 'data',
# Megatron's tensor-parallel pair over 'model'. Each op below is a no-op on an
# axis of size 1, so a grid of one rank computes what one process does. A grid
# adds float partials in rank order (gathered, then added 0..n-1, in float32
# for a 16-bit dtype and rounded once): every rank gets the same bits, and
# two runs the same bits.


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid, axis, dim):
        ctx.grid, ctx.axis, ctx.dim = grid, axis, dim
        return grid.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.grid.reduce_scatter(g, ctx.axis, ctx.dim), None, None, None


class _Join(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid, axis, dim):
        ctx.grid, ctx.axis, ctx.dim = grid, axis, dim
        return grid.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        grid = ctx.grid
        part = g.chunk(grid.size(ctx.axis), ctx.dim)[grid.index(ctx.axis)]
        return part.contiguous(), None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid, axis):
        ctx.grid, ctx.axis = grid, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.grid.all_sum(g, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid, axis):
        return grid.all_sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def gather(x, grid, axis: str, dim: int):
    """``x``'s pieces over ``axis`` joined along ``dim`` in rank order (the
    FSDP gather over 'data'); its backward sums the gradients over the axis
    and keeps this rank's piece (a reduce-scatter)."""
    return x if grid.size(axis) == 1 else _Gather.apply(x, grid, axis, dim)


def join(x, grid, axis: str, dim: int):
    """``x``'s pieces over ``axis`` joined along ``dim`` in rank order, where
    what follows runs whole, and alike, on every rank of the axis (the MoE
    experts' outputs before the combine): its backward keeps this rank's
    piece of the gradient, which every rank holds whole."""
    return x if grid.size(axis) == 1 else _Join.apply(x, grid, axis, dim)


def copy_to(x, grid, axis: str):
    """Identity forward, gradients summed over ``axis`` backward: where a
    tensor replicated over the axis enters products that split it
    (Megatron's f)."""
    return x if grid.size(axis) == 1 else _CopyTo.apply(x, grid, axis)


def reduce_from(x, grid, axis: str):
    """Partials summed over ``axis`` forward, the gradient passed through
    backward: every rank computes the same sum and takes its own part's
    gradient from it (Megatron's g)."""
    return x if grid.size(axis) == 1 else _ReduceFrom.apply(x, grid, axis)


def max_over(x, grid, axis: str):
    """The elementwise max over ``axis``, detached (exact in any order; the
    softmax's shift, which no gradient passes through)."""
    return x.detach() if grid.size(axis) == 1 else grid.all_max(x.detach(),
                                                                 axis)
