"""Activation sharding rules, the port of the JAX package's
``models/sharding.py``.

The reference pins activations at block boundaries with
``with_sharding_constraint`` under a small context the launcher sets:

    set_rules(batch=('pod', 'data'), model='model', seq=None, mesh=mesh)

One process holds every tensor whole, so the port pins nothing. The rules
are kept for what they decide: :func:`act_spec` gives the spec the
reference's ``act_*`` would pin a shape to (``fit``: an axis that does not
divide its dimension, or of size 1, is dropped), and the dry run
(``launch/dryrun.py``) divides its activation, attention and MoE work by
it. A spec is a plain tuple of None, a mesh axis name, or a tuple of names.
"""

from __future__ import annotations

from contextlib import contextmanager

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
