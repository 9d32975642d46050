"""The production mesh and the LM sharding rules (FSDP × TP × EP × SP) of
the JAX package's ``launch/mesh.py``, for the dry run. The port's
``launch/mesh.py`` is the GraphD mesh launcher; this module starts nothing.

Mesh: one pod (data=16, model=16) = 256 GPUs; several pods add a leading
pod axis (pod=2, data=16, model=16) = 512. The mesh is abstract: a shape
and axis names, no devices.

Parallelism map, as the reference's:

* batch        -> ('pod', 'data'): pure data parallelism across pods
* params       -> FSDP over 'data' on the d_model-ish axis, TP over
                  'model' on the heads/ff/vocab/expert axis
* MoE experts  -> EP over 'model'
* KV caches    -> the sequence axis over 'model' (sequence-parallel
                  decode attention)

A spec is a plain tuple with an entry a dimension: None, an axis name, or
a tuple of names (a one-name tuple is written as the name, as JAX's
``PartitionSpec`` normalises it). Parameters are named as the port names
them (``models/transformer.py::param_shapes``): one leaf a layer, where
the reference stacks a pattern position's layers (``groups[pi]``) and the
encoder's along a leading axis; that stacked leaf's spec is ``(None,)``
plus the per-layer spec given here (``transformer.tree_slots`` maps the
names). Caches are named ``layers.{i}.{field}.{leaf}`` after the port's
cache fields (``serving/cache.py::cache_leaves``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.models.sharding import fit


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names, without devices."""
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    def axis_size(self, ax) -> int:
        """The size of an axis, of a tuple of axes (their product), or 1
        for None."""
        if ax is None:
            return 1
        if isinstance(ax, tuple):
            return math.prod(self.axis_size(a) for a in ax)
        return self.shape[self.axis_names.index(ax)]

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def abstract_mesh(shape) -> AbstractMesh:
    """A (data, model) mesh, or (pod, data, model) for three sizes."""
    shape = tuple(int(s) for s in shape)
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}
    if len(shape) not in names:
        raise ValueError(f"mesh shape {shape}: (data, model) or "
                         "(pod, data, model)")
    return AbstractMesh(shape, names[len(shape)])


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    return abstract_mesh((2, 16, 16) if multi_pod else (16, 16))


def dp_axes(mesh: AbstractMesh):
    """The data-parallel (batch) axes of this mesh."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


# ---------------------------------------------------------------------------
# parameter sharding rules
# ---------------------------------------------------------------------------

def _base_spec(name: str, ndim: int) -> tuple:
    """Spec for the UNSTACKED leaf (no leading layer-group axis)."""
    if name in ("embed", "unembed"):
        return ("model", "data")  # vocab TP, d FSDP
    if name in ("wq", "wk", "wv", "w_ukv", "in_proj"):
        return ("data", "model")
    if name in ("wo", "out_proj"):
        return ("model", "data")
    if name in ("w_dkv", "w_krope"):
        return ("data", None)
    if name == "router":
        return ("data", None)
    if name in ("w_gate", "w_up"):
        if ndim == 3:  # MoE expert bank (E, d, f): EP + FSDP
            return ("model", "data", None)
        return ("data", "model")
    if name == "w_down":
        if ndim == 3:  # (E, f, d)
            return ("model", None, "data")
        return ("model", "data")
    if name in ("ws_gate", "ws_up"):
        return ("data", "model")
    if name == "ws_down":
        return ("model", "data")
    if name == "conv_w":
        return (None, "model")
    if name in ("conv_b",):
        return ("model",)
    if name in ("A_log", "dt_bias", "D"):
        return ("model",)
    # norms, gates, scalars: replicated
    return (None,) * ndim


def _base_spec_serve(name: str, ndim: int) -> tuple:
    """Weight-stationary serving specs: NO FSDP axis on dense weights (no
    per-token all-gather: decode is latency-bound, params stay resident,
    TP over 'model' only). MoE expert banks additionally shard their ff
    axis over 'data' so 235B-class experts fit a GPU."""
    if name in ("embed", "unembed"):
        return ("model", None)
    if name in ("wq", "wk", "wv", "w_ukv", "in_proj"):
        return (None, "model")
    if name in ("wo", "out_proj"):
        return ("model", None)
    if name in ("w_dkv", "w_krope", "router"):
        return (None, None)
    if name in ("w_gate", "w_up"):
        if ndim == 3:  # (E, d, f): EP + ff-TP over 'data'
            return ("model", None, "data")
        return (None, "model")
    if name == "w_down":
        if ndim == 3:  # (E, f, d)
            return ("model", "data", None)
        return ("model", None)
    if name in ("ws_gate", "ws_up"):
        return (None, "model")
    if name == "ws_down":
        return ("model", None)
    if name == "conv_w":
        return (None, "model")
    if name in ("conv_b", "A_log", "dt_bias", "D"):
        return ("model",)
    return (None,) * ndim


def _clean(spec, shape, mesh: AbstractMesh) -> tuple:
    """Drop spec axes absent from the mesh (a tuple of one name left is
    that name), then those that do not divide their dimension
    (``sharding.fit``)."""
    named = []
    for ax in spec:
        if isinstance(ax, tuple):
            ax = tuple(a for a in ax if a in mesh.axis_names) or None
            ax = ax[0] if ax and len(ax) == 1 else ax
        elif ax not in mesh.axis_names:
            ax = None
        named.append(ax)
    return fit(tuple(named), shape, mesh)


def spec_axes(spec) -> set:
    """The mesh axis names a spec uses."""
    out = set()
    for ax in spec:
        if isinstance(ax, tuple):
            out.update(ax)
        elif ax is not None:
            out.add(ax)
    return out


def shard_count(spec, mesh: AbstractMesh, without=()) -> int:
    """How many pieces a spec cuts a tensor into: the product of the sizes
    of its axes, less those in ``without``."""
    return math.prod(mesh.axis_size(a) for a in spec_axes(spec)
                     if a not in without)


def leaf_spec(name: str, shape, mesh: AbstractMesh,
              mode: str = "train") -> tuple:
    """The spec of one unstacked parameter (or optimizer-state) leaf."""
    base_fn = _base_spec if mode == "train" else _base_spec_serve
    ndim = len(shape)
    base = base_fn(name.rsplit(".", 1)[-1], ndim)
    base = tuple(base[:ndim]) + (None,) * (ndim - len(base))
    return _clean(base, shape, mesh)


def param_specs(cfg, mesh: AbstractMesh, mode: str = "train") -> dict:
    """``{port weight name: spec}`` for a config's parameters (and for its
    optimizer state's ``mu``, ``nu`` and ``err``, which are sharded as the
    weights; ``step`` is ``()``).

    mode="train": FSDP('data') x TP('model') (ZeRO-sharded states)
    mode="serve": weight-stationary TP (the decode path of §Perf)
    """
    from repro_torch.models.transformer import param_shapes

    if mode not in ("train", "serve"):
        raise ValueError(f"mode {mode!r}: 'train' or 'serve'")
    return {name: leaf_spec(name, shape, mesh, mode)
            for name, shape in param_shapes(cfg).items()}


def batch_specs_tree(batch, mesh: AbstractMesh):
    """The batch axis over the DP axes: a spec for a tensor (or shape), or a
    dict of them for a dict."""
    dp = dp_axes(mesh)

    def spec_for(leaf):
        shape = tuple(getattr(leaf, "shape", leaf))
        return _clean((dp,) + (None,) * (len(shape) - 1), shape, mesh)

    if isinstance(batch, dict):
        return {k: spec_for(v) for k, v in batch.items()}
    return spec_for(batch)


def cache_leaf_spec(name: str, shape, mesh: AbstractMesh) -> tuple:
    """A cache leaf's spec by its last name: batch over the DP axes, the
    sequence (or latent slots, SSM heads, conv channels) over 'model'."""
    dp = dp_axes(mesh)
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "pos":  # (Lc,) int32 position table
        base = (None,)
    elif leaf in ("k", "v"):  # (B, Lc|T, Hkv, hd)
        base = (dp, "model", None, None)
    elif leaf in ("c_kv", "k_rope"):  # (B, Lc, r)
        base = (dp, "model", None)
    elif leaf == "state":  # (B, H, hd, N)
        base = (dp, "model", None, None)
    elif leaf == "conv":  # (B, K-1, C)
        base = (dp, None, "model")
    else:
        base = (dp,) + (None,) * (len(shape) - 1)
    return _clean(base[:len(shape)], shape, mesh)


def cache_specs_tree(caches, mesh: AbstractMesh) -> dict:
    """``{layers.{i}.{field}.{leaf}: spec}`` for ``serving.cache``'s
    caches (a ``LayerCache`` a layer)."""
    from repro_torch.serving.cache import cache_leaves

    return {name: cache_leaf_spec(name, t.shape, mesh)
            for name, t in cache_leaves(caches)}
