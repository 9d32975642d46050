"""The production mesh and the LM sharding rules (FSDP × TP × EP × SP) of
the JAX package's ``launch/mesh.py``, for the dry run; and the live grid
that runs the reference's sharded train step and its serving with them.
The port's ``launch/mesh.py`` is the GraphD mesh launcher.

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

**The live grid.** The reference runs its train step, and lowers its
``prefill`` and ``decode_step`` (``launch/dryrun.py::lower_cell``), over a
device mesh with ``jax.jit(..., in_shardings=to_shardings(...))``; PyTorch
needs one process a rank. :class:`ProcessGrid` is a rank's place in a
(data, model) grid over ``torch.distributed`` (gloo, or NCCL with a GPU a
rank): what it holds of each weight, moment, batch (media included) and
cache is the spec's shard (``shard_index``), and the model built on it
(``models/transformer.py`` with ``grid=`` and a ``mode``) runs every layer
kind tensor-, expert- and vocab-parallel over 'model' (a leaf the spec
leaves whole over 'model' runs whole there) and, under the ``train``
specs, FSDP over 'data'; its MoE layers keep the global batch's capacity.
Under the ``serve`` specs the weights stay whole over 'data' but for the
expert banks' ff, and the caches are split as ``cache_specs_tree`` splits
them (``serving/cache.py``). :func:`run_train_mesh` and
:func:`run_serve_mesh` spawn the ranks (``python -m
repro_torch.launch.lm_mesh rank <workdir> <r>``), each with its shards; one
spawn runs cases of either kind (:func:`run_lm_mesh_cases`). A train case
gathers the weights, moments and gradients back whole; a serving case
brings back every step's logits and tokens.

    res = run_train_mesh(cfg, params, None, batch, (2, 4), device="cpu")
    out = run_serve_mesh(cfg, params, prompts, (2, 4), 32, device="cpu")
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pickle
import shutil
import sys
import tempfile
import time
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


def fsdp_axes(mode: str) -> tuple:
    """The mesh axes a weight's spec splits it over for storage only (FSDP:
    gathered before each use, the work not split): 'data' under the
    ``train`` specs; none under ``serve``, whose 'data' axis splits the
    expert banks' ff dimension (tensor parallel, as 'model' does)."""
    if mode not in ("train", "serve"):
        raise ValueError(f"mode {mode!r}: 'train' or 'serve'")
    return ("data",) if mode == "train" else ()


def param_specs(cfg, mesh: AbstractMesh, mode: str = "train") -> dict:
    """``{port weight name: spec}`` for a config's parameters (and for its
    optimizer state's ``mu``, ``nu`` and ``err``, which are sharded as the
    weights; ``step`` is ``()``).

    mode="train": FSDP('data') x TP('model') (ZeRO-sharded states)
    mode="serve": weight-stationary TP (the decode path of §Perf)
    """
    from repro_torch.models.transformer import param_shapes

    fsdp_axes(mode)  # refuses another mode
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


# ---------------------------------------------------------------------------
# shards: what a rank holds of a leaf under its spec
# ---------------------------------------------------------------------------

def mesh_coords(mesh: AbstractMesh, rank: int) -> dict:
    """A rank's coordinate on each axis: ranks laid out row-major over the
    axes, as ``jax.make_mesh`` lays out its devices (rank = data·m + model
    on a (data, model) mesh)."""
    out, r = {}, int(rank)
    for name, size in reversed(list(zip(mesh.axis_names, mesh.shape))):
        r, out[name] = divmod(r, size)
    return {a: out[a] for a in mesh.axis_names}


def shard_index(spec, shape, mesh: AbstractMesh, rank: int) -> tuple:
    """The slices of a leaf that ``rank`` holds under ``spec`` (None or one
    axis name a dimension, as the (data, model) specs are)."""
    coords = mesh_coords(mesh, rank)
    out = []
    for d, ax in zip(shape, spec):
        n = d // mesh.axis_size(ax)
        i = 0 if ax is None else coords[ax]
        out.append(slice(i * n, (i + 1) * n))
    return tuple(out)


def gather_shards(blocks: list, spec, mesh: AbstractMesh):
    """A leaf whole from every rank's shard (``blocks`` in rank order,
    torch tensors or numpy arrays). The copies a spec replicates over an
    axis must hold the same bits: a ``ValueError`` names the first that
    does not."""
    import numpy as np
    import torch

    used = spec_axes(spec)
    by = {tuple(mesh_coords(mesh, r).values()): b
          for r, b in enumerate(blocks)}
    same = (torch.equal if isinstance(blocks[0], torch.Tensor)
            else np.array_equal)
    for c, b in by.items():
        home = tuple(x if a in used else 0
                     for a, x in zip(mesh.axis_names, c))
        if not same(b, by[home]):
            raise ValueError(f"rank at {dict(zip(mesh.axis_names, c))} holds"
                             f" another copy of a leaf replicated as {spec}")
    cat = (torch.cat if isinstance(blocks[0], torch.Tensor)
           else np.concatenate)

    def build(dim: int, fixed: dict):
        if dim == len(spec):
            return by[tuple(fixed.get(a, 0) for a in mesh.axis_names)]
        ax = spec[dim]
        if ax is None:
            return build(dim + 1, fixed)
        return cat([build(dim + 1, {**fixed, ax: i})
                    for i in range(mesh.axis_size(ax))], dim)

    return build(0, {})


# ---------------------------------------------------------------------------
# the live grid: one process a rank over torch.distributed
# ---------------------------------------------------------------------------

#: a grid's byte counters: what it handed the backend over each axis (the
#: global norm's and the compressor's scalars over ``world``), and what
#: went through host buffers on the way (gloo on CUDA)
GRID_BYTES = ("data", "model", "world", "staged")
#: a grid's host seconds in its collectives: waiting for the card's work
#: before a staged copy, the copies to and from host buffers, the backend's
#: calls (gloo's blocking; NCCL's only enqueue)
GRID_SECONDS = ("wait", "staging", "backend")


class ProcessGrid:
    """This rank's place in a (data, model) grid of processes over the
    initialized default ``torch.distributed`` group: its coordinates
    (``mesh_coords``) and a group an axis (``dist.new_group``, every rank
    making every group in one order). What it holds of a leaf is the
    leaf's spec (``param_specs``, ``shard_index``); the collectives take
    this rank's tensors:

    * ``all_gather``: the axis's pieces joined along a dimension in rank
      order;
    * ``all_sum``: the axis's float partials gathered and added in rank
      order (from rank 0, in float32 for a 16-bit dtype, rounded once), so
      every rank holds the same bits and two runs the same;
    * ``reduce_scatter``: the same sum, a rank keeping its piece (an
      ``all_to_all`` of the pieces, then the ordered sum);
    * ``all_max``: an ``all_reduce`` with MAX (exact in any order);
    * ``stack``: the axis's copies stacked in rank order (serving's
      partial softmax combines them itself).

    Under gloo, tensors on the card go to host buffers and back, as
    ``core/collectives.py::ProcessMesh`` stages them, counted in
    ``bytes["staged"]``; ``bytes[axis]`` counts what each op handed the
    backend over the axis since the last :meth:`reset`, ``seconds`` the
    host time in them (``GRID_SECONDS``). The autograd functions over these
    are ``models/sharding.py``'s."""

    def __init__(self, shape, rank: int, *, backend: str, device):
        import torch
        import torch.distributed as dist

        self.mesh = abstract_mesh(shape)
        if self.mesh.axis_names != ("data", "model"):
            raise ValueError(f"a live grid is (data, model), not {shape}")
        self.rank = int(rank)
        self.coords = mesh_coords(self.mesh, self.rank)
        self.backend = backend
        self.device = torch.device(device)
        self._stage = backend == "gloo" and self.device.type == "cuda"
        D, M = self.mesh.shape
        self._groups = {"world": None, "data": None, "model": None}
        if D * M > 1:
            for d in range(D):
                g = dist.new_group([d * M + m for m in range(M)])
                if d == self.coords["data"]:
                    self._groups["model"] = g
            for m in range(M):
                g = dist.new_group([d * M + m for d in range(D)])
                if m == self.coords["model"]:
                    self._groups["data"] = g
        self.reset()

    def reset(self) -> None:
        self.bytes = dict.fromkeys(GRID_BYTES, 0)
        self.seconds = dict.fromkeys(GRID_SECONDS, 0.0)

    def _clock(self, kind: str, t0: float) -> float:
        now = time.perf_counter()
        self.seconds[kind] += now - t0
        return now

    def size(self, axis: str) -> int:
        return self.mesh.size if axis == "world" else self.mesh.axis_size(axis)

    def index(self, axis: str) -> int:
        return self.rank if axis == "world" else self.coords[axis]

    def param_specs(self, cfg, mode: str = "train") -> dict:
        """``{weight name: spec}`` of a config on this grid, ``mode``
        ``train`` or ``serve``."""
        return param_specs(cfg, self.mesh, mode)

    def cache_shard(self, name: str, shape) -> tuple:
        """A cache leaf's spec (``cache_leaf_spec``) on this grid and the
        slices of it this rank holds (``shard_index``)."""
        spec = cache_leaf_spec(name, shape, self.mesh)
        return spec, shard_index(spec, shape, self.mesh, self.rank)

    def shard_shape(self, spec, shape) -> tuple:
        """A leaf's shard: each dimension over the size of its axis."""
        return tuple(d // self.mesh.axis_size(ax)
                     for d, ax in zip(shape, spec))

    def owns(self, spec) -> bool:
        """Whether this rank counts its shard of a leaf once among the
        ranks: on every axis the spec does not split, its coordinate is
        0."""
        used = spec_axes(spec)
        return all(c == 0 for a, c in self.coords.items() if a not in used)

    def barrier(self) -> None:
        """One small all_reduce over every rank, uncounted."""
        import torch
        import torch.distributed as dist

        if self.mesh.size > 1:
            host = self.backend == "gloo"
            dist.all_reduce(torch.ones(1, device="cpu" if host
                                       else self.device))

    def _out(self, x):
        import torch

        x = x.contiguous()
        if self._stage:
            self.bytes["staged"] += x.numel() * x.element_size()
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            t0 = self._clock("wait", t0)
            x = x.cpu()
            self._clock("staging", t0)
        return x

    def _back(self, x):
        if self._stage:
            self.bytes["staged"] += x.numel() * x.element_size()
            t0 = time.perf_counter()
            x = x.to(self.device)
            self._clock("staging", t0)
        return x

    def _gather(self, x, axis: str):
        """The axis's copies of ``x``, stacked in rank order."""
        import torch
        import torch.distributed as dist

        send = self._out(x)
        parts = [torch.empty_like(send) for _ in range(self.size(axis))]
        t0 = time.perf_counter()
        dist.all_gather(parts, send, group=self._groups[axis])
        self._clock("backend", t0)
        self.bytes[axis] += send.numel() * send.element_size()
        return self._back(torch.stack(parts))

    def stack(self, x, axis: str):
        """The axis's copies of ``x`` stacked in rank order (``x[None]`` on
        an axis of one rank)."""
        return x[None] if self.size(axis) == 1 else self._gather(x, axis)

    def all_gather(self, x, axis: str, dim: int = 0):
        import torch

        if self.size(axis) == 1:
            return x
        return torch.cat(self._gather(x, axis).unbind(0), dim)

    def all_sum(self, x, axis: str):
        if self.size(axis) == 1:
            return x
        return _ordered_sum(self._gather(x, axis), x.dtype)

    def reduce_scatter(self, x, axis: str, dim: int):
        import torch
        import torch.distributed as dist

        n = self.size(axis)
        if n == 1:
            return x
        send = self._out(torch.stack([c.contiguous()
                                      for c in x.chunk(n, dim)]))
        recv = torch.empty_like(send)
        t0 = time.perf_counter()
        dist.all_to_all_single(recv, send, group=self._groups[axis])
        self._clock("backend", t0)
        self.bytes[axis] += send.numel() * send.element_size()
        return _ordered_sum(self._back(recv), x.dtype)

    def all_max(self, x, axis: str):
        import torch.distributed as dist

        if self.size(axis) == 1:
            return x
        t = self._out(x.clone())
        t0 = time.perf_counter()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._groups[axis])
        self._clock("backend", t0)
        self.bytes[axis] += t.numel() * t.element_size()
        return self._back(t)


def _ordered_sum(stacked, dtype):
    """``stacked[0] + stacked[1] + ...`` in that order, in float32 for a
    16-bit float dtype, cast to ``dtype`` once."""
    import torch

    wide = (torch.float32 if dtype in (torch.bfloat16, torch.float16)
            else dtype)
    acc = stacked[0].to(wide)
    for part in stacked[1:]:
        acc = acc + part
    return acc.to(dtype)


# ---------------------------------------------------------------------------
# the launcher: one process a rank, the reference's sharded train step and
# serving under its serve specs
# ---------------------------------------------------------------------------

#: the trees a case can bring back, gathered whole: the weights and the
#: optimizer state after its steps, and ``grads``, the gradients of one
#: ``compute_grads`` on the initial state (taken before the steps)
TREES = ("params", "mu", "nu", "err", "grads")


@dataclass
class TrainCase:
    """One run of :func:`run_lm_mesh_cases`: ``steps`` steps of
    ``training.train.make_train_step(cfg, opt_cfg, microbatches)`` on the
    global ``batch`` from ``params`` (the JAX package's tree of numpy
    arrays, ``{port name: array or tensor}``, or an int: the seed of
    ``models.transformer.init_params``, each rank drawing the weights on
    its device and keeping its shards) and ``opt`` (the
    reference's state tree, the port's ``init_train_state`` form, or None:
    zeros). ``repeats`` > 1 runs it again from the same state, each run
    held to the first's bits. ``keep`` names the ``TREES`` to bring back."""

    cfg: object
    params: object
    batch: dict
    opt: object = None
    opt_cfg: object = None
    steps: int = 1
    microbatches: int = 1
    repeats: int = 1
    keep: tuple = ("params", "mu", "nu", "err")


@dataclass
class TrainResult:
    """One case, gathered on the host: each kept tree ``{port name: CPU
    tensor}`` (None if not kept); ``metrics`` each step's ``loss``,
    ``aux``, ``grad_norm`` and ``lr`` (every rank's are the same: rank
    0's), with MoE layers ``dropped`` and ``load`` (each layer's dropped
    copies of the global batch and its copies an expert),
    ``grads_metrics`` the gradient pass's; ``ranks`` a dict a rank:
    ``resident_bytes`` (its shards of the weights, moments, step and
    batch), ``bytes`` (``GRID_BYTES`` over the first run's steps) and
    ``collective_seconds`` (``GRID_SECONDS``, the same),
    ``peak_bytes`` (None on the CPU), ``step_seconds``, ``load_s``, with
    ``grads`` kept ``grads_seconds``, ``grads_bytes`` and
    ``grads_collective_seconds`` (the gradient pass's),
    ``shards`` (each weight's shard shape) and
    ``repeats`` (each later run's ``metrics``, step ``seconds`` and the
    leaves ``differ``ing from the first's, as ``tree.name``), ``save_s``
    (writing its outputs)."""

    params: dict | None
    mu: dict | None
    nu: dict | None
    err: dict | None
    grads: dict | None
    metrics: list
    grads_metrics: dict | None
    ranks: list
    startup: list | None = None  # run_train_mesh's: LMMeshRun.startup


@dataclass
class ServeCase:
    """One serving run of :func:`run_lm_mesh_cases`, the reference's
    ``prefill`` and ``decode_step`` under ``param_specs(mode="serve")`` and
    ``cache_specs_tree``: a prefill over ``prompts`` (B, S) (and
    ``media``), then ``steps - 1`` decode steps fed the tokens chosen on
    the card (greedy), or ``feed`` (B, steps - 1) where given; caches of
    ``cache_len`` positions (``S + steps`` by default; Whisper's decoder
    448). ``params`` as ``TrainCase``'s. ``repeats`` > 1 runs it again on
    fresh caches, each run held to the first's bits."""

    cfg: object
    params: object
    prompts: object
    steps: int
    media: object = None
    cache_len: int | None = None
    feed: object = None
    repeats: int = 1


@dataclass
class ServeResult:
    """One serving case, gathered on the host: ``logits`` (B, steps,
    vocab) float32, the prefill's first; ``tokens`` (B, steps) int32, each
    step's argmax; ``dropped`` a call (the prefill, then each decode step)
    of each MoE layer's dropped copies of the global batch; ``ranks`` a
    dict a rank: ``resident_bytes`` (``params``, ``caches``, and the
    inputs of a prefill, ``prefill_inputs``: its prompt and media rows, and
    of a decode step, ``decode_inputs``: its token rows and the int32
    position, as the reference passes them), ``bytes`` and
    ``collective_seconds`` of the prefill and of the decode steps
    (``GRID_BYTES``, ``GRID_SECONDS``), ``prefill_seconds``,
    ``step_seconds``, ``peak_bytes`` (None on the CPU), ``load_s``,
    ``shards`` (each weight's and cache leaf's shard shape), ``repeats``
    (each later run's ``differ``: whether its logits or tokens differ from
    the first's bits), ``save_s``."""

    logits: object
    tokens: object
    dropped: list
    ranks: list
    startup: list | None = None  # run_serve_mesh's: LMMeshRun.startup


@dataclass
class LMMeshRun:
    results: list  # a TrainResult or ServeResult a case
    #: per rank: spawn_to_main_s (interpreter and imports), import_s,
    #: rendezvous_s, spawn_to_first_s (to the first case's first step)
    startup: list
    devices: list  # the CUDA_VISIBLE_DEVICES each rank got ("" on the CPU)
    shards_s: float  # the launcher's splitting and writing of the shards
    seconds: float  # first spawn to the last rank's exit
    gather_s: float  # reading the ranks' outputs and joining them


def _case_in(workdir: str, case: int, rank: int) -> str:
    return os.path.join(workdir, f"case-{case}-in-{rank}.pt")


def _case_out(workdir: str, case: int, rank: int, ext: str) -> str:
    return os.path.join(workdir, f"case-{case}-out-{rank}.{ext}")


def _global_state(cfg, opt) -> dict | None:
    """The port's state form (``mu``, ``nu``, ``err``: ``{name: tensor}``;
    ``step``) from either package's, or None."""
    import torch

    from repro_torch import convert

    if opt is None:
        return None
    if "groups" in opt["mu"]:
        return convert.train_state_from_arrays(cfg, opt, device="cpu")
    return {k: (torch.as_tensor(v).cpu() if k == "step" else
                {n: torch.as_tensor(t).cpu() for n, t in v.items()})
            for k, v in opt.items()}


def _write_shards(workdir: str, c: int, case, mesh) -> None:
    """Each rank's file of the case: its shards of the weights and, for a
    train case, the state and the batch, for a serving case the prompt,
    media and fed tokens, as its specs split them."""
    import torch

    from repro_torch import convert

    serve = isinstance(case, ServeCase)
    specs = param_specs(case.cfg, mesh, "serve" if serve else "train")
    params = (None if isinstance(case.params, int)
              else convert.lm_named_tensors(case.cfg, case.params))
    if serve:
        batch = {"prompts": torch.as_tensor(case.prompts).to(torch.int32)}
        if case.media is not None:
            batch["media"] = torch.as_tensor(case.media).to(case.cfg.dtype)
        if case.feed is not None:
            batch["feed"] = torch.as_tensor(case.feed).to(torch.int32)
        state = None
    else:
        batch = {k: torch.as_tensor(v).cpu() for k, v in case.batch.items()}
        state = _global_state(case.cfg, case.opt)
    bspecs = batch_specs_tree(batch, mesh)
    for r in range(mesh.size):
        out = dict(batch=convert.shard_named(batch, bspecs, mesh, r))
        if params is not None:
            out["params"] = convert.shard_named(params, specs, mesh, r)
        if state is not None:
            out.update({k: convert.shard_named(state[k], specs, mesh, r)
                        for k in ("mu", "nu", "err") if k in state})
            out["step"] = state["step"]
        torch.save(out, _case_in(workdir, c, r))


def run_train_mesh(cfg, arrays, opt, batch, mesh_shape, steps: int = 1,
                   device=None, backend: str | None = None, gpus=None, **kw):
    """The reference's sharded train step (``param_specs`` / ``batch_specs_tree``,
    mode ``train``) on a ``(data, model)`` mesh of processes: one
    :class:`TrainCase` (``kw``: its other fields) on
    :func:`run_lm_mesh_cases` (``kw``: ``workdir``, ``timeout`` too).
    Returns its :class:`TrainResult`, the run's start-up a rank as
    ``.startup``."""
    spawn = {k: kw.pop(k) for k in ("workdir", "timeout") if k in kw}
    run = run_lm_mesh_cases(
        [TrainCase(cfg, arrays, batch, opt, steps=steps, **kw)], mesh_shape,
        device=device, backend=backend, gpus=gpus, **spawn)
    res = run.results[0]
    res.startup = run.startup
    return res


def run_serve_mesh(cfg, arrays, prompts, mesh_shape, steps: int, media=None,
                   device=None, backend: str | None = None, gpus=None,
                   **kw):
    """The reference's ``prefill`` and ``decode_step`` under its ``serve``
    specs (``param_specs(mode="serve")``, ``cache_specs_tree``) on a
    ``(data, model)`` mesh of processes: greedy serving of ``prompts``
    (B, S) for ``steps`` tokens, one :class:`ServeCase` (``kw``: its other
    fields) on :func:`run_lm_mesh_cases` (``kw``: ``workdir``, ``timeout``
    too). Returns its :class:`ServeResult`, the run's start-up a rank as
    ``.startup``."""
    spawn = {k: kw.pop(k) for k in ("workdir", "timeout") if k in kw}
    run = run_lm_mesh_cases(
        [ServeCase(cfg, arrays, prompts, steps, media, **kw)], mesh_shape,
        device=device, backend=backend, gpus=gpus, **spawn)
    res = run.results[0]
    res.startup = run.startup
    return res


def _check_case(case, mesh) -> None:
    """Refuse what a case cannot run: trees it cannot keep, a serving
    batch that 'data' does not divide (each data rank serves its rows), a
    decode with no step or past its caches."""
    if isinstance(case, TrainCase):
        bad = set(case.keep) - set(TREES)
        if bad:
            raise ValueError(f"keep {sorted(bad)}: not among {TREES}")
        return
    B, S = case.prompts.shape
    D = mesh.axis_size("data")
    if B % D:
        raise ValueError(f"{case.cfg.name}: a batch of {B} requests does not "
                         f"divide over 'data' of {D}")
    if case.steps < 1:
        raise ValueError(f"{case.cfg.name}: {case.steps} steps: at least 1")
    if case.feed is not None and tuple(case.feed.shape) != (B,
                                                            case.steps - 1):
        raise ValueError(f"feed {tuple(case.feed.shape)}: (B, steps - 1) = "
                         f"{(B, case.steps - 1)}")
    if case.cfg.n_enc_layers == 0 and S + case.steps - 1 > _cache_len(case):
        raise ValueError(f"{case.cfg.name}: {S} + {case.steps - 1} positions "
                         f"pass a cache of {_cache_len(case)}")


def _cache_len(case) -> int:
    if case.cache_len is not None:
        return case.cache_len
    return case.prompts.shape[1] + case.steps


def _serve_result(reports: list, outs: list, mesh) -> ServeResult:
    """A serving case's rows from each data rank's first 'model' rank."""
    import torch

    lead = [d * mesh.shape[1] for d in range(mesh.shape[0])]
    return ServeResult(
        logits=torch.cat([outs[r]["logits"] for r in lead]),
        tokens=torch.cat([outs[r]["tokens"] for r in lead]),
        dropped=reports[0]["dropped"],
        ranks=[{k: v for k, v in rep.items() if k != "dropped"}
               for rep in reports])


def run_lm_mesh_cases(cases, mesh_shape, *, device=None,
                      backend: str | None = None, gpus=None,
                      workdir: str | None = None,
                      timeout: float = 600.0) -> LMMeshRun:
    """Run each case, a :class:`TrainCase` or a :class:`ServeCase`, in
    turn on one mesh of ``data × model`` processes (one spawn): a
    :class:`TrainResult` or :class:`ServeResult` a case. ``device="cpu"``
    means gloo on the CPU; else the ranks run on CUDA (the default, which
    raises without it) over NCCL, one GPU a rank (fewer GPUs than ranks
    raises: it never drops to gloo), or over ``backend="gloo"`` with the
    ranks sharing ``gpus`` (default the visible ones; rank r takes
    ``gpus[r % len(gpus)]``) through host buffers. Rank r is ``(r //
    model, r % model)``. ``workdir`` (default a temporary directory,
    removed after) holds the shards, each rank's log ``rank-r.log`` and
    its outputs. A rank that fails, or a run past ``timeout`` seconds
    (also each collective's deadline), fails the run
    (``launch.mesh.MeshFailed``) with the rank's log tail."""
    import torch

    from repro_torch import convert
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import (
        _free_port, _read_json, _spawn_and_wait, visible_gpus,
    )

    mesh = abstract_mesh(mesh_shape)
    if mesh.axis_names != ("data", "model"):
        raise ValueError(f"mesh {mesh_shape}: (data, model)")
    dev = resolve_device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"a mesh runs on cpu or cuda, not {dev}")
    backend = backend or ("gloo" if dev.type == "cpu" else "nccl")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: gloo or nccl")
    n = mesh.size
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL runs on CUDA; device='cpu' means gloo")
        devices = [""] * n
    else:
        ids = [str(g) for g in (visible_gpus() if gpus is None else gpus)]
        if not ids:
            raise RuntimeError("no GPU to run the mesh on")
        if backend == "nccl" and len(ids) < n:
            raise ValueError(f"NCCL runs one rank a GPU: {n} ranks, "
                             f"{len(ids)} GPUs {ids}")
        devices = [ids[r % len(ids)] for r in range(n)]
    for case in cases:
        _check_case(case, mesh)
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="repro-lm-mesh-") if own else workdir
    os.makedirs(workdir, exist_ok=True)
    try:
        t0 = time.perf_counter()
        meta = []
        for c, case in enumerate(cases):
            _write_shards(workdir, c, case, mesh)
            seed = case.params if isinstance(case.params, int) else None
            if isinstance(case, ServeCase):
                meta.append(dataclasses.replace(
                    case, params=seed, cache_len=_cache_len(case),
                    prompts=None, media=None, feed=None))
            else:
                meta.append(dataclasses.replace(case, params=seed, opt=None,
                                                batch={}))
        shards_s = time.perf_counter() - t0
        with open(os.path.join(workdir, "cases.pkl"), "wb") as fh:
            pickle.dump(meta, fh)
        with open(os.path.join(workdir, "spec.json"), "w") as fh:
            json.dump(dict(mesh_shape=list(mesh.shape), backend=backend,
                           device=dev.type, port=_free_port(),
                           timeout=float(timeout)), fh)
        t0 = time.perf_counter()
        _spawn_and_wait(workdir, devices, timeout,
                        module="repro_torch.launch.lm_mesh")
        seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        results = []
        for c, case in enumerate(cases):
            reports = [_read_json(_case_out(workdir, c, r, "json"))
                       for r in range(n)]
            # mapped, not read: the join copies each shard once
            outs = [torch.load(_case_out(workdir, c, r, "pt"), mmap=True,
                               weights_only=True) for r in range(n)]
            if isinstance(case, ServeCase):
                results.append(_serve_result(reports, outs, mesh))
                continue
            specs = param_specs(case.cfg, mesh)
            trees = {t: (convert.gather_named([o[t] for o in outs], specs,
                                              mesh)
                         if t in outs[0] else None) for t in TREES}
            del outs
            results.append(TrainResult(
                **trees, metrics=reports[0]["metrics"],
                grads_metrics=reports[0]["grads_metrics"],
                ranks=[{k: v for k, v in rep.items()
                        if k not in ("metrics", "grads_metrics")}
                       for rep in reports]))
        return LMMeshRun(
            results=results,
            startup=[_read_json(os.path.join(workdir, f"startup-{r}.json"))
                     for r in range(n)],
            devices=devices, shards_s=shards_s, seconds=seconds,
            gather_s=time.perf_counter() - t0)
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# the rank process
# ---------------------------------------------------------------------------

def _floats(metrics: dict, model) -> dict:
    """A pass's metrics as floats, and with MoE layers ``dropped`` and
    ``load``: each one's dropped copies of the global batch (its last
    slice's) and the copies bound for each expert, in stack order."""
    out = {k: float(v) for k, v in metrics.items()}
    drops = model.moe_dropped()
    if drops:
        out.update(dropped=drops, load=model.moe_loads())
    return out


def _rank_case(grid, case: TrainCase, path: str, device) -> tuple:
    """Run one case on this rank: ``(outputs, report)``."""
    import torch

    from repro_torch.models.transformer import Transformer, init_weights
    from repro_torch.training.compress import init_error_buffer
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train import (
        compute_grads, init_train_state, make_train_step,
    )

    cfg, cuda = case.cfg, device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    specs = grid.param_specs(cfg)

    def shard(name, t):
        return t[shard_index(specs[name], t.shape, grid.mesh,
                             grid.rank)].clone()

    def load():
        z = torch.load(path, map_location=device, weights_only=True)
        if isinstance(case.params, int):
            z["params"] = init_weights(cfg, case.params, device, shard)
        model = Transformer(cfg, z["params"], grid=grid)
        if "mu" not in z:
            opt = init_train_state(cfg, model)
        else:
            opt = {k: z[k] for k in ("mu", "nu", "step")}
            if cfg.grad_compress:
                opt["err"] = z.get("err") or init_error_buffer(z["params"])
        return model, opt, z["batch"]

    def trees(model, opt, names) -> dict:
        state = dict(params=dict(model.named_parameters()), **{
            k: opt[k] for k in ("mu", "nu", "err") if k in opt})
        return {t: {k: v.detach().cpu() for k, v in state[t].items()}
                for t in names if t in state}

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, opt, batch = load()
    load_s = time.perf_counter() - t0
    held = (list(model.parameters()) + [opt["step"]] + list(batch.values())
            + [t for k in ("mu", "nu", "err") if k in opt
               for t in opt[k].values()])
    report = dict(resident_bytes=sum(t.numel() * t.element_size()
                                     for t in held),
                  shards={k: list(p.shape) for k, p in
                          model.named_parameters()},
                  load_s=load_s, grads_metrics=None, repeats=[])
    out = {}
    if "grads" in case.keep:
        grid.reset()
        sync()
        t0 = time.perf_counter()
        grads, gm = compute_grads(model, batch, case.microbatches)
        sync()
        report.update(grads_seconds=time.perf_counter() - t0,
                      grads_bytes=dict(grid.bytes),
                      grads_collective_seconds=dict(grid.seconds))
        out["grads"] = {k: g.cpu() for k, g in grads.items()}
        report["grads_metrics"] = _floats(gm, model)
        del grads
    step = make_train_step(cfg, case.opt_cfg or AdamWConfig(),
                           case.microbatches)
    for rep in range(case.repeats):
        if rep:
            del model, opt
            model, opt, batch = load()
        grid.reset()
        metrics, seconds = [], []
        sync()
        for _ in range(case.steps):
            sync()
            t0 = time.perf_counter()
            model, opt, m = step(model, opt, batch)
            sync()
            seconds.append(time.perf_counter() - t0)
            metrics.append(_floats(m, model))
        if rep == 0:
            first = trees(model, opt, TREES if case.repeats > 1
                          else case.keep)
            report.update(metrics=metrics, step_seconds=seconds,
                          bytes=dict(grid.bytes),
                          collective_seconds=dict(grid.seconds),
                          peak_bytes=(torch.cuda.max_memory_allocated()
                                      if cuda else None))
            continue
        now = trees(model, opt, first)
        report["repeats"].append(dict(metrics=metrics, seconds=seconds, differ=[
            f"{t}.{k}" for t in first for k in first[t]
            if not torch.equal(first[t][k], now[t][k])]))
    out.update({t: first[t] for t in case.keep if t in first})
    return out, report


def _rank_serve(grid, case: ServeCase, path: str, device) -> tuple:
    """Run one serving case on this rank: ``(outputs, report)``; the
    outputs' logits and tokens on the first 'model' rank of each data
    rank (the others hold the same bits)."""
    import torch

    from repro_torch.models.transformer import Transformer, init_weights
    from repro_torch.serving.cache import (
        cache_bytes, cache_leaves, make_caches,
    )
    from repro_torch.serving.engine import decode_step, prefill

    cfg, cuda = case.cfg, device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    specs = grid.param_specs(cfg, "serve")

    def shard(name, t):
        return t[shard_index(specs[name], t.shape, grid.mesh,
                             grid.rank)].clone()

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    z = torch.load(path, map_location=device, weights_only=True)
    if isinstance(case.params, int):
        z["params"] = init_weights(cfg, case.params, device, shard)
    model = Transformer(cfg, z["params"], grid=grid, mode="serve")
    load_s = time.perf_counter() - t0
    batch = z["batch"]
    prompt, media, feed = (batch["prompts"], batch.get("media"),
                           batch.get("feed"))
    B = prompt.shape[0] * grid.size("data")  # _check_case: it divides
    n_media = None if media is None else media.shape[1]

    def run():
        caches = make_caches(cfg, B, case.cache_len, n_media, device,
                             grid=grid)
        grid.reset()
        sync()
        t0 = time.perf_counter()
        logits = [prefill(model, prompt, caches, media)]
        drops = [model.moe_dropped()]
        sync()
        pre = dict(seconds=time.perf_counter() - t0, bytes=dict(grid.bytes),
                   collective_seconds=dict(grid.seconds))
        grid.reset()
        toks = [logits[0].argmax(-1, keepdim=True).to(torch.int32)]
        seconds = []
        for i in range(case.steps - 1):
            tok = toks[-1] if feed is None else feed[:, i:i + 1]
            sync()
            t0 = time.perf_counter()
            logits.append(decode_step(model, caches, tok,
                                      prompt.shape[1] + i))
            drops.append(model.moe_dropped())
            sync()
            seconds.append(time.perf_counter() - t0)
            toks.append(logits[-1].argmax(-1, keepdim=True).to(torch.int32))
        dec = dict(seconds=seconds, bytes=dict(grid.bytes),
                   collective_seconds=dict(grid.seconds))
        return (torch.stack(logits, 1), torch.cat(toks, 1), drops, caches,
                pre, dec)

    logits, tokens, drops, caches, pre, dec = run()
    inputs = [prompt] + ([] if media is None else [media])
    report = dict(
        resident_bytes=dict(
            params=sum(p.numel() * p.element_size()
                       for p in model.parameters()),
            caches=cache_bytes(caches),
            prefill_inputs=sum(t.numel() * t.element_size() for t in inputs),
            decode_inputs=prompt.shape[0] * 4 + 4),
        shards={**{k: list(p.shape) for k, p in model.named_parameters()},
                **{k: list(t.shape) for k, t in cache_leaves(caches)}},
        load_s=load_s, dropped=drops, prefill_seconds=pre["seconds"],
        step_seconds=dec["seconds"],
        bytes=dict(prefill=pre["bytes"], decode=dec["bytes"]),
        collective_seconds=dict(prefill=pre["collective_seconds"],
                                decode=dec["collective_seconds"]),
        peak_bytes=torch.cuda.max_memory_allocated() if cuda else None,
        repeats=[])
    del caches
    for _ in range(case.repeats - 1):
        again = run()
        report["repeats"].append(dict(differ=not (
            torch.equal(again[0], logits) and torch.equal(again[1], tokens))))
        del again
    out = {}
    if grid.index("model") == 0:
        out = dict(logits=logits.cpu(), tokens=tokens.cpu())
    return out, report


def rank_main(workdir: str, rank: int, spawned: float) -> int:
    # analysis: allow[liveness-clock] a start-up report, no deadline
    spawn_to_main_s = time.time() - spawned
    print(f"rank {rank} pid {os.getpid()}", flush=True)
    with open(os.path.join(workdir, "spec.json")) as fh:
        spec = json.load(fh)
    t0 = time.perf_counter()
    import datetime

    import torch
    import torch.distributed as dist

    import_s = time.perf_counter() - t0
    shape = tuple(spec["mesh_shape"])
    n, backend = math.prod(shape), spec["backend"]
    if spec["device"] == "cuda":
        if not torch.cuda.is_available():
            # never the CPU in place of the card the caller asked for
            gpu = os.environ.get("CUDA_VISIBLE_DEVICES")
            raise RuntimeError(f"rank {rank}: no CUDA device "
                               f"(CUDA_VISIBLE_DEVICES={gpu!r})")
        torch.cuda.set_device(0)
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    t0 = time.perf_counter()
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{int(spec['port'])}",
        rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=float(spec["timeout"])))
    try:
        grid = ProcessGrid(shape, rank, backend=backend, device=device)
        grid.barrier()
        rendezvous_s = time.perf_counter() - t0
        with open(os.path.join(workdir, "cases.pkl"), "rb") as fh:
            cases = pickle.load(fh)  # written by this rank's launcher
        first = None
        for c, case in enumerate(cases):
            if first is None:
                # analysis: allow[liveness-clock] a start-up report
                first = time.time()
            if isinstance(case, ServeCase):
                out, report = _rank_serve(grid, case,
                                          _case_in(workdir, c, rank), device)
                print(f"rank {rank} case {c}: {case.cfg.name} served, "
                      f"prefill {report['prefill_seconds']:.3f} s, steps "
                      f"{report['step_seconds']} s", flush=True)
            else:
                out, report = _rank_case(grid, case,
                                         _case_in(workdir, c, rank), device)
                print(f"rank {rank} case {c}: {case.cfg.name} losses "
                      f"{[m['loss'] for m in report['metrics']]} "
                      f"{report['step_seconds']} s", flush=True)
            t0 = time.perf_counter()
            torch.save(out, _case_out(workdir, c, rank, "pt"))
            report["save_s"] = time.perf_counter() - t0
            with open(_case_out(workdir, c, rank, "json"), "w") as fh:
                json.dump(report, fh)
            del out
            if device.type == "cuda":
                torch.cuda.empty_cache()
        with open(os.path.join(workdir, f"startup-{rank}.json"), "w") as fh:
            json.dump(dict(spawn_to_main_s=spawn_to_main_s,
                           import_s=import_s, rendezvous_s=rendezvous_s,
                           spawn_to_first_s=(first - spawned
                                             if first is not None else None)),
                      fh)
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.lm_mesh")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rk = sub.add_parser("rank", help="run one rank of an LM mesh")
    rk.add_argument("workdir")
    rk.add_argument("rank", type=int)
    rk.add_argument("--spawned", type=float, required=True,
                    help="the launcher's wall clock at the spawn")
    args = ap.parse_args(argv)
    return rank_main(args.workdir, args.rank, args.spawned)


if __name__ == "__main__":
    # the module by its name, so the cases it unpickles are its classes
    from repro_torch.launch.lm_mesh import main as _main

    sys.exit(_main())
