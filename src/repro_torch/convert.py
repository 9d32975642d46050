"""Carry a partition and vertex state, or a language model's weights, across
from numpy arrays, so that the port and the JAX package compute on identical
inputs.

The arrays come from the JAX package's objects as
``np.asarray(getattr(pg, field))``; nothing here imports that package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.partition import PartitionedGraph

#: the static (non-tensor) fields of a PartitionedGraph
STATIC = ("n_shards", "n_vertices", "n_edges", "P", "E_cap", "edge_block",
          "n_blocks")
_DTYPES = dict(degree=np.int32, vmask=np.bool_, old_ids=np.int64,
               gids=np.int64, src_pos=np.int32, dst_pos=np.int32,
               eweight=np.float32, blk_lo=np.int32, blk_hi=np.int32)


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.require(a, dtype, ["C", "W"])).to(device)


def partition_from_arrays(d: dict[str, np.ndarray], static: dict,
                          device=None) -> PartitionedGraph:
    """The port's PartitionedGraph from ``{field: array}`` and the static
    fields ``{n_shards, n_vertices, n_edges, P, E_cap, edge_block,
    n_blocks}``. Ids widen to int64 (a JAX run without x64 holds them as
    int32)."""
    device = resolve_device(device)
    return PartitionedGraph(
        **{k: int(static[k]) for k in STATIC},
        **{f: _tensor(d[f], _DTYPES[f], device) for f in PartitionedGraph.TENSORS},
    )


def state_from_arrays(values: np.ndarray, active: np.ndarray, device=None):
    """(values, active) tensors from ``(n, P)`` arrays; values keep their
    dtype (float32 or int32), active becomes bool."""
    device = resolve_device(device)
    values = np.asarray(values)
    return _tensor(values, values.dtype, device), _tensor(active, np.bool_, device)


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (for the numpy-side stores, the
    planner's byte model and the job's identity file)."""
    return torch.empty(0, dtype=dtype).numpy().dtype


def keystr(path: tuple) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys and list indices:
    ``['groups'][0]['attn']['wq']``."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)


def lm_named_from_tree(cfg, tree: dict) -> dict[str, np.ndarray]:
    """The JAX package's LM param tree (``{embed, final_norm, [unembed],
    prologue: [layer], groups: [stacked layer a pattern position],
    [encoder: stacked layer, enc_final_norm]}``, a layer a dict of leaves
    and of groups of leaves: ``ln1``, ``attn: {wq, ...}``, ``ssm:
    {in_proj, ...}``, ``ffn: {...}``, ...) as ``{port name: array}``, the
    stacked leaves cut apart (views). Any tree of that shape: weights,
    gradients, moments or error buffers. A tree with other pattern
    positions, prologue layers or group counts is refused."""
    n_pro, n_pat, G = len(cfg.prologue), len(cfg.pattern), cfg.n_pattern_groups
    if len(tree["prologue"]) != n_pro or len(tree["groups"]) != n_pat:
        raise ValueError(
            f"{cfg.name}: tree has {len(tree['prologue'])} prologue layers and "
            f"{len(tree['groups'])} pattern positions, the config {n_pro} and "
            f"{n_pat}")
    from repro_torch.models.transformer import tree_slots

    slots = tree_slots(cfg)
    have = {p for p, _ in tree_leaves(tree)}
    want = {p for p, _ in slots.values()}
    if have != want:
        raise ValueError(
            f"{cfg.name}: params missing "
            f"{sorted(keystr(p) for p in want - have)}, unexpected "
            f"{sorted(keystr(p) for p in have - want)}")
    out = {}
    for name, (path, g) in slots.items():
        a = tree
        for k in path:
            a = a[k]
        a = np.asarray(a)
        if g is not None:
            n = cfg.n_enc_layers if path[0] == "encoder" else G
            if a.shape[:1] != (n,):
                raise ValueError(f"{cfg.name}: {keystr(path)} stacks "
                                 f"{a.shape[:1]}, the config {n}")
            a = a[g]
        out[name] = a
    return out


def tree_leaves(tree, path: tuple = ()):
    """``(path, leaf)`` of every leaf of a tree of dicts, lists and tuples,
    in their order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, path + (i,))
    else:
        yield path, tree


def lm_tree_from_named(cfg, named: dict) -> dict:
    """The inverse of ``lm_named_from_tree``: ``{port name: array}`` as the
    reference's tree, each pattern position's and the encoder's leaves
    stacked along a new first axis in group (layer) order."""
    from repro_torch.models.transformer import tree_slots

    tree: dict = {"prologue": [{} for _ in cfg.prologue],
                  "groups": [{} for _ in cfg.pattern]}
    stacks: dict[tuple, list] = {}
    for name, (path, g) in tree_slots(cfg).items():
        if g is None:
            _put(tree, path, named[name])
        else:
            stacks.setdefault(path, []).append(named[name])
    for path, leaves in stacks.items():
        _put(tree, path, np.stack(leaves))
    layers = tree["prologue"] + tree["groups"] + (
        [tree["encoder"]] if cfg.n_enc_layers else [])
    for layer in layers:  # a layer without an FFN has an empty one
        layer.setdefault("ffn", {})
    return tree


def _put(tree, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree[k] if isinstance(k, int) else tree.setdefault(k, {})
    tree[path[-1]] = value


def tensor_from_array(a: np.ndarray, device=None) -> torch.Tensor:
    """A tensor of ``a``: bf16 arrays (ml_dtypes', told by their dtype's
    name) carried bit for bit through a uint16 view."""
    a = np.asarray(a)
    bf16 = a.dtype.name == "bfloat16"
    t = torch.from_numpy(np.require(a.view(np.uint16) if bf16 else a,
                                    requirements=["C", "W"]))
    return (t.view(torch.bfloat16) if bf16 else t).to(resolve_device(device))


def array_from_tensor(t: torch.Tensor) -> np.ndarray:
    """A numpy array of ``t`` on the host; bf16 widened to float32, which
    holds its bits exactly (numpy has no bf16 of its own)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def lm_params_from_arrays(cfg, tree: dict, device=None):
    """The port's ``Transformer`` over the JAX package's LM params given as
    a tree of numpy arrays (``lm_named_from_tree``'s shape). bf16 arrays
    are carried bit for bit (``tensor_from_array``). A tree whose names,
    shapes or dtypes do not match ``cfg`` is refused: every leaf is
    ``cfg.dtype`` but those the reference keeps in float32
    (``param_dtype``)."""
    from repro_torch.models.transformer import Transformer, param_dtype

    device = resolve_device(device)
    params = {}
    for name, a in lm_named_from_tree(cfg, tree).items():
        want = str(param_dtype(cfg, name)).removeprefix("torch.")
        if a.dtype.name != want:
            raise ValueError(f"{cfg.name}: {name} is {a.dtype.name}, "
                             f"the config says {want}")
        params[name] = tensor_from_array(a, device)
    return Transformer(cfg, params)  # refuses other shapes


def lm_arrays_from_params(cfg, model) -> dict:
    """The reference's param tree of numpy arrays from the port's model:
    the inverse of ``lm_params_from_arrays``, bf16 widened to float32 bit
    for bit (``array_from_tensor``)."""
    return lm_tree_from_named(cfg, {k: array_from_tensor(p) for k, p in
                                    model.named_parameters()})


def train_state_from_arrays(cfg, opt_tree: dict, device=None) -> dict:
    """The port's training state (``training/train.py::init_train_state``'s
    form: ``mu``, ``nu`` and, with compression, ``err`` float32 a weight
    name; ``step`` int32) from the reference's, given as numpy arrays."""
    device = resolve_device(device)
    out = {k: {n: tensor_from_array(np.asarray(a, np.float32), device)
               for n, a in lm_named_from_tree(cfg, opt_tree[k]).items()}
           for k in ("mu", "nu", "err") if k in opt_tree}
    out["step"] = torch.tensor(int(np.asarray(opt_tree["step"])),
                               dtype=torch.int32, device=device)
    return out


def lm_named_tensors(cfg, params, device="cpu") -> dict[str, torch.Tensor]:
    """``{port name: tensor}`` of an LM's weights given as the JAX package's
    tree of numpy arrays, or as ``{port name: array or tensor}``; each of
    its ``param_dtype`` (bf16 carried bit for bit), or refused."""
    from repro_torch.models.transformer import param_dtype, param_shapes

    named = (lm_named_from_tree(cfg, params) if "groups" in params
             else dict(params))
    if set(named) != set(param_shapes(cfg)):
        raise ValueError(f"{cfg.name}: weights do not name the config's")
    out = {}
    for name, a in named.items():
        t = a if isinstance(a, torch.Tensor) else tensor_from_array(a, "cpu")
        if t.dtype != param_dtype(cfg, name):
            raise ValueError(f"{cfg.name}: {name} is {t.dtype}, the config "
                             f"says {param_dtype(cfg, name)}")
        out[name] = t.to(device)
    return out


def shard_named(named: dict, specs: dict, mesh, rank: int) -> dict:
    """Rank ``rank``'s shard of each leaf of ``{name: array or tensor}``
    under ``specs`` (``launch/lm_mesh.py::param_specs``) on ``mesh``: the
    slices ``shard_index`` gives, copied (a tensor view would carry its
    whole storage into ``torch.save``)."""
    from repro_torch.launch.lm_mesh import shard_index

    out = {}
    for k, a in named.items():
        part = a[shard_index(specs[k], a.shape, mesh, rank)]
        out[k] = part.clone() if isinstance(part, torch.Tensor) else part.copy()
    return out


def gather_named(ranks: list[dict], specs: dict, mesh) -> dict:
    """Each leaf whole from every rank's ``{name: shard}`` (in rank order):
    the inverse of ``shard_named``; replicated copies must agree bit for
    bit (``lm_mesh.gather_shards``). ``lm_tree_from_named`` makes the
    reference's tree of the result."""
    from repro_torch.launch.lm_mesh import gather_shards

    return {k: gather_shards([r[k] for r in ranks], specs[k], mesh)
            for k in ranks[0]}
