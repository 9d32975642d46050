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


def lm_params_from_arrays(cfg, tree: dict, device=None):
    """The port's ``Transformer`` over the JAX package's LM params given as
    a tree of numpy arrays (``{embed, final_norm, [unembed], prologue:
    [layer], groups: [stacked layer a pattern position], [encoder: stacked
    layer, enc_final_norm]}``, a layer a dict of leaves and of groups of
    leaves: ``ln1``, ``attn: {wq, ...}``, ``ssm: {in_proj, ...}``,
    ``ffn: {...}``, ...). ``groups[pi][...][g]`` becomes layer
    ``len(prologue) + g·len(pattern) + pi``, ``encoder[...][j]`` encoder
    layer j. bf16 arrays (ml_dtypes', told by their dtype's name) are
    carried bit for bit through a uint16 view. A tree whose names, shapes or
    dtypes do not match ``cfg`` is refused: every leaf is ``cfg.dtype`` but
    those the reference keeps in float32 (``param_dtype``)."""
    from repro_torch.models.transformer import Transformer, param_dtype

    device = resolve_device(device)
    n_pro, n_pat, G = len(cfg.prologue), len(cfg.pattern), cfg.n_pattern_groups
    if len(tree["prologue"]) != n_pro or len(tree["groups"]) != n_pat:
        raise ValueError(
            f"{cfg.name}: tree has {len(tree['prologue'])} prologue layers and "
            f"{len(tree['groups'])} pattern positions, the config {n_pro} and "
            f"{n_pat}")
    flat = {k: tree[k] for k in ("embed", "final_norm", "unembed",
                                 "enc_final_norm") if k in tree}

    def put(pre: str, d: dict, g: int | None = None, n: int = G,
            where: str = "") -> None:
        for key, val in d.items():
            for sub, a in (val.items() if isinstance(val, dict) else [("", val)]):
                a = np.asarray(a)
                if g is not None:
                    if a.shape[:1] != (n,):
                        raise ValueError(f"{cfg.name}: {where}.{key} stacks "
                                         f"{a.shape[:1]}, the config {n}")
                    a = a[g]
                flat[pre + key + (f".{sub}" if sub else "")] = a

    for li, d in enumerate(tree["prologue"]):
        put(f"layers.{li}.", d)
    for pi, d in enumerate(tree["groups"]):
        for g in range(G):
            put(f"layers.{n_pro + g * n_pat + pi}.", d, g,
                where=f"groups[{pi}]")
    if "encoder" in tree:
        for j in range(cfg.n_enc_layers):
            put(f"encoder.{j}.", tree["encoder"], j, cfg.n_enc_layers,
                "encoder")
    params = {}
    for name, a in flat.items():
        a = np.asarray(a)
        want = str(param_dtype(cfg, name)).removeprefix("torch.")
        if a.dtype.name != want:
            raise ValueError(f"{cfg.name}: {name} is {a.dtype.name}, "
                             f"the config says {want}")
        bf16 = a.dtype.name == "bfloat16"
        t = torch.from_numpy(np.require(a.view(np.uint16) if bf16 else a,
                                        requirements=["C", "W"]))
        params[name] = (t.view(torch.bfloat16) if bf16 else t).to(device)
    return Transformer(cfg, params)  # refuses other names or shapes
