"""Carry a partition and vertex state across from numpy arrays, so that the
port and the JAX package compute on identical inputs.

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
