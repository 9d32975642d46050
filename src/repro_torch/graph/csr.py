"""Graph container and CSR construction.

The on-host (pre-partitioning) representation mirrors the paper's HDFS input:
an edge list over *old* (possibly sparse) vertex IDs. ``build_csr`` produces the
indptr/indices arrays used by host-side preprocessing and by test oracles.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def sorted_unique(x: np.ndarray) -> np.ndarray:
    """``np.unique(x)`` for 1-D ints, by one sort: some numpy releases take
    a hash-table path in ``np.unique`` that is far slower at hundreds of
    millions of keys."""
    x = np.sort(x)
    if x.size:
        keep = np.empty(x.shape[0], dtype=bool)
        keep[0] = True
        np.not_equal(x[1:], x[:-1], out=keep[1:])
        x = x[keep]
    return x


@dataclass
class Graph:
    """An in-memory edge-list graph over (possibly sparse) old vertex IDs."""

    src: np.ndarray  # (E,) int64 old ids
    dst: np.ndarray  # (E,) int64 old ids
    weight: np.ndarray  # (E,) float32
    directed: bool = True
    # All vertex old-ids present (sources, targets, and isolated vertices if given).
    vertex_ids: np.ndarray = field(default=None)  # type: ignore[assignment]

    def __post_init__(self):
        self.src = np.asarray(self.src, dtype=np.int64)
        self.dst = np.asarray(self.dst, dtype=np.int64)
        if self.weight is None:
            self.weight = np.ones(self.src.shape[0], dtype=np.float32)
        self.weight = np.asarray(self.weight, dtype=np.float32)
        if self.vertex_ids is None:
            self.vertex_ids = sorted_unique(np.concatenate([self.src, self.dst]))
        else:
            self.vertex_ids = sorted_unique(
                np.asarray(self.vertex_ids, dtype=np.int64))
        if not self.directed:
            # Undirected graphs store both directions (paper: Γ(v) = all neighbours).
            fwd = np.stack([self.src, self.dst], axis=0)
            bwd = np.stack([self.dst, self.src], axis=0)
            both = np.concatenate([fwd, bwd], axis=1)
            w = np.concatenate([self.weight, self.weight])
            # dedupe (u,v) pairs
            key = both[0] * (both.max() + 1) + both[1]
            _, idx = np.unique(key, return_index=True)
            self.src, self.dst = both[0][idx], both[1][idx]
            self.weight = w[idx]
            self.directed = True  # now stored as a symmetric directed graph

    @property
    def n_vertices(self) -> int:
        return int(self.vertex_ids.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])


def build_csr(n_vertices: int, src: np.ndarray, dst: np.ndarray, weight: np.ndarray):
    """CSR over dense ids 0..n-1. Returns (indptr, indices, weights), sorted by src.

    Pure-numpy oracle used by tests and host preprocessing.
    """
    order = np.argsort(src, kind="stable")
    src, dst, weight = src[order], dst[order], weight[order]
    counts = np.bincount(src, minlength=n_vertices)
    indptr = np.zeros(n_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, dst.astype(np.int64), weight.astype(np.float32)
