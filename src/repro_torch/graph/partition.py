"""Hash partitioning + per-destination edge groups + skip() block metadata.

The layout is the JAX package's (``repro/graph/partition.py``), array for
array; only the container differs:

* the in-memory state array ``A``: ``degree/vmask/old_ids/gids``, ``(n, P)``,
* the edge stream organized into ``n`` per-destination groups: group
  ``(i, k)`` holds shard i's edges whose destination lives on shard k,
  sorted by source position and padded to ``E_cap`` (a multiple of
  ``edge_block``), as ``src_pos/dst_pos/eweight`` of shape ``(n, n, E_cap)``,
* per-block source ranges ``blk_lo/blk_hi`` ``(n, n, n_blocks)``: a block can
  be skipped iff no vertex in ``[blk_lo, blk_hi]`` is active (§3.2).

Padded edge slots carry ``src_pos = -1``, ``dst_pos = 0`` and weight 0, so
they are compute-neutral. The host work is numpy; the arrays move to the
device once, at the end of ``build_partition``.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import ClassVar

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.csr import Graph
from repro_torch.graph.recode import RecodeMap, recode_ids
from repro_torch.kernels.run_sum import marked_order


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def block_ranges(sp_blocks: np.ndarray, P: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-block [min, max] source range over the trailing axis — the skip()
    metadata of §3.2. Sentinels (P, -1) mark empty blocks."""
    valid = sp_blocks >= 0
    lo = np.where(valid, sp_blocks, P).min(axis=-1).astype(np.int32)
    hi = np.where(valid, sp_blocks, -1).max(axis=-1).astype(np.int32)
    return lo, hi


@dataclass
class PartitionedGraph:
    """Partitioned graph; the leading axis of every tensor is the shard."""

    TENSORS: ClassVar[tuple[str, ...]] = (
        "degree", "vmask", "old_ids", "gids", "src_pos", "dst_pos",
        "eweight", "blk_lo", "blk_hi",
    )

    n_shards: int
    n_vertices: int
    n_edges: int
    P: int  # padded vertices per shard
    E_cap: int  # padded edges per group
    edge_block: int
    n_blocks: int

    degree: torch.Tensor  # (n, P) int32 — global out-degree d(v)
    vmask: torch.Tensor  # (n, P) bool — position holds a real vertex
    old_ids: torch.Tensor  # (n, P) int64 — original ids, -1 for holes
    gids: torch.Tensor  # (n, P) int64 — recoded global id, -1 for holes
    src_pos: torch.Tensor  # (n, n, E_cap) int32, -1 for padding
    dst_pos: torch.Tensor  # (n, n, E_cap) int32
    eweight: torch.Tensor  # (n, n, E_cap) float32
    blk_lo: torch.Tensor  # (n, n, n_blocks) int32 — min src_pos (P if empty)
    blk_hi: torch.Tensor  # (n, n, n_blocks) int32 — max src_pos (-1 if empty)

    @property
    def device(self) -> torch.device:
        return self.degree.device

    @property
    def n_rows(self) -> int:
        """Shards whose rows this object holds: ``n_shards``, or 1 for one
        rank's slice (:func:`shard_slice`), which keeps ``n_shards``."""
        return self.degree.shape[0]

    def to(self, device) -> "PartitionedGraph":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in self.TENSORS}
        )

    @functools.cached_property
    def dst_order(self) -> torch.Tensor:
        """``(rows, n, E_cap)`` int32: each edge group's slots in the stable
        order of their ``dst_pos``, the padding (``src_pos`` -1) last: the
        order in which the engine adds a group's float messages
        (``core/engine.py::_combine_scatter``), marked for
        ``run_sum(..., marked=True)`` (``kernels.run_sum.marked_order``;
        ``kernels.run_sum.unmark`` gives the slots). Sorted at first use,
        a row at a time, and kept: E_cap int32 a group. An abstract
        partition (on ``meta``) has no order to sort."""
        if self.device.type == "meta":
            raise ValueError("an abstract partition has no dst_order; the "
                             "dry run reckons its bytes from the shape")
        out = torch.empty(self.dst_pos.shape, dtype=torch.int32,
                          device=self.device)
        for r in range(self.n_rows):
            key = torch.where(self.src_pos[r] >= 0, self.dst_pos[r], self.P)
            out[r] = marked_order(key)
        return out

    @property
    def shape_summary(self) -> str:
        return (
            f"PartitionedGraph(n={self.n_shards}, |V|={self.n_vertices}, "
            f"|E|={self.n_edges}, P={self.P}, E_cap={self.E_cap}, "
            f"blocks={self.n_blocks}x{self.edge_block})"
        )


def build_partition(
    n: int,
    src_g: np.ndarray,  # (E,) edge sources, global recoded ids
    dst_g: np.ndarray,  # (E,) edge destinations, global recoded ids
    weight: np.ndarray,  # (E,)
    gids_real: np.ndarray,  # (V,) all real vertex global ids
    old_ids_real: np.ndarray,  # (V,) their original ids
    edge_block: int = 512,
    vertex_pad: int = 8,
    device=None,
) -> PartitionedGraph:
    """Assemble the layout from global-recoded-id edge/vertex arrays
    (shard = g mod n, pos = g // n)."""
    device = resolve_device(device)
    P = max(_round_up(int(gids_real.max()) // n + 1 if gids_real.size else 1,
                      vertex_pad), vertex_pad)
    src_shard, src_p = src_g % n, src_g // n
    dst_shard, dst_p = dst_g % n, dst_g // n

    deg_global = np.bincount(src_g, minlength=n * P).astype(np.int32)

    # group edges by (src_shard, dst_shard), sort each group by src position
    group_key = src_shard * n + dst_shard
    E = src_g.shape[0]
    if n * n * P * max(E, 1) < 2**63:
        # stable sort by (group, src position) as one unstable sort of keys
        # that carry the edge's index in their low digits
        packed = (group_key * P + src_p) * E + np.arange(E, dtype=np.int64)
        order = np.sort(packed) % max(E, 1)
        del packed
    else:
        order = np.lexsort((src_p, group_key))
    gk, sp, dp, w = group_key[order], src_p[order], dst_p[order], weight[order]
    del order, group_key, src_shard, src_p, dst_shard, dst_p
    counts = np.bincount(gk, minlength=n * n)
    E_cap = max(_round_up(int(counts.max()) if counts.size else 0, edge_block),
                edge_block)
    n_blocks = E_cap // edge_block

    src_pos = np.full((n, n, E_cap), -1, dtype=np.int32)
    dst_pos = np.zeros((n, n, E_cap), dtype=np.int32)
    eweight = np.zeros((n, n, E_cap), dtype=np.float32)
    offs = np.zeros(n * n + 1, dtype=np.int64)
    np.cumsum(counts, out=offs[1:])
    for i in range(n):
        for k in range(n):
            a, b = offs[i * n + k], offs[i * n + k + 1]
            c = b - a
            src_pos[i, k, :c] = sp[a:b]
            dst_pos[i, k, :c] = dp[a:b]
            eweight[i, k, :c] = w[a:b]
    del gk, sp, dp, w

    blk_lo, blk_hi = block_ranges(
        src_pos.reshape(n, n, n_blocks, edge_block), P
    )

    degree = np.zeros((n, P), dtype=np.int32)
    vmask = np.zeros((n, P), dtype=bool)
    old_ids = np.full((n, P), -1, dtype=np.int64)
    gid_arr = np.full((n, P), -1, dtype=np.int64)
    degree[gids_real % n, gids_real // n] = deg_global[gids_real]
    vmask[gids_real % n, gids_real // n] = True
    old_ids[gids_real % n, gids_real // n] = old_ids_real
    gid_arr[gids_real % n, gids_real // n] = gids_real

    t = lambda a: torch.from_numpy(a).to(device)
    return PartitionedGraph(
        n_shards=n,
        n_vertices=int(gids_real.shape[0]),
        n_edges=int(src_g.shape[0]),
        P=P,
        E_cap=E_cap,
        edge_block=edge_block,
        n_blocks=n_blocks,
        degree=t(degree),
        vmask=t(vmask),
        old_ids=t(old_ids),
        gids=t(gid_arr),
        src_pos=t(src_pos),
        dst_pos=t(dst_pos),
        eweight=t(eweight),
        blk_lo=t(blk_lo),
        blk_hi=t(blk_hi),
    )


def partition_graph(
    g: Graph,
    n_shards: int,
    edge_block: int = 512,
    vertex_pad: int = 8,
    recode: RecodeMap | None = None,
    device=None,
) -> tuple[PartitionedGraph, RecodeMap]:
    """Preprocess on the host (the paper's loading + ID-recoding pass) and
    place the partition on ``device`` (default: CUDA)."""
    device = resolve_device(device)
    rmap = recode if recode is not None else recode_ids(g.vertex_ids, n_shards)
    pg = build_partition(
        n_shards,
        rmap.to_new(g.src),
        rmap.to_new(g.dst),
        g.weight,
        rmap.new_for_old_sorted,
        rmap.old_sorted,
        edge_block=edge_block,
        vertex_pad=vertex_pad,
        device=device,
    )
    return pg, rmap


def drop_edges(pg: PartitionedGraph) -> PartitionedGraph:
    """Vertex-only view of a partition: the O(|V|/n) state array survives,
    the O(|E|) edge groups become zero-length placeholders. The static
    geometry still describes the dropped layout."""
    n, dev = pg.n_shards, pg.device
    return dataclasses.replace(
        pg,
        src_pos=torch.full((n, n, 0), -1, dtype=torch.int32, device=dev),
        dst_pos=torch.zeros((n, n, 0), dtype=torch.int32, device=dev),
        eweight=torch.zeros((n, n, 0), dtype=torch.float32, device=dev),
        blk_lo=torch.zeros((n, n, 0), dtype=torch.int32, device=dev),
        blk_hi=torch.zeros((n, n, 0), dtype=torch.int32, device=dev),
    )


def shard_slice(pg: PartitionedGraph, shard: int) -> PartitionedGraph:
    """Shard ``shard``'s rows of every tensor (a leading axis of 1, views of
    ``pg``'s), as one rank of a mesh holds them; ``n_shards`` stays n, the
    destinations of its edge groups."""
    if pg.n_rows != pg.n_shards:
        raise ValueError(f"{pg.shape_summary} holds {pg.n_rows} rows: "
                         "already a slice")
    if not 0 <= shard < pg.n_shards:
        raise ValueError(f"shard {shard} of {pg.n_shards}")
    return dataclasses.replace(pg, **{
        f: getattr(pg, f)[shard:shard + 1] for f in pg.TENSORS})


def _static_fields() -> tuple[str, ...]:
    return tuple(f.name for f in dataclasses.fields(PartitionedGraph)
                 if f.name not in PartitionedGraph.TENSORS)


def write_shard_slice(pg: PartitionedGraph, shard: int, path: str) -> None:
    """Write :func:`shard_slice` of ``pg`` to ``path`` (an ``.npz`` of the
    port's own: the nine tensors, the scalars and the shard index)."""
    part = shard_slice(pg, shard)
    arrays = {f: getattr(part, f).cpu().numpy() for f in pg.TENSORS}
    arrays.update({f: np.int64(getattr(pg, f)) for f in _static_fields()})
    with open(path, "wb") as fh:
        np.savez(fh, shard=np.int64(shard), **arrays)


def load_shard_slice(path: str, device=None) -> tuple[PartitionedGraph, int]:
    """``(slice, shard)`` from :func:`write_shard_slice`'s file, on
    ``device`` (default: CUDA)."""
    device = resolve_device(device)
    with np.load(path) as z:
        static = {f: int(z[f]) for f in _static_fields()}
        tensors = {f: torch.from_numpy(z[f]).to(device)
                   for f in PartitionedGraph.TENSORS}
        shard = int(z["shard"])
    return PartitionedGraph(**static, **tensors), shard


def spill_partition(pg: PartitionedGraph, directory: str,
                    compress: bool = False, compress_payload: bool = False):
    """Write the edge groups of ``pg`` to an on-disk ``EdgeStreamStore`` and
    return ``(vertex_only_pg, store)``: the paper's partition-time spill.
    Edges are written once, sequentially, in the per-destination group
    layout, and streamed back every superstep. ``pg`` may lie on any
    device; its groups reach the host one at a time, and the vertex-only
    partition stays on ``pg``'s device. ``compress=True`` varint-delta
    encodes the position channels; ``compress_payload=True``
    payload-encodes the weight channel (both ``streams/codec.py``, both
    lossless)."""
    from repro_torch.streams.store import EdgeStreamStore  # streams -> partition

    store = EdgeStreamStore.from_partition(
        pg, directory, compress=compress, compress_payload=compress_payload,
    )
    return drop_edges(pg), store


def partition_graph_streamed(
    g: Graph,
    n_shards: int,
    spill_dir: str,
    edge_block: int = 512,
    vertex_pad: int = 8,
    recode: RecodeMap | None = None,
    compress: bool = False,
    compress_payload: bool = False,
    device=None,
):
    """``partition_graph`` for the out-of-core path: partitions in host
    memory, spills the edge streams to ``spill_dir``, and only then moves
    the O(|V|/n) vertex arrays to ``device`` (default: CUDA); no edge
    tensor reaches the device. Returns ``(pg, rmap, store)``."""
    device = resolve_device(device)
    pg_host, rmap = partition_graph(
        g, n_shards, edge_block=edge_block, vertex_pad=vertex_pad,
        recode=recode, device="cpu",
    )
    pg, store = spill_partition(pg_host, spill_dir, compress=compress,
                                compress_payload=compress_payload)
    del pg_host
    return pg.to(device), rmap, store


def partition_for_plan(g: Graph, plan, spill_dir: str,
                       recode: RecodeMap | None = None, device=None):
    """Materialize the physical layout a ``core.plan.ExecutionPlan`` chose:
    hash-partition with the plan's geometry knobs and, when the plan picked
    the out-of-core mode, spill the edge groups to ``spill_dir`` (compressed
    iff the plan says so). Returns ``(pg, rmap, store)``, ``store`` None for
    the in-memory modes; ``core.job.GraphDJob`` builds every mode through
    it."""
    if plan.mode == "streamed":
        return partition_graph_streamed(
            g, plan.n_shards, spill_dir, edge_block=plan.edge_block,
            vertex_pad=plan.vertex_pad, recode=recode,
            compress=plan.compress,
            compress_payload=bool(plan.compress_payload), device=device,
        )
    pg, rmap = partition_graph(
        g, plan.n_shards, edge_block=plan.edge_block,
        vertex_pad=plan.vertex_pad, recode=recode, device=device,
    )
    return pg, rmap, None


def abstract_partitioned_graph(
    n_shards: int,
    n_vertices: int,
    n_edges: int,
    edge_block: int = 4096,
    vertex_pad: int = 128,
    skew: float = 1.5,
) -> PartitionedGraph:
    """A partition of shapes and dtypes alone, for the dry run: every tensor
    lies on PyTorch's ``meta`` device (the counterpart of the reference's
    ``jax.ShapeDtypeStruct``), so nothing is allocated.

    P = ⌈V/n⌉ rounded up to ``vertex_pad``; E_cap = ``int(E/n² · skew)``
    rounded up to ``edge_block`` (``skew`` models the largest group over
    the mean one), each at least one pad or block, as the reference
    reckons them (``repro/graph/partition.py::abstract_partitioned_graph``).
    Its ``dst_order`` refuses: the dry run reckons its bytes from the
    shape (``launch/dryrun.py``)."""
    n = n_shards
    P = max(_round_up((n_vertices + n - 1) // n, vertex_pad), vertex_pad)
    mean_group = n_edges / (n * n)
    E_cap = max(_round_up(int(mean_group * skew), edge_block), edge_block)
    n_blocks = E_cap // edge_block
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                            device="meta")
    return PartitionedGraph(
        n_shards=n, n_vertices=n_vertices, n_edges=n_edges, P=P,
        E_cap=E_cap, edge_block=edge_block, n_blocks=n_blocks,
        degree=meta((n, P), torch.int32),
        vmask=meta((n, P), torch.bool),
        old_ids=meta((n, P), torch.int64),
        gids=meta((n, P), torch.int64),
        src_pos=meta((n, n, E_cap), torch.int32),
        dst_pos=meta((n, n, E_cap), torch.int32),
        eweight=meta((n, n, E_cap), torch.float32),
        blk_lo=meta((n, n, n_blocks), torch.int32),
        blk_hi=meta((n, n, n_blocks), torch.int32),
    )
