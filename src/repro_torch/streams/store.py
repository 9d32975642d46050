"""On-disk edge-block store — the local edge stream S^E of the paper (§3.1).

GraphD's memory theorem (each machine needs only O(|V|/n) RAM) holds because
edges never live in memory: they are written once at partition time, in the
per-destination group layout of §3.3.1, and *streamed* back every superstep.
``EdgeStreamStore`` is that disk tier:

* three flat binary files (``sp.bin``/``dp.bin``/``w.bin``); uncompressed,
  each is a memmap of logical shape ``(n, n, n_blocks, edge_block)`` in
  row-major order, so the blocks of one ``(src_shard, dst_shard)`` group are
  **contiguous on disk** and a group scan is one sequential read — the
  access pattern the paper's streaming analysis assumes. With
  ``compress=True`` the two position channels are stored as per-block
  varint-delta blobs (``streams/codec.py``; ``sp`` is sorted within a group,
  so its deltas are tiny) with an int64 offset table, and with
  ``compress_payload=True`` the weight channel is stored as per-block
  payload-codec blobs (lossless byte-shuffle + DEFLATE) the same way —
  both shrink the stream the paper's sequential-bandwidth argument pays
  for every superstep;
* a JSON ``manifest.json`` with the static geometry, a content signature
  (used by checkpoint recovery to refuse restoring state against the wrong
  edge streams), and a **row-ownership table**: per channel, the byte extent
  of every source shard's row, so machine i can map *only its own* stream
  S^E_i (``open(dir, owner=i)`` / :meth:`owner_view`) — the stepping stone
  to multi-process deployment where no machine ever maps a peer's edges;
* the skip() metadata (``blk_lo``/``blk_hi`` per block, §3.2) in
  ``blocks.npz``, kept host-resident — O(n · n_blocks) ints, not O(|E|) —
  so inactive blocks are *never read off disk*.

Padded slots carry ``src_pos = -1`` exactly like the in-memory layout, so a
staged block is compute-neutral in the engine's combine.
"""

from __future__ import annotations

import hashlib
import json
import os
import zlib
from dataclasses import dataclass

import numpy as np

import repro_torch.fault as _fault
from repro_torch.fault import BlobCorruption
from repro_torch.streams.codec import (
    PAYLOAD_RATIO_ESTIMATE, decode_payload, decode_varint_delta,
    encode_payload, encode_varint_delta,
)


def _spill_write(f, data: bytes, crc: int, path: str) -> int:
    """Append ``data``, returning the running CRC32 of the pristine bytes.

    Routes through the installed chaos injector (site ``io.write.store``)
    so partition-time spills are fault-injectable like every other tier.
    """
    crc = zlib.crc32(data, crc)
    inj = _fault.active()
    if inj is not None:
        inj.file_write(f, data, site="io.write.store", path=path)
    else:
        f.write(data)
    return crc

MANIFEST = "manifest.json"
BLOCKS = "blocks.npz"
_FILES = {"sp": np.int32, "dp": np.int32, "w": np.float32}
_COMPRESSED_CHANNELS = ("sp", "dp")  # varint-delta (position structure)
_PAYLOAD_CHANNELS = ("w",)  # payload codec (no delta structure)
FORMAT_VERSION = 3  # v1/v2 readable: v2 added compress + row ownership,
#                     v3 added the payload-compressed weight channel

#: bytes per edge slot across the three channels (int32 sp + int32 dp +
#: float32 w) — the unit of every edge-tier byte model (device groups, disk
#: streams, staging pools). Kept next to the format it describes.
EDGE_SLOT_BYTES = sum(np.dtype(dt).itemsize for dt in _FILES.values())

#: conservative planning estimate of the varint-delta codec's shrink on the
#: position channels (about 0.5x measured on RMAT streams; planners that
#: promise less than the codec delivers stay feasible).
COMPRESS_RATIO_ESTIMATE = 0.6

#: position-channel (sp+dp) vs weight-channel bytes of one edge slot
_POS_BYTES = 8
_W_BYTES = 4


def estimate_edge_disk_bytes(n_shards: int, E_cap: int,
                             compress: bool = False,
                             compress_payload: bool = False) -> int:
    """Predicted on-disk bytes of one shard's edge streams (its n
    per-destination groups) — the planner-side mirror of
    :meth:`EdgeStreamStore.disk_bytes`. ``compress`` shrinks the position
    channels by the varint estimate; ``compress_payload`` the weight
    channel by the payload-codec estimate."""
    pos = _POS_BYTES * (COMPRESS_RATIO_ESTIMATE if compress else 1.0)
    w = _W_BYTES * (PAYLOAD_RATIO_ESTIMATE if compress_payload else 1.0)
    return int(n_shards * E_cap * (pos + w))


@dataclass(frozen=True)
class StoreGeometry:
    """Static shape of the on-disk layout (mirrors PartitionedGraph statics)."""

    n_shards: int
    n_vertices: int
    n_edges: int
    P: int
    E_cap: int
    edge_block: int
    n_blocks: int

    @property
    def shape(self) -> tuple[int, int, int, int]:
        n = self.n_shards
        return (n, n, self.n_blocks, self.edge_block)


class EdgeStreamStore:
    """Memmap-backed, write-once edge-block store with a block manifest.

    ``owner`` restricts the instance to ONE source shard's row: only the
    bytes listed for that row in the manifest's ownership table are mapped,
    and reads for any other source raise — the per-machine view of the
    paper's deployment, emulated in-process by the pipelined engine.
    """

    def __init__(self, directory: str, geom: StoreGeometry,
                 blk_lo: np.ndarray, blk_hi: np.ndarray, signature: str,
                 *, compress: bool = False, compress_payload: bool = False,
                 row_bytes: dict[str, list[int]] | None = None,
                 block_index: dict[str, np.ndarray] | None = None,
                 owner: int | None = None):
        self.dir = directory
        self.geom = geom
        self.blk_lo = blk_lo  # (n, n, n_blocks) int32, P sentinel when empty
        self.blk_hi = blk_hi  # (n, n, n_blocks) int32, -1 sentinel when empty
        self.compress = bool(compress)
        self.compress_payload = bool(compress_payload)
        self.owner = owner
        self._signature = signature
        self._row_bytes = row_bytes or self._default_row_bytes(geom)
        self._block_index = block_index or {}
        if owner is not None and not 0 <= owner < geom.n_shards:
            raise ValueError(f"owner={owner} outside 0..{geom.n_shards - 1}")
        n, nb, B = geom.n_shards, geom.n_blocks, geom.edge_block
        rows = (owner, owner + 1) if owner is not None else (0, n)
        self._mm = {}
        for name, dt in _FILES.items():
            path = os.path.join(directory, f"{name}.bin")
            off = self._row_bytes[name][rows[0]]
            length = self._row_bytes[name][rows[1]] - off
            if self._is_blob(name):
                # byte-granular map of the owned rows' blobs only
                self._mm[name] = np.memmap(path, dtype=np.uint8, mode="r",
                                           offset=off, shape=(length,))
            else:
                self._mm[name] = np.memmap(
                    path, dtype=dt, mode="r", offset=off,
                    shape=(rows[1] - rows[0], n, nb, B),
                )

    def _is_blob(self, name: str) -> bool:
        """Channels stored as per-block compressed blobs."""
        return (self.compress and name in _COMPRESSED_CHANNELS) or (
            self.compress_payload and name in _PAYLOAD_CHANNELS
        )

    @staticmethod
    def _default_row_bytes(geom: StoreGeometry) -> dict[str, list[int]]:
        """Uncompressed layout: every channel row is one fixed stride."""
        n, nb, B = geom.n_shards, geom.n_blocks, geom.edge_block
        out = {}
        for name, dt in _FILES.items():
            stride = n * nb * B * np.dtype(dt).itemsize
            out[name] = [r * stride for r in range(n + 1)]
        return out

    def _row(self, name: str, i: int) -> np.ndarray:
        """The (n_dest, n_blocks, B) view of source row ``i`` (raw channels)."""
        if self.owner is not None:
            if i != self.owner:
                raise PermissionError(
                    f"store view owns only source shard {self.owner}'s rows; "
                    f"refusing to read shard {i}'s edge stream"
                )
            return self._mm[name][0]
        return self._mm[name][i]

    def _blob(self, name: str, i: int, k: int, b: int) -> np.ndarray:
        """One block's varint blob (compressed channels)."""
        if self.owner is not None and i != self.owner:
            raise PermissionError(
                f"store view owns only source shard {self.owner}'s rows; "
                f"refusing to read shard {i}'s edge stream"
            )
        idx = self._block_index[name]
        nb = self.geom.n_blocks
        flat = (i * self.geom.n_shards + k) * nb + b
        base = self._row_bytes[name][self.owner] if self.owner is not None else 0
        return self._mm[name][idx[flat] - base:idx[flat + 1] - base]

    # -- construction --------------------------------------------------------
    @classmethod
    def create(
        cls,
        directory: str,
        src_pos: np.ndarray,  # (n, n, E_cap) int32, -1 padding
        dst_pos: np.ndarray,  # (n, n, E_cap) int32
        eweight: np.ndarray,  # (n, n, E_cap) float32
        *,
        edge_block: int,
        P: int,
        n_vertices: int,
        n_edges: int,
        compress: bool = False,
        compress_payload: bool = False,
    ) -> "EdgeStreamStore":
        """Spill the per-destination edge groups to disk (done once, at
        partition time — the paper's graph-loading pass). ``compress``
        varint-delta encodes the position channels; ``compress_payload``
        payload-encodes the weight channel (losslessly), each as per-block
        blobs behind an offset table."""
        arrays = dict(
            sp=np.ascontiguousarray(src_pos, dtype=np.int32),
            dp=np.ascontiguousarray(dst_pos, dtype=np.int32),
            w=np.ascontiguousarray(eweight, dtype=np.float32),
        )
        return cls._spill(
            directory, lambda name, i, k: arrays[name][i, k],
            n=src_pos.shape[0], E_cap=src_pos.shape[2],
            edge_block=edge_block, P=P, n_vertices=n_vertices,
            n_edges=n_edges, compress=compress,
            compress_payload=compress_payload,
        )

    @classmethod
    def _spill(cls, directory: str, group, *, n: int, E_cap: int,
               edge_block: int, P: int, n_vertices: int, n_edges: int,
               compress: bool, compress_payload: bool) -> "EdgeStreamStore":
        """Write the store from ``group(channel, i, k)``, which returns group
        (i, k) of one channel as a contiguous ``(E_cap,)`` array. Groups are
        fetched one at a time, so the edge arrays never need to sit in host
        memory whole (a partition on the card is copied over group by
        group). Files, manifest and signature are those of one write of the
        whole arrays."""
        assert E_cap % edge_block == 0
        n_blocks = E_cap // edge_block
        geom = StoreGeometry(
            n_shards=n, n_vertices=n_vertices, n_edges=n_edges, P=P,
            E_cap=E_cap, edge_block=edge_block, n_blocks=n_blocks,
        )
        os.makedirs(directory, exist_ok=True)
        row_bytes: dict[str, list[int]] = {}
        index_arrays: dict[str, np.ndarray] = {}
        file_crcs: dict[str, str] = {}
        for name, dt in _FILES.items():
            as_varint = compress and name in _COMPRESSED_CHANNELS
            as_payload = compress_payload and name in _PAYLOAD_CHANNELS
            path = os.path.join(directory, f"{name}.bin")
            crc = 0
            if as_varint or as_payload:
                enc = (encode_varint_delta if as_varint
                       else encode_payload)
                idx = np.zeros(n * n * n_blocks + 1, np.int64)
                j = 0
                with open(path, "wb") as f:
                    for i in range(n):
                        for k in range(n):
                            blocks = group(name, i, k).reshape(n_blocks,
                                                               edge_block)
                            for blk in blocks:
                                blob = enc(blk)
                                crc = _spill_write(f, blob, crc, path)
                                idx[j + 1] = idx[j] + len(blob)
                                j += 1
                index_arrays[name] = idx
                row_stride = n * n_blocks  # blocks per source row
                row_bytes[name] = [
                    int(idx[r * row_stride]) for r in range(n + 1)
                ]
            else:
                with open(path, "wb") as f:
                    for r in range(n):  # per-row writes: O(row) copy, not O(file)
                        crc = _spill_write(
                            f, b"".join(group(name, r, k).tobytes()
                                        for k in range(n)),
                            crc, path)
                stride = n * n_blocks * edge_block * np.dtype(dt).itemsize
                row_bytes[name] = [r * stride for r in range(n + 1)]
            file_crcs[name] = f"{crc & 0xFFFFFFFF:08x}"

        # skip() metadata: per-block source range (same contract as the
        # device layout's blk_lo/blk_hi)
        from repro_torch.graph.partition import block_ranges

        blk_lo = np.empty((n, n, n_blocks), np.int32)
        blk_hi = np.empty((n, n, n_blocks), np.int32)
        for i in range(n):
            for k in range(n):
                blk_lo[i, k], blk_hi[i, k] = block_ranges(
                    group("sp", i, k).reshape(n_blocks, edge_block), P)
        np.savez(os.path.join(directory, BLOCKS), blk_lo=blk_lo, blk_hi=blk_hi,
                 **{f"{name}_idx": idx for name, idx in index_arrays.items()})

        signature = cls._digest(geom, blk_lo, blk_hi, group)
        manifest = dict(
            version=FORMAT_VERSION, signature=signature,
            files={k: f"{k}.bin" for k in _FILES},
            # per-file CRC32 of the bytes as written: read-path integrity
            # for the write-once edge tier (verify_integrity())
            crc32=file_crcs,
            compress=bool(compress),
            compress_payload=bool(compress_payload),
            # manifest-driven row ownership: machine i maps only the byte
            # extent [row_bytes[ch][i], row_bytes[ch][i+1]) of each channel
            row_ownership=dict(axis="src_shard", row_bytes=row_bytes),
            **geom.__dict__,
        )
        tmp = os.path.join(directory, f".{MANIFEST}.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())  # manifest durable before the name appears
        os.replace(tmp, os.path.join(directory, MANIFEST))  # atomic publish
        return cls(directory, geom, blk_lo, blk_hi, signature,
                   compress=compress, compress_payload=compress_payload,
                   row_bytes=row_bytes, block_index=index_arrays)

    @classmethod
    def from_partition(cls, pg, directory: str, compress: bool = False,
                       compress_payload: bool = False) -> "EdgeStreamStore":
        """Spill a (fully materialized) PartitionedGraph's edge groups. Its
        tensors may lie on any device: each ``(src, dst)`` group is copied
        to the host on its own."""
        fields = dict(sp="src_pos", dp="dst_pos", w="eweight")

        def group(name, i, k):
            return np.ascontiguousarray(
                getattr(pg, fields[name])[i, k].cpu().numpy(), _FILES[name])

        return cls._spill(
            directory, group, n=pg.n_shards, E_cap=pg.E_cap,
            edge_block=pg.edge_block, P=pg.P,
            n_vertices=pg.n_vertices, n_edges=pg.n_edges,
            compress=compress, compress_payload=compress_payload,
        )

    @classmethod
    def open(cls, directory: str, owner: int | None = None) -> "EdgeStreamStore":
        with open(os.path.join(directory, MANIFEST)) as f:
            m = json.load(f)
        if m.get("version") not in (1, 2, FORMAT_VERSION):
            raise ValueError(f"unsupported stream-store version {m.get('version')}")
        geom = StoreGeometry(**{k: m[k] for k in StoreGeometry.__dataclass_fields__})
        z = np.load(os.path.join(directory, BLOCKS))
        compress = m.get("compress", False)
        compress_payload = m.get("compress_payload", False)
        ownership = m.get("row_ownership") or {}
        row_bytes = ownership.get("row_bytes")
        block_index = {
            name: z[f"{name}_idx"]
            for name in _COMPRESSED_CHANNELS + _PAYLOAD_CHANNELS
            if f"{name}_idx" in z.files
        }
        return cls(directory, geom, z["blk_lo"], z["blk_hi"], m["signature"],
                   compress=compress, compress_payload=compress_payload,
                   row_bytes=row_bytes, block_index=block_index, owner=owner)

    def owner_view(self, shard: int) -> "EdgeStreamStore":
        """A view of this store that maps ONLY ``shard``'s source row — what
        machine ``shard`` would open in a multi-process deployment."""
        return EdgeStreamStore(
            self.dir, self.geom, self.blk_lo, self.blk_hi, self._signature,
            compress=self.compress, compress_payload=self.compress_payload,
            row_bytes=self._row_bytes,
            block_index=self._block_index, owner=shard,
        )

    @staticmethod
    def _digest(geom: StoreGeometry, blk_lo, blk_hi, group) -> str:
        """Content signature: geometry + skip metadata + the edge data
        itself (two stores with equal topology but different weights must
        not look interchangeable to checkpoint recovery). Computed over the
        LOGICAL arrays (each channel's groups in row-major order, as
        ``group(channel, i, k)`` gives them), so a compressed and an
        uncompressed spill of the same graph are interchangeable to
        recovery — as they should be."""
        h = hashlib.sha256()
        h.update(json.dumps(geom.__dict__, sort_keys=True).encode())
        h.update(np.ascontiguousarray(blk_lo).tobytes())
        h.update(np.ascontiguousarray(blk_hi).tobytes())
        n = geom.n_shards
        for name in sorted(_FILES):
            for i in range(n):
                for k in range(n):
                    h.update(group(name, i, k).tobytes())
        return h.hexdigest()[:16]

    def verify_integrity(self) -> None:
        """Recompute each channel file's CRC32 against the manifest record.

        Raises :class:`repro_torch.fault.BlobCorruption` naming the first file
        whose bytes no longer match what partition time wrote. Called by
        recovering workers before checkpoint-lineage replay (an O(|E|)
        sequential read — cheap next to the replay itself) and by the chaos
        harness; silently a no-op on legacy manifests without checksums.
        """
        with open(os.path.join(self.dir, MANIFEST)) as f:
            m = json.load(f)
        for name, want in (m.get("crc32") or {}).items():
            path = os.path.join(self.dir, f"{name}.bin")
            crc = 0
            with open(path, "rb") as fh:
                while True:
                    chunk = fh.read(1 << 22)
                    if not chunk:
                        break
                    crc = zlib.crc32(chunk, crc)
            got = f"{crc & 0xFFFFFFFF:08x}"
            if got != want:
                raise BlobCorruption(
                    path,
                    f"edge channel file {name}.bin: manifest crc32 {want} "
                    f"!= read crc32 {got}",
                    directory=self.dir,
                )

    # -- identity / accounting -----------------------------------------------
    def signature(self) -> dict:
        """Stable identity of the edge streams, recorded in checkpoint
        manifests so recovery can detect a store/state mismatch."""
        return dict(store="edge-stream", signature=self._signature,
                    n_shards=self.geom.n_shards, n_edges=self.geom.n_edges)

    def disk_bytes(self) -> int:
        return sum(
            os.path.getsize(os.path.join(self.dir, f"{name}.bin"))
            for name in _FILES
        )

    def block_bytes(self) -> int:
        """DECODED bytes of one staged edge block across the three channels
        — the admission/accounting unit of the hot-block residency cache
        (streams/residency.py), independent of on-disk compression."""
        return self.geom.edge_block * EDGE_SLOT_BYTES

    # -- skip() (§3.2) -------------------------------------------------------
    def active_blocks(self, i: int, k: int, prefix: np.ndarray) -> np.ndarray:
        """Block ids of group (i, k) whose source range [lo, hi] contains an
        active vertex; ``prefix`` is the inclusive prefix sum (P+1,) of shard
        i's active bitmap. Returned ascending => the read is sequential."""
        lo = self.blk_lo[i, k]
        hi = self.blk_hi[i, k]
        nonempty = hi >= 0
        cnt = prefix[np.clip(hi + 1, 0, self.geom.P)] - prefix[np.clip(lo, 0, self.geom.P)]
        return np.nonzero(nonempty & (cnt > 0))[0].astype(np.int64)

    def nonempty_blocks(self) -> int:
        return int((self.blk_hi >= 0).sum())

    # -- reads ---------------------------------------------------------------
    def read_blocks(self, i: int, k: int, ids: np.ndarray,
                    out_sp: np.ndarray, out_dp: np.ndarray,
                    out_w: np.ndarray) -> int:
        """Read blocks ``ids`` of group (i, k) into the staging buffers
        (shape (chunk_blocks, edge_block) each); unused tail rows are padded
        (sp = -1) so the staged chunk is compute-neutral. Returns the number
        of real blocks staged."""
        c = len(ids)
        out_sp[c:] = -1
        out_dp[c:] = 0
        out_w[c:] = 0.0
        if not c:
            return 0
        B = self.geom.edge_block
        if self.compress:
            for j, b in enumerate(ids):
                out_sp[j] = decode_varint_delta(self._blob("sp", i, k, int(b)))
                out_dp[j] = decode_varint_delta(self._blob("dp", i, k, int(b)))
        else:
            self._row("sp", i)[k].take(ids, axis=0, out=out_sp[:c])
            self._row("dp", i)[k].take(ids, axis=0, out=out_dp[:c])
        if self.compress_payload:
            for j, b in enumerate(ids):
                out_w[j] = decode_payload(
                    self._blob("w", i, k, int(b)), np.float32, B)
        else:
            self._row("w", i)[k].take(ids, axis=0, out=out_w[:c])
        return c

    def group_edges(self, i: int, k: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Whole-group read (tests / tooling — not the streaming hot path)."""
        nb, B = self.geom.n_blocks, self.geom.edge_block
        if self.compress:
            sp = np.empty((nb, B), np.int32)
            dp = np.empty((nb, B), np.int32)
            for b in range(nb):
                sp[b] = decode_varint_delta(self._blob("sp", i, k, b))
                dp[b] = decode_varint_delta(self._blob("dp", i, k, b))
        else:
            sp = np.array(self._row("sp", i)[k])
            dp = np.array(self._row("dp", i)[k])
        if self.compress_payload:
            w = np.empty((nb, B), np.float32)
            for b in range(nb):
                w[b] = decode_payload(self._blob("w", i, k, b), np.float32, B)
        else:
            w = np.array(self._row("w", i)[k])
        return sp, dp, w
