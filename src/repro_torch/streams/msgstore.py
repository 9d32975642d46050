"""Disk-spilled outgoing-message streams — the OMS tier of the paper (§3.3).

Combiner-less Pregel programs consume destination-sorted message *lists*
(``VertexProgram.apply_list``), so the streamed engine cannot scatter-combine
messages into an O(|V|/n) accumulator as it digests edge chunks. GraphD's
answer (§3.3.1) is the external merge-sort: every chunk of raw messages is
sorted by destination and appended to a local-disk run, and the runs are
k-way merged back into one destination-sorted stream at apply time. Pregelix
pays an external join/group-by for the same class of programs; here the
merge is a sequential scan of sorted runs — the access pattern the paper's
streaming analysis assumes.

``MessageRunStore`` is that tier:

* per destination shard ``k``, two flat binary append-only files
  (``oms-k.dp.bin`` destination positions, ``oms-k.msg.bin`` payloads; an
  optional ``oms-k.cnt.bin`` int32 channel carries combined-message counts
  when the store backs a message log) plus an in-memory run table — each run
  is a contiguous, destination-sorted segment of those files;
* with ``compress=True`` the sorted ``dp`` channel is varint-delta encoded
  (``streams/codec.py``): each run's positions become one self-contained
  blob, read back through a bounded streaming decoder, so the paper's
  sequential-bandwidth argument gets a smaller stream at the same
  O(read_chunk) residency;
* with ``compress_payload=`` the VALUE channels shrink too: the ``msg``
  payload (and, on combined stores, the ``cnt`` channel) are stored as
  payload-codec blobs — losslessly by default (byte-plane shuffle +
  DEFLATE; results stay bit-identical), or with bfloat16 wire rounding
  under the ``"bf16"`` scheme (float32 messages only, the
  ``recoded_compact`` guard) — again streamed back through bounded
  decoders;
* ``iter_merged`` — a k-way heap merge over the sorted runs that reads each
  run through a small fixed-size cursor buffer, so merge-time resident
  memory is O(fan-in · read_chunk), never O(messages);
* ``compact_tag`` — the multi-pass bounded-fan-in merge of §3.3.1: when a
  destination accumulates more runs than the merge may hold open, same-tag
  runs are merged into longer runs on disk until the fan-in bound holds
  (tags record the producing source shard, so log-backed stores never lose
  message attribution — single-shard recovery excludes the failed shard's
  own runs and regenerates them instead). Superseded segments become dead
  file regions; once a destination's dead bytes reach its live bytes,
  :meth:`vacuum` rewrites the files compactly, so compaction can no longer
  leak disk until the per-step store is deleted;
* ``merged_slices`` — fixed-capacity, *destination-aligned* slices of the
  merged stream, padded with the ``dst = P`` sentinel, ready for
  ``program.apply_list``. A vertex's whole message run always lands in one
  slice (the Pregel contract: ``compute()`` sees the full message list of a
  vertex), so slicing is invisible to any vertex-local program.

A JSON index (run table + geometry) makes a store re-openable after a crash,
which is what lets ``RunFileMessageLog`` (core/checkpoint.py) use these same
run files as the persisted OMSs of the paper's fast-recovery protocol — and
the pipelined engine's *inbox* files (streams/channel.py) are exactly these
stores, so transmitted-but-unapplied messages survive a crash the same way.

Read-path integrity: every appended run records a CRC32 per channel blob
(computed over the pristine bytes before they hit the page cache) in its
:class:`RunSegment`, persisted through the index. Readers verify a run's
checksums once before first use and raise
:class:`repro_torch.fault.BlobCorruption` on mismatch — so a flipped bit on disk
(or injected by the chaos layer between write and read) is a detected,
named event the worker can quarantine and replay, never silently wrong
math. All blob writes route through the installed
:class:`repro_torch.fault.FaultInjector` (if any), which is how the chaos
drills land ENOSPC/EIO/short-write/bit-flip faults at this tier.
"""

from __future__ import annotations

import dataclasses
import heapq
import json
import os
import shutil
import zlib
from dataclasses import dataclass

import numpy as np

import repro_torch.fault as _fault
from repro_torch.fault import BlobCorruption
from repro_torch.streams.codec import (
    PayloadDecoder, PayloadEncoder, VarintDeltaDecoder, decode_varint_delta,
    encode_payload, encode_varint_delta, normalize_payload_scheme,
)

INDEX = "index.json"


@dataclass(frozen=True)
class RunSegment:
    """One sorted run: a contiguous slice of a destination's OMS files.

    ``offset``/``length`` are in messages (fixed-width channels are indexed
    by them directly); ``*_off``/``*_nbytes`` are the *byte* extent of a
    channel's compressed blob when that channel is encoded (-1 on
    fixed-width channels, where the extent is implied by offset/length):
    ``dp_*`` for the varint-delta position blob (``compress=True``),
    ``msg_*``/``cnt_*`` for the payload-codec blobs
    (``compress_payload=...``).
    """

    tag: int  # producing source shard (-1 = untagged)
    offset: int  # messages before this run in the files
    length: int  # messages in this run
    dp_off: int = -1  # byte offset of the compressed dp blob
    dp_nbytes: int = -1  # byte length of the compressed dp blob
    msg_off: int = -1  # byte offset of the payload-codec msg blob
    msg_nbytes: int = -1  # byte length of the payload-codec msg blob
    cnt_off: int = -1  # byte offset of the payload-codec cnt blob
    cnt_nbytes: int = -1  # byte length of the payload-codec cnt blob
    crc: str = ""  # comma-joined per-channel CRC32 hex ("" = legacy, unchecked)


#: RunSegment byte-extent fields per blob-encoded channel
_EXTENTS = {"dp": ("dp_off", "dp_nbytes"), "msg": ("msg_off", "msg_nbytes"),
            "cnt": ("cnt_off", "cnt_nbytes")}


class MessageRunStore:
    """Append-only per-destination sorted message runs + bounded k-way merge."""

    def __init__(self, directory: str, n_shards: int, P: int, msg_dtype,
                 with_counts: bool = False, create: bool = True,
                 compress: bool = False, compress_payload=False,
                 payload_channels=None):
        self.dir = directory
        self.n_shards = n_shards
        self.P = P
        self.msg_dtype = np.dtype(msg_dtype)
        self.with_counts = with_counts
        self.compress = bool(compress)
        # payload codec: msg channel in the requested scheme; the cnt
        # channel (combine counts must stay exact) always lossless
        self.payload_scheme = normalize_payload_scheme(compress_payload)
        # which value channels the codec covers: None = all of them; the
        # payload auto-pick narrows this to the channels whose measured
        # ratio paid off (a channel outside the set stays fixed-width)
        if payload_channels is not None:
            bad = set(payload_channels) - {"msg", "cnt"}
            if bad:
                raise ValueError(
                    f"payload_channels must be among ('msg', 'cnt'): {bad}")
            payload_channels = tuple(sorted(payload_channels))
        self.payload_channels = payload_channels
        # optional codec.PayloadAutoPicker: sees every value column this
        # store appends (set by the engine on the sampling superstep only)
        self.payload_sampler = None
        if self.payload_scheme == "bf16" and self.msg_dtype != np.float32:
            raise ValueError(
                "compress_payload='bf16' rounds float32 payloads on the "
                f"wire; this store carries {self.msg_dtype} messages"
            )
        self._runs: list[list[RunSegment]] = [[] for _ in range(n_shards)]
        self._sizes = [0] * n_shards  # messages written per destination
        # per-channel blob file bytes (encoded channels only)
        self._blob_bytes: dict[str, list[int]] = {
            ch: [0] * n_shards for ch in self._blob_channels()
        }
        # per-(dest, position) message counts: O(|V|) host ints, the slice
        # planner's only state (NOT O(messages))
        self._counts = np.zeros((n_shards, P), np.int64)
        self._wfh: dict[tuple[int, str], object] = {}
        # run identities whose CRCs verified clean (reads re-check only
        # segments not yet seen; set.add is GIL-atomic for the cross-thread
        # append/digest pattern)
        self._crc_ok: set[tuple] = set()
        # destinations whose _counts row must be rebuilt from the live runs
        # before use (set by open(); rebuilding eagerly would scan every
        # destination when a reader typically wants just one)
        self._stale_counts: set[int] = set()
        if create:
            os.makedirs(directory, exist_ok=True)
            # a re-created store restarts its step from scratch: truncate the
            # data files AND drop any index a crashed earlier attempt
            # published, or a later open() would map past the truncated files
            try:
                os.remove(os.path.join(directory, INDEX))
            except OSError:
                pass
            for k in range(n_shards):
                for ch in self._channels():
                    open(self._path(k, ch), "wb").close()

    def _channels(self) -> tuple[str, ...]:
        return ("dp", "msg", "cnt") if self.with_counts else ("dp", "msg")

    def _blob_channels(self) -> tuple[str, ...]:
        """Channels stored as per-run compressed blobs (byte-indexed)."""
        out = []
        if self.compress:
            out.append("dp")
        if self.payload_scheme is not None:
            covered = (self.payload_channels
                       if self.payload_channels is not None
                       else ("msg", "cnt"))
            if "msg" in covered:
                out.append("msg")
            if self.with_counts and "cnt" in covered:
                out.append("cnt")
        return tuple(out)

    def _is_blob(self, ch: str) -> bool:
        return ch in self._blob_bytes

    def _scheme(self, ch: str) -> str:
        return self.payload_scheme if ch == "msg" else "lossless"

    def _decoded_dtype(self, ch: str):
        return self.msg_dtype if ch == "msg" else np.dtype(np.int32)

    def _dtype(self, ch: str):
        if self._is_blob(ch):
            return np.dtype(np.uint8)
        return self._decoded_dtype(ch)

    def _encode(self, ch: str, values: np.ndarray) -> bytes:
        if ch == "dp":
            return encode_varint_delta(np.asarray(values, np.int64))
        return encode_payload(
            np.ascontiguousarray(values, self._decoded_dtype(ch)),
            self._scheme(ch),
        )

    def _blob_slice(self, mm: dict, seg: RunSegment, ch: str) -> np.ndarray:
        off_f, nb_f = _EXTENTS[ch]
        off, nb = getattr(seg, off_f), getattr(seg, nb_f)
        return mm[ch][off:off + nb]

    def _decoder(self, mm: dict, seg: RunSegment, ch: str):
        """Streaming decoder over one run's blob for ``ch`` (None when the
        channel is fixed-width and the memmap slice is the stream)."""
        if not self._is_blob(ch):
            return None
        blob = self._blob_slice(mm, seg, ch)
        if ch == "dp":
            return VarintDeltaDecoder(blob, seg.length)
        return PayloadDecoder(blob, self._decoded_dtype(ch), seg.length,
                              self._scheme(ch))

    def _path(self, dest: int, ch: str) -> str:
        return os.path.join(self.dir, f"oms-{dest:03d}.{ch}.bin")

    # -- writes ---------------------------------------------------------------
    def _handle(self, dest: int, ch: str):
        fh = self._wfh.get((dest, ch))
        if fh is None:
            fh = open(self._path(dest, ch), "ab")
            self._wfh[(dest, ch)] = fh
        return fh

    def _write(self, dest: int, ch: str, data: bytes, crc: int = 0) -> int:
        """Append one channel blob; returns the CRC32 of the pristine bytes.

        The checksum is computed BEFORE the bytes reach the injector/OS, so
        anything that mutates them on the way to (or at rest on) disk is
        caught by read-path verification. A failed write poisons the store:
        extents for the torn bytes are never published and the worker
        aborts the step (quarantine-and-replay regenerates the data).
        """
        crc = zlib.crc32(data, crc)
        fh = self._handle(dest, ch)
        inj = _fault.active()
        if inj is not None:
            inj.file_write(fh, data, site="io.write.spill",
                           path=self._path(dest, ch))
        else:
            fh.write(data)
        return crc

    @staticmethod
    def _crc_field(crcs: list[int]) -> str:
        return ",".join(f"{c & 0xFFFFFFFF:08x}" for c in crcs)

    def _verify(self, dest: int, seg: RunSegment, mm: dict) -> None:
        """Check one run's stored CRCs against the bytes on disk (memoized
        per segment identity; vacuum re-bases offsets, which re-keys)."""
        if not seg.crc:
            return  # legacy segment from a pre-CRC index: unverifiable
        key = (dest, seg.tag, seg.offset, seg.length, seg.crc)
        if key in self._crc_ok:
            return
        want = seg.crc.split(",")
        for ch, w in zip(self._channels(), want):
            if self._is_blob(ch):
                data = np.ascontiguousarray(
                    self._blob_slice(mm, seg, ch)).tobytes()
            else:
                data = np.ascontiguousarray(
                    mm[ch][seg.offset:seg.offset + seg.length]).tobytes()
            got = f"{zlib.crc32(data):08x}"
            if got != w:
                raise BlobCorruption(
                    self._path(dest, ch),
                    f"run tag={seg.tag} offset={seg.offset} "
                    f"length={seg.length} channel={ch}: "
                    f"stored crc32 {w} != read crc32 {got}",
                    directory=self.dir,
                )
        self._crc_ok.add(key)

    def append_run(self, dest: int, dp: np.ndarray, msg: np.ndarray,
                   cnt: np.ndarray | None = None, tag: int = -1) -> RunSegment:
        """Append one destination-sorted run for shard ``dest``.

        ``dp`` must be ascending (the chunk was sorted by destination before
        spilling); ``cnt`` is required iff the store carries a count channel.
        """
        if dp.size and np.any(np.diff(dp) < 0):
            raise ValueError("append_run requires destination-sorted input")
        if self.with_counts and cnt is None:
            raise ValueError("this store carries a count channel; pass cnt=")
        data = {"dp": dp, "msg": msg}
        if self.with_counts:
            data["cnt"] = cnt
        if self.payload_sampler is not None:
            for ch in self._channels():
                if ch != "dp":
                    self.payload_sampler.offer(ch, data[ch])
        extents: dict[str, int] = {}
        blob_len: dict[str, int] = {}
        crcs: list[int] = []
        for ch in self._channels():
            if self._is_blob(ch):
                blob = self._encode(ch, data[ch])
                off_f, nb_f = _EXTENTS[ch]
                extents[off_f] = self._blob_bytes[ch][dest]
                extents[nb_f] = len(blob)
                blob_len[ch] = len(blob)
                crcs.append(self._write(dest, ch, blob))
            else:
                crcs.append(self._write(
                    dest, ch,
                    np.ascontiguousarray(data[ch],
                                         self._decoded_dtype(ch)).tobytes()))
        seg = RunSegment(tag=tag, offset=self._sizes[dest],
                         length=int(dp.size), crc=self._crc_field(crcs),
                         **extents)
        for ch in self._channels():
            self._wfh[(dest, ch)].flush()
        # size counters move only AFTER the flush: the full-duplex receiver
        # maps read extents from these counters on another thread, and a
        # counter that ran ahead of the bytes on disk would make it mmap
        # past EOF (the sender's single-thread append order makes
        # post-flush publication sufficient)
        for ch, nb in blob_len.items():
            self._blob_bytes[ch][dest] += nb
        self._sizes[dest] += seg.length
        if dp.size:
            self._ensure_counts(dest)
            np.add.at(
                self._counts[dest], dp,
                cnt.astype(np.int64) if cnt is not None else 1,
            )
        self._runs[dest].append(seg)
        return seg

    def append_combined(self, dest: int, A: np.ndarray, cnt: np.ndarray,
                        tag: int = -1) -> RunSegment:
        """One dense combined buffer A_s(tag→dest) -> one sparse sorted run:
        positions with no messages hold the combiner identity by
        construction and are dropped on the wire. THE combined-group format
        — shared by the channel sender, the message log and recovery, so
        the three can never drift."""
        dp = np.nonzero(np.asarray(cnt) > 0)[0].astype(np.int32)
        return self.append_run(dest, dp, np.asarray(A)[dp],
                               cnt=np.asarray(cnt)[dp].astype(np.int32),
                               tag=tag)

    def read_combined(self, dest: int, seg: RunSegment, e0):
        """Inverse of :meth:`append_combined`: densify one sparse run back
        to full (P,) ``(A, cnt)`` buffers, identity at absent positions."""
        dp, msg, cnt = self.read_run(dest, seg)
        A = np.full((self.P,), e0, dtype=self.msg_dtype)
        A[dp] = msg
        c = np.zeros((self.P,), np.int32)
        c[dp] = cnt
        return A, c

    def append_raw(self, dest: int, dp: np.ndarray, msg: np.ndarray,
                   valid: np.ndarray, tag: int = -1) -> RunSegment | None:
        """One edge chunk's raw messages -> one sorted run: drop invalid
        lanes, stable-sort by destination, append. THE spill transform —
        shared by the inline engine path and the channel sender, so the
        pipelined run's byte-identical-results guarantee can never drift.
        Returns None when the chunk had no valid messages."""
        dpv = dp[valid]
        if not dpv.size:
            return None
        order = np.argsort(dpv, kind="stable")
        return self.append_run(dest, dpv[order], msg[valid][order], tag=tag)

    # -- run access -----------------------------------------------------------
    def runs(self, dest: int) -> list[RunSegment]:
        return list(self._runs[dest])

    def n_messages(self, dest: int) -> int:
        return int(self.dest_counts(dest).sum())

    def _ensure_counts(self, dest: int) -> None:
        if dest in self._stale_counts:
            self._stale_counts.discard(dest)
            for seg in self._runs[dest]:
                for part in self.iter_run(dest, seg, read_chunk=1 << 20):
                    weights = part[2] if self.with_counts else None
                    self._counts[dest] += np.bincount(
                        part[0], weights=weights, minlength=self.P
                    ).astype(np.int64)

    def dest_counts(self, dest: int) -> np.ndarray:
        """(P,) messages per destination position (max = the in-degree bound
        a single apply_list slice must hold — Pregel's per-vertex list)."""
        self._ensure_counts(dest)
        return self._counts[dest]

    def _read_mm(self, dest: int):
        """Fresh read memmaps over the currently-written extent (writers only
        ever append, so an open memmap never sees moving data). Snapshot the
        handle table: a channel sender may be opening handles for OTHER
        destinations while this destination is being merged."""
        for (d, ch), fh in list(self._wfh.items()):
            if d == dest:
                fh.flush()
        sizes = {
            ch: (self._blob_bytes[ch][dest] if self._is_blob(ch)
                 else self._sizes[dest])
            for ch in self._channels()
        }
        return {
            ch: (np.empty((0,), self._dtype(ch)) if sizes[ch] == 0 else
                 np.memmap(self._path(dest, ch), dtype=self._dtype(ch),
                           mode="r", shape=(sizes[ch],)))
            for ch in self._channels()
        }

    def read_run(self, dest: int, seg: RunSegment):
        """Materialize one run (tests / log densification — small runs)."""
        mm = self._read_mm(dest)
        self._verify(dest, seg, mm)
        sl = slice(seg.offset, seg.offset + seg.length)
        out = []
        for ch in self._channels():
            dec = self._decoder(mm, seg, ch)
            if dec is None:
                out.append(np.array(mm[ch][sl]))
            else:
                vals = dec.take(seg.length)
                out.append(np.asarray(vals, self._decoded_dtype(ch)))
        return tuple(out)

    def iter_run(self, dest: int, seg: RunSegment, read_chunk: int = 4096):
        """Stream one run in bounded chunks (per-channel tuples) — for
        copying arbitrarily long runs without materializing them."""
        mm = self._read_mm(dest)
        self._verify(dest, seg, mm)
        # blobs stay memmap views: the decoders read them in bounded
        # windows, so even a compaction-length run costs O(read_chunk) heap
        decs = {ch: self._decoder(mm, seg, ch) for ch in self._channels()}
        end = seg.offset + seg.length
        for off in range(seg.offset, end, max(1, read_chunk)):
            hi = min(off + max(1, read_chunk), end)
            yield tuple(
                (np.asarray(decs[ch].take(hi - off), self._decoded_dtype(ch))
                 if decs[ch] is not None else np.array(mm[ch][off:hi]))
                for ch in self._channels()
            )

    # -- the external merge (§3.3.1) -----------------------------------------
    def iter_merged(self, dest: int, read_chunk: int = 4096,
                    segments: list[RunSegment] | None = None):
        """K-way heap merge of the sorted runs of ``dest``; yields ascending
        per-channel numpy chunk tuples (``(dp, msg)``, plus ``cnt`` when the
        store carries it). Resident memory is O(runs · read_chunk): each run
        is read through a fixed-size cursor buffer, never whole."""
        segs = self._runs[dest] if segments is None else segments
        segs = [s for s in segs if s.length]
        if not segs:
            return
        mm = self._read_mm(dest)
        for s in segs:
            self._verify(dest, s, mm)
        channels = self._channels()
        cursors = [
            _Cursor(mm, s, read_chunk, channels,
                    decoders={ch: self._decoder(mm, s, ch)
                              for ch in channels})
            for s in segs
        ]
        heap = [(c.head, j) for j, c in enumerate(cursors)]
        heapq.heapify(heap)
        while heap:
            _, j = heapq.heappop(heap)
            cur = cursors[j]
            bound = heap[0][0] if heap else None
            yield cur.take_until(bound)
            if not cur.exhausted:
                heapq.heappush(heap, (cur.head, j))

    def compact_tag(self, dest: int, tag: int, fanin: int = 16,
                    read_chunk: int = 4096) -> None:
        """Multi-pass merge of all runs with this ``tag`` down to ONE run,
        never holding more than ``fanin`` cursors open (§3.3.1's bounded
        external merge-sort). All channels are rewritten together. Merged
        output is appended to the same files and the superseded segments
        become dead regions; :meth:`vacuum` reclaims them as soon as they
        outweigh the live data, so repeated compaction holds disk usage at
        <= 2x the live bytes instead of leaking until store deletion."""
        channels = self._channels()
        while True:
            mine = [s for s in self._runs[dest] if s.tag == tag]
            if len(mine) <= 1:
                self.vacuum_if_worthwhile(dest)
                return
            batch = mine[:max(2, fanin)]
            offset = self._sizes[dest]
            blob_start = {ch: self._blob_bytes[ch][dest]
                          for ch in self._blob_channels()}
            length = 0
            prev = None  # chains the varint deltas across merge chunks
            # payload blocks are self-contained, but the merge yields small
            # fragments — buffer them to full blocks so compaction keeps
            # the dense block layout (and ratio) of a one-shot encode
            encoders = {
                ch: PayloadEncoder(self._decoded_dtype(ch), self._scheme(ch))
                for ch in self._blob_channels() if ch != "dp"
            }
            # byte counts of the merged run accumulate locally; the
            # published counters (_blob_bytes/_sizes) move only after the
            # flush below, so a reader that maps mid-merge sees at most
            # the pre-merge extent (which the old segments fully cover)
            written = {ch: 0 for ch in self._blob_channels()}
            # per-channel CRC of the merged run accumulates across the
            # fragment writes (crc32 chains over concatenation)
            crcs = {ch: 0 for ch in channels}
            for part in self.iter_merged(dest, read_chunk, segments=batch):
                for ch, arr in zip(channels, part):
                    if ch == "dp" and self.compress:
                        blob = encode_varint_delta(
                            np.asarray(arr, np.int64), prev=prev)
                        prev = int(arr[-1])
                        crcs[ch] = self._write(dest, ch, blob, crcs[ch])
                        written[ch] += len(blob)
                    elif ch in encoders:
                        blob = encoders[ch].add(arr)
                        crcs[ch] = self._write(dest, ch, blob, crcs[ch])
                        written[ch] += len(blob)
                    else:
                        crcs[ch] = self._write(
                            dest, ch,
                            np.ascontiguousarray(
                                arr, self._dtype(ch)).tobytes(), crcs[ch])
                length += int(part[0].size)
            extents: dict[str, int] = {}
            for ch, enc in encoders.items():
                blob = enc.flush()
                crcs[ch] = self._write(dest, ch, blob, crcs[ch])
                written[ch] += len(blob)
            for ch in self._blob_channels():
                off_f, nb_f = _EXTENTS[ch]
                extents[off_f] = blob_start[ch]
                extents[nb_f] = written[ch]
            for ch in channels:
                if (dest, ch) in self._wfh:
                    self._wfh[(dest, ch)].flush()
            for ch in self._blob_channels():
                self._blob_bytes[ch][dest] += written[ch]
            self._sizes[dest] += length
            merged = RunSegment(tag=tag, offset=offset, length=length,
                                crc=self._crc_field(
                                    [crcs[ch] for ch in channels]),
                                **extents)
            keep = [s for s in self._runs[dest] if s not in batch]
            self._runs[dest] = keep + [merged]

    # -- dead-region reclamation ---------------------------------------------
    @staticmethod
    def fixed_bytes_per_message(msg_itemsize: int, with_counts: bool = False,
                                compress: bool = False) -> int:
        """Bytes per message in the fixed-width channels (msg [+ cnt], and dp
        when uncompressed) — the unit of the OMS-tier byte model, shared with
        the resource planner (core/plan.py) so predicted and realized window
        sizes use the same algebra."""
        b = int(msg_itemsize)
        if with_counts:
            b += 4
        if not compress:
            b += 4
        return b

    def _per_msg_fixed_bytes(self) -> int:
        """On-disk bytes per message in the FIXED-WIDTH channels of this
        store (blob-encoded channels are byte-accounted per run instead)."""
        b = 0
        for ch in self._channels():
            if not self._is_blob(ch):
                b += self._decoded_dtype(ch).itemsize
        return b

    def live_bytes(self, dest: int) -> int:
        live = sum(s.length for s in self._runs[dest])
        b = live * self._per_msg_fixed_bytes()
        for ch in self._blob_channels():
            nb_f = _EXTENTS[ch][1]
            b += sum(max(getattr(s, nb_f), 0) for s in self._runs[dest])
        return b

    def dead_bytes(self, dest: int) -> int:
        """Bytes of superseded (compacted-away) run data still on disk."""
        live = sum(s.length for s in self._runs[dest])
        b = (self._sizes[dest] - live) * self._per_msg_fixed_bytes()
        for ch in self._blob_channels():
            nb_f = _EXTENTS[ch][1]
            live_blob = sum(max(getattr(s, nb_f), 0)
                            for s in self._runs[dest])
            b += self._blob_bytes[ch][dest] - live_blob
        return b

    def vacuum_if_worthwhile(self, dest: int) -> bool:
        """Vacuum when the dead regions outweigh the live data — amortized
        O(1) rewrites per byte of compacted traffic."""
        dead = self.dead_bytes(dest)
        if dead and dead >= self.live_bytes(dest):
            self.vacuum(dest)
            return True
        return False

    def vacuum(self, dest: int) -> None:
        """Rewrite ``dest``'s files with only the live segments (chunked
        sequential copy — never materializes a run), atomically replacing
        the originals and re-basing every run's offsets. Reclaims the dead
        regions compaction leaves behind."""
        if not self.dead_bytes(dest):
            return
        channels = self._channels()
        for ch in channels:
            fh = self._wfh.pop((dest, ch), None)
            if fh is not None:
                fh.close()
        mm = self._read_mm(dest)
        tmp = {ch: open(self._path(dest, ch) + ".vacuum", "wb")
               for ch in channels}
        inj = _fault.active()

        def _copy(ch: str, data: bytes) -> None:
            # byte-identical copy, so each segment's recorded CRC survives
            # the rewrite; still injectable (ENOSPC mid-vacuum leaves the
            # originals untouched behind the atomic replace below)
            if inj is not None:
                inj.file_write(tmp[ch], data, site="io.write.spill",
                               path=self._path(dest, ch) + ".vacuum")
            else:
                tmp[ch].write(data)

        new_runs = []
        off = 0
        blob_off = {ch: 0 for ch in self._blob_channels()}
        for seg in self._runs[dest]:
            extents: dict[str, int] = {}
            for ch in channels:
                if self._is_blob(ch):
                    blob = np.ascontiguousarray(self._blob_slice(mm, seg, ch))
                    _copy(ch, blob.tobytes())
                    off_f, nb_f = _EXTENTS[ch]
                    extents[off_f] = blob_off[ch]
                    extents[nb_f] = int(blob.size)
                    blob_off[ch] += int(blob.size)
                else:
                    _copy(ch, np.ascontiguousarray(
                        mm[ch][seg.offset:seg.offset + seg.length]
                    ).tobytes())
            new_runs.append(dataclasses.replace(seg, offset=off, **extents))
            off += seg.length
        del mm  # drop the read maps over the old inodes before replacing
        for ch in channels:
            tmp[ch].flush()
            os.fsync(tmp[ch].fileno())  # bytes durable before the name moves
            tmp[ch].close()
            os.replace(self._path(dest, ch) + ".vacuum",
                       self._path(dest, ch))
        self._runs[dest] = new_runs
        self._sizes[dest] = off
        for ch, b in blob_off.items():
            self._blob_bytes[ch][dest] = b

    def merged_slices(self, dest: int, capacity: int, read_chunk: int = 4096):
        """Destination-aligned fixed-shape slices of the merged stream.

        Yields ``(sdp, smsg, covered)``: ``sdp``/``smsg`` are (capacity,)
        padded with the ``dst = P`` sentinel (payload 0), exactly the sorted
        IMS layout ``apply_list`` consumes in mode="basic"; ``covered`` is the
        (P,) bool mask of destinations whose ENTIRE message run is in this
        slice. Whole runs never straddle slices, so any vertex-local
        ``apply_list`` sees the same per-vertex list as the in-memory path.
        Buffers are freshly allocated per slice (safe to alias into a tensor).
        """
        counts = self.dest_counts(dest)
        max_run = int(counts.max()) if counts.size else 0
        if max_run > capacity:
            raise ValueError(
                f"slice capacity {capacity} < max per-vertex message run "
                f"{max_run}; raise msg_slice_cap (Pregel's compute() needs a "
                "vertex's whole message list resident)"
            )
        # plan cut points: greedily pack whole destination runs, ascending
        positions = np.nonzero(counts > 0)[0]
        plans: list[tuple[int, int, int]] = []  # (first_pos, last_pos, n_msgs)
        lo = 0
        acc = 0
        for idx, p in enumerate(positions):
            c = int(counts[p])
            if acc and acc + c > capacity:
                plans.append((int(positions[lo]), int(positions[idx - 1]), acc))
                lo, acc = idx, 0
            acc += c
        if acc:
            plans.append((int(positions[lo]), int(positions[-1]), acc))

        chunks = self.iter_merged(dest, read_chunk)
        carry_dp = np.empty((0,), np.int32)
        carry_msg = np.empty((0,), self.msg_dtype)
        for first, last, n_msgs in plans:
            sdp = np.full((capacity,), self.P, np.int32)
            smsg = np.zeros((capacity,), self.msg_dtype)
            filled = 0
            while filled < n_msgs:
                if carry_dp.size == 0:
                    carry_dp, carry_msg = next(chunks)[:2]
                take = min(n_msgs - filled, carry_dp.size)
                sdp[filled:filled + take] = carry_dp[:take]
                smsg[filled:filled + take] = carry_msg[:take]
                carry_dp, carry_msg = carry_dp[take:], carry_msg[take:]
                filled += take
            covered = np.zeros((self.P,), bool)
            covered[first:last + 1] = counts[first:last + 1] > 0
            yield sdp, smsg, covered

    # -- persistence (the log-backed use) ------------------------------------
    def save_index(self) -> None:
        index = dict(
            n_shards=self.n_shards, P=self.P,
            msg_dtype=self.msg_dtype.name, with_counts=self.with_counts,
            compress=self.compress,
            compress_payload=self.payload_scheme,
            payload_channels=self.payload_channels,
            sizes=self._sizes, blob_bytes=self._blob_bytes,
            runs=[[s.__dict__ for s in runs] for runs in self._runs],
        )
        tmp = os.path.join(self.dir, f".{INDEX}.tmp")
        with open(tmp, "w") as f:
            json.dump(index, f)
            f.flush()
            os.fsync(f.fileno())  # the index is the recovery root: no
            # publish until the extents it describes are durable
        os.replace(tmp, os.path.join(self.dir, INDEX))

    @classmethod
    def open(cls, directory: str) -> "MessageRunStore":
        with open(os.path.join(directory, INDEX)) as f:
            m = json.load(f)
        store = cls(directory, m["n_shards"], m["P"],
                    np.dtype(m["msg_dtype"]), with_counts=m["with_counts"],
                    create=False, compress=m.get("compress", False),
                    compress_payload=m.get("compress_payload") or False,
                    payload_channels=m.get("payload_channels"))
        store._sizes = list(m["sizes"])
        blob = m.get("blob_bytes")
        if blob is None and "dp_bytes" in m and store.compress:
            blob = {"dp": m["dp_bytes"]}  # pre-payload-codec index layout
        for ch in store._blob_channels():
            store._blob_bytes[ch] = list((blob or {}).get(
                ch, [0] * m["n_shards"]))
        store._runs = [
            [RunSegment(**s) for s in runs] for runs in m["runs"]
        ]
        # counts rebuild lazily, per destination, on first use (one chunked
        # scan of that destination's LIVE runs — compaction leaves dead file
        # regions that must not be counted): recovery reads one destination
        # per replayed step, so eagerly scanning all of them would multiply
        # recovery I/O by n for nothing
        store._stale_counts = {
            k for k in range(store.n_shards) if store._runs[k]
        }
        return store

    # -- accounting / lifecycle ----------------------------------------------
    def disk_bytes(self) -> int:
        total = 0
        for k in range(self.n_shards):
            for ch in self._channels():
                try:
                    total += os.path.getsize(self._path(k, ch))
                except OSError:
                    pass
        return total

    def clear_dest(self, dest: int) -> None:
        """Drop one destination's runs (its messages were applied; §3.3:
        an OMS is deleted once consumed — unless a log retains it)."""
        for ch in self._channels():
            fh = self._wfh.pop((dest, ch), None)
            if fh is not None:
                fh.close()
            try:
                os.remove(self._path(dest, ch))
            except OSError:
                pass
        self._runs[dest] = []
        self._sizes[dest] = 0
        for ch in self._blob_bytes:
            self._blob_bytes[ch][dest] = 0
        self._counts[dest] = 0
        self._stale_counts.discard(dest)

    def close(self) -> None:
        for fh in self._wfh.values():
            fh.close()
        self._wfh = {}

    def delete(self) -> None:
        self.close()
        shutil.rmtree(self.dir, ignore_errors=True)


class _Cursor:
    """Fixed-size read window over one sorted run (the merge's only per-run
    resident state). Tracks every store channel so compaction can rewrite
    payload AND count data together; on compressed stores an encoded
    channel's window is refilled by its streaming decoder (varint-delta for
    dp, payload codec for msg/cnt) instead of a memmap slice, keeping the
    same O(read_chunk) residency."""

    def __init__(self, mm: dict, seg: RunSegment, read_chunk: int,
                 channels: tuple[str, ...],
                 decoders: dict[str, object] | None = None):
        self._mm = mm
        self._channels = channels
        self._pos = seg.offset
        self._end = seg.offset + seg.length
        self._chunk = max(1, read_chunk)
        self._decs = decoders or {}
        self._bufs: tuple[np.ndarray, ...] = ()
        self._bpos = 0
        self._fill()

    def _fill(self) -> None:
        n = min(self._chunk, self._end - self._pos)
        bufs = []
        for ch in self._channels:
            dec = self._decs.get(ch)
            if dec is not None:
                vals = dec.take(n)
                bufs.append(np.asarray(
                    vals, np.int32 if ch != "msg" else vals.dtype))
            else:
                bufs.append(np.array(self._mm[ch][self._pos:self._pos + n]))
        self._bufs = tuple(bufs)
        self._pos += n
        self._bpos = 0

    @property
    def head(self) -> int:
        return int(self._bufs[0][self._bpos])

    @property
    def exhausted(self) -> bool:
        return self._bpos >= self._bufs[0].size and self._pos >= self._end

    def take_until(self, bound: int | None):
        """Return buffered elements with dp <= bound (>= 1 element; the heap
        guarantees head <= bound), refilling the window afterwards if empty."""
        dp = self._bufs[0]
        if bound is None:
            hi = dp.size
        else:
            hi = int(np.searchsorted(dp[self._bpos:], bound,
                                     side="right")) + self._bpos
        out = tuple(buf[self._bpos:hi] for buf in self._bufs)
        self._bpos = hi
        if self._bpos >= dp.size and self._pos < self._end:
            self._fill()
        return out
