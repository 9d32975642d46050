"""Codecs for the byte streams the paper pays sequential bandwidth for.

The paper's streaming analysis (§3) argues cost in terms of *sequential disk
bandwidth*, so shrinking the byte stream is a direct superstep speedup. Two
codec families live here:

* **varint-delta** for sorted position columns: the sorted ``dst_pos`` of a
  message run (and the source-sorted ``src_pos`` of an edge block) is
  monotone, so consecutive deltas are tiny and a varint encoding stores most
  of them in one byte instead of four;
* **payload codec** for the value columns (message payloads, edge weights,
  combine counts): block-wise byte-plane shuffle + DEFLATE — similar floats
  share exponent/high-mantissa bytes, so transposing the byte planes turns
  them into long runs the stdlib ``zlib`` folds away, LOSSLESSLY (the
  equivalence matrix stays bit-identical). The optional ``"bf16"`` scheme
  additionally rounds float32 payloads to bfloat16 on the wire — the same
  trick ``mode="recoded_compact"`` plays in memory — halving the stream
  before the shuffle at the cost of bf16 rounding (float-message programs
  only; the engine enforces the same guard as recoded_compact).

Encoding: first value absolute, the rest first-order deltas; every delta is
zigzag-mapped (so out-of-order inputs — e.g. the unsorted ``dst_pos`` column
of a source-sorted edge block, or the ``-1`` padding tail — still round-trip,
they just compress less) and LEB128 varint-packed, 7 bits per byte with a
continuation MSB.

Both directions are numpy-vectorized (no per-value Python loop):

* :func:`encode_varint_delta` builds the byte-length table for all values at
  once and scatters the 7-bit groups by position;
* :func:`decode_varint_delta` recovers value boundaries from the
  continuation bits with one cumulative sum and reassembles every value with
  a single ``np.add.at``.

:class:`VarintDeltaDecoder` is the streaming form: it decodes a blob in
bounded chunks while carrying the delta predecessor across calls, so the
external-merge cursors of ``streams/msgstore.py`` keep their O(read_chunk)
residency over compressed runs. Chained encoding (``prev=``) is the mirror
image, used by run compaction to emit one logical stream chunk-by-chunk.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_U64 = np.uint64
_MAX_VARINT_BYTES = 10  # ceil(64 / 7)

#: values per self-contained payload block: the unit of streaming decode —
#: a reader never holds more than one decoded block per cursor, so
#: compressed payload runs keep the same O(read_chunk)-class residency as
#: the fixed-width channels they replace
PAYLOAD_BLOCK = 4096

#: conservative planning estimate of the payload codec's shrink on message
#: payload channels (measured ~0.4x on combined (msg, cnt) PageRank wire
#: traffic; planners that promise less than the codec delivers stay
#: feasible). Shared with core/plan.py's net-budget ladder.
PAYLOAD_RATIO_ESTIMATE = 0.7

#: payload codec schemes: "lossless" = byte-plane shuffle + DEFLATE
#: (bit-exact round-trip for ANY dtype); "bf16" = float32 -> bfloat16
#: rounding first (recoded_compact's wire trick), then shuffle + DEFLATE
PAYLOAD_SCHEMES = ("lossless", "bf16")


def normalize_payload_scheme(compress_payload, allow_auto: bool = False
                             ) -> str | None:
    """THE ``compress_payload`` knob normalization — ``False`` -> None,
    ``True`` -> "lossless", a scheme name passes through. Every consumer
    (``ChannelConfig``, ``MessageRunStore``) delegates here so the accepted
    value set cannot drift from the codec's scheme table.

    ``"auto"`` (config surface only, hence opt-in via ``allow_auto``) defers
    the choice to a first-superstep sample: the engine spills the first
    superstep raw, measures the lossless codec on those runs via
    :class:`PayloadAutoPicker`, and picks lossless vs raw per value channel.
    Stores never see "auto" — they get the resolved scheme."""
    if not compress_payload:
        return None
    if compress_payload is True:
        return "lossless"
    if compress_payload == "auto" and allow_auto:
        return "auto"
    if compress_payload not in PAYLOAD_SCHEMES:
        raise ValueError(
            f"unknown compress_payload={compress_payload!r}; use a bool"
            f"{', auto' if allow_auto else ''} or one of {PAYLOAD_SCHEMES}"
        )
    return compress_payload


class PayloadAutoPicker:
    """First-superstep payload-codec sampling (``compress_payload="auto"``).

    The engine attaches one of these to the first superstep's message store
    (``MessageRunStore.payload_sampler``); ``offer`` sees every value column
    the store spills — possibly from the channel sender thread; the counter
    updates are GIL-atomic and there is a single writer — and trial-encodes
    the first ``max_samples`` runs per channel with the LOSSLESS codec. At
    superstep end the engine asks :meth:`choose` which channels measured a
    ratio better than ``threshold`` and fixes the wire format for every
    later superstep; raw spilling meanwhile means the sample costs no codec
    work on the critical path beyond the trial encodes themselves.
    """

    def __init__(self, max_samples: int = 8, threshold: float = 0.9):
        self.max_samples = int(max_samples)
        self.threshold = float(threshold)
        self._raw: dict[str, int] = {}  # channel -> sampled decoded bytes
        self._enc: dict[str, int] = {}  # channel -> lossless-encoded bytes
        self._n: dict[str, int] = {}  # channel -> runs sampled

    def offer(self, channel: str, values: np.ndarray) -> None:
        n = self._n.get(channel, 0)
        if n >= self.max_samples or values.size == 0:
            return
        arr = np.ascontiguousarray(values)
        self._n[channel] = n + 1
        self._raw[channel] = self._raw.get(channel, 0) + arr.nbytes
        self._enc[channel] = (self._enc.get(channel, 0)
                              + len(encode_payload(arr, "lossless")))

    @property
    def sampled(self) -> bool:
        return bool(self._n)

    def ratios(self) -> dict[str, float]:
        """Measured encoded/raw byte ratio per sampled channel (< 1 means
        the codec shrinks that channel's wire bytes)."""
        return {ch: self._enc[ch] / self._raw[ch]
                for ch in self._n if self._raw.get(ch)}

    def choose(self) -> tuple[str, ...]:
        """Channels whose measured ratio beats the threshold — the store's
        ``payload_channels`` for every subsequent superstep."""
        return tuple(sorted(ch for ch, r in self.ratios().items()
                            if r < self.threshold))

    def summary(self) -> str:
        """Human-readable record of the decision, e.g.
        ``"cnt=lossless(0.31) msg=raw(0.97)"`` — stored in
        ``ChannelStats.payload_choice``."""
        picked = set(self.choose())
        return " ".join(
            f"{ch}={'lossless' if ch in picked else 'raw'}({r:.2f})"
            for ch, r in sorted(self.ratios().items())
        )

_BLOCK_HEADER = struct.Struct("<II")  # (compressed nbytes, n values)


def encode_varint_delta(values: np.ndarray, prev: int | None = None) -> bytes:
    """Delta + zigzag + LEB128 encode ``values`` (any integer dtype).

    ``prev`` chains encoding across chunks of one logical stream: when given,
    the first delta is ``values[0] - prev`` instead of an absolute value, so
    ``encode(a) + encode(b, prev=a[-1])`` decodes identically to
    ``encode(concat(a, b))``.
    """
    v = np.asarray(values, dtype=np.int64)
    if v.ndim != 1:
        raise ValueError("encode_varint_delta takes a 1-D integer array")
    if v.size == 0:
        return b""
    d = np.empty_like(v)
    d[0] = v[0] if prev is None else v[0] - int(prev)
    np.subtract(v[1:], v[:-1], out=d[1:])
    # zigzag: sign bit to bit 0, magnitude doubled -> small |delta| stays small
    z = ((d << 1) ^ (d >> 63)).astype(_U64)

    nbytes = np.ones(z.shape, np.int64)
    rest = z >> _U64(7)
    while rest.any():
        nbytes += (rest > 0)
        rest >>= _U64(7)
    ends = np.cumsum(nbytes)
    starts = ends - nbytes
    out = np.zeros(int(ends[-1]), np.uint8)
    for j in range(int(nbytes.max())):
        m = nbytes > j
        group = ((z[m] >> _U64(7 * j)) & _U64(0x7F)).astype(np.uint8)
        cont = (nbytes[m] - 1 > j).astype(np.uint8) << 7
        out[starts[m] + j] = group | cont
    return out.tobytes()


def decode_varint_delta(data: bytes | np.ndarray,
                        prev: int | None = None) -> np.ndarray:
    """Inverse of :func:`encode_varint_delta`; returns int64 values.

    ``prev`` must match the value passed at encode time (None for a
    self-contained blob, the predecessor value for a chained chunk).
    """
    b = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else data.astype(np.uint8, copy=False)
    if b.size == 0:
        return np.empty((0,), np.int64)
    is_end = (b & 0x80) == 0
    if not is_end[-1]:
        raise ValueError("truncated varint stream (dangling continuation)")
    vid = np.zeros(b.size, np.int64)
    np.cumsum(is_end[:-1], out=vid[1:])
    val_starts = np.concatenate([[0], np.nonzero(is_end)[0][:-1] + 1])
    pos = np.arange(b.size, dtype=np.int64) - val_starts[vid]
    if int(pos.max()) >= _MAX_VARINT_BYTES:
        raise ValueError("varint longer than 10 bytes (corrupt stream)")
    z = np.zeros(int(vid[-1]) + 1, _U64)
    contrib = (b & 0x7F).astype(_U64) << (_U64(7) * pos.astype(_U64))
    np.add.at(z, vid, contrib)  # 7-bit groups never overlap -> add == or
    # un-zigzag in uint64 (a signed shift would sign-extend bit 63 and
    # corrupt |values| >= 2^62), then reinterpret the bits as int64
    d = ((z >> _U64(1)) ^ (_U64(0) - (z & _U64(1)))).view(np.int64)
    if prev is not None:
        d = d.copy()
        d[0] += int(prev)
    return np.cumsum(d)


class VarintDeltaDecoder:
    """Streaming decoder over one encoded blob: yields bounded chunks of
    values in order, holding only a cursor (byte position + predecessor) —
    the compressed-run counterpart of a fixed-size read window."""

    def __init__(self, blob: np.ndarray | bytes, n_values: int):
        self._blob = (np.frombuffer(blob, np.uint8)
                      if not isinstance(blob, np.ndarray) else blob)
        self._n = int(n_values)
        self._done = 0
        self._byte = 0
        self._prev: int | None = None

    @property
    def remaining(self) -> int:
        return self._n - self._done

    def take(self, count: int) -> np.ndarray:
        """Decode the next ``min(count, remaining)`` values."""
        count = min(int(count), self.remaining)
        if count <= 0:
            return np.empty((0,), np.int64)
        # a value is <= 10 bytes: a bounded byte window always covers `count`
        window = self._blob[self._byte:
                            self._byte + count * _MAX_VARINT_BYTES]
        is_end = (window & 0x80) == 0
        ends = np.nonzero(is_end)[0]
        if ends.size < count:
            raise ValueError("truncated varint stream (short blob)")
        used = int(ends[count - 1]) + 1
        vals = decode_varint_delta(window[:used], prev=self._prev)
        self._byte += used
        self._done += count
        self._prev = int(vals[-1])
        return vals


# --------------------------------------------------------------------------
# payload codec (value columns: message payloads, edge weights, counts)
# --------------------------------------------------------------------------

def _f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit pattern (uint16), round-to-nearest-even —
    the rounding of a cast to bfloat16 (``Tensor.to(torch.bfloat16)``), so
    the wire matches what recoded_compact would have put in memory. NaN
    must bypass the rounding bias (it would carry into the exponent and
    turn NaN into ±0) and stays NaN with the quiet bit forced."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rounding = np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))
    rounded = ((b + rounding) >> np.uint32(16)).astype(np.uint16)
    is_nan = (b & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    quiet_nan = ((b >> np.uint32(16)).astype(np.uint16)
                 | np.uint16(0x0040))
    return np.where(is_nan, quiet_nan, rounded)


def _bf16_bits_to_f32(b: np.ndarray) -> np.ndarray:
    return (b.astype(np.uint32) << np.uint32(16)).view(np.float32)


def _shuffle_bytes(arr: np.ndarray) -> bytes:
    """Byte-plane transposition: plane j holds byte j of every value, so the
    near-constant sign/exponent planes of similar floats (and the zero high
    bytes of small ints) become long runs DEFLATE collapses."""
    raw = np.ascontiguousarray(arr).view(np.uint8)
    return raw.reshape(arr.size, arr.itemsize).T.tobytes()


def _unshuffle_bytes(data: bytes, dtype: np.dtype, n: int) -> np.ndarray:
    planes = np.frombuffer(data, np.uint8).reshape(dtype.itemsize, n)
    return np.ascontiguousarray(planes.T).reshape(-1).view(dtype)[:n]


def encode_payload(values: np.ndarray, scheme: str = "lossless") -> bytes:
    """Encode a value column as self-contained compressed blocks.

    Block format: ``<u32 compressed nbytes><u32 n values><DEFLATE data>``,
    each covering up to :data:`PAYLOAD_BLOCK` values — so concatenating two
    encoded streams yields a valid encoded stream (run compaction emits
    merged runs chunk-by-chunk through :class:`PayloadEncoder`).
    """
    if scheme not in PAYLOAD_SCHEMES:
        raise ValueError(f"unknown payload scheme {scheme!r}")
    arr = np.ascontiguousarray(values)
    if arr.ndim != 1:
        raise ValueError("encode_payload takes a 1-D array")
    if scheme == "bf16":
        if arr.dtype != np.float32:
            raise ValueError("payload scheme 'bf16' needs float32 values")
        arr = _f32_to_bf16_bits(arr)
    out = []
    for off in range(0, arr.size, PAYLOAD_BLOCK):
        block = arr[off:off + PAYLOAD_BLOCK]
        comp = zlib.compress(_shuffle_bytes(block), 6)
        out.append(_BLOCK_HEADER.pack(len(comp), block.size))
        out.append(comp)
    return b"".join(out)


class PayloadEncoder:
    """Chunk-wise payload encoding for one logical stream: buffers values to
    full :data:`PAYLOAD_BLOCK` blocks so that feeding a stream in arbitrary
    small chunks (the external merge yields per-cursor fragments) produces
    the same dense block layout — and ratio — as one-shot encoding."""

    def __init__(self, dtype, scheme: str = "lossless"):
        self.dtype = np.dtype(dtype)
        self.scheme = scheme
        self._pending = np.empty((0,), self.dtype)

    def add(self, values: np.ndarray) -> bytes:
        """Absorb ``values``; returns the bytes of any blocks completed."""
        buf = np.concatenate(
            [self._pending, np.ascontiguousarray(values, self.dtype)]
        )
        full = (buf.size // PAYLOAD_BLOCK) * PAYLOAD_BLOCK
        self._pending = buf[full:]
        return encode_payload(buf[:full], self.scheme) if full else b""

    def flush(self) -> bytes:
        out = encode_payload(self._pending, self.scheme)
        self._pending = np.empty((0,), self.dtype)
        return out


class PayloadDecoder:
    """Streaming decoder over one encoded payload blob: yields bounded
    chunks of values in order, holding at most one decoded block — the
    compressed-payload counterpart of a fixed-size read window."""

    def __init__(self, blob: np.ndarray | bytes, dtype,
                 n_values: int, scheme: str = "lossless"):
        if scheme not in PAYLOAD_SCHEMES:
            raise ValueError(f"unknown payload scheme {scheme!r}")
        self._blob = (np.frombuffer(blob, np.uint8)
                      if not isinstance(blob, np.ndarray) else blob)
        self.dtype = np.dtype(dtype)
        self.scheme = scheme
        self._n = int(n_values)
        self._done = 0
        self._byte = 0
        self._buf = np.empty((0,), self.dtype)

    @property
    def remaining(self) -> int:
        return self._n - self._done

    def _next_block(self) -> np.ndarray:
        hdr = bytes(self._blob[self._byte:self._byte + _BLOCK_HEADER.size])
        if len(hdr) < _BLOCK_HEADER.size:
            raise ValueError("truncated payload stream (short header)")
        nbytes, nvals = _BLOCK_HEADER.unpack(hdr)
        start = self._byte + _BLOCK_HEADER.size
        comp = bytes(self._blob[start:start + nbytes])
        if len(comp) < nbytes:
            raise ValueError("truncated payload stream (short block)")
        self._byte = start + nbytes
        raw = zlib.decompress(comp)
        store_dt = np.dtype(np.uint16) if self.scheme == "bf16" else self.dtype
        vals = _unshuffle_bytes(raw, store_dt, nvals)
        if self.scheme == "bf16":
            vals = _bf16_bits_to_f32(vals)
        return vals

    def take(self, count: int) -> np.ndarray:
        """Decode the next ``min(count, remaining)`` values."""
        count = min(int(count), self.remaining)
        if count <= 0:
            return np.empty((0,), self.dtype)
        parts = []
        got = 0
        while got < count:
            if self._buf.size == 0:
                self._buf = self._next_block()
            take = min(count - got, self._buf.size)
            parts.append(self._buf[:take])
            self._buf = self._buf[take:]
            got += take
        self._done += count
        out = np.concatenate(parts) if len(parts) > 1 else parts[0]
        return np.ascontiguousarray(out)


def decode_payload(blob: np.ndarray | bytes, dtype, n_values: int,
                   scheme: str = "lossless") -> np.ndarray:
    """One-shot inverse of :func:`encode_payload`."""
    return PayloadDecoder(blob, dtype, n_values, scheme).take(n_values)
