"""Out-of-core streaming (paper §3–§4): the on-disk edge-block store, the
double-buffered prefetching reader behind the engine's ``streamed`` mode,
the disk-spilled outgoing-message (OMS) run store with its §3.3.1 external
merge for combiner-less programs, the full-duplex outbox→inbox channel
layer that overlaps transmission AND receiver digest with compute (§4),
the varint-delta codec behind the ``compress=`` knobs, and the payload
codec behind ``compress_payload=``.
"""

from repro_torch.streams.store import EdgeStreamStore, StoreGeometry
from repro_torch.streams.reader import (
    StagedChunk, StreamReader, StreamStats, prefetch_iter,
)
from repro_torch.streams.schedule import plan_stream_schedule
from repro_torch.streams.msgstore import MessageRunStore, RunSegment
from repro_torch.streams.channel import (
    ChannelError, ChannelReceiver, ChannelStats, FaultPoint, ShardChannels,
    receive_iter,
)
from repro_torch.streams.codec import (
    PayloadDecoder, PayloadEncoder, VarintDeltaDecoder, decode_payload,
    decode_varint_delta, encode_payload, encode_varint_delta,
)

__all__ = [
    "EdgeStreamStore",
    "StoreGeometry",
    "StagedChunk",
    "StreamReader",
    "StreamStats",
    "prefetch_iter",
    "plan_stream_schedule",
    "MessageRunStore",
    "RunSegment",
    "ChannelError",
    "ChannelReceiver",
    "ChannelStats",
    "FaultPoint",
    "ShardChannels",
    "receive_iter",
    "PayloadDecoder",
    "PayloadEncoder",
    "VarintDeltaDecoder",
    "decode_payload",
    "decode_varint_delta",
    "encode_payload",
    "encode_varint_delta",
]
