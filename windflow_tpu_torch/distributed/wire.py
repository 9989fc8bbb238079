"""Shared wire codec: columnar batch frames + the shuffle message layer
(docs/DISTRIBUTED.md "Wire protocol").

Two framings live here:

* the **batch codec** (``encode_batch`` / ``decode_batch`` /
  :class:`StreamDecoder`) -- the ``WFB1`` frame the ingest plane's
  ``SocketSource`` has spoken from the start, promoted out of
  ``ingest/codec.py`` so the inter-worker shuffle transport and the
  ingest sources share ONE codec (``ingest.codec`` remains as a
  deprecation shim).  One frame carries one ``TupleBatch`` as a
  length-prefixed columnar payload -- the network twin of the
  in-process struct-of-arrays currency, so a decoded frame enters the
  batch plane zero-copy (each column is a view over the receive
  buffer)::

      [magic 'WFB1'][u32 payload_len] payload:
          [u16 n_cols] then per column:
              [u8 name_len][name utf-8][u8 dtype tag][u32 byte_len][raw LE]

* the **shuffle message layer** (``encode_msg`` / :class:`MsgDecoder`,
  ``WFM1`` frames) -- the framing of cross-worker PipeGraph edges
  (distributed/transport.py).  Every channel item of an in-process
  edge has a wire twin: data batches (the batch-codec payload),
  pickled record items, ``EpochBarrier`` control items, per-producer
  EOS -- plus the control traffic the in-process planes get for free:
  credit replenishment (backpressure), HELLO (edge identification /
  reconnect resume), CANCEL (cross-worker failure propagation) and a
  STATS trailer (the producer-side delivery book the consumer audits
  against)::

      [magic 'WFM1'][u8 kind][u16 pid][u64 seq][u32 payload_len][payload]

  ``pid`` is the producer id the item would have carried on the
  in-process channel (both sides build the same wired graph, so ids
  agree by construction).  ``seq`` numbers the data-plane stream per
  (edge, producer-worker) connection: receivers detect wire loss as
  sequence gaps, drop duplicates after a reconnect resume, and ack by
  sequence in every CREDIT frame so the sender can retire its bounded
  replay buffer.

Trace contexts (telemetry/trace.py) serialize into the data-frame
header: hop stamps are rebased onto the receiver's clock and the
crossing itself lands as an ``@wire``-suffixed hop, which the
diagnosis plane's attribution charges to the ``wire`` class.
"""
from __future__ import annotations

import json
import pickle
import struct
import time as _time
from typing import List, Optional, Tuple

import numpy as np

from ..core.tuples import TupleBatch
from ..runtime.queues import EpochBarrier
from ..telemetry.trace import MAX_HOPS, TraceContext

MAGIC = b"WFB1"
_HEADER = struct.Struct("<4sI")

_DTYPE_TAGS = {
    np.dtype("<i8"): 0, np.dtype("<f8"): 1,
    np.dtype("<i4"): 2, np.dtype("<f4"): 3,
}
_TAG_DTYPES = {v: k for k, v in _DTYPE_TAGS.items()}


def encode_batch_payload(batch: TupleBatch) -> bytes:
    """The columnar payload of one batch (no outer header) -- shared by
    the ingest frame and the shuffle DATA message."""
    parts = [struct.pack("<H", len(batch.cols))]
    for name, col in batch.cols.items():
        col = np.ascontiguousarray(col)
        if col.dtype not in _DTYPE_TAGS:
            # normalize exotic ints/floats instead of refusing the batch
            col = col.astype(np.float64 if col.dtype.kind == "f"
                             else np.int64)
        raw = col.tobytes()
        nb = name.encode("utf-8")
        if len(nb) > 255:
            raise ValueError(f"column name too long: {name!r}")
        parts.append(struct.pack("<B", len(nb)))
        parts.append(nb)
        parts.append(struct.pack("<BI", _DTYPE_TAGS[col.dtype], len(raw)))
        parts.append(raw)
    return b"".join(parts)


def encode_batch(batch: TupleBatch) -> bytes:
    """One framed ingest wire message for ``batch``."""
    payload = encode_batch_payload(batch)
    return _HEADER.pack(MAGIC, len(payload)) + payload


def decode_batch(payload: bytes) -> TupleBatch:
    """Decode one frame payload (without the 8-byte header)."""
    view = memoryview(payload)
    (n_cols,) = struct.unpack_from("<H", view, 0)
    off = 2
    cols = {}
    for _ in range(n_cols):
        (name_len,) = struct.unpack_from("<B", view, off)
        off += 1
        name = bytes(view[off:off + name_len]).decode("utf-8")
        off += name_len
        tag, nbytes = struct.unpack_from("<BI", view, off)
        off += 5
        if tag not in _TAG_DTYPES:
            raise ValueError(f"unknown dtype tag {tag} in frame")
        cols[name] = np.frombuffer(view[off:off + nbytes],
                                   dtype=_TAG_DTYPES[tag])
        off += nbytes
    return TupleBatch(cols)


class StreamDecoder:
    """Incremental ingest-frame decoder over a byte stream."""

    def __init__(self, max_frame_bytes: int = 1 << 28):
        self._buf = bytearray()
        self.max_frame_bytes = max_frame_bytes
        self.frames_decoded = 0

    def feed(self, data: bytes) -> List[TupleBatch]:
        """Append received bytes; return every now-complete batch."""
        self._buf.extend(data)
        out: List[TupleBatch] = []
        while True:
            frame = self._next_frame()
            if frame is None:
                return out
            out.append(frame)

    def _next_frame(self) -> Optional[TupleBatch]:
        if len(self._buf) < _HEADER.size:
            return None
        magic, length = _HEADER.unpack_from(bytes(self._buf[:_HEADER.size]))
        if magic != MAGIC:
            raise ValueError(f"bad frame magic {magic!r} (stream desync)")
        if length > self.max_frame_bytes:
            raise ValueError(f"frame of {length} bytes exceeds the "
                             f"{self.max_frame_bytes} limit")
        end = _HEADER.size + length
        if len(self._buf) < end:
            return None
        # copy the payload out so decoded columns do not pin (or get
        # corrupted by) the growing receive buffer
        payload = bytes(self._buf[_HEADER.size:end])
        del self._buf[:end]
        self.frames_decoded += 1
        return decode_batch(payload)

    def pending_bytes(self) -> int:
        return len(self._buf)


# ---------------------------------------------------------------------------
# Shuffle message layer (distributed/transport.py speaks this)
# ---------------------------------------------------------------------------

MSG_MAGIC = b"WFM1"
_MSG_HEADER = struct.Struct("<4sBHQI")  # magic, kind, pid, seq, len

# message kinds -- data plane (sequenced, credit-charged):
MSG_DATA = 1      # columnar TupleBatch (+ optional trace header)
MSG_RECORD = 2    # pickled scalar item / EOSMarker (+ optional trace)
MSG_BARRIER = 3   # EpochBarrier control item
MSG_EOS = 4       # per-producer end of stream
MSG_STATS = 7     # producer-side delivery-book trailer (per pid-less edge)
# control plane (unsequenced, free):
MSG_HELLO = 0     # connection open / reconnect resume (JSON)
MSG_CREDIT = 5    # consumer -> producer: tuples granted + acked seq
MSG_CANCEL = 6    # either direction: graph cancelled, reason utf-8

DATA_KINDS = frozenset((MSG_DATA, MSG_RECORD, MSG_BARRIER, MSG_EOS,
                        MSG_STATS))

_BARRIER_PAYLOAD = struct.Struct("<qB")
_CREDIT_PAYLOAD = struct.Struct("<IQ")


def encode_msg(kind: int, pid: int, seq: int, payload: bytes = b"") -> bytes:
    return _MSG_HEADER.pack(MSG_MAGIC, kind, pid, seq, len(payload)) \
        + payload


class MsgDecoder:
    """Incremental shuffle-message decoder: feed arbitrary byte chunks,
    get complete ``(kind, pid, seq, payload)`` messages.  Oversized
    frames and foreign magic raise -- a desynced stream must fail loud,
    never deliver garbage into a channel."""

    def __init__(self, max_frame_bytes: int = 1 << 28):
        self._buf = bytearray()
        self.max_frame_bytes = max_frame_bytes
        self.msgs_decoded = 0

    def feed(self, data: bytes) -> List[Tuple[int, int, int, bytes]]:
        self._buf.extend(data)
        out: List[Tuple[int, int, int, bytes]] = []
        while True:
            if len(self._buf) < _MSG_HEADER.size:
                return out
            magic, kind, pid, seq, length = _MSG_HEADER.unpack_from(
                bytes(self._buf[:_MSG_HEADER.size]))
            if magic != MSG_MAGIC:
                raise ValueError(
                    f"bad shuffle magic {magic!r} (stream desync)")
            if length > self.max_frame_bytes:
                raise ValueError(
                    f"shuffle frame of {length} bytes exceeds the "
                    f"{self.max_frame_bytes} limit")
            end = _MSG_HEADER.size + length
            if len(self._buf) < end:
                return out
            payload = bytes(self._buf[_MSG_HEADER.size:end])
            del self._buf[:end]
            self.msgs_decoded += 1
            out.append((kind, pid, seq, payload))

    def pending_bytes(self) -> int:
        return len(self._buf)


# -- trace serialization ----------------------------------------------------

def _trace_header(item) -> bytes:
    """``[u16 len][json]`` trace header of a data-plane payload; the
    zero-length header means untraced.  Times ship as offsets relative
    to the context's source stamp (perf_counter bases do not survive a
    process boundary) plus one wall-clock send stamp so the receiver
    can estimate the wire residency."""
    ctx = getattr(item, "trace", None)
    if ctx is None:
        return struct.pack("<H", 0)
    now = _time.perf_counter()
    doc = {
        "src": ctx.src,
        "id": getattr(ctx, "trace_id", None),
        "age_s": round(now - ctx.t0, 9),
        "last_s": round(ctx.last - ctx.t0, 9),
        "sent_unix": _time.time(),
        "hops": [[name, round(a - ctx.t0, 9), round(d - ctx.t0, 9), *rest]
                 for name, a, d, *rest in ctx.hops],
    }
    blob = json.dumps(doc).encode("utf-8")
    if len(blob) > 0xFFFF:  # pathological hop list: ship untraced
        return struct.pack("<H", 0)
    return struct.pack("<H", len(blob)) + blob


def _split_trace(payload: bytes) -> Tuple[Optional[dict], bytes]:
    (tlen,) = struct.unpack_from("<H", payload, 0)
    body = payload[2 + tlen:]
    if tlen == 0:
        return None, body
    try:
        doc = json.loads(payload[2:2 + tlen].decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None, body
    return doc, body


def rebuild_trace(doc: Optional[dict], edge: str,
                  arrival: Optional[float] = None) -> Optional[TraceContext]:
    """Reconstruct a TraceContext on the receiver's clock.  The wire
    residency (send wall stamp -> arrival wall stamp, clamped >= 0) is
    stamped as an ``{edge}@wire`` hop so attribution charges the
    crossing to the ``wire`` class; hop offsets rebase exactly, so
    per-operator shares survive the boundary (gauge-grade across hosts:
    the wall clocks must roughly agree)."""
    if doc is None:
        return None
    if arrival is None:
        arrival = _time.perf_counter()
    wire_s = max(0.0, _time.time() - float(doc.get("sent_unix") or 0.0))
    age = float(doc.get("age_s") or 0.0)
    last = float(doc.get("last_s") or 0.0)
    ctx = TraceContext(str(doc.get("src") or "?"),
                       arrival - age - wire_s,
                       trace_id=doc.get("id"))
    for hop in doc.get("hops") or ():
        try:
            name, a, d = hop[0], float(hop[1]), float(hop[2])
        except (TypeError, ValueError, IndexError):
            continue
        meta = hop[3] if len(hop) > 3 and isinstance(hop[3], dict) else None
        if len(ctx.hops) < MAX_HOPS:
            ctx.hops.append((str(name), ctx.t0 + a, ctx.t0 + d) if meta
                            is None else
                            (str(name), ctx.t0 + a, ctx.t0 + d, meta))
    ctx.hop(f"{edge}@wire", ctx.t0 + last + 1e-9, arrival)
    return ctx


# -- item <-> message -------------------------------------------------------

def encode_item(item, pool=None) -> Tuple[int, bytes, int]:
    """``(kind, payload, tuple_cost)`` of one channel item.  Batches go
    columnar; ``EpochBarrier`` control items ride a dedicated kind (so
    the receiver never unpickles them on the hot path); everything else
    -- scalar records, EOSMarkers -- pickles.  SynthChunk descriptors
    materialize at the boundary: their generator closures do not cross
    processes."""
    from ..core.tuples import SynthChunk
    if isinstance(item, SynthChunk):
        item = item.materialize(pool)
    if isinstance(item, TupleBatch):
        return (MSG_DATA,
                _trace_header(item) + encode_batch_payload(item),
                max(1, len(item)))
    if type(item) is EpochBarrier:
        return (MSG_BARRIER,
                _trace_header(None)
                + _BARRIER_PAYLOAD.pack(item.epoch, 1 if item.final else 0),
                1)
    trace = _trace_header(item)
    tr = getattr(item, "trace", None)
    if tr is not None:
        # the context must not pickle (thread-unsafe perf stamps; it is
        # re-built from the header on the other side)
        try:
            item.trace = None
        except AttributeError:
            pass
    try:
        blob = pickle.dumps(item, protocol=pickle.HIGHEST_PROTOCOL)
    finally:
        if tr is not None:
            try:
                item.trace = tr
            except AttributeError:
                pass
    return MSG_RECORD, trace + blob, 1


def decode_item(kind: int, payload: bytes, edge: str):
    """``(item, tuple_cost)`` of one data message (DATA/RECORD/BARRIER).
    The trace header, when present, is rebuilt onto the local clock and
    attached to the decoded item."""
    doc, body = _split_trace(payload)
    if kind == MSG_DATA:
        item = decode_batch(body)
        cost = max(1, len(item))
    elif kind == MSG_BARRIER:
        epoch, final = _BARRIER_PAYLOAD.unpack(body)
        return EpochBarrier(epoch, final=bool(final)), 1
    elif kind == MSG_RECORD:
        item = pickle.loads(body)
        cost = 1
    else:  # pragma: no cover - caller dispatches data kinds only
        raise ValueError(f"not a data message kind: {kind}")
    ctx = rebuild_trace(doc, edge)
    if ctx is not None:
        try:
            item.trace = ctx
        except AttributeError:
            pass
    return item, cost


def encode_credit(tuples: int, acked_seq: int) -> bytes:
    return encode_msg(MSG_CREDIT, 0, 0,
                      _CREDIT_PAYLOAD.pack(tuples, acked_seq))


def decode_credit(payload: bytes) -> Tuple[int, int]:
    return _CREDIT_PAYLOAD.unpack(payload)
