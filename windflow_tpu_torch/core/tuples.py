"""Tuple contract and the columnar batch type.

The reference imposes a structural contract on user types:
``getControlFields() -> (key, id, ts)`` / ``setControlFields(key,id,ts)``
(used e.g. at win_seq.hpp:331-333; test type mp_tests_gpu/mp_common.hpp:44-81).
We keep that contract for the record-oriented plane and add the thing the
reference cannot have: a **columnar TupleBatch** -- the native currency of
the TPU plane.  A stream here is a sequence of batches (struct-of-arrays),
which is what the device wants; single records exist only at the API edge.
"""
from __future__ import annotations

import sys
import threading
from typing import Any, Dict, Iterator, Optional, Protocol, Tuple, \
    runtime_checkable

import numpy as np


class ColumnPool:
    """Arena of reusable numpy column buffers (per PipeGraph).

    ``take(n, dtype)`` returns a length-``n`` view over a pooled
    power-of-two buffer.  Reuse is **refcount-driven**: the pool keeps a
    strong reference to every base buffer it handed out; a buffer whose
    only remaining referent is the pool itself (every downstream view
    of it has died) is free and gets re-lent.  No explicit release call
    exists, so a consumer holding a batch alive can never have its
    columns scribbled over -- the safety property an explicit-free
    arena cannot give a Python dataflow.

    The per-(dtype, bucket) freelists are bounded (``max_per_bucket``)
    so a burst of in-flight batches degrades to plain allocation
    instead of growing the arena without bound.
    """

    __slots__ = ("_lock", "_buckets", "max_per_bucket", "hits", "misses")

    # refcount of a free base buffer: the bucket list + the loop local
    # + the getrefcount argument
    _FREE_RC = 3

    def __init__(self, max_per_bucket: int = 32):
        self._lock = threading.Lock()
        self._buckets: Dict[Tuple[str, int], list] = {}
        self.max_per_bucket = max_per_bucket
        self.hits = 0
        self.misses = 0

    def take(self, n: int, dtype) -> np.ndarray:
        """A length-``n`` uninitialized view over a pooled buffer."""
        dt = np.dtype(dtype)
        if n <= 0:
            return np.empty(0, dt)
        cap = 1 << (int(n) - 1).bit_length()
        key = (dt.str, cap)
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is not None:
                for buf in bucket:
                    # free iff nothing outside this pool references it
                    if sys.getrefcount(buf) <= self._FREE_RC:
                        self.hits += 1
                        return buf[:n]
            self.misses += 1
            buf = np.empty(cap, dt)
            if bucket is None:
                bucket = self._buckets[key] = []
            if len(bucket) < self.max_per_bucket:
                bucket.append(buf)
            return buf[:n]

    def stats(self) -> dict:
        with self._lock:
            held = sum(len(b) for b in self._buckets.values())
            held_bytes = sum(buf.nbytes for b in self._buckets.values()
                             for buf in b)
        return {"buffers": held, "bytes": held_bytes,
                "hits": self.hits, "misses": self.misses}

    def drain(self) -> int:
        """Release the arena: drop the pool's strong references to
        every pooled base buffer, returning the byte count let go.
        Buffers with live outside views survive exactly as long as
        those views do (refcounting, not the pool, owns them now); the
        pool stays usable and simply re-allocates on the next take.
        The serving plane calls this at tenant teardown so repeated
        submit/evict cycles reclaim arena memory (docs/SERVING.md)."""
        with self._lock:
            released = sum(buf.nbytes for b in self._buckets.values()
                           for buf in b)
            self._buckets.clear()
        return released


@runtime_checkable
class WFRecord(Protocol):
    """Structural contract every user record type must satisfy."""

    def get_control_fields(self) -> Tuple[Any, int, int]:
        """Return (key, id, ts)."""
        ...

    def set_control_fields(self, key: Any, tid: int, ts: int) -> None:
        ...


class SynthChunk:
    """A descriptor slice of the declared synthetic law
    (operators/synth.SyntheticSource): events [start, start + n) with
    key = e % n_keys, id = ts = e // n_keys,
    value = (e % vmod) * vscale + voff.

    A stream item like TupleBatch: consumers that own a native engine
    fold it without materializing the columns; the runtime materializes
    it transparently at every other plane boundary (RtNode dispatch,
    multi-destination outlets)."""

    # ``trace`` stays UNSET (not None-initialized) so untraced chunks
    # pay zero construction cost; telemetry reads it via getattr-with-
    # default (telemetry/trace.py)
    __slots__ = ("start", "n", "n_keys", "vmod", "vscale", "voff", "trace")

    def __init__(self, start, n, n_keys, vmod, vscale, voff):
        self.start = start
        self.n = n
        self.n_keys = n_keys
        self.vmod = vmod
        self.vscale = vscale
        self.voff = voff

    def __len__(self):
        return self.n

    def materialize(self, pool: Optional[ColumnPool] = None) -> "TupleBatch":
        tr = getattr(self, "trace", None)
        if pool is None:
            idx = self.start + np.arange(self.n)
            ids = idx // self.n_keys
            out = TupleBatch({
                "key": idx % self.n_keys, "id": ids, "ts": ids,
                "value": (idx % self.vmod).astype(np.float64) * self.vscale
                         + self.voff})
            if tr is not None:
                out.trace = tr
            return out
        # pooled lane: all columns come from the graph arena;
        # np.ufunc(..., out=) writes them in place (no fresh allocation
        # per chunk)
        n = self.n
        idx = pool.take(n, np.int64)
        idx[:] = np.arange(self.start, self.start + n)
        keys = np.mod(idx, self.n_keys, out=pool.take(n, np.int64))
        res = np.mod(idx, self.vmod, out=pool.take(n, np.int64))
        ids = np.floor_divide(idx, self.n_keys, out=idx)  # idx is scratch
        vals = np.multiply(res, self.vscale, out=pool.take(n, np.float64),
                           casting="unsafe")
        if self.voff:
            np.add(vals, self.voff, out=vals)
        out = TupleBatch({"key": keys, "id": ids, "ts": ids, "value": vals})
        if tr is not None:
            out.trace = tr
        return out


class BasicRecord:
    """Convenience record: key/id/ts control fields + a float value.

    Mirrors the reference test fixture tuple (mp_common.hpp:44-81) but is
    a library type so users do not have to define one for simple streams.
    """

    # ``trace`` stays unset unless the telemetry plane attaches a
    # context (telemetry/trace.py); no per-record construction cost
    __slots__ = ("key", "id", "ts", "value", "trace")

    def __init__(self, key: Any = 0, tid: int = 0, ts: int = 0, value: float = 0.0):
        self.key = key
        self.id = tid
        self.ts = ts
        self.value = value

    def get_control_fields(self):
        return (self.key, self.id, self.ts)

    def set_control_fields(self, key, tid, ts):
        self.key = key
        self.id = tid
        self.ts = ts

    def __repr__(self):
        return f"BasicRecord(key={self.key}, id={self.id}, ts={self.ts}, value={self.value})"


class TupleBatch:
    """Columnar micro-batch of tuples: dict of equal-length numpy columns.

    Required columns: ``key`` (int64), ``id`` (int64), ``ts`` (int64).
    Any number of payload columns (e.g. ``value``).  This is the unit that
    flows over host queues on the batch plane and the host-side staging
    format for device transfers (the TPU analogue of the reference's
    pinned-buffer batch assembly, win_seq_gpu.hpp:552-596).

    A BatchFilter's output may be a :class:`DeferredBatch`: a deferred
    selection over its input's columns, each column gathered when first
    read.  Its values are those of an eager ``take`` of the same rows.
    """

    # ``trace`` carries a sampled telemetry TraceContext end to end
    # (telemetry/trace.py); it stays unset on untraced batches (getattr
    # default read) so batch construction pays nothing for it
    __slots__ = ("cols", "trace")

    CONTROL = ("key", "id", "ts")

    def __init__(self, cols: Dict[str, np.ndarray]):
        for c in self.CONTROL:
            if c not in cols:
                raise ValueError(f"TupleBatch missing control column '{c}'")
        n = len(cols["key"])
        for name, col in cols.items():
            if len(col) != n:
                raise ValueError(f"column '{name}' length {len(col)} != {n}")
        self.cols = cols

    # -- construction ------------------------------------------------------
    @classmethod
    def from_records(cls, records, payload=("value",)) -> "TupleBatch":
        keys, ids, tss = [], [], []
        pay = {p: [] for p in payload}
        for r in records:
            k, i, t = r.get_control_fields()
            keys.append(k)
            ids.append(i)
            tss.append(t)
            for p in payload:
                pay[p].append(getattr(r, p))
        cols = {
            "key": np.asarray(keys, dtype=np.int64),
            "id": np.asarray(ids, dtype=np.int64),
            "ts": np.asarray(tss, dtype=np.int64),
        }
        for p in payload:
            cols[p] = np.asarray(pay[p])
        return cls(cols)

    @classmethod
    def empty_like(cls, other: "TupleBatch") -> "TupleBatch":
        return cls({k: v[:0] for k, v in other.cols.items()})

    # -- accessors ---------------------------------------------------------
    def __len__(self) -> int:
        return len(self.cols["key"])

    @property
    def key(self) -> np.ndarray:
        return self.cols["key"]

    @property
    def id(self) -> np.ndarray:
        return self.cols["id"]

    @property
    def ts(self) -> np.ndarray:
        return self.cols["ts"]

    def __getitem__(self, name: str) -> np.ndarray:
        return self.cols[name]

    def payload_names(self):
        return [c for c in self.cols if c not in self.CONTROL]

    # -- transforms --------------------------------------------------------
    def _rows(self, idx):
        """The rows ``idx`` names, as ``take`` and a filter's deferred
        selection read them: a slice (the one given, or a contiguous
        ascending index run as its zero-copy view) or an intp index
        array (a boolean mask converted once with nonzero, which is
        4-5x faster than boolean fancy indexing repeated per column)."""
        if isinstance(idx, slice):
            return idx
        idx = np.asarray(idx)
        if idx.dtype == np.bool_:
            if len(idx) != len(self):
                raise IndexError(
                    f"boolean mask length {len(idx)} != batch "
                    f"length {len(self)}")
            idx = np.nonzero(idx)[0]
        elif idx.size == 0:
            idx = idx.astype(np.intp)   # e.g. a bare [] (float64)
        n = len(idx)
        if n > 1 and int(idx[-1]) - int(idx[0]) == n - 1 \
                and bool((np.diff(idx) == 1).all()):
            # contiguous ascending run (the cheap first/last guard
            # gates the O(n) check)
            lo = int(idx[0])
            return slice(lo, lo + n)
        return idx

    def take(self, idx, pool: Optional[ColumnPool] = None) -> "TupleBatch":
        """Row subset.  Slices and contiguous index runs stay zero-copy
        views; other indices (a boolean mask's once) are gathered with
        np.take (``_rows``); with ``pool`` the gathered columns reuse
        arena buffers instead of allocating.  A riding trace context
        propagates to every sub-batch (KEYBY partitions keep their
        sampled path traced)."""
        idx = self._rows(idx)
        if isinstance(idx, slice):
            return self._carry(
                TupleBatch({k: v[idx] for k, v in self.cols.items()}))
        n = len(idx)
        if pool is None:
            return self._carry(TupleBatch({k: np.take(v, idx, axis=0)
                                           for k, v in self.cols.items()}))
        out = {}
        for k, v in self.cols.items():
            if v.base is not None and not v.flags.owndata \
                    and not v.flags.c_contiguous:
                out[k] = np.take(v, idx, axis=0)  # odd layout: let numpy
                continue
            out[k] = np.take(v, idx, axis=0, out=pool.take(n, v.dtype))
        return self._carry(TupleBatch(out))

    def _carry(self, out: "TupleBatch") -> "TupleBatch":
        """Propagate a riding trace context onto a derived batch."""
        tr = getattr(self, "trace", None)
        if tr is not None:
            out.trace = tr
        return out

    def concat(self, other: "TupleBatch") -> "TupleBatch":
        out = TupleBatch(
            {k: np.concatenate([v, other.cols[k]]) for k, v in self.cols.items()}
        )
        # either side's context rides on (self's stamp wins: it entered
        # the stream earlier, so the merged batch's latency is honest)
        tr = getattr(self, "trace", None) or getattr(other, "trace", None)
        if tr is not None:
            out.trace = tr
        return out

    def with_cols(self, **cols) -> "TupleBatch":
        out = dict(self.cols)
        out.update(cols)
        return self._carry(TupleBatch(out))

    def records(self, cls=BasicRecord) -> Iterator[Any]:
        """Materialize records at the API edge (slow path, tests only)."""
        names = self.payload_names()
        for i in range(len(self)):
            r = cls(self.cols["key"][i].item(), self.cols["id"][i].item(),
                    self.cols["ts"][i].item())
            for p in names:
                if hasattr(r, p):
                    setattr(r, p, self.cols[p][i].item())
            yield r

    def __repr__(self):
        return f"TupleBatch(n={len(self)}, cols={list(self.cols)})"


class DeferredBatch(TupleBatch):
    """A filter's scattered row selection, gathered column by column.

    It holds its input's columns, the kept rows' indices and a cache:
    a column is gathered with ``np.take`` the first time anything reads
    it (``key``/``id``/``ts``, ``batch[name]``), and once.  ``len``
    gathers nothing; ``cols`` (and so ``payload_names``, ``with_cols``,
    ``concat``, ``records``, pickling) gathers every column, in the
    input's order.  Every value is that of ``TupleBatch.take`` of the
    same rows, byte for byte.  ``take`` composes the indices and
    gathers nothing.

    A BatchFilter emits one for a scattered selection: a chained or
    fused successor on its thread gathers where it reads, and an outlet
    materializes one (``materialize``) before it enters a channel, so
    the gathers stay on the filter's thread and a queue never keeps the
    input's columns alive.  ``stats`` is the filter's StatsRecord
    (or None): each gather adds its bytes to ``bytes_gathered``."""

    __slots__ = ("_src", "_idx", "_cache", "_all", "_stats")

    def __init__(self, batch: TupleBatch, idx: np.ndarray, stats=None):
        if isinstance(batch, DeferredBatch):
            self._src = batch._src
            self._idx = batch._idx[idx]
        else:
            self._src = batch.cols
            self._idx = idx
        self._cache: Dict[str, np.ndarray] = {}
        self._all = None
        self._stats = stats
        tr = getattr(batch, "trace", None)
        if tr is not None:
            self.trace = tr

    def _col(self, name: str) -> np.ndarray:
        col = self._cache.get(name)
        if col is None:
            col = np.take(self._src[name], self._idx, axis=0)
            self._cache[name] = col
            st = self._stats
            if st is not None:
                st.bytes_gathered += col.nbytes
        return col

    @property
    def cols(self) -> Dict[str, np.ndarray]:
        if self._all is None:
            self._all = {name: self._col(name) for name in self._src}
        return self._all

    def __len__(self) -> int:
        return len(self._idx)

    @property
    def selected_nbytes(self) -> int:
        """Bytes of every column over the kept rows: what an eager take
        copies (read from the input's columns; nothing is gathered)."""
        return len(self._idx) * sum(c[:1].nbytes for c in self._src.values())

    @property
    def key(self) -> np.ndarray:
        return self._col("key")

    @property
    def id(self) -> np.ndarray:
        return self._col("id")

    @property
    def ts(self) -> np.ndarray:
        return self._col("ts")

    def __getitem__(self, name: str) -> np.ndarray:
        return self._col(name)

    def take(self, idx, pool: Optional[ColumnPool] = None) -> "TupleBatch":
        """Row subset of the selection: the index arrays compose and
        nothing is gathered (``pool`` is not needed)."""
        return DeferredBatch(self, self._rows(idx), self._stats)

    def materialize(self) -> TupleBatch:
        """A plain TupleBatch of every column (the trace rides on)."""
        return self._carry(TupleBatch(self.cols))

    def __reduce__(self):
        return _plain_batch, (self.cols, getattr(self, "trace", None))

    def __repr__(self):
        return (f"DeferredBatch(n={len(self)}, cols={list(self._src)}, "
                f"gathered={list(self._cache)})")


def _plain_batch(cols, trace):
    """Unpickle a DeferredBatch as the plain TupleBatch it stands for."""
    out = TupleBatch(cols)
    if trace is not None:
        out.trace = trace
    return out


class EOS:
    """End-of-stream marker carried over host queues.

    The reference encodes EOS as a flagged refcounted wrapper
    (meta.hpp:770-783, ``isEOSMarker``); here it is a first-class queue
    item optionally carrying the per-key last tuples a WF emitter needs
    to broadcast (wf_nodes.hpp:207-227).
    """

    __slots__ = ("payload",)

    def __init__(self, payload=None):
        self.payload = payload

    def __repr__(self):
        return "EOS()"
