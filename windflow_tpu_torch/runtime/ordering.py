"""Ordering + K-slack collectors (the DETERMINISTIC / PROBABILISTIC plane).

Re-designs of reference ``wf/ordering_node.hpp`` (watermark-by-min
priority queues, :121-193; EOS flush :196-281) and ``wf/kslack_node.hpp``
(adaptive K-slack buffering :93-139, late drops :193-200).

Both collectors speak BOTH planes: records ride per-item priority
queues like the reference; ``TupleBatch`` items ride a columnar lane
(per-channel row buffers, one vectorized sort-merge per emission) so
the batch plane runs under DETERMINISTIC/PROBABILISTIC modes too --
something the record-at-a-time reference has no analogue for.
"""
from __future__ import annotations

import bisect
import heapq
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..core.basic import OrderingMode
from ..core.tuples import TupleBatch
from .node import EOSMarker, NodeLogic


class _ColumnarMerge:
    """Per-channel columnar buffers merged by a watermark-by-min over
    the order field: rows at or below the smallest per-channel maximum
    are safe to emit in sorted order (ordering_node.hpp:121-193 at
    batch granularity)."""

    __slots__ = ("field", "n_channels", "parts", "maxs")

    def __init__(self, field: str, n_channels: int):
        self.field = field
        self.n_channels = n_channels
        self.parts: List[List[TupleBatch]] = [[] for _ in range(n_channels)]
        self.maxs = [-1] * n_channels

    def push(self, batch: TupleBatch, channel_id: int):
        f = batch[self.field] if self.field == "ts" else batch.id
        if len(f) > 1 and not np.all(f[:-1] <= f[1:]):
            batch = batch.take(np.argsort(f, kind="stable"))
        self.parts[channel_id].append(batch)
        if len(f):
            self.maxs[channel_id] = max(self.maxs[channel_id],
                                        int(f.max()))

    def _field_of(self, b: TupleBatch):
        return b[self.field] if self.field == "ts" else b.id

    def drain(self, watermark: Optional[int] = None):
        """Merged rows with field <= watermark (None = everything),
        sorted by the order field; remainder stays buffered."""
        ready = []
        for ch in range(self.n_channels):
            kept = []
            for b in self.parts[ch]:
                f = self._field_of(b)
                if watermark is None:
                    ready.append(b)
                    continue
                cut = int(np.searchsorted(f, watermark, "right"))
                if cut:
                    ready.append(b.take(slice(0, cut)))
                if cut < len(f):
                    kept.append(b.take(slice(cut, len(f))))
            self.parts[ch] = kept
        if not ready:
            return None
        if len(ready) > 1:
            merged = TupleBatch({k: np.concatenate([b.cols[k]
                                                    for b in ready])
                                 for k in ready[0].cols})
        else:
            merged = ready[0]
        f = self._field_of(merged)
        if len(f) > 1 and not np.all(f[:-1] <= f[1:]):
            merged = merged.take(np.argsort(f, kind="stable"))
        return merged

    def watermark(self) -> int:
        return min(self.maxs)


def _check_plane(logic, plane: str) -> None:
    """The record queues and the columnar buffers are independent
    orderings; interleaving them would silently break the global order,
    so a collector serves exactly one plane per stream."""
    cur = getattr(logic, "_plane", None)
    if cur is None:
        logic._plane = plane
    elif cur != plane:
        raise RuntimeError(
            "mixed record/batch streams through one ordering collector "
            "are unsupported; materialize one plane before the "
            "DETERMINISTIC/PROBABILISTIC stage")


def _renumber_columnar(batch: TupleBatch, get_counter, bump_counter):
    """Per-key dense ids in emitted order (columnar twin of the
    TS_RENUMBERING record path, shared by both collectors)."""
    keys = batch.key
    new_ids = np.empty(len(keys), np.int64)
    order = np.argsort(keys, kind="stable")  # keeps ts order per key
    keys_s = keys[order]
    edges = np.nonzero(np.diff(keys_s))[0] + 1
    bounds = np.concatenate([[0], edges, [len(keys_s)]])
    for j in range(len(bounds) - 1):
        lo, hi = int(bounds[j]), int(bounds[j + 1])
        key = keys_s[lo].item()
        c = get_counter(key)
        new_ids[order[lo:hi]] = np.arange(c, c + (hi - lo))
        bump_counter(key, c + (hi - lo))
    return batch.with_cols(id=new_ids)


class _KeyState:
    __slots__ = ("maxs", "heap", "eos_marker", "emit_counter")

    def __init__(self, n_channels: int):
        self.maxs = [0] * n_channels
        self.heap: List = []
        self.eos_marker: Optional[EOSMarker] = None
        self.emit_counter = 0


class OrderingLogic(NodeLogic):
    """DETERMINISTIC-mode collector: buffers items in priority queues and
    releases them once their id/ts is covered by the watermark = min of
    per-channel maxima (ordering_node.hpp:121-193).

    mode ID             -- per-key queues ordered by tuple id.
    mode TS             -- one global queue ordered by timestamp.
    mode TS_RENUMBERING -- TS ordering + per-key dense re-assignment of
                           ids on emission (used for CB windows inside
                           complex nestings, multipipe.hpp:1039-1051).
    """

    def __init__(self, mode: OrderingMode, n_channels: int):
        self.mode = mode
        self.n_channels = n_channels
        self.keys: Dict[Any, _KeyState] = {}
        self.global_heap: List = []
        self.global_maxs = [0] * n_channels
        self._cmerge: Optional[_ColumnarMerge] = None  # batch lane
        # unique tiebreaker (ptr compare in ref); a plain int, not
        # itertools.count, so collector state pickles for the live
        # checkpoint barrier
        self._seq = 0

    # -- columnar lane -----------------------------------------------------
    def _svc_batch(self, batch: TupleBatch, channel_id: int, emit):
        if self.mode == OrderingMode.ID:
            # ID ordering is per-key dense-id arithmetic; the columnar
            # lane is timestamp-based, so degrade this batch to the
            # record plane (slow but correct -- CB batch streams in
            # DETERMINISTIC mode are an edge, not the hot path; bypasses
            # the plane guard, which tracks the USER-facing item type)
            for rec in batch.records():
                self._svc_record(rec, channel_id, emit)
            return
        if self._cmerge is None:
            self._cmerge = _ColumnarMerge("ts", self.n_channels)
        self._cmerge.push(batch, channel_id)
        wm = self._cmerge.watermark()
        if wm >= 0:
            out = self._cmerge.drain(wm)
            if out is not None and len(out):
                emit(self._renumber_batch(out))

    def _renumber_batch(self, batch: TupleBatch) -> TupleBatch:
        """TS_RENUMBERING: per-key dense ids in emitted (ts) order --
        the columnar twin of _emit_rec's per-record renumbering."""
        if self.mode != OrderingMode.TS_RENUMBERING:
            return batch

        def get(key):
            return self._key_state(key).emit_counter

        def bump(key, c):
            self._key_state(key).emit_counter = c

        return _renumber_columnar(batch, get, bump)

    def _key_state(self, key) -> _KeyState:
        st = self.keys.get(key)
        if st is None:
            st = self.keys[key] = _KeyState(self.n_channels)
        return st

    def _order_field(self, rec) -> int:
        k, tid, ts = rec.get_control_fields()
        return tid if self.mode == OrderingMode.ID else ts

    def _emit_rec(self, rec, emit, is_marker=False):
        if self.mode == OrderingMode.TS_RENUMBERING:
            # renumber a COPY: under the CB broadcast plane every
            # replica's collector receives the SAME record object
            # (BroadcastEmitter's immutability contract), and each
            # assigns its own dense id
            import copy
            rec = copy.copy(rec)
            key = rec.get_control_fields()[0]
            st = self._key_state(key)
            rec.set_control_fields(key, st.emit_counter,
                                   rec.get_control_fields()[2])
            st.emit_counter += 1
        emit(EOSMarker(rec) if is_marker else rec)

    def svc(self, item, channel_id, emit):
        if isinstance(item, TupleBatch):
            _check_plane(self, "batch")
            self._svc_batch(item, channel_id, emit)
            return
        if not isinstance(item, EOSMarker):
            # EOS markers are plane-neutral: batch streams still carry
            # per-key record markers (WFEmitter._emit_batch)
            _check_plane(self, "record")
        self._svc_record(item, channel_id, emit)

    def _svc_record(self, item, channel_id, emit):
        rec = item.record if isinstance(item, EOSMarker) else item
        key = rec.get_control_fields()[0]
        wid = self._order_field(rec)
        st = self._key_state(key)
        if isinstance(item, EOSMarker):
            # keep only the most recent EOS marker per key (:136-150)
            if st.eos_marker is None or wid > self._order_field(st.eos_marker.record):
                st.eos_marker = item
            return
        if self.mode == OrderingMode.ID:
            st.maxs[channel_id] = wid
            min_id = min(st.maxs)
            heap = st.heap
        else:
            self.global_maxs[channel_id] = wid
            min_id = min(self.global_maxs)
            heap = self.global_heap
        self._seq += 1
        heapq.heappush(heap, (wid, self._seq, rec))
        while heap and heap[0][0] <= min_id:
            _, _, nxt = heapq.heappop(heap)
            self._emit_rec(nxt, emit)

    # live-checkpoint snapshots: buffered records are part of the
    # in-flight stream and must survive a restore.  Deep copies on both
    # sides: the resumed run keeps heappop-ing the live heaps, and an
    # aliased snapshot would decay with it.
    def state_dict(self):
        import copy
        st = {"keys": copy.deepcopy(self.keys),
              "global_heap": copy.deepcopy(self.global_heap),
              "global_maxs": list(self.global_maxs), "seq": self._seq}
        if self._cmerge is not None:
            st["cmerge"] = (self._cmerge.field,
                            copy.deepcopy(self._cmerge.parts),
                            list(self._cmerge.maxs))
        return st

    def load_state(self, state):
        import copy
        self.keys = copy.deepcopy(state["keys"])
        self.global_heap = copy.deepcopy(state["global_heap"])
        self.global_maxs = list(state["global_maxs"])
        self._seq = state["seq"]
        if "cmerge" in state:
            field, parts, maxs = state["cmerge"]
            self._cmerge = _ColumnarMerge(field, len(maxs))
            self._cmerge.parts = copy.deepcopy(parts)
            self._cmerge.maxs = list(maxs)

    def eos_flush(self, emit):
        """Drain every queue in order, then re-publish the retained EOS
        markers (ordering_node.hpp:196-281)."""
        if self._cmerge is not None:
            out = self._cmerge.drain(None)
            if out is not None and len(out):
                emit(self._renumber_batch(out))
        if self.mode == OrderingMode.ID:
            for key, st in self.keys.items():
                while st.heap:
                    _, _, nxt = heapq.heappop(st.heap)
                    self._emit_rec(nxt, emit)
                if st.eos_marker is not None:
                    self._emit_rec(st.eos_marker.record, emit, is_marker=True)
        else:
            while self.global_heap:
                _, _, nxt = heapq.heappop(self.global_heap)
                self._emit_rec(nxt, emit)
            for key, st in self.keys.items():
                if st.eos_marker is not None:
                    self._emit_rec(st.eos_marker.record, emit, is_marker=True)


class LateTupleDropped(Exception):
    """Quarantine reason attached to event-time-dropped tuples: the
    tuple's timestamp fell behind the already-emitted watermark (K-slack
    late drop, kslack_node.hpp:193-200; eventtime/ allowed-lateness
    misses reuse it)."""


class KSlackLogic(NodeLogic):
    """PROBABILISTIC-mode collector: K-slack buffering with K adapted to
    the maximum observed delay; tuples older than the emitted watermark
    are dropped and counted (kslack_node.hpp:93-200).

    Drop accounting (docs/EVENTTIME.md "Late data"): beyond the exact
    ``dropped`` counter and the capped ``dropped_records`` identities,
    every drop is quarantined in the graph dead-letter store with a
    :class:`LateTupleDropped` reason and announced as a ``late_data``
    flight event -- event-time loss is loud, never a silent counter.
    ``dead_letters``/``node_name`` are bound by PipeGraph.start through
    the ``uses_dead_letters`` marker (None outside a started graph).
    """

    uses_dead_letters = True
    dead_letters = None
    node_name = "kslack"

    def __init__(self, mode: OrderingMode = OrderingMode.TS,
                 on_drop: Callable[[int], None] = None):
        assert mode != OrderingMode.ID
        self.mode = mode
        self.K = 0
        self.tcurr = 0
        self.buffer_ts: List[int] = []   # sorted timestamps
        self.buffer: List[Any] = []      # records, parallel to buffer_ts
        self.ts_sample: List[int] = []   # delays sampled since last advance
        self.last_timestamp = 0
        self.dropped = 0
        # control fields of dropped records, for exact accounting
        # oracles (each source tuple is either emitted in-order exactly
        # once or appears here).  The reference only counts
        # (kslack_node.hpp dropped_inputs); identities are retained up
        # to a cap so a long-running lossy stream cannot leak -- the
        # `dropped` counter stays exact past it
        self.dropped_records: List = []
        self.dropped_records_cap = 1 << 16
        self.on_drop = on_drop or (lambda n: None)
        self.key_counters: Dict[Any, int] = {}
        self._cbuf: Optional[_ColumnarMerge] = None  # batch lane
        self._cmin = 2**63 - 1  # min ts sampled since the last advance

    # -- columnar lane -----------------------------------------------------
    def _svc_batch(self, batch: TupleBatch, emit):
        if self._cbuf is None:
            self._cbuf = _ColumnarMerge("ts", 1)
        ts = batch.ts
        if len(ts) == 0:
            return
        self._cbuf.push(batch, 0)
        # sample EVERY batch's minimum into the delay window -- a late
        # batch (max <= tcurr) must still grow K on the next advance,
        # exactly like the record lane's ts_sample of late tuples,
        # otherwise cross-channel disorder is dropped forever
        self._cmin = min(self._cmin, int(ts.min()))
        new_max = int(ts.max())
        if new_max <= self.tcurr:
            return
        self.tcurr = new_max
        max_d = self.tcurr - self._cmin
        self._cmin = self.tcurr
        if max_d > self.K:
            self.K = max_d
        # strict `< tcurr - K` like the record lane's bisect_left cut
        out = self._cbuf.drain(self.tcurr - self.K - 1)
        if out is None or not len(out):
            return
        self._emit_batch_in_order(out, emit)

    def _emit_batch_in_order(self, out: TupleBatch, emit):
        ots = out.ts
        keep = ots >= self.last_timestamp
        n_drop = int((~keep).sum())
        if n_drop:
            self.dropped += n_drop
            d = out.take(~keep)
            room = self.dropped_records_cap - len(self.dropped_records)
            if room > 0:
                self.dropped_records.extend(
                    zip(d.key[:room].tolist(), d.id[:room].tolist(),
                        d.ts[:room].tolist()))
            self.on_drop(n_drop)
            self._quarantine(d, n_drop)
            out = out.take(keep)
        if not len(out):
            return
        self.last_timestamp = int(out.ts[-1])
        if self.mode == OrderingMode.TS_RENUMBERING:
            out = _renumber_columnar(
                out, lambda k: self.key_counters.get(k, 0),
                self.key_counters.__setitem__)
        emit(out)

    def _quarantine(self, item, n: int) -> None:
        """Loud accounting for ``n`` event-time drops: one dead-letter
        entry per call (the columnar lane passes the whole dropped
        sub-batch as the sample, like ingest shedding) plus a
        ``late_data`` flight event naming the emitted watermark the
        tuples fell behind."""
        dl = self.dead_letters
        if dl is not None:
            dl.add(self.node_name, item,
                   LateTupleDropped(
                       f"event-time ts behind emitted watermark "
                       f"{self.last_timestamp}"), count=n)
        fl = self.flight
        if fl is not None:
            fl.record("late_data", node=self.node_name, n=n,
                      watermark=self.last_timestamp)

    def _emit_in_order(self, recs, emit):
        for rec in recs:
            ts = rec.get_control_fields()[2]
            if ts < self.last_timestamp:
                self.dropped += 1
                if len(self.dropped_records) < self.dropped_records_cap:
                    self.dropped_records.append(rec.get_control_fields())
                self.on_drop(1)
                self._quarantine(rec, 1)
                continue
            self.last_timestamp = ts
            if self.mode == OrderingMode.TS_RENUMBERING:
                import copy
                rec = copy.copy(rec)  # shared under the broadcast plane
                key = rec.get_control_fields()[0]
                c = self.key_counters.get(key, 0)
                self.key_counters[key] = c + 1
                rec.set_control_fields(key, c, ts)
            emit(rec)

    def svc(self, item, channel_id, emit):
        if isinstance(item, TupleBatch):
            _check_plane(self, "batch")
            self._svc_batch(item, emit)
            return
        if isinstance(item, EOSMarker):
            return  # plane-neutral; flush happens at EOS
        _check_plane(self, "record")
        rec = item
        ts = rec.get_control_fields()[2]
        self.ts_sample.append(ts)
        i = bisect.bisect_left(self.buffer_ts, ts)
        self.buffer_ts.insert(i, ts)
        self.buffer.insert(i, rec)
        if ts <= self.tcurr:
            return
        self.tcurr = ts
        max_d = max(self.tcurr - t for t in self.ts_sample)
        if max_d > self.K:
            self.K = max_d
        self.ts_sample.clear()
        cut = bisect.bisect_left(self.buffer_ts, self.tcurr - self.K)
        out, self.buffer = self.buffer[:cut], self.buffer[cut:]
        del self.buffer_ts[:cut]
        self._emit_in_order(out, emit)

    def state_dict(self):
        import copy
        st = {"K": self.K, "tcurr": self.tcurr,
              "buffer_ts": list(self.buffer_ts),
              "buffer": copy.deepcopy(self.buffer),
              "ts_sample": list(self.ts_sample),
              "last_timestamp": self.last_timestamp,
              "dropped": self.dropped,
              "dropped_records": list(self.dropped_records),
              "key_counters": dict(self.key_counters),
              "cmin": self._cmin}
        if self._cbuf is not None:
            st["cbuf"] = copy.deepcopy(self._cbuf.parts)
        return st

    def load_state(self, state):
        import copy
        self.K = state["K"]
        self.tcurr = state["tcurr"]
        self.buffer_ts = list(state["buffer_ts"])
        self.buffer = copy.deepcopy(state["buffer"])
        self.ts_sample = list(state["ts_sample"])
        self.last_timestamp = state["last_timestamp"]
        self.dropped = state["dropped"]
        self.dropped_records = list(state.get("dropped_records", []))
        self.key_counters = dict(state["key_counters"])
        self._cmin = state.get("cmin", 2**63 - 1)
        if "cbuf" in state:
            self._cbuf = _ColumnarMerge("ts", 1)
            self._cbuf.parts = copy.deepcopy(state["cbuf"])

    def eos_flush(self, emit):
        if self._cbuf is not None:
            out = self._cbuf.drain(None)
            if out is not None and len(out):
                self._emit_batch_in_order(out, emit)
        out, self.buffer = self.buffer, []
        self.buffer_ts.clear()
        self._emit_in_order(out, emit)
