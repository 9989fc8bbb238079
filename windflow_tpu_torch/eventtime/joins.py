"""Two-input event-time stream joins: interval and windowed.

windflow graphs are single-input DAGs at the channel level, so a
binary join is expressed with the merge algebra: each input pipe tags
its records with a side (:func:`side_tagger` -> :class:`Sided`), the
pipes ``merge()``, and the join operator consumes the merged stream --
its replica channel then has every tail of both inputs as producers,
which is exactly what the runtime's per-producer watermark min-merge
needs: the join's event-time clock is ``min(left WM, right WM)`` by
construction, and the join node participates in epoch barrier
alignment like any multi-producer node.

* :class:`IntervalJoin` -- match L and R rows of one key when
  ``lower <= ts_r - ts_l <= upper``.  Probing is incremental on
  arrival; the watermark EVICTS a buffered left row once
  ``ts_l + upper + lateness < WM`` (no future right row can match it)
  and a right row once ``ts_r - lower + lateness < WM``.  Infinite
  bounds disable eviction on that side (a full history join, NexMark
  Q3).
* :class:`WindowJoin` -- per-(key, window) two-sided buffers; the
  cross product fires when the watermark passes ``win_end +
  lateness``, in deterministic (win_start, key, ts_l, ts_r) order.

An arrival whose own eviction/fire horizon has already passed is late
and quarantined loudly (docs/EVENTTIME.md).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional

from ..core.basic import OrderingMode, Pattern, RoutingMode
from ..core.tuples import BasicRecord, TupleBatch
from ..operators.base import Operator, StageSpec
from ..operators.basic_ops import FlatMap
from ..runtime.emitters import StandardEmitter
from ..runtime.node import EOSMarker
from .base import EventTimeLogic

__all__ = ["LEFT", "RIGHT", "Sided", "side_tagger", "tag_side",
           "IntervalJoinLogic", "IntervalJoin",
           "WindowJoinLogic", "WindowJoin"]

LEFT = 0
RIGHT = 1


class Sided:
    """A record tagged with its join side.  Carries the standard
    control-field contract so KEYBY emitters, ordering collectors and
    the audit plane treat it like any record."""

    __slots__ = ("side", "key", "id", "ts", "value", "trace")

    def __init__(self, side: int, key: Any, tid: int, ts: float,
                 value: Any):
        self.side = side
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
        side = "L" if self.side == LEFT else "R"
        return (f"Sided({side}, key={self.key}, id={self.id}, "
                f"ts={self.ts}, value={self.value})")


def side_tagger(side: int, key_of: Callable = None,
                key_col: str = None, value_col: str = "value"):
    """FlatMap body tagging one join input: expands records or
    TupleBatch rows into :class:`Sided` with an optional re-key --
    ``key_of(record)`` on the record plane, column ``key_col`` on the
    batch plane (joins key both sides on the JOIN key, which is rarely
    both inputs' native key)."""

    def tag(item, shipper):
        if isinstance(item, TupleBatch):
            keys = item[key_col] if key_col else item.key
            vals = item.cols.get(value_col)
            tid, ts = item.id, item.ts
            for i in range(len(item)):
                shipper.push(Sided(
                    side, int(keys[i]), int(tid[i]), float(ts[i]),
                    None if vals is None else vals[i]))
        else:
            k, tid, ts = item.get_control_fields()
            if key_of is not None:
                k = key_of(item)
            shipper.push(Sided(side, k, tid, float(ts),
                               getattr(item, "value", None)))
    return tag


def tag_side(side: int, key_of: Callable = None, key_col: str = None,
             value_col: str = "value", parallelism: int = 1,
             name: str = None) -> FlatMap:
    """The :func:`side_tagger` body packaged as a FlatMap operator:
    ``pipe.chain(tag_side(LEFT, key_col="seller"))``."""
    return FlatMap(side_tagger(side, key_of, key_col, value_col),
                   parallelism=parallelism,
                   name=name or ("tag_left" if side == LEFT
                                 else "tag_right"))


class _JoinLogicBase(EventTimeLogic):
    """Shared: pair construction + join-state gauge."""

    def __init__(self, join_fn: Optional[Callable],
                 lateness: float = 0.0):
        super().__init__(lateness)
        self.join_fn = join_fn or (lambda l, r: (l, r))

    def _gauge(self):
        if self.stats is not None:
            self.stats.join_state_keys = len(self.state)


class IntervalJoinLogic(_JoinLogicBase):
    """State per key: ``{"L": [(ts, id, value)...], "R": [...]}``."""

    node_name = "interval_join"

    def __init__(self, lower: float, upper: float,
                 join_fn: Callable = None, lateness: float = 0.0):
        super().__init__(join_fn, lateness)
        self.lower = float(lower)
        self.upper = float(upper)

    def _evictable(self, side: int, ts: float, wm: float) -> bool:
        if side == LEFT:
            return ts + self.upper + self.lateness < wm
        return ts - self.lower + self.lateness < wm

    def svc(self, item, channel_id, emit):
        if isinstance(item, EOSMarker):
            return
        side = item.side
        key, tid, ts = item.get_control_fields()
        ts = float(ts)
        if self._evictable(side, ts, self.wm):
            self._late(key, tid, ts, item.value)
            return
        st = self.state.get(key)
        if st is None:
            st = self.state[key] = {"L": [], "R": []}
        mine, other = ("L", "R") if side == LEFT else ("R", "L")
        st[mine].append((ts, tid, item.value))
        for ts2, tid2, val2 in st[other]:
            d = (ts2 - ts) if side == LEFT else (ts - ts2)
            if self.lower <= d <= self.upper:
                lv, rv = ((item.value, val2) if side == LEFT
                          else (val2, item.value))
                emit(BasicRecord(key, tid, max(ts, ts2),
                                 self.join_fn(lv, rv)))
        self._gauge()

    def on_watermark(self, wm, emit):
        if wm.ts > self.wm:
            self.wm = wm.ts
        w = self.wm
        for key in list(self.state.keys()):
            st = self.state.get(key)
            st["L"] = [r for r in st["L"]
                       if not self._evictable(LEFT, r[0], w)]
            st["R"] = [r for r in st["R"]
                       if not self._evictable(RIGHT, r[0], w)]
            if not st["L"] and not st["R"]:
                del self.state[key]
        self._gauge()


class WindowJoinLogic(_JoinLogicBase):
    """State per key: ``{win_start: [L_rows, R_rows]}``."""

    node_name = "window_join"

    def __init__(self, size: float, slide: float = None,
                 join_fn: Callable = None, lateness: float = 0.0):
        super().__init__(join_fn, lateness)
        self.size = float(size)
        self.slide = float(slide) if slide else float(size)

    def svc(self, item, channel_id, emit):
        if isinstance(item, EOSMarker):
            return
        side = item.side
        key, tid, ts = item.get_control_fields()
        ts = float(ts)
        horizon = self.size + self.lateness
        n_hi = math.floor(ts / self.slide)
        n_lo = math.floor((ts - self.size) / self.slide) + 1
        if self.wm >= n_hi * self.slide + horizon:
            self._late(key, tid, ts, item.value)
            return
        wins = self.state.get(key)
        if wins is None:
            wins = self.state[key] = {}
        for n in range(n_lo, n_hi + 1):
            s = n * self.slide
            if self.wm < s + horizon:
                wins.setdefault(s, [[], []])[side].append(
                    (ts, tid, item.value))
        self._gauge()

    def on_watermark(self, wm, emit):
        if wm.ts > self.wm:
            self.wm = wm.ts
        self._fire(self.wm, emit)

    def eos_flush(self, emit):
        self._fire(float("inf"), emit)

    def _fire(self, wm_ts, emit):
        horizon = self.size + self.lateness
        fired = []
        for key in list(self.state.keys()):
            wins = self.state.get(key)
            for s in [s for s in wins if s + horizon <= wm_ts]:
                fired.append((s, key, wins.pop(s)))
            if not wins:
                del self.state[key]
        self._gauge()
        fired.sort(key=lambda f: (f[0], f[1]))
        for s, key, (left, right) in fired:
            left.sort(key=lambda r: (r[0], r[1]))
            right.sort(key=lambda r: (r[0], r[1]))
            for ts_l, tid_l, lv in left:
                for ts_r, _tid_r, rv in right:
                    emit(BasicRecord(key, tid_l, s,
                                     self.join_fn(lv, rv)))


class _JoinOp(Operator):
    def __init__(self, name, parallelism):
        super().__init__(name, parallelism, RoutingMode.KEYBY,
                         Pattern.ACCUMULATOR)

    def _make_logic(self, i, n=None):
        raise NotImplementedError

    def stages(self):
        reps = [self._make_logic(i) for i in range(self.parallelism)]
        return [StageSpec(self.name, reps, StandardEmitter(keyed=True),
                          self.routing, ordering_mode=OrderingMode.TS)]

    def elastic_logic_factory(self):
        return self._make_logic


class IntervalJoin(_JoinOp):
    """Keyed interval join over a merged side-tagged stream: emit
    ``join_fn(l, r)`` when ``lower <= ts_r - ts_l <= upper``.  Use
    ``-inf/inf`` bounds for a full-history incremental join."""

    def __init__(self, lower: float, upper: float,
                 join_fn: Callable = None, lateness: float = 0.0,
                 parallelism: int = 1, name: str = "interval_join"):
        super().__init__(name, parallelism)
        self.lower = lower
        self.upper = upper
        self.join_fn = join_fn
        self.lateness = lateness

    def _make_logic(self, i, n=None):
        return IntervalJoinLogic(self.lower, self.upper, self.join_fn,
                                 self.lateness)


class WindowJoin(_JoinOp):
    """Keyed tumbling/sliding window join over a merged side-tagged
    stream: the per-window cross product of both sides fires at
    watermark passage."""

    def __init__(self, size: float, slide: float = None,
                 join_fn: Callable = None, lateness: float = 0.0,
                 parallelism: int = 1, name: str = "window_join"):
        super().__init__(name, parallelism)
        self.size = size
        self.slide = slide
        self.join_fn = join_fn
        self.lateness = lateness

    def _make_logic(self, i, n=None):
        return WindowJoinLogic(self.size, self.slide, self.join_fn,
                               self.lateness)
