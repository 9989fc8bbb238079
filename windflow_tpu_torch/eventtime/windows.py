"""Watermark-triggered event-time windows (tumbling and sliding).

Unlike the device window engines (operators/tpu/) which fire on tuple
ARRIVAL order, an event-time window [s, s+size) fires exactly when the
merged low-watermark passes ``s + size + allowed_lateness`` -- the
out-of-order-safe trigger (docs/EVENTTIME.md).  Determinism contract:
the replica buffers ``(ts, id, value)`` rows per (key, window), sorts
them at fire time and applies the aggregation to the sorted value
list, so results are bitwise identical to the numpy oracle no matter
how arrival order was shuffled.  Fired windows emit in (win_start,
key) order as :class:`~windflow_tpu_torch.core.tuples.BasicRecord` with
``ts = win_start`` and ``id = win_start // slide``.

A tuple whose LAST containing window already fired is late: it is
quarantined through the loud lateness policy
(:meth:`~windflow_tpu_torch.eventtime.base.EventTimeLogic._late`), never
silently dropped.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

from ..core.basic import OrderingMode, Pattern, RoutingMode
from ..core.tuples import BasicRecord
from ..operators.base import Operator, StageSpec
from ..runtime.emitters import StandardEmitter
from ..runtime.node import EOSMarker
from .base import EventTimeLogic, iter_rows

__all__ = ["EventTimeWindowLogic", "EventTimeWindow"]


class EventTimeWindowLogic(EventTimeLogic):
    """Replica logic: per-key aligned windows, watermark-fired.

    State shape (the keyed contract's unit of repartition):
    ``{key: {win_start: [(ts, id, value), ...]}}``.
    """

    node_name = "event_window"

    def __init__(self, agg: Callable, size: float, slide: float = None,
                 lateness: float = 0.0):
        super().__init__(lateness)
        self.agg = agg
        self.size = float(size)
        self.slide = float(slide) if slide else float(size)

    # window index range containing ts: n*slide <= ts < n*slide + size
    def _win_range(self, ts: float):
        n_hi = math.floor(ts / self.slide)
        n_lo = math.floor((ts - self.size) / self.slide) + 1
        return n_lo, n_hi

    def svc(self, item, channel_id, emit):
        if isinstance(item, EOSMarker):
            return
        horizon = self.size + self.lateness
        for key, tid, ts, value in iter_rows(item):
            n_lo, n_hi = self._win_range(ts)
            if self.wm >= n_hi * self.slide + horizon:
                self._late(key, tid, ts, value)  # every window fired
                continue
            wins = self.state.get(key)
            if wins is None:
                wins = self.state[key] = {}
            for n in range(n_lo, n_hi + 1):
                s = n * self.slide
                if self.wm < s + horizon:  # unfired windows only
                    wins.setdefault(s, []).append((ts, tid, value))

    def on_watermark(self, wm, emit):
        if wm.ts > self.wm:
            self.wm = wm.ts
        self._fire(self.wm, emit)

    def eos_flush(self, emit):
        # safety net for graphs whose sources never seal with
        # Watermark(inf): end of stream fires everything still open
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
        fired.sort(key=lambda f: (f[0], f[1]))
        for s, key, rows in fired:
            rows.sort(key=lambda r: (r[0], r[1]))
            emit(BasicRecord(key, int(s // self.slide), s,
                             self.agg([r[2] for r in rows])))


class EventTimeWindow(Operator):
    """Keyed event-time window operator: ``agg(sorted_values)`` per
    (key, window), fired by watermark passage.

    ``EventTimeWindow(sum, size=10)`` tumbles; a ``slide < size``
    overlaps.  Composes with elastic rescale (keyed repartition),
    exactly-once epochs and the tiered keyed store through the
    EventTimeLogic contract."""

    def __init__(self, agg: Callable, size: float, slide: float = None,
                 lateness: float = 0.0, parallelism: int = 1,
                 name: str = "event_window"):
        super().__init__(name, parallelism, RoutingMode.KEYBY,
                         Pattern.ACCUMULATOR)
        self.agg = agg
        self.size = size
        self.slide = slide
        self.lateness = lateness

    def _make_logic(self, i, n=None):
        return EventTimeWindowLogic(self.agg, self.size, self.slide,
                                    self.lateness)

    def stages(self):
        reps = [self._make_logic(i) for i in range(self.parallelism)]
        return [StageSpec(self.name, reps, StandardEmitter(keyed=True),
                          self.routing, ordering_mode=OrderingMode.TS)]

    def elastic_logic_factory(self):
        return self._make_logic
