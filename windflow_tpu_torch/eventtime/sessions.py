"""Gap-based session windows, merged on overlap, watermark-closed.

A session for key k is a maximal run of tuples where consecutive
event-times are at most ``gap`` apart.  Sessions are DATA-DEFINED
windows: a new tuple either extends a live session (``start - gap <=
ts <= last + gap``), bridges several (they merge into one), or opens a
fresh one.  A session closes -- fires its aggregate and leaves state --
when the merged watermark passes ``last_event + gap + lateness``: no
future tuple can extend it any more (every future ts >= watermark >
last + gap).  A tuple that can neither join a live session nor open a
closable-in-the-future one (``wm >= ts + gap + lateness`` already) is
late and quarantined loudly (docs/EVENTTIME.md).

State shape per key: ``[[start, last, rows], ...]`` sorted by start --
plain lists so sessions pickle for epochs, repartition at rescale and
demote into the tiered store unchanged.
"""
from __future__ import annotations

from typing import Callable

from ..core.basic import OrderingMode, Pattern, RoutingMode
from ..core.tuples import BasicRecord
from ..operators.base import Operator, StageSpec
from ..runtime.emitters import StandardEmitter
from ..runtime.node import EOSMarker
from .base import EventTimeLogic, iter_rows

__all__ = ["SessionWindowLogic", "SessionWindow"]


class SessionWindowLogic(EventTimeLogic):
    node_name = "session_window"

    def __init__(self, agg: Callable, gap: float, lateness: float = 0.0):
        super().__init__(lateness)
        self.agg = agg
        self.gap = float(gap)
        self._open = 0  # gauge: live sessions across keys

    def svc(self, item, channel_id, emit):
        if isinstance(item, EOSMarker):
            return
        gap = self.gap
        for key, tid, ts, value in iter_rows(item):
            sess = self.state.get(key)
            if sess is None:
                sess = self.state[key] = []
            joined = [s for s in sess if s[0] - gap <= ts <= s[1] + gap]
            if not joined:
                if self.wm >= ts + gap + self.lateness:
                    self._late(key, tid, ts, value)
                    continue
                sess.append([ts, ts, [(ts, tid, value)]])
                sess.sort(key=lambda s: s[0])
                self._open += 1
            else:
                base = joined[0]
                base[2].append((ts, tid, value))
                base[0] = min(base[0], ts)
                base[1] = max(base[1], ts)
                for other in joined[1:]:  # ts bridged them: merge
                    base[2].extend(other[2])
                    base[0] = min(base[0], other[0])
                    base[1] = max(base[1], other[1])
                    sess.remove(other)
                    self._open -= 1
        if self.stats is not None:
            self.stats.sessions_open = self._open

    # the open-session gauge rebuilds from restored/repartitioned state
    def load_state(self, st):
        super().load_state(st)
        self._open = sum(len(v) for v in st["state"].values())

    def load_keyed_state(self, kv):
        super().load_keyed_state(kv)
        self._open = sum(len(v) for v in kv.values())

    def on_watermark(self, wm, emit):
        if wm.ts > self.wm:
            self.wm = wm.ts
        self._close(self.wm, emit)

    def eos_flush(self, emit):
        self._close(float("inf"), emit)

    def _close(self, wm_ts, emit):
        horizon = self.gap + self.lateness
        fired = []
        for key in list(self.state.keys()):
            sess = self.state.get(key)
            live = []
            for s in sess:
                if s[1] + horizon <= wm_ts:
                    fired.append((s[0], key, s))
                else:
                    live.append(s)
            if live:
                self.state[key] = live
            else:
                del self.state[key]
        self._open -= len(fired)
        if self.stats is not None:
            self.stats.sessions_open = self._open
        fired.sort(key=lambda f: (f[0], f[1]))
        for start, key, (_, last, rows) in fired:
            rows.sort(key=lambda r: (r[0], r[1]))
            emit(BasicRecord(key, len(rows), start,
                             self.agg([r[2] for r in rows])))


class SessionWindow(Operator):
    """Keyed session-window operator: per-key gap sessions, merging on
    overlap, closing at watermark passage.  The fired record carries
    ``ts = session start`` and ``id = session tuple count``."""

    def __init__(self, agg: Callable, gap: float, lateness: float = 0.0,
                 parallelism: int = 1, name: str = "session_window"):
        super().__init__(name, parallelism, RoutingMode.KEYBY,
                         Pattern.ACCUMULATOR)
        self.agg = agg
        self.gap = gap
        self.lateness = lateness

    def _make_logic(self, i, n=None):
        return SessionWindowLogic(self.agg, self.gap, self.lateness)

    def stages(self):
        reps = [self._make_logic(i) for i in range(self.parallelism)]
        return [StageSpec(self.name, reps, StandardEmitter(keyed=True),
                          self.routing, ordering_mode=OrderingMode.TS)]

    def elastic_logic_factory(self):
        return self._make_logic
