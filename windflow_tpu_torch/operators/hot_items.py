"""HotItems: per window, every key whose value reaches the window's
maximum -- the last step of NEXMark Q5 ("hot items": the auctions with
the most bids in each sliding window).

It reads the result batches of a keyed window engine (``key`` the item,
``id`` the window, ``value`` the window's aggregate), keeps for each
open window its running maximum and the keys that reach it, and emits a
window's rows once a watermark passes the window's end (a window engine
fires every window due by a watermark before forwarding it), or at the
end of the stream.  Its state is keyed by window: a handful of open
windows, each holding only the keys at its maximum.

Windows are the engine's: window ``w`` spans event time
``[w * slide, w * slide + win)``.  Each emitted batch holds the rows of
the windows it closes, in window order: ``key`` the item, ``id`` the
window, ``ts`` the window's last event time, ``value`` the maximum.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..core.basic import OrderingMode, Pattern, RoutingMode
from ..core.tuples import TupleBatch
from ..runtime.emitters import StandardEmitter
from ..runtime.node import EOSMarker, NodeLogic
from .base import Operator, StageSpec


class _HotItemsLogic(NodeLogic):
    def __init__(self, win_len: int, slide_len: int):
        self.win_len = win_len
        self.slide_len = slide_len
        # window -> [maximum, key arrays that reach it]
        self.best: Dict[int, list] = {}

    def svc(self, item, channel_id, emit):
        if isinstance(item, EOSMarker) or not len(item):
            return
        wid = np.asarray(item.id, np.int64)
        val = np.asarray(item["value"], np.float64)
        key = np.asarray(item.key, np.int64)
        if len(wid) > 1 and not np.all(wid[:-1] <= wid[1:]):
            order = np.argsort(wid, kind="stable")
            wid, val, key = wid[order], val[order], key[order]
        starts = np.flatnonzero(np.diff(wid)) + 1
        starts = np.concatenate([[0], starts])
        top = np.maximum.reduceat(val, starts)
        lens = np.diff(np.append(starts, len(wid)))
        at_top = np.flatnonzero(val == np.repeat(top, lens))
        cut = np.searchsorted(at_top, np.append(starts, len(wid)))
        best = self.best
        for j, w in enumerate(wid[starts].tolist()):
            m = float(top[j])
            rows = key[at_top[cut[j]:cut[j + 1]]]
            cur = best.get(w)
            if cur is None or m > cur[0]:
                best[w] = [m, [rows]]
            elif m == cur[0]:
                cur[1].append(rows)

    def _emit_windows(self, windows: List[int], emit) -> None:
        if not windows:
            return
        keys, wids, vals = [], [], []
        for w in sorted(windows):
            m, parts = self.best.pop(w)
            rows = np.concatenate(parts)
            keys.append(rows)
            wids.append(np.full(len(rows), w, np.int64))
            vals.append(np.full(len(rows), m))
        wid = np.concatenate(wids)
        emit(TupleBatch({"key": np.concatenate(keys), "id": wid,
                         "ts": wid * self.slide_len + self.win_len - 1,
                         "value": np.concatenate(vals)}))

    def on_watermark(self, wm, emit) -> None:
        """Emit every window whose end is at or below the watermark."""
        self._emit_windows([w for w in self.best
                            if w * self.slide_len + self.win_len <= wm.ts],
                           emit)

    def eos_flush(self, emit) -> None:
        self._emit_windows(list(self.best), emit)

    # -- checkpoint / resume: the open windows' maxima and their keys --
    def state_dict(self):
        return {"best": {w: (m, np.concatenate(parts))
                         for w, (m, parts) in self.best.items()}}

    def load_state(self, state) -> None:
        self.best = {int(w): [float(m), [np.asarray(keys, np.int64)]]
                     for w, (m, keys) in state["best"].items()}


class HotItems(Operator):
    """Per window of ``win_len`` / ``slide_len`` (event-time units, as
    the window engine upstream counts them), the keys whose value equals
    the window's maximum (ties all kept)."""

    def __init__(self, win_len: int, slide_len: int, name: str = "hot_items"):
        super().__init__(name, 1, RoutingMode.FORWARD, Pattern.ACCUMULATOR)
        self.win_len = win_len
        self.slide_len = slide_len

    def stages(self):
        return [StageSpec(self.name,
                          [_HotItemsLogic(self.win_len, self.slide_len)],
                          StandardEmitter(), self.routing,
                          ordering_mode=OrderingMode.TS)]
