"""Window state machines: count-based and time-based triggerers.

Re-design of the reference's ``wf/window.hpp`` (Triggerer_CB at
window.hpp:48-80, Triggerer_TB at window.hpp:83-121, Window at
window.hpp:124-306).  The semantics are kept bit-exact because the
distributed determinism oracles depend on them; the representation is
new (plain Python + a vectorized numpy twin used by the batch plane).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from .basic import WinEvent, WinType


@dataclass(frozen=True)
class TriggererCB:
    """Count-based triggerer (for in-order keyed substreams).

    Window ``lwid`` spans tuple identifiers
    ``[initial_id + lwid*slide, initial_id + lwid*slide + win_len)``
    (reference window.hpp:68-79).
    """

    win_len: int
    slide_len: int
    lwid: int
    initial_id: int

    def __call__(self, tid: int) -> WinEvent:
        lo = self.initial_id + self.lwid * self.slide_len
        if tid < lo:
            return WinEvent.OLD
        if tid <= lo + self.win_len - 1:
            return WinEvent.IN
        return WinEvent.FIRED


@dataclass(frozen=True)
class TriggererTB:
    """Time-based triggerer (tolerates out-of-order input within the
    triggering delay).  Window ``lwid`` spans timestamps
    ``[start + lwid*slide, start + lwid*slide + win_len)``; tuples past
    the extent but within ``triggering_delay`` raise DELAYED
    (reference window.hpp:106-120)."""

    win_len: int
    slide_len: int
    lwid: int
    starting_ts: int
    triggering_delay: int = 0

    def __call__(self, ts: int) -> WinEvent:
        lo = self.starting_ts + self.lwid * self.slide_len
        if ts < lo:
            return WinEvent.OLD
        if ts < lo + self.win_len:
            return WinEvent.IN
        if ts < lo + self.win_len + self.triggering_delay:
            return WinEvent.DELAYED
        return WinEvent.FIRED


@dataclass
class Window:
    """Per-(key, lwid) window accumulator (reference window.hpp:124-306).

    Tracks the result record, the number of IN tuples, the boundary
    tuples used for archive range queries, and the batched flag used by
    the device path.  ``result`` is created by ``result_factory`` and
    carries control fields via the tuple contract (core.tuples).
    """

    key: Any
    lwid: int
    gwid: int
    triggerer: Any
    win_type: WinType
    win_len: int
    slide_len: int
    result: Any = None
    no_tuples: int = 0
    batched: bool = False
    first_tuple: Optional[Any] = None
    last_tuple: Optional[Any] = None
    _result_initialized: bool = field(default=False, repr=False)

    def init_result(self, result: Any) -> None:
        """Seed the result's control fields (reference window.hpp:160-168):
        CB -> (key, gwid, 0); TB -> (key, gwid, gwid*slide + win_len - 1)."""
        self.result = result
        if self.win_type == WinType.CB:
            result.set_control_fields(self.key, self.gwid, 0)
        else:
            result.set_control_fields(
                self.key, self.gwid, self.gwid * self.slide_len + self.win_len - 1
            )

    def on_tuple(self, t: Any) -> WinEvent:
        """Evaluate the window against a new tuple (window.hpp:186-251)."""
        if self.batched:
            return WinEvent.BATCHED
        key, tid, ts = t.get_control_fields()
        if self.win_type == WinType.CB:
            event = self.triggerer(tid)
            if event == WinEvent.IN:
                self.no_tuples += 1
                if self.first_tuple is None:
                    self.first_tuple = t
                    # CB result timestamp = most recent IN tuple's ts
                    rk, rid, _ = self.result.get_control_fields()
                    self.result.set_control_fields(rk, rid, ts)
                else:
                    rk, rid, rts = self.result.get_control_fields()
                    if rts < ts:
                        self.result.set_control_fields(rk, rid, ts)
            elif event == WinEvent.FIRED:
                if self.last_tuple is None:
                    self.last_tuple = t
            else:
                raise AssertionError("OLD event on an in-order CB stream")
            return event
        else:
            event = self.triggerer(ts)
            if event == WinEvent.IN:
                self.no_tuples += 1
                if self.first_tuple is None or ts < self.first_tuple.get_control_fields()[2]:
                    self.first_tuple = t  # oldest IN tuple
            elif event in (WinEvent.DELAYED, WinEvent.FIRED):
                if self.last_tuple is None or ts < self.last_tuple.get_control_fields()[2]:
                    self.last_tuple = t  # oldest tuple past the extent
            return event

    def set_batched(self) -> None:
        self.batched = True


# ---------------------------------------------------------------------------
# Vectorized twins used by the columnar/TPU plane.  Given arrays of tuple
# ids (or timestamps) and a window index, classify all tuples at once.
# These keep identical boundary semantics to the scalar triggerers above.
# ---------------------------------------------------------------------------

def classify_cb(ids: np.ndarray, win_len: int, slide_len: int, lwid: int,
                initial_id: int) -> np.ndarray:
    """Vectorized TriggererCB: returns WinEvent values as int8 array."""
    lo = initial_id + lwid * slide_len
    out = np.full(ids.shape, WinEvent.FIRED.value, dtype=np.int8)
    out[ids < lo] = WinEvent.OLD.value
    out[(ids >= lo) & (ids <= lo + win_len - 1)] = WinEvent.IN.value
    return out


def classify_tb(ts: np.ndarray, win_len: int, slide_len: int, lwid: int,
                starting_ts: int, triggering_delay: int = 0) -> np.ndarray:
    """Vectorized TriggererTB."""
    lo = starting_ts + lwid * slide_len
    out = np.full(ts.shape, WinEvent.FIRED.value, dtype=np.int8)
    out[ts < lo + win_len + triggering_delay] = WinEvent.DELAYED.value
    out[ts < lo + win_len] = WinEvent.IN.value
    out[ts < lo] = WinEvent.OLD.value
    return out
