"""Shared plumbing of the event-time relational plane.

Every operator in :mod:`windflow_tpu_torch.eventtime` (watermark-triggered
windows, session windows, stream joins) is a keyed stateful logic fed
by the generic watermark transport in :mod:`windflow_tpu_torch.runtime.node`:
the runtime min-merges per-producer ``Watermark`` items and hands every
*advanced* merged value to the logic's ``on_watermark(wm, emit)`` hook
before forwarding it downstream.  What the operators share lives here:

* :class:`EventTimeLogic` -- the keyed-state contract (checkpoint,
  tiered store, elastic repartition, census) lifted verbatim from
  ``AccumulatorLogic`` so event-time state composes with exactly-once
  epochs (durability/), the tiered store (state/) and runtime rescale
  (elastic/) without any special-casing, plus the **loud lateness
  policy**: a tuple arriving behind the allowed-lateness horizon is
  never silently dropped -- it lands in ``graph.dead_letters`` with a
  :class:`~windflow_tpu_torch.runtime.ordering.LateTupleDropped` reason, a
  ``late_data`` flight event and the ``Late_tuples`` gauge.
* :func:`iter_rows` -- plane-agnostic row iteration (records or
  columnar ``TupleBatch``), so event-time operators sit downstream of
  either the record or the batch plane.

See docs/EVENTTIME.md for the semantics contract.
"""
from __future__ import annotations

from ..core.tuples import TupleBatch
from ..runtime.node import NodeLogic
from ..runtime.ordering import LateTupleDropped


def iter_rows(item):
    """Yield ``(key, tid, ts, value)`` rows from a record or a
    TupleBatch (ts as float -- event time is a real-valued axis)."""
    if isinstance(item, TupleBatch):
        key, tid, ts = item.key, item.id, item.ts
        val = item.cols.get("value")
        for i in range(len(item)):
            yield (int(key[i]), int(tid[i]), float(ts[i]),
                   None if val is None else float(val[i]))
    else:
        k, t, s = item.get_control_fields()
        yield (k, t, float(s), getattr(item, "value", None))


class EventTimeLogic(NodeLogic):
    """Base replica logic for the event-time plane: watermark scalar,
    allowed-lateness accounting and the full keyed-state contract."""

    # dead-letter binding marker (graph/pipegraph.py binds the graph
    # store + node name at start on any logic carrying this flag)
    uses_dead_letters = True
    dead_letters = None
    node_name = "eventtime"

    def __init__(self, lateness: float = 0.0):
        self.lateness = float(lateness)
        # last merged watermark observed by THIS replica; part of the
        # checkpointed state so a restored replica keeps detecting late
        # replays of windows it already fired (docs/EVENTTIME.md)
        self.wm = float("-inf")
        self.state: dict = {}

    # -- lateness policy ----------------------------------------------
    def _late(self, key, tid, ts, value) -> None:
        """A tuple behind the lateness horizon: account it loudly."""
        if self.stats is not None:
            self.stats.late_tuples += 1
        dl = self.dead_letters
        if dl is not None:
            dl.add(self.node_name, (key, tid, ts, value),
                   LateTupleDropped(
                       f"event-time ts {ts} behind watermark {self.wm} "
                       f"(allowed lateness {self.lateness})"))
        fl = self.flight
        if fl is not None:
            fl.record("late_data", node=self.node_name, n=1,
                      watermark=self.wm, ts=ts)

    # -- checkpoint hooks (durability/; utils/checkpoint.py) ----------
    def state_dict(self):
        st = self.state
        if hasattr(st, "materialize"):     # tiered store: inline copy
            st = st.materialize()
        return {"state": st, "wm": self.wm}

    def load_state(self, st):
        if hasattr(self.state, "replace_all"):
            self.state.replace_all(st["state"])
        else:
            self.state = st["state"]
        self.wm = st.get("wm", float("-inf"))

    # -- tiered keyed state (state/; docs/RESILIENCE.md) --------------
    def enable_tiered_state(self, store):
        store.replace_all(self.state)
        self.state = store

    def bind_hot_sketch(self, hot_keys_fn):
        if hasattr(self.state, "bind_hot_sketch"):
            self.state.bind_hot_sketch(hot_keys_fn)

    def state_tier_of(self, key):
        if hasattr(self.state, "tier_of"):
            return self.state.tier_of(key)
        return "hot" if key in self.state else None

    def keyed_state_pickled(self):
        if hasattr(self.state, "keyed_state_pickled"):
            return self.state.keyed_state_pickled()
        return None

    # -- keyed-state hooks (elastic/rescale.py) -----------------------
    def keyed_state_dict(self):
        st = self.state
        if hasattr(st, "materialize"):
            return st.materialize()
        return dict(st)

    def load_keyed_state(self, kv):
        if hasattr(self.state, "replace_all"):
            self.state.replace_all(kv)
        else:
            self.state = dict(kv)

    # -- audit-plane census (audit/census.py) -------------------------
    def keyed_state_census(self):
        state = self.state
        if hasattr(state, "census"):       # tiered: per-tier gauges
            return state.census()
        n = len(state)
        if n == 0:
            return (0, 0)
        import sys
        try:
            per = sys.getsizeof(next(iter(state.values()))) + 64
        except (RuntimeError, StopIteration):
            per = 64  # resized under us: count-only estimate
        return (n, n * per)
