"""Win_Seq: the sequential keyed window engine.

Re-design of reference ``wf/win_seq.hpp`` (623 LoC): per-key descriptors
holding a StreamArchive + open windows, distributed window-id assignment
via WinOperatorConfig (svc :319-511), EOS flush of open windows
(:514-579).  Building block of every composite window operator.

Two query styles (API:44-100):
* non-incremental: ``win_func(gwid, Iterable, result[, ctx])`` runs on
  the archived window extent at fire time;
* incremental: ``winupdate_func(gwid, tuple, result[, ctx])`` folds each
  IN tuple as it arrives (no archive kept).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

from ..core.archive import StreamArchive
from ..core.basic import (OrderingMode, Pattern, Role, RoutingMode,
                          WinOperatorConfig, WinType, WinEvent)
from ..core.context import RuntimeContext
from ..core.iterable import Iterable
from ..core.meta import default_hash, with_context
from ..core.tuples import BasicRecord
from ..core.window import TriggererCB, TriggererTB, Window
from ..core import win_assign as wa
from ..runtime.emitters import StandardEmitter
from ..runtime.node import EOSMarker, NodeLogic
from .base import Operator, StageSpec


def _sort_by_id(t):
    return t.get_control_fields()[1]


def _sort_by_ts(t):
    return t.get_control_fields()[2]


class _KeyDescriptor:
    """Per-key state (win_seq.hpp:98-127)."""

    __slots__ = ("archive", "wins", "next_lwid", "last_lwid", "next_ids",
                 "emit_counter")

    def __init__(self, sort_key, emit_counter_start: int = 0):
        self.archive = StreamArchive(sort_key)
        self.wins: List[Window] = []
        self.next_lwid = 0    # next window to open
        self.last_lwid = -1   # last window fired
        self.next_ids = 0     # renumbering counter
        self.emit_counter = emit_counter_start


class WinSeqLogic(NodeLogic):
    def __init__(self, win_func: Callable, win_len: int, slide_len: int,
                 win_type: WinType, *, triggering_delay: int = 0,
                 incremental: bool = False,
                 result_factory: Callable[[], Any] = BasicRecord,
                 closing_func: Callable = None,
                 config: WinOperatorConfig = None, role: Role = Role.SEQ,
                 map_indexes=(0, 1), parallelism: int = 1,
                 replica_index: int = 0, renumbering: bool = False):
        if win_len == 0 or slide_len == 0:
            raise ValueError("win_len and slide_len must be > 0")
        self.win_len = win_len
        self.slide_len = slide_len
        self.win_type = win_type
        self.triggering_delay = triggering_delay
        self.is_nic = not incremental
        self.result_factory = result_factory
        self.closing_func = closing_func
        self.config = config or WinOperatorConfig()
        self.role = role
        self.map_indexes = map_indexes
        self.renumbering = renumbering
        self.context = RuntimeContext(parallelism, replica_index)
        base = 3  # (gwid, data, result)
        self.win_func = with_context(win_func, base, self.context)
        # module-level sort keys keep per-key state picklable
        # (utils/checkpoint.py)
        self._sort_key = (_sort_by_id if win_type == WinType.CB
                          else _sort_by_ts)
        self.keys: Dict[Any, _KeyDescriptor] = {}
        self.ignored_tuples = 0

    # -- helpers -----------------------------------------------------------
    def _key_descriptor(self, key) -> _KeyDescriptor:
        kd = self.keys.get(key)
        if kd is None:
            start = self.map_indexes[0] if self.role == Role.MAP else 0
            kd = self.keys[key] = _KeyDescriptor(self._sort_key, start)
        return kd

    def _make_window(self, key, lwid: int, gwid: int, initial_id: int) -> Window:
        if self.win_type == WinType.CB:
            trig = TriggererCB(self.win_len, self.slide_len, lwid, initial_id)
        else:
            trig = TriggererTB(self.win_len, self.slide_len, lwid, initial_id,
                               self.triggering_delay)
        w = Window(key, lwid, gwid, trig, self.win_type, self.win_len,
                   self.slide_len)
        w.init_result(self.result_factory())
        return w

    def _emit_result(self, key, kd: _KeyDescriptor, result, emit) -> None:
        """Role-specific renumbering of outgoing results
        (win_seq.hpp:478-487): MAP stripes dense ids across the reduce
        windows; PLQ renumbers panes densely per key."""
        if self.role == Role.MAP:
            _, _, ts = result.get_control_fields()
            result.set_control_fields(key, kd.emit_counter, ts)
            kd.emit_counter += self.map_indexes[1]
        elif self.role == Role.PLQ:
            hashcode = default_hash(key)
            new_id = wa.plq_renumbered_id(hashcode, kd.emit_counter,
                                          self.config)
            _, _, ts = result.get_control_fields()
            result.set_control_fields(key, new_id, ts)
            kd.emit_counter += 1
        emit(result)

    # -- node interface ----------------------------------------------------
    def svc(self, item, channel_id, emit):
        is_marker = isinstance(item, EOSMarker)
        t = item.record if is_marker else item
        key, tid, ts = t.get_control_fields()
        hashcode = default_hash(key)
        id_ = tid if self.win_type == WinType.CB else ts
        kd = self._key_descriptor(key)
        if self.renumbering:  # CB windows in DEFAULT mode (win_seq.hpp:342-347)
            assert self.win_type == WinType.CB
            id_ = kd.next_ids
            kd.next_ids += 1
            t.set_control_fields(key, id_, ts)
        cfg = self.config
        first_gwid_key = wa.first_gwid_of_key(hashcode, cfg)
        initial_id = wa.initial_id_of_key(hashcode, cfg, self.role)
        # first tuple of this key: anchor window creation at its first
        # containing window -- an epoch-scale first id/ts must not
        # materialize ~id/slide empty leading windows (matches the
        # native engine and the on-demand creation of win_seq.hpp:
        # 417-428)
        if (kd.next_lwid == 0 and kd.last_lwid < 0 and not kd.wins
                and not is_marker):
            rel = id_ - initial_id
            if rel >= self.win_len:
                kd.next_lwid = (rel - self.win_len) // self.slide_len + 1
        # ignore tuples predating the last fired window (win_seq.hpp:358-380)
        min_boundary = (self.win_len + kd.last_lwid * self.slide_len
                        if kd.last_lwid >= 0 else 0)
        if id_ < initial_id + min_boundary:
            if kd.last_lwid >= 0:
                self.ignored_tuples += 1
            return
        last_w = wa.last_window_of(id_, initial_id, self.win_len,
                                   self.slide_len)
        if last_w < 0 and not is_marker:
            return  # hopping-window gap (win_seq.hpp:388-411)
        if self.is_nic and not is_marker:
            kd.archive.insert(t)
        # open new windows up to last_w (win_seq.hpp:417-428)
        for lwid in range(kd.next_lwid, last_w + 1):
            gwid = wa.gwid_of_lwid(first_gwid_key, lwid, cfg)
            kd.wins.append(self._make_window(key, lwid, gwid, initial_id))
            kd.next_lwid += 1
        # evaluate all open windows (win_seq.hpp:429-494)
        cnt_fired = 0
        for win in kd.wins:
            event = win.on_tuple(t)
            if event == WinEvent.IN:
                if not self.is_nic and not is_marker:
                    self.win_func(win.gwid, t, win.result)
            elif event == WinEvent.FIRED:
                t_s, t_e = win.first_tuple, win.last_tuple
                if self.is_nic:
                    if t_s is None:
                        it = Iterable([], 0, 0)
                    else:
                        lo, hi = kd.archive.win_range(t_s, t_e)
                        it = Iterable(kd.archive.items(), lo, hi)
                    self.win_func(win.gwid, it, win.result)
                if t_s is not None:
                    kd.archive.purge(t_s)
                cnt_fired += 1
                kd.last_lwid += 1
                self._emit_result(key, kd, win.result, emit)
        del kd.wins[:cnt_fired]

    def eos_flush(self, emit):
        """Flush every open window of every key (win_seq.hpp:514-579)."""
        for key, kd in self.keys.items():
            for win in kd.wins:
                if self.is_nic:
                    t_s, t_e = win.first_tuple, win.last_tuple
                    if t_s is None:
                        it = Iterable([], 0, 0)
                    else:
                        lo, hi = kd.archive.win_range(t_s, t_e)
                        it = Iterable(kd.archive.items(), lo, hi)
                    self.win_func(win.gwid, it, win.result)
                self._emit_result(key, kd, win.result, emit)
            kd.wins.clear()

    def svc_end(self):
        if self.closing_func is not None:
            self.closing_func(self.context)

    def state_dict(self):
        return {"keys": self.keys, "ignored": self.ignored_tuples}

    def load_state(self, state):
        self.keys = state["keys"]
        self.ignored_tuples = state["ignored"]


def builtin_win_func(kind: str):
    """Non-incremental window function for a builtin aggregate name
    (sum/count/mean/max/min).  Empty windows produce the masked neutral
    0, matching the columnar/native planes (window_compute.py)."""
    if kind == "sum":
        def f(gwid, it, res):
            res.value = sum(t.value for t in it)
    elif kind == "count":
        def f(gwid, it, res):
            res.value = float(len(it))
    elif kind == "mean":
        def f(gwid, it, res):
            res.value = (sum(t.value for t in it) / len(it)
                         if len(it) else 0.0)
    elif kind == "max":
        def f(gwid, it, res):
            res.value = max((t.value for t in it), default=0.0)
    elif kind == "min":
        def f(gwid, it, res):
            res.value = min((t.value for t in it), default=0.0)
    else:
        raise ValueError(f"unknown builtin window kind {kind!r}")
    return f


class WinSeq(Operator):
    """Standalone sequential window operator (parallelism 1).

    ``win_func`` may be a callable or a builtin aggregate name
    ("sum"/"count"/"max"/"min") -- builtin names additionally let the
    chain lower onto the native C++ record pipeline
    (graph/native_lowering.py)."""

    def __init__(self, win_func, win_len, slide_len, win_type,
                 triggering_delay=0, incremental=False, name="win_seq",
                 result_factory=BasicRecord, closing_func=None):
        super().__init__(name, 1, RoutingMode.FORWARD, Pattern.WIN_SEQ)
        self.win_kind_name = win_func if isinstance(win_func, str) else None
        if self.win_kind_name is not None:
            win_func = builtin_win_func(self.win_kind_name)
            incremental = False
        self.kwargs = dict(
            win_func=win_func, win_len=win_len, slide_len=slide_len,
            win_type=win_type, triggering_delay=triggering_delay,
            incremental=incremental, result_factory=result_factory,
            closing_func=closing_func)
        self.win_type = win_type
        self._renumbering = False

    def enable_renumbering(self):
        self._renumbering = True

    def make_logic(self, renumbering=False) -> WinSeqLogic:
        return WinSeqLogic(renumbering=renumbering, **self.kwargs)

    def stages(self):
        return [StageSpec(
            self.name, [self.make_logic(renumbering=self._renumbering)],
            StandardEmitter(), self.routing,
            ordering_mode=(OrderingMode.ID if self.win_type == WinType.CB
                           else OrderingMode.TS))]
