"""Win_SeqFFAT: sequential incremental window engine on a FlatFAT tree.

Re-design of reference ``wf/win_seqffat.hpp`` (706 LoC): user provides a
**lift** (tuple -> partial) and an associative **combine**
(partial x partial -> partial); per-key state is a FlatFAT aggregator
tree plus a pending buffer, giving O(log win_len) amortized cost per
tuple instead of re-scanning the window (Tangwongsan VLDB'15).  CB path
fires every ``slide`` tuples once ``win_len`` are present
(win_seqffat.hpp:365-432); TB path fires on timestamp proof
(win_seqffat.hpp:444-).
"""
from __future__ import annotations

import bisect
from typing import Any, Callable, Dict, List

from ..core.basic import OrderingMode, Pattern, RoutingMode, WinType
from ..core.context import RuntimeContext
from ..core.flatfat import FlatFAT
from ..core.meta import with_context
from ..core.tuples import BasicRecord
from ..runtime.emitters import StandardEmitter
from ..runtime.node import EOSMarker, NodeLogic
from .base import Operator, StageSpec


class _FFATKeyState:
    __slots__ = ("tree", "content_keys", "pending_keys", "pending_vals",
                 "next_lwid", "max_id", "renumber_next")

    def __init__(self, tree: FlatFAT):
        self.tree = tree
        self.content_keys: List[int] = []   # sort keys of values in tree
        self.pending_keys: List[int] = []   # sorted sort-keys of pending
        self.pending_vals: List = []        # lifted values, parallel list
        self.next_lwid = 0
        self.max_id = -1
        self.renumber_next = 0


class WinSeqFFATLogic(NodeLogic):
    def __init__(self, lift_func: Callable, combine_func: Callable,
                 win_len: int, slide_len: int, win_type: WinType, *,
                 triggering_delay: int = 0, result_factory=BasicRecord,
                 closing_func=None, parallelism: int = 1,
                 replica_index: int = 0, renumbering: bool = False):
        if win_len == 0 or slide_len == 0:
            raise ValueError("win_len and slide_len must be > 0")
        self.win_len = win_len
        self.slide_len = slide_len
        self.win_type = win_type
        self.triggering_delay = triggering_delay
        self.result_factory = result_factory
        self.closing_func = closing_func
        self.renumbering = renumbering
        self.context = RuntimeContext(parallelism, replica_index)
        # lift: (tuple, result) -> None   (API:55-58)
        self.lift = with_context(lift_func, 2, self.context)
        # combine: (a, b, out) -> None    (API:59-61)
        self.combine = with_context(combine_func, 3, self.context)
        self.keys: Dict[Any, _FFATKeyState] = {}
        self.ignored_tuples = 0

    # -- FlatFAT plumbing --------------------------------------------------
    def _combine2(self, a, b):
        out = self.result_factory()
        self.combine(a, b, out)
        return out

    def _new_tree(self, capacity: int) -> FlatFAT:
        return FlatFAT(self._combine2, self.result_factory, capacity)

    def _key_state(self, key) -> _FFATKeyState:
        st = self.keys.get(key)
        if st is None:
            cap = self.win_len if self.win_type == WinType.CB else 64
            st = self.keys[key] = _FFATKeyState(self._new_tree(cap))
        return st

    def _grow(self, st: _FFATKeyState, needed: int) -> None:
        """TB windows have no tuple-count bound: rebuild the tree with
        doubled capacity when full (the reference pre-sizes from
        batch_len; we grow adaptively)."""
        cap = st.tree.capacity
        while cap < needed:
            cap *= 2
        if cap == st.tree.capacity:
            return
        values = []
        old = st.tree
        # drain old tree values in order via removal of leaves
        idx = old.front
        for _ in range(old.count):
            values.append(old.tree[old.n + idx])
            idx = (idx + 1) % old.n
        st.tree = self._new_tree(cap)
        if values:
            st.tree.insert_bulk(values)

    # -- windows -----------------------------------------------------------
    def _win_bounds(self, lwid: int):
        start = lwid * self.slide_len
        return start, start + self.win_len

    def _fire(self, key, st: _FFATKeyState, lwid: int, emit) -> None:
        start, end = self._win_bounds(lwid)
        # evict values that precede the window
        n_evict = bisect.bisect_left(st.content_keys, start)
        if n_evict:
            st.tree.remove(n_evict)
            del st.content_keys[:n_evict]
        # hopping (win < slide): pending may hold gap tuples that
        # arrived before this fire (e.g. the previous window's trigger
        # tuple); they belong to NO window -- discard, never insert
        # (win_seq.hpp:388-411 gap semantics)
        gap = bisect.bisect_left(st.pending_keys, start)
        if gap:
            del st.pending_keys[:gap]
            del st.pending_vals[:gap]
            self.ignored_tuples += gap
        # insert pending values inside the window extent
        cut = bisect.bisect_left(st.pending_keys, end)
        if cut:
            vals = st.pending_vals[:cut]
            self._grow(st, len(st.content_keys) + len(vals))
            st.tree.insert_bulk(vals)
            st.content_keys.extend(st.pending_keys[:cut])
            del st.pending_keys[:cut]
            del st.pending_vals[:cut]
        result = st.tree.get_result()
        if self.win_type == WinType.CB:
            result.set_control_fields(key, lwid, 0)
        else:
            result.set_control_fields(
                key, lwid, lwid * self.slide_len + self.win_len - 1)
        emit(result)

    def svc(self, item, channel_id, emit):
        is_marker = isinstance(item, EOSMarker)
        t = item.record if is_marker else item
        key, tid, ts = t.get_control_fields()
        st = self._key_state(key)
        if self.renumbering and not is_marker:
            tid = st.renumber_next
            st.renumber_next += 1
            t.set_control_fields(key, tid, ts)
        id_ = tid if self.win_type == WinType.CB else ts
        if not is_marker:
            if st.next_lwid > 0 and id_ < st.next_lwid * self.slide_len:
                # tuple precedes the next open window: late, ignore
                # (win_seqffat drops tuples of already-fired windows)
                self.ignored_tuples += 1
                return
            lifted = self.result_factory()
            self.lift(t, lifted)
            i = bisect.bisect_right(st.pending_keys, id_)
            st.pending_keys.insert(i, id_)
            st.pending_vals.insert(i, lifted)
            st.max_id = max(st.max_id, id_)
        # fire every window proven complete by id_
        fire_slack = 0 if self.win_type == WinType.CB else self.triggering_delay
        while id_ >= self._win_bounds(st.next_lwid)[1] + fire_slack:
            self._fire(key, st, st.next_lwid, emit)
            st.next_lwid += 1

    def eos_flush(self, emit):
        """Flush every window containing buffered data
        (win_seqffat eosnotify)."""
        for key, st in self.keys.items():
            cand = []
            if st.pending_keys:
                cand.append(st.pending_keys[-1])
            if st.content_keys:
                cand.append(st.content_keys[-1])
            if not cand:
                continue
            last = max(cand)
            while st.next_lwid * self.slide_len <= last:
                self._fire(key, st, st.next_lwid, emit)
                st.next_lwid += 1

    def svc_end(self):
        if self.closing_func is not None:
            self.closing_func(self.context)

    def state_dict(self):
        # FlatFAT trees hold closures (combine); snapshot their live
        # values and rebuild the trees on load
        snap = {}
        for key, st in self.keys.items():
            vals = []
            idx = st.tree.front
            for _ in range(st.tree.count):
                vals.append(st.tree.tree[st.tree.n + idx])
                idx = (idx + 1) % st.tree.n
            snap[key] = {
                "tree_values": vals, "capacity": st.tree.n,
                "content_keys": list(st.content_keys),
                "pending_keys": list(st.pending_keys),
                "pending_vals": list(st.pending_vals),
                "next_lwid": st.next_lwid, "max_id": st.max_id,
                "renumber_next": st.renumber_next,
            }
        return {"keys": snap, "ignored": self.ignored_tuples}

    def load_state(self, state):
        self.keys.clear()
        for key, snap in state["keys"].items():
            st = _FFATKeyState(self._new_tree(snap["capacity"]))
            if snap["tree_values"]:
                st.tree.insert_bulk(snap["tree_values"])
            st.content_keys = list(snap["content_keys"])
            st.pending_keys = list(snap["pending_keys"])
            st.pending_vals = list(snap["pending_vals"])
            st.next_lwid = snap["next_lwid"]
            st.max_id = snap["max_id"]
            st.renumber_next = snap["renumber_next"]
            self.keys[key] = st
        self.ignored_tuples = state["ignored"]


class WinSeqFFAT(Operator):
    def __init__(self, lift_func, combine_func, win_len, slide_len, win_type,
                 triggering_delay=0, name="win_seqffat",
                 result_factory=BasicRecord, closing_func=None):
        super().__init__(name, 1, RoutingMode.FORWARD, Pattern.WIN_SEQFFAT)
        self.win_type = win_type
        self.kwargs = dict(
            lift_func=lift_func, combine_func=combine_func, win_len=win_len,
            slide_len=slide_len, win_type=win_type,
            triggering_delay=triggering_delay, result_factory=result_factory,
            closing_func=closing_func)
        self._renumbering = False

    def enable_renumbering(self):
        self._renumbering = True

    def stages(self):
        logic = WinSeqFFATLogic(renumbering=self._renumbering, **self.kwargs)
        return [StageSpec(
            self.name, [logic], StandardEmitter(), self.routing,
            ordering_mode=(OrderingMode.ID if self.win_type == WinType.CB
                           else OrderingMode.TS))]


class KeyFFAT(Operator):
    """Key-parallel farm of Win_SeqFFAT engines
    (reference ``wf/key_ffat.hpp``:65-170: KF_Emitter routing, no
    collector)."""

    def __init__(self, lift_func, combine_func, win_len, slide_len, win_type,
                 parallelism=1, triggering_delay=0, name="key_ffat",
                 result_factory=BasicRecord, closing_func=None):
        super().__init__(name, parallelism, RoutingMode.KEYBY,
                         Pattern.KEY_FFAT)
        self.win_type = win_type
        self.kwargs = dict(
            lift_func=lift_func, combine_func=combine_func, win_len=win_len,
            slide_len=slide_len, win_type=win_type,
            triggering_delay=triggering_delay, result_factory=result_factory,
            closing_func=closing_func)
        self._renumbering = False

    def enable_renumbering(self):
        self._renumbering = True

    def stages(self):
        from ..runtime.win_routing import KFEmitter
        replicas = [WinSeqFFATLogic(parallelism=self.parallelism,
                                    replica_index=i,
                                    renumbering=self._renumbering,
                                    **self.kwargs)
                    for i in range(self.parallelism)]
        return [StageSpec(
            self.name, replicas, KFEmitter(self.parallelism), self.routing,
            ordering_mode=(OrderingMode.ID if self.win_type == WinType.CB
                           else OrderingMode.TS))]
