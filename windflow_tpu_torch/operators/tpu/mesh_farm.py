"""KeyFarmMesh: the multi-shard Key_Farm -- window state sharded across a
('key', 'win') mesh, one graph operator.

BASELINE config #4 ("key-sharded windows across 8 chips") as a
first-class operator: a single host logic partitions keys into
``n_key_shards`` shard-groups (hash % shards, the KF routing applied at
shard granularity), stages each shard's flat buffer into a
[K_shards, T_pad] array, and answers every shard's windows in one call
of the sharded engine (parallel/sharded.compute_kf): on the card one
launch of the window-sum kernel K1 for sums and means, or of the fused
FlatFAT build+query kernel K2r for max/min/FFAT folds, over all shards
at once -- the collective-free steady state of key partitioning (keys
never talk to each other).

The mesh generalization of key_farm_gpu.hpp; its shards are the mesh's
logical slots (parallel/mesh.py).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ...core.basic import OrderingMode, Pattern, RoutingMode, WinType
from ...core.tuples import BasicRecord, TupleBatch
from ...core import win_assign as wa
from ...runtime.emitters import StandardEmitter
from ...runtime.node import EOSMarker, NodeLogic
from ..base import Operator, StageSpec


class _ShardKeyState:
    __slots__ = ("ids", "vals", "next_fire", "opened_max", "max_id")

    def __init__(self):
        self.ids: List[np.ndarray] = []
        self.vals: List[np.ndarray] = []
        self.next_fire = 0
        self.opened_max = -1
        self.max_id = -1


class KeyFarmMeshLogic(NodeLogic):
    """Single host logic driving the whole mesh (the host is the
    emitter plane; the mesh is the farm).  It holds host buffers only:
    no device state outlives a launch."""

    def __init__(self, engine, win_len: int, slide_len: int,
                 win_type: WinType, batch_windows: int = 1024,
                 emit_batches: bool = True):
        self.engine = engine
        self.win_len = win_len
        self.slide_len = slide_len
        self.win_type = win_type
        self.batch_windows = batch_windows
        self.emit_batches = emit_batches
        self.n_shards = engine.n_key_shards
        self.keys: Dict[Any, _ShardKeyState] = {}
        self.ready: List = []  # (key, gwid, start, end)
        self.launched_batches = 0

    def _ingest_key(self, key, ids, vals):
        st = self.keys.get(key)
        if st is None:
            st = self.keys[key] = _ShardKeyState()
        if st.max_id < 0 and len(ids):
            # anchor at the first containing window (native parity)
            first = int(ids.min())
            if first >= self.win_len:
                st.next_fire = ((first - self.win_len)
                                // self.slide_len + 1)
        keep = ids >= st.next_fire * self.slide_len
        if self.win_len < self.slide_len:
            # hopping: ids in the inter-window gaps belong to no window
            # -- drop them BEFORE max_id/opened_max (win_seq_tpu does
            # the same), else a gap id either loses the final window
            # (if ignored) or fabricates empty ones (if counted)
            keep &= (ids % self.slide_len) < self.win_len
        ids, vals = ids[keep], vals[keep]
        if len(ids) == 0:
            return
        if self.engine.lift is not None:  # FFAT lift, columnar
            vals = np.asarray(self.engine.lift(vals))
        st.ids.append(ids)
        st.vals.append(vals)
        st.max_id = max(st.max_id, int(ids.max()))
        last_w = wa.last_window_of(st.max_id, 0, self.win_len,
                                   self.slide_len)
        if last_w >= 0:   # gap ids were filtered above, so >= 0 unless
            st.opened_max = max(st.opened_max, last_w)  # batch was empty
        while True:
            end = st.next_fire * self.slide_len + self.win_len
            if st.max_id < end or st.next_fire > st.opened_max:
                break
            self.ready.append((key, st.next_fire,
                               st.next_fire * self.slide_len, end))
            st.next_fire += 1

    def svc(self, item, channel_id, emit):
        if isinstance(item, EOSMarker):
            return
        if isinstance(item, TupleBatch):
            keys = item.key
            ids = item.id if self.win_type == WinType.CB else item.ts
            vals = item["value"]
            order = np.argsort(keys, kind="stable")
            keys_s, ids_s, vals_s = keys[order], ids[order], vals[order]
            edges = np.nonzero(np.diff(keys_s))[0] + 1
            bounds = np.concatenate([[0], edges, [len(keys_s)]])
            for j in range(len(bounds) - 1):
                lo, hi = bounds[j], bounds[j + 1]
                self._ingest_key(keys_s[lo].item(), ids_s[lo:hi],
                                 vals_s[lo:hi])
        else:
            key, tid, ts = item.get_control_fields()
            id_ = tid if self.win_type == WinType.CB else ts
            self._ingest_key(key, np.array([id_]),
                             np.array([item.value]))
        if len(self.ready) >= self.batch_windows:
            self._launch(emit)

    def _involved_keys(self, ready):
        """Ready windows' keys, first-seen order."""
        involved, seen = [], set()
        for key, *_ in ready:
            if key not in seen:
                seen.add(key)
                involved.append(key)
        return involved

    def _consolidate_key(self, key):
        """Sort-merge one key's buffered chunks in place; returns the
        consolidated (ids, vals)."""
        st = self.keys[key]
        ids = np.concatenate(st.ids) if st.ids else np.empty(0, np.int64)
        vals = (np.concatenate(st.vals) if st.vals
                else np.empty(0, np.float64))
        order = np.argsort(ids, kind="stable")
        ids, vals = ids[order], vals[order]
        st.ids, st.vals = [ids], [vals]
        return ids, vals

    def _evict_consumed(self, involved):
        """Drop each key's prefix no window >= next_fire can reach."""
        for key in involved:
            st = self.keys[key]
            keep_from = st.next_fire * self.slide_len
            ids = st.ids[0]
            cut = np.searchsorted(ids, keep_from, "left")
            if cut:
                st.ids = [ids[cut:]]
                st.vals = [st.vals[0][cut:]]

    def _launch(self, emit):
        if not self.ready:
            return
        ready, self.ready = self.ready, []
        S = self.n_shards
        # per-shard flat buffers: consolidate each involved key's series
        shard_vals: List[List[np.ndarray]] = [[] for _ in range(S)]
        shard_len = [0] * S
        offsets: Dict[Any, tuple] = {}
        involved = self._involved_keys(ready)
        for key in involved:
            ids, vals = self._consolidate_key(key)
            sh = abs(hash(key)) % S
            offsets[key] = (sh, shard_len[sh], ids)
            shard_vals[sh].append(vals)
            shard_len[sh] += len(vals)
        T_pad = 1
        while T_pad < max(max(shard_len), 1):
            T_pad <<= 1
        B = len(ready)
        B_pad = 1
        while B_pad < B:
            B_pad <<= 1
        # pad with the combine's neutral: extents never read padding,
        # but max/min/ffat tree builds must not poison internal nodes
        values = np.full((S, T_pad), self.engine.neutral, np.float32)
        for sh in range(S):
            if shard_vals[sh]:
                flat = np.concatenate(shard_vals[sh])
                values[sh, : len(flat)] = flat
        starts = np.zeros((S, B_pad), np.int32)
        ends = np.zeros((S, B_pad), np.int32)
        slots = [0] * S
        placement = []
        for key, lwid, s_key, e_key in ready:
            sh, base, ids = offsets[key]
            slot = slots[sh]
            slots[sh] += 1
            starts[sh, slot] = base + np.searchsorted(ids, s_key, "left")
            ends[sh, slot] = base + np.searchsorted(ids, e_key, "left")
            placement.append((key, lwid, sh, slot))
        out = self.engine.compute_kf(values, starts, ends).cpu().numpy()
        self.launched_batches += 1
        if self.emit_batches:
            n = len(placement)
            emit(TupleBatch({
                "key": np.fromiter((p[0] for p in placement), np.int64, n),
                "id": np.fromiter((p[1] for p in placement), np.int64, n),
                "ts": np.zeros(n, np.int64),
                "value": np.fromiter(
                    (out[sh, slot] for _, _, sh, slot in placement),
                    np.float64, n),
            }))
        else:
            for key, lwid, sh, slot in placement:
                r = BasicRecord(key, lwid, 0, float(out[sh, slot]))
                emit(r)
        self._evict_consumed(involved)

    def eos_flush(self, emit):
        for key, st in self.keys.items():
            while st.next_fire <= st.opened_max:
                self.ready.append(
                    (key, st.next_fire, st.next_fire * self.slide_len,
                     st.next_fire * self.slide_len + self.win_len))
                st.next_fire += 1
            if len(self.ready) >= self.batch_windows:
                self._launch(emit)
        self._launch(emit)


class KeyFarmMesh(Operator):
    """``kind`` is a builtin combine name ('sum'/'count'/'mean'/'max'/
    'min') or an FFAT spec ('ffat', lift, combine, neutral) -- lift is
    applied columnar on the host at ingest, combine (a binary torch
    function) runs in the shards' device FlatFAT (key_farm_gpu.hpp /
    key_ffat_gpu.hpp at mesh scale).  The engine runs on the mesh's
    device (``make_mesh(..., device=...)``; the card by default)."""

    _logic_cls = KeyFarmMeshLogic
    _pattern = Pattern.KEY_FARM_TPU

    def __init__(self, mesh, win_len: int, slide_len: int,
                 win_type: WinType, batch_windows: int = 1024,
                 name: str = "key_farm_mesh", emit_batches: bool = True,
                 kind="sum"):
        super().__init__(name, 1, RoutingMode.FORWARD, self._pattern)
        from ...parallel.sharded import ShardedWindowEngine
        self.win_type = win_type
        self.engine = ShardedWindowEngine(mesh, win_len, slide_len, kind)
        self.args = (win_len, slide_len, win_type, batch_windows,
                     emit_batches)

    def stages(self):
        win_len, slide_len, win_type, bw, eb = self.args
        logic = self._logic_cls(self.engine, win_len, slide_len, win_type,
                                bw, eb)
        return [StageSpec(self.name, [logic], StandardEmitter(),
                          self.routing,
                          ordering_mode=(OrderingMode.ID
                                         if win_type == WinType.CB
                                         else OrderingMode.TS))]
