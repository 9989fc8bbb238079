"""PaneFarmMesh: multi-shard Pane_Farm with the ring pane combine.

BASELINE config #3 ("pane partial agg + window combine") at mesh scale
as one graph operator: keys shard over the mesh 'key' axis, each key's
pane timeline chunks over the 'win' axis, and sliding windows spanning
chunk boundaries fetch neighbour panes with ring hops
(parallel/sharded.compute_pf_ring, a torch program on the mesh's
device) -- the ring sequence-parallel version of the reference's
two-stage PLQ/WLQ decomposition
(pane_farm.hpp:178-214; pane partials per Li et al. SIGMOD'05).

Host plane: one logic pane-reduces each key's series on ingest (the
PLQ applied as a transport optimization, shipping partials not tuples)
and stages fixed-size **epochs** of ``P_total`` panes per key.  Windows
whose extent crosses an epoch's end are recomputed from the carried
tail panes of the next epoch, so every window is emitted exactly once.
Keys advance through epochs independently; each launch groups keys at
the same epoch (rows padded to the mesh's key-axis multiple).

Scope: builtin ``sum``/``count``/``max``/``min`` or FFAT lift+combine
windows (``mean`` is rejected: pane partials carry no count channel)
over dense per-key ids (CB) or timestamps (TB); win/slide must be
pane-aligned multiples.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ...core.basic import OrderingMode, Pattern, RoutingMode, WinType
from ...core.tuples import TupleBatch
from ...runtime.emitters import StandardEmitter
from ...runtime.node import EOSMarker, NodeLogic
from ..base import Operator, StageSpec


class _PaneKeyState:
    __slots__ = ("panes", "pane_base", "max_id", "partial", "partial_pane")

    def __init__(self, neutral: float = 0.0):
        self.panes: List[float] = []  # complete pane partials
        self.pane_base = 0            # global pane index of panes[0]
        self.max_id = -1
        self.partial = neutral        # open (incomplete) pane accumulator
        self.partial_pane = 0         # its global pane index


class PaneFarmMeshLogic(NodeLogic):
    def __init__(self, engine, win_len: int, slide_len: int,
                 win_type: WinType, panes_per_epoch: int = 64,
                 emit_batches: bool = True):
        self.engine = engine
        self.kind = engine.kind
        self.combine = engine.combine
        self.neutral = engine.neutral
        self.lift = engine.lift
        self.win_len = win_len
        self.slide_len = slide_len
        self.win_type = win_type
        self.emit_batches = emit_batches
        self.pane = int(np.gcd(win_len, slide_len))
        self.wpp = win_len // self.pane
        self.spp = slide_len // self.pane
        W = engine.n_win_shards
        # epoch size: multiple of (W * spp) and > wpp so at least one
        # window completes per epoch
        per = max(panes_per_epoch, self.wpp + self.spp)
        unit = W * self.spp
        self.p_total = ((per + unit - 1) // unit) * unit
        # windows fully inside one epoch; consumption advances by whole
        # windows (wpp and spp are coprime after the gcd, so the carry
        # tail is p_total - n_valid*spp, not wpp - spp)
        self.n_valid = (self.p_total - self.wpp) // self.spp + 1
        self.consumed_per_epoch = self.n_valid * self.spp
        self.keys: Dict[Any, _PaneKeyState] = {}
        self.launched_batches = 0

    # upper bound on panes materialized for one id/ts gap: beyond this
    # the stream is outside the dense-id contract (e.g. epoch-millis
    # timestamps with a mis-sized pane) and filling would OOM
    MAX_GAP_PANES = 1 << 20

    def _fold_chunk(self, partial: float, vals) -> float:
        """Fold one chunk of a pane's values into its open accumulator
        (the host PLQ, generalized over the combine kind)."""
        k = self.kind
        if k == "sum":
            return partial + float(vals.sum())
        if k == "count":
            return partial + float(len(vals))
        if k == "max":
            return max(partial, float(vals.max()))
        if k == "min":
            return min(partial, float(vals.min()))
        # ffat: host-side lift + pairwise combine tree (the __host__
        # half of the reference's combine contract,
        # flatfat_gpu.hpp:68-82) -- log2(n) array-level combine calls
        # per chunk, not one scalar dispatch per tuple; the torch
        # combine runs on CPU float64 tensors
        from ...parallel.sharded import pairwise_fold
        seq = torch.as_tensor(np.asarray(
            self.lift(vals) if self.lift is not None else vals, np.float64))
        if not len(seq):
            return partial
        return float(self.combine(
            torch.tensor(partial, dtype=torch.float64),
            pairwise_fold(seq, self.combine, self.neutral)))

    # -- host PLQ: pane pre-reduction ---------------------------------
    def _ingest_key(self, key, ids, vals) -> None:
        st = self.keys.get(key)
        if st is None:
            st = self.keys[key] = _PaneKeyState(self.neutral)
            # anchor the pane timeline at the first window containing
            # the first tuple (not pane 0): a large first id/ts (e.g.
            # epoch-millis TB streams) must not materialize ~1e9 empty
            # panes from an implicit 0 anchor
            first = int(ids[0]) // self.pane
            # first window whose extent can contain pane `first`, but
            # never anchored past it: sampling windows (spp > wpp)
            # leave inter-window gap panes, and pane_base must stay
            # <= first so ingest's gap accounting holds
            w0 = max(0, (first - self.wpp) // self.spp + 1)
            st.pane_base = min(w0, first // self.spp) * self.spp
            st.partial_pane = st.pane_base
        # pane index per tuple; ids must be non-decreasing per key
        p = ids // self.pane
        st.max_id = max(st.max_id, int(ids[-1]))
        lo = 0
        while lo < len(p):
            cur = int(p[lo])
            hi = int(np.searchsorted(p, cur + 1, "left"))
            if cur > st.partial_pane:
                gap = cur - st.partial_pane - 1
                if gap > self.MAX_GAP_PANES:
                    raise ValueError(
                        f"PaneFarmMesh: id/ts gap of {gap} empty panes "
                        f"for key {key!r} exceeds MAX_GAP_PANES "
                        f"({self.MAX_GAP_PANES}); stream violates the "
                        "dense-id scope (check pane/window sizing)")
                # panes up to cur-1 are complete
                st.panes.append(st.partial)
                st.panes.extend([self.neutral] * gap)  # empty panes
                st.partial = self.neutral
                st.partial_pane = cur
            st.partial = self._fold_chunk(st.partial, vals[lo:hi])
            lo = hi

    def svc(self, item, channel_id, emit):
        if isinstance(item, EOSMarker):
            return
        if isinstance(item, TupleBatch):
            keys = item.key
            ids = item.id if self.win_type == WinType.CB else item.ts
            vals = item["value"]
            if len(keys) > 1 and not np.all(keys[:-1] <= keys[1:]):
                order = np.argsort(keys, kind="stable")
                keys, ids, vals = keys[order], ids[order], vals[order]
            edges = np.nonzero(np.diff(keys))[0] + 1
            bounds = np.concatenate([[0], edges, [len(keys)]])
            for j in range(len(bounds) - 1):
                lo, hi = int(bounds[j]), int(bounds[j + 1])
                self._ingest_key(keys[lo].item(), ids[lo:hi], vals[lo:hi])
        else:
            key, tid, ts = item.get_control_fields()
            id_ = tid if self.win_type == WinType.CB else ts
            self._ingest_key(key, np.array([id_]), np.array([item.value]))
        self._launch_ready(emit)

    # -- epoch launches over the ring ---------------------------------
    def _ready_keys(self) -> List[Any]:
        # a key is epoch-ready when it has p_total complete panes beyond
        # its epoch base (pane_base counts consumed panes already)
        return [k for k, st in self.keys.items()
                if len(st.panes) >= self.p_total]

    def _launch_ready(self, emit) -> None:
        while True:
            ready = self._ready_keys()
            if not ready:
                return
            self._launch(ready, emit, real_counts=None)

    def _launch(self, ready: List[Any], emit,
                real_counts: Dict[Any, int] = None) -> None:
        """One epoch over the ring.  Steady state (real_counts=None):
        emit the n_valid full windows and advance by whole windows,
        carrying the tail panes.  EOS (real_counts set): the timeline
        was zero-padded to p_total; emit every window starting inside
        the key's real panes (zeros give the partial tail sums), then
        drop the key's panes entirely."""
        S = self.engine.n_key_shards
        K = ((len(ready) + S - 1) // S) * S  # pad rows to the key axis
        # neutral-padded staging: clipped EOS tail windows then combine
        # only the real panes
        pane_vals = np.full((K, self.p_total, 1), self.neutral, np.float32)
        for r, key in enumerate(ready):
            panes = self.keys[key].panes
            take = min(self.p_total, len(panes))
            pane_vals[r, :take, 0] = panes[:take]
        out = self.engine.compute_pf_ring(pane_vals, 1).cpu().numpy()
        self.launched_batches += 1
        rec_keys: List = []
        rec_wids: List[int] = []
        rec_vals: List[float] = []
        for r, key in enumerate(ready):
            st = self.keys[key]
            base_win = st.pane_base // self.spp
            if real_counts is None:
                n_emit = self.n_valid
            else:
                # EOS: windows starting inside the real panes, clamped
                # to the epoch's unmasked range; later starts re-emerge
                # in the next EOS epoch after normal consumption
                n_emit = min(-(-real_counts[key] // self.spp),
                             self.n_valid)
            for w in range(n_emit):
                rec_keys.append(key)
                rec_wids.append(base_win + w)
                rec_vals.append(float(out[r, w]))
            if real_counts is None \
                    or real_counts[key] > self.consumed_per_epoch:
                st.panes = st.panes[self.consumed_per_epoch:]
                st.pane_base += self.consumed_per_epoch
            else:
                st.panes = []
        if not rec_keys:
            return
        if self.emit_batches:
            n = len(rec_keys)
            emit(TupleBatch({
                "key": np.asarray(rec_keys, np.int64),
                "id": np.asarray(rec_wids, np.int64),
                "ts": np.zeros(n, np.int64),
                "value": np.asarray(rec_vals, np.float64)}))
        else:
            from ...core.tuples import BasicRecord
            for k, w, v in zip(rec_keys, rec_wids, rec_vals):
                emit(BasicRecord(k, w, 0, v))

    def eos_flush(self, emit):
        # close each key's open pane, then drain EOS epochs: the staging
        # array pads short timelines with the combine's neutral, so
        # clipped tail windows come out as partial combines
        for st in self.keys.values():
            if st.max_id >= 0:
                st.panes.append(st.partial)
                st.partial = self.neutral
                st.partial_pane += 1
        while True:
            remaining = [k for k, st in self.keys.items() if st.panes]
            if not remaining:
                return
            real = {k: len(self.keys[k].panes) for k in remaining}
            self._launch(remaining, emit, real_counts=real)


class PaneFarmMesh(Operator):
    """Mesh-scale Pane_Farm over the ring collective (config #3)."""

    def __init__(self, mesh, win_len: int, slide_len: int,
                 win_type: WinType, panes_per_epoch: int = 64,
                 name: str = "pane_farm_mesh", emit_batches: bool = True,
                 kind="sum"):
        super().__init__(name, 1, RoutingMode.FORWARD,
                         Pattern.PANE_FARM_TPU)
        from ...parallel.sharded import ShardedWindowEngine
        # NOTE: unlike the farm-based Pane_Farm planes (sliding-only,
        # pane_farm.hpp:170-173), the epoch/ring decomposition has no
        # PLQ renumbering to misalign, so tumbling and hopping windows
        # are supported here (covered by test_mesh_farm geometry tests)
        self.win_type = win_type
        # the host pre-reduces panes, so the ring engine works in PANE
        # units: its window = wpp panes of width 1, slide = spp panes.
        # ``kind``: builtin combine or ('ffat', lift, combine, neutral),
        # the combine a binary torch function;
        # 'mean' is rejected (panes carry no count channel).  A window
        # whose extent holds only empty panes combines to the kind's
        # neutral, not the single-chip engines' masked 0.
        if kind == "mean":
            raise ValueError(
                "PaneFarmMesh does not support 'mean': pane partials "
                "carry no count channel (use KeyFarmMesh)")
        pane = int(np.gcd(win_len, slide_len))
        self.engine = ShardedWindowEngine(mesh, win_len // pane,
                                          slide_len // pane, kind)
        self.args = (win_len, slide_len, win_type, panes_per_epoch,
                     emit_batches)

    def stages(self):
        win_len, slide_len, win_type, ppe, eb = self.args
        logic = PaneFarmMeshLogic(self.engine, win_len, slide_len,
                                  win_type, ppe, eb)
        return [StageSpec(self.name, [logic], StandardEmitter(),
                          self.routing,
                          ordering_mode=(OrderingMode.ID
                                         if win_type == WinType.CB
                                         else OrderingMode.TS))]
