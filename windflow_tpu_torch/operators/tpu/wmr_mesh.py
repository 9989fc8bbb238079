"""WinMapReduceMesh: multi-shard Win_MapReduce -- intra-window striping
over the mesh 'win' axis, one graph operator.

BASELINE config #5 ("Win_MapReduce ... on v5e-8") as a first-class
operator, the mesh generalization of win_mapreduce_gpu.hpp:63: each
window's tuples are striped round-robin across the 'win' axis (the
WinMap_Emitter per-key round robin, wm_nodes.hpp:62, applied at chip
granularity), every shard folds its stripe locally (the MAP stage), and
the REDUCE combines the shards' partials -- a sum/max/min over the
shard axis for the builtins, the gathered partials under a pairwise
combine for a custom FFAT fold (parallel/sharded.compute_wmr, torch
programs on the mesh's device).  Multiple keys ride the 'key' axis
simultaneously, so one launch computes key-rows x windows at once.

Host plane: window assignment, batching and emission are shared with
KeyFarmMesh (same dense-id CB / timestamp TB contract, anchoring,
hopping-gap filtering); only the launch layout differs -- KF ships each
key's series to ONE shard, WMR splits each WINDOW across ALL 'win'
shards.  The reference cannot express either beyond one process
(SURVEY.md §5 "no network backend").
"""
from __future__ import annotations


import numpy as np

from ...core.basic import Pattern, WinType
from ...core.tuples import BasicRecord, TupleBatch
from .mesh_farm import KeyFarmMesh, KeyFarmMeshLogic


class WinMapReduceMeshLogic(KeyFarmMeshLogic):
    """KeyFarmMesh's host plane with the striped launch layout."""

    def _launch(self, emit):
        if not self.ready:
            return
        ready, self.ready = self.ready, []
        eng = self.engine
        W = eng.n_win_shards
        K = eng.n_key_shards
        neutral = eng.neutral
        involved = self._involved_keys(ready)
        cons = {k: self._consolidate_key(k) for k in involved}
        row_of = {k: i for i, k in enumerate(involved)}
        # (row, slot) placement + the widest stripe of this launch
        slots = [0] * len(involved)
        placement = []
        segs = []
        stripe_len = 1
        for key, lwid, s_key, e_key in ready:
            ids, vals = cons[key]
            lo = int(np.searchsorted(ids, s_key, "left"))
            hi = int(np.searchsorted(ids, e_key, "left"))
            seg = vals[lo:hi]
            if eng.kind == "count":
                seg = np.ones(hi - lo, np.float64)
            segs.append(seg)
            stripe_len = max(stripe_len, -(-(hi - lo) // W))
            row = row_of[key]
            placement.append((key, lwid, row, slots[row]))
            slots[row] += 1
        B = max(slots)
        rows_pad = -(-len(involved) // K) * K  # 'key' axis divisibility
        stripes = np.full((rows_pad, W, B, stripe_len), neutral, np.float32)
        for (key, lwid, row, slot), seg in zip(placement, segs):
            pad = np.full(W * stripe_len, neutral, np.float32)
            pad[: len(seg)] = seg
            # element i -> stripe i % W, position i // W: the round-robin
            # striping of WinMap_Emitter as a reshape
            stripes[row, :, slot, :] = pad.reshape(stripe_len, W).T
        out = eng.compute_wmr(stripes).cpu().numpy()
        self.launched_batches += 1
        if self.emit_batches:
            n = len(placement)
            emit(TupleBatch({
                "key": np.fromiter((p[0] for p in placement), np.int64, n),
                "id": np.fromiter((p[1] for p in placement), np.int64, n),
                "ts": np.zeros(n, np.int64),
                "value": np.fromiter(
                    (out[row, slot] for _, _, row, slot in placement),
                    np.float64, n),
            }))
        else:
            for key, lwid, row, slot in placement:
                emit(BasicRecord(key, lwid, 0, float(out[row, slot])))
        self._evict_consumed(involved)


class WinMapReduceMesh(KeyFarmMesh):
    """``kind`` is a builtin combine name ('sum'/'count'/'max'/'min' --
    'mean' is rejected: stripe partials carry no count channel) or an
    FFAT spec ('ffat', lift, combine, neutral); lift is applied
    columnar on the host at ingest, the combine folds stripes on
    device and across chips (win_mapreduce_gpu.hpp:63 at mesh
    scale).  Shares KeyFarmMesh's operator shell; only the launch
    layout (logic class) and pattern differ."""

    _logic_cls = WinMapReduceMeshLogic
    _pattern = Pattern.WIN_MAPREDUCE_TPU

    def __init__(self, mesh, win_len: int, slide_len: int,
                 win_type: WinType, batch_windows: int = 1024,
                 name: str = "win_mr_mesh", emit_batches: bool = True,
                 kind="sum"):
        super().__init__(mesh, win_len, slide_len, win_type,
                         batch_windows, name, emit_batches, kind)
        if self.engine.kind == "mean":
            raise ValueError("WinMapReduceMesh does not support 'mean' "
                             "(stripe partials carry no count channel)")
