"""Carry a window engine's state from the reference package to the port.

``from_reference_state`` takes a ``WinSeqTPULogic.state_dict()``, a
``WinSeqFFATResidentLogic.state_dict()`` or a
``PaneCombineLogic.state_dict()`` snapshot taken in ``windflow_tpu`` --
numpy arrays, the native engine's serialized bytes, counters, a
resident forest, pane runs -- and returns the state the port's logic of
the same name takes in ``load_state``, so a stream checkpointed under
the reference resumes under the port and produces the same remaining
windows.  A farm's snapshot (a list of per-replica snapshots) and a
fused stage's (``ChainedLogic``: ``{"a": ..., "b": ...}``, e.g.
PaneFarmTPU's PLQ + WLQ at LEVEL2) convert element by element.  This is
the stream processor's counterpart of carrying weights across.

A resident FFAT snapshot carries its forest as a numpy ``[K, 2n]``
array; the port's ``load_state`` puts it on the logic's device.  (The
resident pane carry of ``WinSeqTPULogic`` is not part of a snapshot in
either package: it is rebuilt from the host series.)

A resident FFAT lane's per-key blobs (``keyed_state_dict()``, what a
rescale or a restore into another parallelism moves) need no
conversion in either direction: both packages write the same fields --
counters and numpy leaf and timestamp spans -- and each
``load_keyed_state`` takes the other's as they are
(``tests/test_torch_resident.py::test_keyed_state_blob_crosses_packages``).

Both packages build the same ``native/*.cpp`` engine, so its versioned
blob passes through unchanged.  The Python staging path's per-key
stores are rebuilt as the port's key-state objects, attribute by
attribute (the reference's key-state class is read, never imported).
"""
from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np

from .operators.tpu.win_seq_tpu import _TPUKeyState

# snapshot fields both packages share verbatim
_PASS_THROUGH = ("descriptors", "ignored_tuples", "launched_batches",
                 "buffered", "native", "plq_counters", "key_intern")
# a WinSeqFFATResidentLogic snapshot: per-key tuples, forest, capacity
_RESIDENT_FFAT = ("keys", "tree", "capacity")
# a ChainedLogic snapshot: its two halves
_CHAINED = {"a", "b"}


def _key_state(ref) -> _TPUKeyState:
    st = _TPUKeyState()
    for slot in _TPUKeyState.__slots__:
        setattr(st, slot, copy.deepcopy(getattr(ref, slot)))
    return st


def _pane_runs(keys: Dict[Any, tuple]) -> Dict[Any, tuple]:
    """A PaneCombineLogic snapshot's per-key (vals, ts, base, next_fire,
    pending) runs, copied."""
    return {k: (np.array(vals, np.float64), np.array(ts, np.int64),
                int(base), int(next_fire), dict(pending))
            for k, (vals, ts, base, next_fire, pending) in keys.items()}


def _is_pane_combine(state: Dict[str, Any]) -> bool:
    return set(state) == {"keys"} and all(
        isinstance(v, tuple) and len(v) == 5 for v in state["keys"].values())


def from_reference_state(state: Any) -> Any:
    """The port's state for a reference snapshot: of a
    ``WinSeqTPULogic``, ``WinSeqFFATResidentLogic`` or
    ``PaneCombineLogic``, a list of them (a farm's replicas, in replica
    order) or a ``ChainedLogic``'s pair."""
    if isinstance(state, (list, tuple)):
        return [from_reference_state(s) for s in state]
    if state is None:
        return None
    if set(state) == _CHAINED:
        return {h: from_reference_state(state[h]) for h in ("a", "b")}
    if _is_pane_combine(state):
        return {"keys": _pane_runs(state["keys"])}
    if "tree" in state:
        unknown = set(state) - set(_RESIDENT_FFAT)
        if unknown:
            raise ValueError(f"unknown reference snapshot fields: "
                             f"{sorted(unknown)}")
        return {"keys": copy.deepcopy(state["keys"]),
                "tree": np.array(state["tree"], np.float32),
                "capacity": int(state["capacity"])}
    unknown = set(state) - set(_PASS_THROUGH) - {"keys"}
    if unknown:
        raise ValueError(f"unknown reference snapshot fields: "
                         f"{sorted(unknown)}")
    out = {k: copy.deepcopy(state[k]) for k in _PASS_THROUGH if k in state}
    if "keys" in state:
        out["keys"] = {k: _key_state(v) for k, v in state["keys"].items()}
    return out
