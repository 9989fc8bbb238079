"""Carry a window engine's state from the reference package to the port.

``from_reference_state`` takes a ``WinSeqTPULogic.state_dict()``
snapshot taken in ``windflow_tpu`` -- numpy arrays, the native engine's
serialized bytes, counters -- and returns the state
``windflow_tpu_torch``'s ``WinSeqTPULogic.load_state`` takes, so a
stream checkpointed under the reference resumes under the port and
produces the same remaining windows.  This is the stream processor's
counterpart of carrying weights across.

Both packages build the same ``native/*.cpp`` engine, so its versioned
blob passes through unchanged.  The Python staging path's per-key
stores are rebuilt as the port's key-state objects, attribute by
attribute (the reference's key-state class is read, never imported).
"""
from __future__ import annotations

import copy
from typing import Any, Dict

from .operators.tpu.win_seq_tpu import _TPUKeyState

# snapshot fields both packages share verbatim
_PASS_THROUGH = ("descriptors", "ignored_tuples", "launched_batches",
                 "buffered", "native", "plq_counters", "key_intern")


def _key_state(ref) -> _TPUKeyState:
    st = _TPUKeyState()
    for slot in _TPUKeyState.__slots__:
        setattr(st, slot, copy.deepcopy(getattr(ref, slot)))
    return st


def from_reference_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's ``WinSeqTPULogic`` state for a reference snapshot."""
    unknown = set(state) - set(_PASS_THROUGH) - {"keys"}
    if unknown:
        raise ValueError(f"unknown reference snapshot fields: "
                         f"{sorted(unknown)}")
    out = {k: copy.deepcopy(state[k]) for k in _PASS_THROUGH if k in state}
    if "keys" in state:
        out["keys"] = {k: _key_state(v) for k, v in state["keys"].items()}
    return out
