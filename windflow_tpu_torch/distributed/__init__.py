"""Distributed runtime plane: only its host pieces are ported so far.

The wire codec (`wire.py`, shared with the ingest plane) and the
worker identity helper (`identity.py`, used for log-file names) are
copied from the reference package.  Partitioning, the shuffle
transport and the worker processes wait for ROADMAP.md A10; their
names raise an ``AttributeError`` that says so.
"""
from __future__ import annotations

_LAZY = {
    "worker_id": ".identity",
    "worker_suffix": ".identity",
    "encode_batch": ".wire",
    "decode_batch": ".wire",
    "StreamDecoder": ".wire",
    "MsgDecoder": ".wire",
    "encode_msg": ".wire",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    # lazy surface: the wire codec must import without dragging the
    # transport/process layers in (ingest imports it at package load)
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r} (the "
            f"distributed runtime is not ported yet: ROADMAP.md A10)")
    from importlib import import_module
    return getattr(import_module(target, __name__), name)
