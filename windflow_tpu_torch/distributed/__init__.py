"""Distributed runtime plane: the host pieces a single process uses.

Ported so far, each a copy of the reference module:

* `wire` -- the wire codec and message layer (shared with the ingest
  plane);
* `identity` -- the worker id and log-name suffix;
* `observe` -- the merged cluster view: ``merge_stats`` folds per-worker
  stats dumps into one graph view (the doctor's ``--merge``, the
  dashboard's ``GET /cluster``), and the live pair ``StatsPusher`` ->
  ``ClusterObserver`` streams a graph's stats and flight deltas over a
  loopback side socket (``attach_pusher`` on any graph).

Partitioning, the shuffle transport and the worker processes wait for
ROADMAP.md A10g; their names raise an ``AttributeError`` that says so.
"""
from __future__ import annotations

_LAZY = {
    "merge_stats": ".observe",
    "wire_table": ".observe",
    "check_wire_conservation": ".observe",
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
    # observer's sockets or the transport/process layers in (ingest
    # imports it at package load)
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r} (the "
            f"distributed runtime is not ported yet: ROADMAP.md A10g)")
    from importlib import import_module
    return getattr(import_module(target, __name__), name)
