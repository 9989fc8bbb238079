"""Distributed runtime plane: one PipeGraph across worker processes
(docs/DISTRIBUTED.md).

This package partitions a logical ``PipeGraph`` across N workers --
explicit ``.with_worker(i)`` pins plus an automatic cut that keeps
fused FORWARD runs co-located and only cuts KEYBY shuffle edges -- and
carries every cross-worker edge over a **credit-backpressured shuffle
transport** built on the shared wire codec (`wire.py`).  EOS,
poison/cancel, ``EpochBarrier`` control items and trace contexts all
ride the frames, so the observability and durability planes extend
across the boundary: per-edge ledgers close over each socket
(`observe.merge_stats` composes the cross-process conservation
identity), attribution charges a ``wire`` hop class, and
``run_distributed`` restarts a killed worker fleet from the newest
globally-committed epoch.

Workers are ``python -m windflow_tpu_torch.distributed.worker``
processes; each imports the user's build function from a module that
imports only this package.  Workers talk over loopback sockets, so
several of them may share one card, each with its own CUDA context; a
worker whose partition holds no device engine never touches the card.

Modules: `wire` (codec + message layer), `partition` (ownership plan),
`transport` (sender/server), `wiring` (graph-start application),
`runtime` (worker processes + coordinator), `observe` (merged view),
`identity` (worker id / log-name suffix).
"""
from __future__ import annotations

_LAZY = {
    "DistributedSpec": ".runtime",
    "run_distributed": ".runtime",
    "WorkerFailure": ".runtime",
    "free_ports": ".runtime",
    "worker_main": ".runtime",
    "plan_partition": ".partition",
    "PartitionError": ".partition",
    "node_owner": ".partition",
    "RemoteEdgeSender": ".transport",
    "ShuffleServer": ".transport",
    "EdgeState": ".transport",
    "WireError": ".transport",
    "distribute_graph": ".wiring",
    "DistRuntime": ".wiring",
    "KILL_EXIT": ".wiring",
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
    # transport/process layers in (ingest imports it at package load)
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    from importlib import import_module
    return getattr(import_module(target, __name__), name)
