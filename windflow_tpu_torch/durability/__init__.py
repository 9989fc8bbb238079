"""Durability plane: exactly-once pipelines through aligned epoch
barriers (docs/RESILIENCE.md "Exactly-once epochs").

Composes the machinery earlier planes proved -- fusion-invariant
state snapshots (utils/checkpoint), checkpointable source offsets
(ingest/operators), FaultPlan + recovery runners (resilience), the
audit plane's frontiers and delivery books -- into Flink-style aligned
incremental snapshots taken **without stopping the graph**, an
atomically-committed epoch manifest store, a transactional /
idempotent sink contract, and an epoch-aware restart runner.

Enable with ``RuntimeConfig.durability = DurabilityConfig(...)`` and,
for exactly-once sink output, ``SinkBuilder(fn).with_exactly_once()``.
``DurabilityConfig(delta=True)`` switches keyed replicas to
incremental blob-chain snapshots (delta.py); ``RuntimeConfig.
supervision = SupervisionConfig(...)`` arms in-place replica
self-healing for ``.with_restartable()`` operators (supervision.py).
"""
from ..core.basic import DurabilityConfig, SupervisionConfig
from ..runtime.queues import EpochBarrier
from .barrier import EpochAligner, EpochInjector, epoch_cut
from .coordinator import EpochCoordinator
from .delta import BlobRef, BlobStore, DeltaEncoder, KeyedCapture
from .recovery import restore_epoch, run_with_epochs
from .store import EpochStore, MANIFEST_SCHEMA, atomic_write_bytes
from .supervision import ReplicaSupervisor, SupervisedGroup
from .transaction import (EpochTaggedStore, IdempotentSinkLogic,
                          TransactionalSinkLogic)

__all__ = [
    "DurabilityConfig", "SupervisionConfig", "EpochBarrier",
    "EpochAligner", "EpochInjector", "EpochCoordinator", "EpochStore",
    "EpochTaggedStore", "IdempotentSinkLogic", "TransactionalSinkLogic",
    "MANIFEST_SCHEMA", "BlobRef", "BlobStore", "DeltaEncoder",
    "KeyedCapture", "ReplicaSupervisor", "SupervisedGroup",
    "atomic_write_bytes", "epoch_cut", "restore_epoch", "run_with_epochs",
]
