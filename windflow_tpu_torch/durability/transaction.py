"""The exactly-once sink contract (docs/RESILIENCE.md "Exactly-once
epochs").

``SinkBuilder(fn).with_exactly_once()`` swaps the plain SinkLogic for
one of two wrappers:

* **transactional** (default): effects buffer per epoch; the barrier
  seals the open buffer (``epoch_mark``) and the coordinator releases
  sealed buffers *after* the epoch's manifest is durably committed
  (``commit_epoch``).  A crash discards every unreleased buffer with
  the failed graph, and the restarted run regenerates exactly those
  effects from the restored epoch -- no duplicate, no loss.  A clean
  end releases everything (the complete stream is the implicit final
  commit).
* **idempotent** (``with_exactly_once("idempotent")``): effects apply
  immediately, tagged with the epoch id they belong to -- the contract
  for side channels that tolerate replays keyed by epoch (the
  stats/dead-letter surfaces, external stores with epoch-keyed
  upserts).  The sink callable must be an epoch-keyed writer
  (``write(epoch, item)``, e.g. :class:`EpochTaggedStore`); recovery
  truncates it above the restored epoch (``truncate_above``) and the
  replay re-applies the truncated epochs identically.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from ..operators.basic_ops import SinkLogic
from ..runtime.node import EOSMarker, NodeLogic


class TransactionalSinkLogic(SinkLogic):
    """Buffer-per-epoch sink: release on durable commit, flush on clean
    EOS, discard (implicitly, with the process/graph) on crash."""

    def __init__(self, fn, parallelism=1, replica_index=0,
                 closing_func=None):
        super().__init__(fn, parallelism, replica_index, closing_func)
        self._lock = threading.Lock()
        self._emit_lock = threading.Lock()  # serializes fn() calls:
        # the coordinator releases committed buffers from its own
        # thread while the replica may be flushing at EOS
        self._buf: List[Any] = []
        self._sealed: Dict[int, List[Any]] = {}
        self.effects_released = 0
        self.effects_failed = 0
        # graph dead-letter store + replica name, bound by the
        # coordinator: a sink-fn error during release must quarantine
        # the offending effect and keep going -- the epoch is already
        # durably committed, so nothing will ever regenerate it
        self._dead_letters = None
        self._name = "transactional_sink"
        # True once an EpochCoordinator adopted this sink: per-sink EOS
        # then defers release to the coordinator's graph-level final
        # commit -- one branch ending cleanly must not release
        # uncommitted effects that another branch's later crash would
        # regenerate on restart (duplicates).  False (no durability
        # plane) keeps the legacy flush-at-EOS behaviour.
        self._coordinated = False

    def svc(self, item, channel_id, emit):
        if isinstance(item, EOSMarker):
            return
        with self._lock:
            self._buf.append(item)

    # -- durability hooks ----------------------------------------------
    def epoch_mark(self, epoch: int) -> None:
        """Barrier passage (replica thread): everything buffered so far
        belongs to ``epoch``."""
        with self._lock:
            self._sealed[epoch] = self._buf
            self._buf = []

    def _apply(self, runs) -> int:
        """Deliver released effects one by one; a sink-fn Exception
        quarantines THAT effect in the dead-letter store and keeps
        going (the epoch is committed -- a restart will never
        regenerate it, so dropping the rest of the run would be
        silent loss).  Non-Exception BaseExceptions propagate, as on
        the normal svc path."""
        n = 0
        for run in runs:
            for it in run:
                try:
                    self.fn(it)
                    n += 1
                except Exception as e:
                    self.effects_failed += 1
                    if self._dead_letters is not None:
                        self._dead_letters.add(self._name, it, e)
        self.effects_released += n
        return n

    def commit_epoch(self, epoch: int) -> int:
        """Coordinator thread, after the manifest is durable: release
        every sealed buffer up to ``epoch``, in epoch order."""
        with self._lock:
            ready = sorted(e for e in self._sealed if e <= epoch)
            runs = [self._sealed.pop(e) for e in ready]
        with self._emit_lock:
            return self._apply(runs)

    def _release_all(self) -> int:
        with self._lock:
            runs = [self._sealed.pop(e) for e in sorted(self._sealed)]
            runs.append(self._buf)
            self._buf = []
        with self._emit_lock:
            n = self._apply(runs)
            self.fn(None)
        return n

    def final_release(self) -> int:
        """Graph-level clean-end release (EpochCoordinator.stop): every
        replica joined without error, the final manifest is durable --
        the remaining sealed + open buffers are the final commit."""
        return self._release_all()

    def epoch_rewind(self, committed: int) -> int:
        """Supervised replica restart (durability/supervision.py): the
        stream rewinds to epoch ``committed``, so every uncommitted
        buffer -- sealed above it or still open -- is about to be
        REGENERATED by the source replay.  Discard them; releasing
        later would duplicate.  Returns the discarded count."""
        with self._lock:
            drop = [e for e in self._sealed if e > committed]
            n = sum(len(self._sealed.pop(e)) for e in drop)
            n += len(self._buf)
            self._buf = []
        return n

    def eos_flush(self, emit):
        if self._coordinated:
            # a durable graph releases at the COORDINATOR's final
            # commit, after every sink branch ended cleanly: this
            # sink's own EOS is not a safe commit point (another
            # branch may still crash, and the restart would regenerate
            # whatever released here)
            return
        # legacy (no durability plane): clean end of stream = the
        # remaining buffers are the final commit.  (A crashed graph
        # never reaches eos_flush -- its channels raise GraphCancelled
        # -- which is exactly the discard contract.)
        self._release_all()


class EpochTaggedStore:
    """Thread-safe epoch-keyed effect store: the reference
    implementation of the idempotent sink target.  Survives restart
    attempts (the caller owns it across graph rebuilds); recovery
    truncates it above the restored epoch before the replay re-applies
    those epochs."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_epoch: Dict[int, List[Any]] = {}

    def write(self, epoch: int, item: Any) -> None:
        with self._lock:
            self._by_epoch.setdefault(epoch, []).append(item)

    def truncate_above(self, epoch: int) -> int:
        """Drop every effect of epochs > ``epoch`` (the un-committed
        tail a crashed attempt may have applied); returns the count."""
        with self._lock:
            drop = [e for e in self._by_epoch if e > epoch]
            n = sum(len(self._by_epoch.pop(e)) for e in drop)
        return n

    def items(self) -> List[Any]:
        with self._lock:
            return [it for e in sorted(self._by_epoch)
                    for it in self._by_epoch[e]]

    def epochs(self) -> List[int]:
        with self._lock:
            return sorted(self._by_epoch)

    def count(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._by_epoch.values())


class IdempotentSinkLogic(NodeLogic):
    """Apply-immediately sink writing through an epoch-keyed store
    (``write(epoch, item)``): effects between barriers ``e-1`` and
    ``e`` are tagged epoch ``e`` -- the same epoch whose manifest
    commit makes them permanent."""

    def __init__(self, store, parallelism=1, replica_index=0,
                 closing_func: Optional[Callable] = None):
        if not hasattr(store, "write"):
            raise TypeError(
                "with_exactly_once('idempotent') needs an epoch-keyed "
                "writer with write(epoch, item) -- e.g. an "
                "EpochTaggedStore -- not a plain callable")
        from ..core.context import RuntimeContext
        self.store = store
        self.context = RuntimeContext(parallelism, replica_index)
        self.closing_func = closing_func
        self._epoch = 1

    def svc(self, item, channel_id, emit):
        if isinstance(item, EOSMarker):
            return
        self.store.write(self._epoch, item)

    def epoch_mark(self, epoch: int) -> None:
        self._epoch = epoch + 1

    def epoch_resume(self, committed: int) -> None:
        """Restored run (coordinator attach): effects before the first
        new barrier belong to the epoch after the restored one."""
        self._epoch = committed + 1

    def epoch_rewind(self, committed: int) -> int:
        """Supervised replica restart: the source replay is about to
        re-apply every effect above ``committed`` -- truncate them
        from the store so the replay lands them exactly once, and
        re-anchor the tag counter."""
        n = self.store.truncate_above(committed)
        self._epoch = committed + 1
        return n

    def eos_flush(self, emit):
        done = getattr(self.store, "eos", None)
        if done is not None:
            done()

    def svc_end(self):
        if self.closing_func is not None:
            self.closing_func(self.context)
