"""Epoch-aware recovery: restart from the last committed epoch
(docs/RESILIENCE.md "Exactly-once epochs").

``run_with_epochs`` is the durable sibling of
``utils.checkpoint.run_with_recovery``: each attempt rebuilds the graph
from the factory, restores every replica's state from the newest
loadable epoch manifest (sources rewind to the committed offsets --
their offset IS their snapshot state), and re-runs.  Combined with a
transactional/idempotent sink, the restart regenerates exactly the
effects the crashed attempt had not durably committed: end-to-end
exactly-once, verified online by the conservation ledger balancing in
the restarted run and offline by the kill-restart-verify chaos suite.
"""
from __future__ import annotations

import pickle
from typing import Any, Callable, List, Optional

from ..resilience.errors import NodeFailureError
from .store import EpochStore


def restore_epoch(graph, payload: dict, overrides=None) -> int:
    """Load a committed epoch manifest into an UNSTARTED graph;
    returns the number of replicas restored.

    Structure checking and state loading are shared with
    ``utils.checkpoint.restore_graph`` (``restore_states``): the
    manifest's stateful-replica names must equal this graph's (names
    are pre-fusion, so any OptLevel restores) -- a silent partial
    restore would misdistribute keyed state.  ``overrides``
    (operator-name -> new parallelism) lifts named replica groups out
    of that contract: their keyed state is merged and repartitioned
    through the elastic ``hash % n`` owner function instead
    (docs/RESILIENCE.md "Restore into a different parallelism")."""
    from ..utils.checkpoint import restore_states
    return restore_states(
        graph, payload["states"],
        f"epoch manifest (epoch {payload.get('epoch')})",
        decode=pickle.loads, overrides=overrides)


def run_with_epochs(graph_factory: Callable[[int], Any],
                    max_restarts: int = 3,
                    on_failure: Optional[Callable] = None,
                    on_restore: Optional[Callable] = None,
                    parallelism_overrides: Optional[dict] = None) -> Any:
    """Run ``graph_factory(attempt)`` to completion with epoch-aware
    restarts.  Every graph the factory builds must carry the SAME
    ``RuntimeConfig.durability`` (same manifest path).

    On a retryable failure (``NodeFailureError`` -- replica death,
    stall, injected torn commit) the latest loadable epoch manifest is
    restored into a freshly built graph: replica state reloads,
    sources rewind to the committed offsets, and uncommitted sink
    output is discarded with the dead graph.  ``on_restore(graph,
    epoch, payload)`` runs after a successful restore -- e.g. to
    ``truncate_above(epoch)`` an idempotent sink's store.
    ``on_failure(attempt, error, graph)`` observes each failed attempt;
    all failures attach to the finally raised error as
    ``attempt_history``.

    ``parallelism_overrides`` ({operator name: new replica count})
    declares that the factory now builds named operators at a DIFFERENT
    parallelism than the manifest was written with: their keyed state
    is repartitioned across the new replica set through the elastic
    ``hash % n`` contract instead of raising the structure-mismatch
    error.  Source offsets re-assign by name (sources are
    parallelism-1 under the durability plane, so their names -- and
    offsets -- survive any operator rescale unchanged).  The counts
    are advisory documentation of intent; the authoritative new
    parallelism is whatever the factory builds."""
    attempt = 0
    history: List[BaseException] = []
    while True:
        g = graph_factory(attempt)
        dcfg = getattr(g.config, "durability", None)
        if dcfg is None:
            raise ValueError(
                "run_with_epochs: the factory's graphs must set "
                "RuntimeConfig.durability (use run_with_recovery for "
                "quiescent-checkpoint restarts)")
        store = EpochStore(dcfg.path, dcfg.retained)
        epoch, payload = store.latest(flight=g.flight)
        if epoch is not None:
            n = restore_epoch(g, payload,
                              overrides=parallelism_overrides)
            g.flight.record("epoch_restore", epoch=epoch, replicas=n,
                            offsets=payload.get("offsets", {}),
                            attempt=attempt,
                            repartitioned=sorted(parallelism_overrides)
                            if parallelism_overrides else [])
            g._epoch_restored = epoch
            if on_restore is not None:
                on_restore(g, epoch, payload)
        try:
            g.run()
            return g
        except NodeFailureError as e:
            history.append(e)
            if on_failure is not None:
                on_failure(attempt, e, g)
            attempt += 1
            if attempt > max_restarts:
                e.attempt_history = history
                raise
