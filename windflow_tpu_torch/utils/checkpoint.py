"""Checkpoint / resume of operator state.

The reference has **no** checkpointing (SURVEY.md §5: "Absent. No
serialization of operator state exists"); windflow_tpu_torch isolates it as a
policy layer, as the survey recommends.  Mechanism: every stateful
NodeLogic exposes ``state_dict() / load_state()`` (pickle-friendly
snapshots of per-key window state); this module walks a PipeGraph and
saves/restores every replica's state.

Scope and contract:
* checkpoint at quiescent points: before start, after wait_end, or
  mid-stream through the LIVE barrier (``PipeGraph.quiesce()`` /
  ``live_checkpoint()`` pause sources, drain channels and in-flight
  device batches, snapshot, resume);
* user record/result types must be picklable;
* restores pair with source replay from the captured offset
  (at-least-once without source acknowledgement).
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional

from ..graph.pipegraph import NodeFailureError

# snapshot-file header (the stats-JSON Schema_version contract applied
# to pickled snapshots): save_graph stamps every file; restore_graph
# tolerates header-less legacy files but rejects foreign, newer-schema
# or truncated ones with an actionable error instead of an unpickling
# crash mid-restore
SNAPSHOT_MAGIC = "windflow-graph-state"
SNAPSHOT_SCHEMA = 1


def _is_stateful(logic) -> bool:
    """Structural statefulness probe: True iff the logic's class
    overrides NodeLogic.state_dict (so the saved twin produced state).
    Avoids calling state_dict(), which serializes the full store just
    to test for None.  ChainedLogic defers to its halves (its own
    override returns None when both are stateless); FusedLogic to its
    segments."""
    from ..runtime.node import ChainedLogic, FusedLogic, NodeLogic
    if isinstance(logic, ChainedLogic):
        return _is_stateful(logic.a) or _is_stateful(logic.b)
    if isinstance(logic, FusedLogic):
        return any(_is_stateful(s.logic) for s in logic.segments)
    fn = getattr(type(logic), "state_dict", None)
    if fn is None:  # duck-typed logic: the instance hook decides
        return getattr(logic, "state_dict", None) is not None
    return fn is not NodeLogic.state_dict


def graph_state(graph) -> Dict[str, Any]:
    """Collect every replica's state_dict, keyed by (pre-fusion) node
    name.  Nodes the LEVEL2 compile pass fused (graph/fuse.py) are
    flattened back to their segments via ``iter_logics``, so snapshot
    keys are FUSION-INVARIANT: a LEVEL0 snapshot restores into a LEVEL2
    graph (started or not) and vice versa."""
    from ..graph.fuse import iter_logics
    out = {}
    for name, logic in iter_logics(graph):
        getter = getattr(logic, "state_dict", None)
        if getter is None:
            continue
        st = getter()
        if st is not None:
            out[name] = st
    return out


def write_snapshot(path: str, states: Dict[str, Any],
                   epoch: Optional[int] = None) -> None:
    """Persist a state map crash-safely: schema/epoch header, then
    write-temp + fsync + atomic rename (durability/store.py) -- a crash
    mid-write can no longer leave a truncated pickle at ``path`` that
    poisons every subsequent restart."""
    from ..durability.store import atomic_write_bytes
    payload = {"magic": SNAPSHOT_MAGIC, "schema": SNAPSHOT_SCHEMA,
               "epoch": epoch, "states": states}
    atomic_write_bytes(path, pickle.dumps(
        payload, protocol=pickle.HIGHEST_PROTOCOL))


def save_graph(graph, path: str) -> None:
    write_snapshot(path, graph_state(graph))


def read_snapshot(path: str) -> Dict[str, Any]:
    """Tolerant snapshot loader: stamped files validate their header
    (foreign magic / newer schema / truncation raise an actionable
    RuntimeError naming the file, via the validators shared with the
    epoch-manifest reader); header-less legacy files -- a plain
    pickled state map -- still load."""
    from ..durability.store import load_pickle, validate_header
    payload = load_pickle(path, "graph snapshot")
    if isinstance(payload, dict) and "magic" in payload:
        validate_header(payload, path, SNAPSHOT_MAGIC, SNAPSHOT_SCHEMA,
                        "graph snapshot")
        return payload["states"]
    if not isinstance(payload, dict):
        raise RuntimeError(
            f"{path!r} is not a windflow graph snapshot")
    return payload  # legacy header-less state map


def _replica_group(name: str):
    """Split a replica node name into (group_prefix, index): names end
    with ``.<int>`` per the wiring convention (multipipe._append_stage).
    Returns (None, None) for un-indexed names (sources, collectors)."""
    base, dot, idx = name.rpartition(".")
    if dot and idx.isdigit():
        return base, int(idx)
    return None, None


def _override_for(prefix: str, overrides) -> Optional[str]:
    """The override key authorizing repartition of replica group
    ``prefix`` (e.g. ``pipe0/acc``): exact prefix, its last path
    component (the operator name), or a substring -- the same loose
    matching PipeGraph.rescale applies to elastic registry keys."""
    if not overrides:
        return None
    tail = prefix.rsplit("/", 1)[-1]
    for key in overrides:
        if key == prefix or key == tail or key in prefix:
            return key
    return None


def _slice_keyed_entries(decoded: Any, scratch) -> Dict[Any, Any]:
    """One manifest slice -> {key: value}.  Delta manifests resolve to
    keyed marker payloads (durability/delta.py) that unpack directly;
    schema-1 slices are opaque ``state_dict`` pickles, so the slice is
    decoded THROUGH a scratch logic of the destination group
    (``load_state`` then ``keyed_state_dict``) -- the logic's own
    serialization round-trip is the only universal way back to per-key
    form.  The scratch logic's state is clobbered; callers overwrite
    it with its final partition afterwards."""
    from ..durability.delta import is_keyed_payload, unpack_keyed
    if is_keyed_payload(decoded):
        return unpack_keyed(decoded)
    scratch.load_state(decoded)
    return dict(scratch.keyed_state_dict())


def _repartition_group(prefix: str, describe: str, states, decode,
                       manifest_names, group_logics) -> None:
    """Repartition one replica group's manifest keyed state into a
    different replica count through the elastic ``hash % n`` contract
    (elastic/rescale.py owns the partitioner and the duplicate-key
    invariant)."""
    from ..durability.delta import keyed_capable
    from ..elastic.rescale import partition_keyed_state
    new_n = len(group_logics)
    for idx, logic in group_logics:
        if not keyed_capable(logic):
            raise RuntimeError(
                f"{describe}: parallelism override for {prefix!r} "
                f"needs the keyed-state contract, but replica "
                f"{prefix}.{idx}'s logic ({type(logic).__name__}) "
                "does not implement keyed_state_dict/load_keyed_state")
    scratch = group_logics[0][1]
    merged: Dict[Any, Any] = {}
    for name in manifest_names:
        st = states[name]
        decoded = decode(st) if decode is not None else st
        for k, v in _slice_keyed_entries(decoded, scratch).items():
            if k in merged:
                raise RuntimeError(
                    f"{describe}: key {k!r} appears in more than one "
                    f"manifest slice of {prefix!r} -- the snapshot "
                    "violates the single-owner contract; refusing to "
                    "merge")
            merged[k] = v
    parts = partition_keyed_state(merged, new_n)
    for i, (idx, logic) in enumerate(
            sorted(group_logics, key=lambda t: t[0])):
        logic.load_keyed_state(parts[i])


def restore_states(graph, states: Dict[str, Any], describe: str,
                   decode=None, overrides=None) -> int:
    """Load a state map into a graph, shared by ``restore_graph`` and
    the epoch-manifest restore (durability/recovery.py).  Returns the
    number of replicas restored.

    Without ``overrides`` the graph must be structurally identical:
    raises BEFORE loading anything if the map's stateful-node names
    differ from this graph's -- in either direction the resume would
    silently run with misdistributed window state (e.g. an N-replica
    farm snapshot into a coalesced single-engine lowering, or vice
    versa).  Which nodes are stateful is determined by the graph
    structure, not by stream data, so set equality is the structure
    check.  ``decode`` maps each stored entry to the load argument
    (the manifest path stores pickled blobs).

    ``overrides`` (operator-name keys, from
    ``run_with_epochs(parallelism_overrides=...)``) authorizes named
    replica GROUPS to restore into a DIFFERENT parallelism: the
    group's manifest slices are merged per key (duplicate keys abort)
    and repartitioned through the elastic ``hash % n`` owner contract,
    so every key lands on the replica the new topology's KEYBY emitter
    routes it to.  Groups not named by an override still require exact
    structure."""
    from ..durability.delta import load_into
    from ..graph.fuse import iter_logics
    loadable = {}
    for name, logic in iter_logics(graph):
        if _is_stateful(logic):
            loadable[name] = logic
    extra = set(states) - set(loadable)
    missing = set(loadable) - set(states)
    repartitioned = 0
    if (extra or missing) and overrides:
        # group mismatched names by replica prefix; an override that
        # names a group lifts it out of the exact-match contract
        groups = set()
        for name in list(extra) + list(missing):
            prefix, _idx = _replica_group(name)
            if prefix is not None and _override_for(prefix,
                                                    overrides):
                groups.add(prefix)
        for prefix in sorted(groups):
            manifest_names = sorted(
                n for n in states
                if _replica_group(n)[0] == prefix)
            group_logics = sorted(
                ((_replica_group(n)[1], lg)
                 for n, lg in loadable.items()
                 if _replica_group(n)[0] == prefix),
                key=lambda t: t[0])
            if not manifest_names or not group_logics:
                continue  # nothing to merge / nowhere to load
            _repartition_group(prefix, describe, states, decode,
                               manifest_names, group_logics)
            repartitioned += len(group_logics)
            extra -= set(manifest_names)
            for n in list(missing):
                if _replica_group(n)[0] == prefix:
                    missing.discard(n)
            # the group is fully restored: drop it from the exact-match
            # load below (states entries only load via loadable keys)
            loadable = {k: v for k, v in loadable.items()
                        if _replica_group(k)[0] != prefix}
    if extra or missing:
        raise RuntimeError(
            f"{describe}/graph structure mismatch (e.g. different "
            "parallelism or coalesce setting than at save time): "
            f"snapshot-only nodes {sorted(extra)}, "
            f"graph-only nodes {sorted(missing)}; nothing was restored"
            + ("" if overrides is None else
               " (parallelism_overrides matched no repartitionable "
               "group for these)"))
    for name, logic in loadable.items():
        st = states[name]
        load_into(logic, decode(st) if decode is not None else st)
    return len(loadable) + repartitioned


def restore_graph(graph, path: str) -> int:
    """Load a snapshot file into a structurally identical graph (same
    operator names/parallelisms); returns the replicas restored."""
    return restore_states(graph, read_snapshot(path),
                          f"snapshot {path!r}")


def run_with_recovery(graph_factory, checkpoint_path: str,
                      max_restarts: int = 3, on_failure=None) -> Any:
    """Failure-recovery policy runner (the recovery layer the reference
    lacks entirely, SURVEY.md §5 "failure detection / elastic
    recovery: Absent").

    ``graph_factory(attempt: int) -> PipeGraph`` builds a structurally
    identical graph each attempt (fresh sources may resume from their
    own offsets via the attempt number).  The graph runs to completion;
    on a node failure (``NodeFailureError`` from ``wait_end`` -- a
    replica thread died; deterministic validation errors raise plain
    RuntimeError and propagate immediately) the latest checkpoint -- taken after every successful
    run()-quiescent state, or seeded by the caller -- is restored into a
    freshly built graph and the run retries, up to ``max_restarts``.

    The failure-containment layer (resilience/; docs/RESILIENCE.md)
    makes this runner reach its retry path for *mid-stream* crashes
    too: graph cancellation guarantees ``wait_end`` returns (no
    full-channel deadlock) and a configured stall watchdog converts
    hangs into ``StallError`` (a ``NodeFailureError`` subclass, so
    stalled runs are retried as well).

    ``on_failure(attempt, error, graph)``, when given, observes every
    failed attempt before the retry -- e.g. to drain
    ``graph.dead_letters`` or emit alerts.  The failures of all
    attempts are attached to the finally raised error as
    ``error.attempt_history``.

    Checkpoints are only taken at quiescent points (this runner
    checkpoints AFTER a successful run; mid-stream snapshots require
    the caller to stage input so a replayed attempt re-feeds unacked
    data -- at-least-once semantics, like any checkpoint/replay system
    without source acknowledgement).

    Returns the graph whose run completed.
    """
    import os
    attempt = 0
    history: List[BaseException] = []
    while True:
        g = graph_factory(attempt)
        if attempt > 0 and os.path.exists(checkpoint_path):
            restore_graph(g, checkpoint_path)
        try:
            g.run()
            save_graph(g, checkpoint_path)
            return g
        except NodeFailureError as e:
            # only replica-thread deaths are retried; deterministic
            # graph-construction/validation errors (plain RuntimeError
            # from merge checks etc.) re-raise immediately instead of
            # silently re-running the full source stream
            history.append(e)
            if on_failure is not None:
                on_failure(attempt, e, g)
            attempt += 1
            if attempt > max_restarts:
                e.attempt_history = history
                raise
