"""Pause-drain-migrate rescale mechanics (docs/ELASTIC.md).

The protocol that turns a frozen-parallelism graph into a rescalable
one, composed entirely from machinery earlier planes already proved:

1. **Pause + drain (the rescale barrier).**  ``PipeGraph.quiesce``
   parks every source at a generation-step boundary (the live
   checkpoint barrier, SourcePauseControl) and drains channels and
   in-flight device batches to a globally quiescent state.  Because
   the target operator's inbound channels are empty and its replicas
   are parked between items, *no tuple is in flight across the
   operator*: conservation is structural, not probabilistic.
2. **Snapshot keyed state.**  Every replica's ``keyed_state_dict()``
   (the per-key flattening ``utils/checkpoint.py`` established) is
   merged; keys must be disjoint across replicas -- the KEYBY routing
   invariant -- and a duplicate aborts the rescale loudly.
3. **Repartition + rewire.**  Keys re-hash over the new replica count
   with the exact routing contract the emitters use
   (``default_hash(key) % parallelism``, runtime/win_routing.py /
   StandardEmitter), so ownership after the rescale equals where the
   emitter will route.  Scale-up builds fresh replica threads,
   channels and downstream outlets (mirroring PipeGraph.start's
   bindings: cancel token, pause gate, dead letters, buffer pool,
   fault clocks, stats records) and extends every upstream emitter's
   destination set; CreditedChannel proxies are mirrored onto the new
   channels so ingest credit accounting stays exact.  Scale-down trims
   the upstream fan-out and closes the retiring replicas' channels so
   they unwind through their normal EOS path (their logics emit
   nothing at EOS -- enforced by the elastic validation in
   MultiPipe.add).
4. **Restore + resume.**  Each surviving/new replica loads exactly the
   keys it now owns, the sources resume, and the event is recorded in
   ``GraphStats`` (``Rescale_events`` in the stats JSON + dashboard).

Elastic replicas are a fusion barrier (graph/fuse.py skips them, like
the ingest credit boundary): the compile pass must not fold a node
whose thread set changes at runtime into a neighbour.
"""
from __future__ import annotations

import time as _time
from dataclasses import asdict, dataclass
from typing import Callable, Dict, List, Optional

from ..core.meta import default_hash
from ..ingest.credits import CreditedChannel
from ..runtime.node import NodeLogic, Outlet, RtNode
from ..runtime.queues import make_channel


class RescaleError(RuntimeError):
    """A rescale attempt failed; the graph was resumed and keeps its
    previous parallelism unless stated otherwise in the message."""


@dataclass
class RescaleEvent:
    """One completed rescale, recorded in GraphStats (stats JSON)."""

    at: float            # epoch seconds
    operator: str
    old_parallelism: int
    new_parallelism: int
    trigger: str         # controller signal string or "manual"
    duration_s: float    # pause-to-resume wall time

    def to_dict(self) -> dict:
        d = asdict(self)
        d["duration_s"] = round(d["duration_s"], 6)
        return d


class ElasticHandle:
    """Runtime registry entry for one elastic operator: everything the
    rescale mechanics need, captured at wiring time (MultiPipe).

    ``outlets`` are the upstream Outlet OBJECTS feeding the stage --
    stable across the LEVEL2 compile pass (fusion moves outlet lists by
    reference) and across ingest wiring (credit proxies are swapped
    into ``outlet.dests`` in place)."""

    def __init__(self, name: str, spec, pipe, factory: Callable,
                 replicas: List[RtNode], outlets: List[Outlet],
                 error_policy: str = "fail"):
        self.name = name          # graph-wide key, also the stats key
        self.spec = spec
        self.pipe = pipe
        self.make_logic = factory  # (replica_index, parallelism) -> logic
        self.replicas = list(replicas)
        self.outlets = list(outlets)
        self.error_policy = error_policy

    @property
    def parallelism(self) -> int:
        return len(self.replicas)


def owner_of(key, parallelism: int) -> int:
    """The replica owning ``key`` at ``parallelism`` -- the SAME
    contract as the KEYBY routing plane (StandardEmitter record path
    ``default_hash(key) % n``; its batch path ``abs(int64) % n`` agrees
    because ``default_hash`` is identity-abs on ints)."""
    return default_hash(key) % parallelism


def partition_keyed_state(merged: Dict, parallelism: int) -> List[Dict]:
    """Deterministic, total partition of a merged per-key state mapping
    over ``parallelism`` replicas: every key lands in exactly one part,
    parts are disjoint, and their union is ``merged``."""
    parts: List[Dict] = [{} for _ in range(parallelism)]
    for k, v in merged.items():
        parts[owner_of(k, parallelism)][k] = v
    return parts


def merge_keyed_states(nodes: List[RtNode]):
    """(merged, stateful): snapshot + merge every replica's keyed
    state.  A key owned by two replicas would mean the routing
    invariant was already broken -- abort rather than silently pick
    one."""
    states = []
    for node in nodes:
        getter = getattr(node.logic, "keyed_state_dict", None)
        states.append(getter() if getter is not None else None)
    stateful = any(s is not None for s in states)
    merged: Dict = {}
    if stateful:
        for node, st in zip(nodes, states):
            for k, v in (st or {}).items():
                if k in merged:
                    raise RescaleError(
                        f"key {k!r} held by two replicas of "
                        f"{node.name!r}: keyed routing invariant broken")
                merged[k] = v
    return merged, stateful


def _reset_round_robin(emitter, n: int) -> None:
    # FORWARD StandardEmitter keeps a round-robin cursor; after a
    # shrink it could point past the new destination count
    rr = getattr(emitter, "_rr", None)
    if rr is not None and n > 0:
        emitter._rr = rr % n


def _clone_emitter(emitter):
    """Emitter.clone() with the graph ColumnPool detached first: the
    pool holds locks (not deep-copyable) and must be SHARED by the
    clone, not duplicated.  Any audit hot-key sketch is detached the
    same way -- deep-copying it would duplicate the observed counts;
    the auditor attaches a fresh sketch to the clone instead."""
    pool = getattr(emitter, "pool", None)
    sketch = getattr(emitter, "key_sketch", None)
    if pool is not None:
        emitter.pool = None
    if sketch is not None:
        emitter.key_sketch = None
    try:
        clone = emitter.clone()
    finally:
        if pool is not None:
            emitter.pool = pool
        if sketch is not None:
            emitter.key_sketch = sketch
    clone.pool = pool
    return clone


def _can_load_keyed(logic: NodeLogic) -> bool:
    fn = getattr(type(logic), "load_keyed_state", None)
    return fn is not None and fn is not NodeLogic.load_keyed_state


def rescale_operator(graph, handle: ElasticHandle, new_n: int,
                     trigger: str = "manual",
                     timeout: float = 60.0) -> Optional[RescaleEvent]:
    """Rescale ``handle`` to ``new_n`` replicas; returns the recorded
    event, or None when ``new_n`` equals the current parallelism.
    Caller (PipeGraph.rescale) holds the graph's rescale lock."""
    spec = handle.spec
    new_n = int(new_n)
    if not spec.min_replicas <= new_n <= spec.max_replicas:
        raise ValueError(
            f"rescale({handle.name!r}, {new_n}) outside the declared "
            f"elastic interval [{spec.min_replicas}, "
            f"{spec.max_replicas}]")
    if new_n == len(handle.replicas):
        return None
    t0 = _time.monotonic()
    graph.quiesce(timeout)
    try:
        old_nodes = list(handle.replicas)
        old_n = len(old_nodes)
        if any(not n.is_alive() for n in old_nodes):
            # EOS (or a failure unwind) already reached the operator:
            # there is no live replica set to migrate -- refuse instead
            # of wiring new replicas whose producers will never close
            raise RescaleError(
                f"cannot rescale {handle.name!r}: stream already "
                "ended at the operator")
        merged, stateful = merge_keyed_states(old_nodes)
        if stateful and not all(_can_load_keyed(n.logic)
                                for n in old_nodes):
            # validate BEFORE any rewiring: a failure past this point
            # would leave the graph half-rewired
            raise RescaleError(
                f"{handle.name!r} snapshots keyed state but cannot "
                "load it (load_keyed_state missing)")
        kept = old_nodes[:min(old_n, new_n)]
        added: List[RtNode] = []
        closing = []  # (channel, producer_id) of retiring replicas
        if new_n > old_n:
            added = _grow(graph, handle, old_nodes, new_n)
        else:
            for outlet in handle.outlets:
                closing.extend(outlet.dests[new_n:])
                del outlet.dests[new_n:]
                if outlet.audit_cells is not None:
                    # audit plane: the trimmed destinations are the
                    # retiring replicas' (drained) channels -- their
                    # edges leave the topology with them, but a
                    # source's deliveries into them stay part of the
                    # graph-wide Sources_emitted roll-up
                    if graph.auditor is not None:
                        graph.auditor.ledger.fold_trimmed(
                            outlet, outlet.audit_cells[new_n:])
                    del outlet.audit_cells[new_n:]
                outlet.emitter.set_n_destinations(new_n)
                _reset_round_robin(outlet.emitter, new_n)
        retired = old_nodes[new_n:]
        new_replicas = kept + added
        for node in kept:
            # added replicas were built with the new parallelism; kept
            # ones still hold the old count in their RuntimeContext,
            # which a rich fn(t, ctx) may read for per-replica sharding
            ctx = getattr(node.logic, "context", None)
            if ctx is not None:
                ctx.parallelism = new_n
        if stateful:
            parts = partition_keyed_state(merged, new_n)
            for i, node in enumerate(new_replicas):
                if not _can_load_keyed(node.logic):
                    raise RescaleError(
                        f"{type(node.logic).__name__} cannot load "
                        "keyed state")
                node.logic.load_keyed_state(parts[i])
            for node in old_nodes[new_n:]:
                # the snapshot above is shallow: the survivors' loaded
                # partitions alias the retiring replicas' inner state
                # objects.  Clear the retiring copies before their EOS
                # unwind -- a keyed logic with a destructive eos_flush
                # (event-time windows/joins fire-and-pop) would
                # otherwise re-fire the migrated windows AND mutate
                # state now owned by a survivor
                if _can_load_keyed(node.logic):
                    node.logic.load_keyed_state({})
        handle.replicas = new_replicas
        graph.stats.set_parallelism(handle.name, new_n)
        for node in added:
            node.start()
        # wake the retiring replicas through their EOS path: every
        # producer slot of their (drained) channels closes, get()
        # returns None, eos_flush emits nothing (validated at wiring)
        # and flush_eos closes their downstream producer slots exactly
        # as a natural end of stream would
        for ch, pid in closing:
            ch.close(pid)
        deadline = _time.monotonic() + 10.0
        for node in retired:
            node.join(timeout=max(0.0, deadline - _time.monotonic()))
            if node.is_alive():
                raise RescaleError(
                    f"retired replica {node.name!r} failed to unwind")
            if graph.auditor is not None:
                # migration accounting: fold the retiring replica's
                # delivery books into the per-channel retired ledger --
                # its downstream channels keep cumulative put counts,
                # so dropping the cells without folding would read as
                # a permanent duplication on every scale-down
                graph.auditor.fold_retired(node)
            if getattr(graph, "tiered_state", None) is not None:
                # the retired replica's keys migrated with the merge;
                # its spill segments are dead weight on disk
                graph.tiered_state.release(node.name)
            if node in handle.pipe.nodes:
                handle.pipe.nodes.remove(node)
            if node.stats is not None:
                # the retired record stays as history, but its gauges
                # must not freeze at their last pre-rescale value: the
                # channel is drained and closed, so zero is the truth
                # (dashboard columns sum over ALL replica records)
                node.stats.queue_depth = 0
                node.stats.credit_wait_s = 0.0
    finally:
        graph.resume()
    event = RescaleEvent(_time.time(), handle.name, old_n, new_n,
                         trigger, _time.monotonic() - t0)
    graph.stats.record_rescale(event)
    return event


def _grow(graph, handle: ElasticHandle, old_nodes: List[RtNode],
          new_n: int) -> List[RtNode]:
    """Build, wire and bind replicas old_n..new_n-1 (not yet started)."""
    cfg = graph.config
    old_n = len(old_nodes)
    template = old_nodes[0]
    prefix = template.name.rsplit(".", 1)[0]
    added: List[RtNode] = []
    for i in range(old_n, new_n):
        logic = handle.make_logic(i, new_n)
        node = RtNode(f"{prefix}.{i}", logic, make_channel(cfg), [])
        node.elastic_group = handle.name
        node.error_policy = handle.error_policy
        added.append(node)
    # upstream fan-out: one new destination per outlet, mirroring any
    # credit proxy of the existing destinations (each outlet belongs to
    # one upstream replica, so its gate -- if any -- is uniform across
    # its dests)
    for outlet in handle.outlets:
        gate = None
        proxied = False
        if outlet.dests:
            ch0, pid0 = outlet.dests[0]
            if isinstance(ch0, CreditedChannel):
                proxied = True
                gate = ch0.gates.get(pid0)
        for node in added:
            ch = node.channel
            if proxied and not isinstance(ch, CreditedChannel):
                ch = CreditedChannel(ch)
                node.channel = ch
            pid = ch.register_producer()
            if proxied and gate is not None:
                ch.bind_gate(pid, gate)
            outlet.dests.append((ch, pid))
            if outlet.audit_cells is not None:
                # audit plane: a fresh delivery book per new edge
                from ..audit import EdgeCell
                outlet.audit_cells.append(EdgeCell())
        outlet.emitter.set_n_destinations(new_n)
    # downstream wiring: clone replica 0's outlet shape, registering a
    # fresh producer slot per destination channel (EOS accounting on
    # the consumer side counts slots, so mid-run registration before
    # our stage's own EOS is exact)
    for node in added:
        for o in template.outlets:
            dests = [(dch, dch.register_producer()) for dch, _pid in o.dests]
            node.outlets.append(Outlet(_clone_emitter(o.emitter), dests))
    # runtime plumbing: the same bindings PipeGraph.start applies
    fault_plan = getattr(cfg, "fault_plan", None)
    for idx, node in enumerate(added, start=old_n):
        node.pause_ctl = graph._pause_ctl
        node.cancel_token = graph._cancel
        node.dead_letters = graph.dead_letters
        node.pool = graph.buffer_pool
        # telemetry plane: rescale-created replicas trace and record
        # exactly like start()-wired ones (their stats records pick up
        # histograms via GraphStats.register's enabled flag)
        node.flight = graph.flight
        node.logic.flight = graph.flight
        if graph.telemetry is not None:
            node.telemetry = graph.telemetry
            node.logic.telemetry = graph.telemetry
        if node.pool is not None:
            for o in node.outlets:
                o.emitter.pool = node.pool
        if fault_plan is not None:
            node.faults = fault_plan.for_node(node.name)
            node.bind_outlet_faults()
        if getattr(graph, "tiered_state", None) is not None:
            # tiered keyed state (state/): the grown replica's store
            # must exist BEFORE the auditor binds its hot-key sketch
            # and before load_keyed_state repartitions into it
            graph.tiered_state.enable(node.logic, node.name)
        if graph.auditor is not None:
            # audit plane: delivery books + put faults + sketches on
            # the new replica's own outlets, exactly as at start()
            graph.auditor.attach_node(node)
        if graph.durability is not None:
            # durability plane: the aligner must exist BEFORE the
            # replica thread starts, exactly as the auditor's books
            graph.durability.attach_node(node)
        node.stats = graph.stats.register(handle.name, str(idx))
        graph._cancel.register(node.channel)
    handle.pipe.nodes.extend(added)
    return added
