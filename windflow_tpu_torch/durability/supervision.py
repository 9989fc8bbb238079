"""Supervised replica self-healing (docs/RESILIENCE.md "Supervised
replica restart").

Opt-in per operator (``.with_restartable()``) + per graph
(``RuntimeConfig.supervision = SupervisionConfig(...)``), and only on
top of the durability plane: a replica crash inside a supervised
operator no longer fails the graph.  Instead the dying thread hands
itself to the :class:`ReplicaSupervisor`, which -- after a jittered
exponential backoff -- quiesces the pipeline in place, rebuilds just
that replica from the operator's fresh-replica factory, rewinds EVERY
logic to the last committed epoch's manifest (sources included, so the
stream replays from the exact cut) and discards uncommitted sink
effects (``epoch_rewind``), then resumes.  Exactly-once holds across
the heal: everything after the committed epoch is regenerated by the
replay, and everything it had already produced was discarded with the
aborted epochs.

Every attempt is a ``replica_restart`` flight event the doctor
explains; when the group's ``max_restarts`` budget exhausts the next
crash falls through to the ordinary fail-fast path
(``NodeFailureError`` out of ``wait_end``), and a failure *inside* the
heal escalates the same way.

The rebuild deliberately does NOT re-bind FaultPlan state to the fresh
replica: injected crash clocks are per-replica-lifetime counters, and
re-arming them would re-fire the very crash being healed on every
attempt (the real-world analogue -- a deterministic poison pill -- is
what the retry budget is for).
"""
from __future__ import annotations

import pickle
import random
import threading
import time as _time
from collections import deque
from typing import Dict, List, Optional


class SupervisedGroup:
    """Registry entry for one restartable operator, captured at wiring
    (MultiPipe._register_restartable): the owning pipe, the
    fresh-replica factory and the live replica nodes -- the supervisor
    swaps healed replicas into ``replicas`` in place."""

    __slots__ = ("key", "pipe", "make_logic", "replicas", "restarts")

    def __init__(self, key: str, pipe, make_logic, replicas: List):
        self.key = key
        self.pipe = pipe
        self.make_logic = make_logic  # (replica_index, parallelism) -> logic
        self.replicas = list(replicas)
        self.restarts = 0             # lifetime heals, capped by the budget


class ReplicaSupervisor(threading.Thread):
    """The per-graph healing thread.  Crashing replicas call
    ``report_failure`` from their own thread (runtime/node.py); the
    supervisor serializes heals through one queue so two concurrent
    crashes never race the rewire."""

    def __init__(self, graph):
        super().__init__(name=f"windflow-supervisor-{graph.name}",
                         daemon=True)
        self.graph = graph
        self.cfg = graph.config.supervision
        self._rng = random.Random(self.cfg.seed)
        self._q: deque = deque()
        self._cond = threading.Condition()
        self._stopping = False
        self.heals = 0
        # pre-first-commit fallback: the state of every logic BEFORE
        # any replica thread ran (on a restored run this is the
        # restored state -- run_with_epochs loads manifests before
        # start()).  Normalized to the same pickled-bytes form as
        # resolve_manifest_states so the rewind path is uniform.
        from .barrier import capture_states
        coord = graph.durability
        self._initial_states: Dict[str, bytes] = {}
        for n in graph._all_nodes():
            self._initial_states.update(coord.resolve_manifest_states(
                {"states": capture_states(n)}))

    # -- crash intake (the dying replica's thread) ---------------------
    def accepts(self, node, exc) -> bool:
        """Whether this crash is healable: an ``Exception`` (shutdown
        signals and graph cancellation are not tuple failures) in a
        registered supervised replica, with budget left, on a graph
        that is still running."""
        if self._stopping or self.graph._ended \
                or self.graph._cancel.cancelled:
            return False
        if not isinstance(exc, Exception):
            return False
        key = getattr(node, "supervised_group", None)
        grp = self.graph.supervised.get(key) if key is not None else None
        if grp is None or node not in grp.replicas:
            return False
        return grp.restarts < self.cfg.max_restarts

    def report_failure(self, node, exc) -> bool:
        """Called by RtNode.run on its own (dying) thread.  True =
        accepted: the replica must exit WITHOUT error, cancel or EOS
        teardown (its outlets' producer slots live on in the rebuilt
        node).  False = fail fast exactly as an unsupervised crash."""
        if not self.accepts(node, exc):
            return False
        with self._cond:
            if self._stopping:
                return False
            self._q.append((node, exc))
            self._cond.notify_all()
        return True

    # -- healing loop --------------------------------------------------
    def run(self) -> None:
        while True:
            with self._cond:
                while not self._q and not self._stopping:
                    self._cond.wait(0.25)
                if self._stopping and not self._q:
                    return
                node, exc = self._q.popleft()
            g = self.graph
            if g._ended or g._cancel.cancelled:
                return
            try:
                self._heal(node, exc)
            except BaseException as e:
                from ..resilience.errors import NodeFailureError
                g.flight.record(
                    "replica_restart", node=node.name,
                    group=getattr(node, "supervised_group", None),
                    outcome="escalated", error=repr(e))
                g._cancel.cancel(
                    NodeFailureError(
                        f"supervised restart of {node.name!r} failed: "
                        f"{e!r} (original crash: {exc!r})"),
                    origin=node.name)
                return

    def stop(self) -> None:
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self.is_alive():
            self.join(timeout=10.0)

    # -- one heal ------------------------------------------------------
    def _heal(self, dead, exc) -> None:
        g = self.graph
        coord = g.durability
        grp = g.supervised[dead.supervised_group]
        attempt = grp.restarts
        grp.restarts += 1
        delay = min(self.cfg.backoff_cap_s,
                    self.cfg.backoff_base_s * (2 ** attempt))
        delay *= 1.0 + self.cfg.jitter * self._rng.random()
        g.flight.record("replica_restart", node=dead.name,
                        group=grp.key, attempt=attempt + 1,
                        budget=self.cfg.max_restarts,
                        delay_s=round(delay, 4),
                        epoch=coord.committed, error=repr(exc))
        _time.sleep(delay)
        # a crash after part of the graph already finished cannot be
        # healed in place: finished replicas' threads are gone, so the
        # post-rewind replay would hit closed stages and strand
        if coord._finished:
            raise RuntimeError(
                "replica crashed after part of the graph finished "
                f"({sorted(coord._finished)}); the rewound replay "
                "would strand at the closed stages")
        dead.join(timeout=10.0)
        if dead.is_alive():
            raise RuntimeError(
                f"crashed replica {dead.name!r} failed to unwind")
        deadline = _time.monotonic() + 60.0
        with g._rescale_lock:
            # drop every in-flight epoch WITHOUT draining (the dead
            # replica's barriers will never arrive) and hold the
            # cadence across the rewire
            coord.abort_epochs(reason="replica_crash")
            try:
                self._pause_sources(dead, deadline)
                self._settle(dead, deadline)
                # abandon open alignments: held-back post-barrier
                # input is regenerated by the rewind below
                for n in g._all_nodes():
                    if n.epochs is not None:
                        n.epochs.reset()
                # injectors must not cut for the aborted epochs after
                # the resume
                self._reset_injectors(coord)
                self._drain_channel(dead, deadline)
                new = self._rebuild(grp, dead)
                self._rewind_state(coord)
                self._rewind_sinks(coord)
                new.start()
                self.heals += 1
            finally:
                g._pause_ctl.resume()
                coord.release_epochs()

    def _drain_some(self, dead, budget: int = 64) -> None:
        """Discard up to ``budget`` queued items of the dead replica's
        channel (its gets counter keeps the audit books balanced; the
        items are regenerated by the rewind).  Keeps upstream producers
        from blocking forever on a full channel nobody consumes."""
        from ..runtime.queues import CHANNEL_TIMEOUT
        ch = dead.channel
        if ch is None:
            return
        for _ in range(budget):
            got = ch.get(timeout=0.002)
            if got is CHANNEL_TIMEOUT or got is None:
                return

    def _pause_sources(self, dead, deadline: float) -> None:
        """Park every source at a generation-step boundary (the
        quiesce() handshake), draining the dead channel meanwhile -- a
        source blocked on a put into it could never reach the pause
        gate."""
        g = self.graph
        g._pause_ctl.request_pause()
        while True:
            alive = [n for n in g._source_nodes() if n.is_alive()]
            with g._pause_ctl._cond:
                acked = g._pause_ctl.paused_count
            if acked >= len(alive):
                return
            if _time.monotonic() > deadline:
                raise RuntimeError("supervised restart: sources failed "
                                   "to pause (timeout)")
            self._drain_some(dead)
            _time.sleep(0.002)

    def _settle(self, dead, deadline: float) -> None:
        """Wait until the surviving pipeline is between items: live
        consumers idle, channels empty, stable across polls.  Aligner
        holdback buffers are deliberately IGNORED (reset() drops them
        next); device lanes drain through their quiesce hooks like the
        live-checkpoint barrier."""
        g = self.graph
        while True:
            consumers = [n for n in g._all_nodes()
                         if n.channel is not None and n is not dead]
            stable = 0
            last_done = -1
            while stable < 5:
                if _time.monotonic() > deadline:
                    raise RuntimeError("supervised restart: pipeline "
                                       "failed to settle (timeout)")
                self._drain_some(dead)
                total_done = sum(n.done for n in consumers)
                idle = all(n.taken == n.done for n in consumers
                           if n.is_alive())
                empty = all(n.channel.qsize() == 0 for n in consumers
                            if n.is_alive())
                if idle and empty and total_done == last_done:
                    stable += 1
                else:
                    stable = 0
                last_done = total_done
                _time.sleep(0.002)
            emitted = False
            for n in g._all_nodes():
                q = getattr(n.logic, "quiesce", None)
                if q is not None and n is not dead and n.is_alive():
                    emitted = bool(q(n._emit)) or emitted
            if not emitted:
                return

    def _reset_injectors(self, coord) -> None:
        from ..runtime.node import source_loop_of
        for n in self.graph._source_nodes():
            src = source_loop_of(n.logic)
            inj = getattr(src, "epoch_injector", None) if src else None
            if inj is not None:
                inj.last = coord.epoch_seq

    def _drain_channel(self, dead, deadline: float) -> None:
        from ..runtime.queues import CHANNEL_TIMEOUT
        ch = dead.channel
        while True:
            if _time.monotonic() > deadline:
                raise RuntimeError("supervised restart: dead replica's "
                                   "channel failed to drain")
            got = ch.get(timeout=0.005)
            if got is CHANNEL_TIMEOUT or got is None:
                return

    def _rebuild(self, grp: SupervisedGroup, dead):
        """A fresh replica in the dead one's exact place: same name,
        same channel, same outlet objects (their producer slots were
        never closed -- the supervised exit skips flush_eos), fresh
        logic from the factory.  Mirrors the elastic ``_grow`` binding
        recipe minus what the reuse makes unnecessary: the channel is
        already registered with the CancelToken and carries its audit
        books, the outlets keep their EdgeCells and emitters, and the
        stats record continues under the same replica identity."""
        from ..runtime.node import RtNode
        g = self.graph
        coord = g.durability
        idx = grp.replicas.index(dead)
        logic = grp.make_logic(idx, len(grp.replicas))
        new = RtNode(dead.name, logic, dead.channel, dead.outlets)
        new.group = dead.group
        new.is_collector = dead.is_collector
        new.worker_pin = dead.worker_pin
        new.elastic_group = dead.elastic_group
        new.error_policy = dead.error_policy
        new.trace_sample = dead.trace_sample
        new.supervised_group = dead.supervised_group
        new.supervisor = self
        new.pause_ctl = g._pause_ctl
        new.cancel_token = g._cancel
        new.dead_letters = g.dead_letters
        new.pool = g.buffer_pool
        new.flight = g.flight
        logic.flight = g.flight
        if g.telemetry is not None:
            new.telemetry = g.telemetry
            logic.telemetry = g.telemetry
        if new.pool is not None:
            for o in new.outlets:
                o.emitter.pool = new.pool
        if getattr(g, "tiered_state", None) is not None:
            # tiered keyed state (state/): the healed replica gets a
            # fresh store -- and a FRESH spill directory, which is how
            # a torn spill segment heals (the damaged working set is
            # wiped; the rewind below reloads from the last committed
            # epoch).  Re-bind the audit sketch the dead replica held.
            g.tiered_state.enable(logic, new.name)
            if g.auditor is not None:
                g.auditor._bind_hot_keys(new)
        new.stats = dead.stats
        # fresh aligner (the old one died mid-alignment); the finished
        # set is structural -- upstream final barriers already counted
        coord.attach_node(new)
        if dead.epochs is not None:
            new.epochs.finished = set(dead.epochs.finished)
        # swap into every live registry that holds the dead node
        pipe = grp.pipe
        for i, n in enumerate(pipe.nodes):
            if n is dead:
                pipe.nodes[i] = new
        grp.replicas[idx] = new
        if dead.elastic_group is not None:
            handle = g.elastic.get(dead.elastic_group)
            if handle is not None:
                for i, n in enumerate(handle.replicas):
                    if n is dead:
                        handle.replicas[i] = new
        return new

    def _rewind_state(self, coord) -> None:
        """Load EVERY logic (sources included) from the last committed
        epoch's manifest -- or the pre-start capture when nothing
        committed yet -- so the whole graph rewinds to one consistent
        cut and the replay regenerates exactly the discarded tail."""
        from .barrier import iter_named_logics
        from .delta import load_into
        m = coord.last_manifest
        states = (coord.resolve_manifest_states(m) if m is not None
                  else self._initial_states)
        logics = {}
        for n in self.graph._all_nodes():
            for name, lg in iter_named_logics(n):
                logics[name] = lg
        for name, blob in states.items():
            lg = logics.get(name)
            if lg is not None:
                load_into(lg, pickle.loads(blob))

    def _rewind_sinks(self, coord) -> None:
        """Discard uncommitted sink effects (sealed buffers above the
        committed epoch, epoch-tagged rows above it): the replay is
        about to regenerate them."""
        from .barrier import iter_named_logics
        for n in self.graph._all_nodes():
            for _name, lg in iter_named_logics(n):
                rw = getattr(lg, "epoch_rewind", None)
                if rw is not None:
                    rw(coord.committed)
