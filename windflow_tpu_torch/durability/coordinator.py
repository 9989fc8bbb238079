"""EpochCoordinator: the durability-plane thread (docs/RESILIENCE.md
"Exactly-once epochs").

One per started PipeGraph when ``RuntimeConfig.durability`` is set.
Every ``epoch_interval_s`` it announces a new epoch (a monotone
``epoch_seq`` the source injectors poll at their step boundaries);
barriers then ride the graph on the replicas' own threads
(durability/barrier.py) while this thread only *collects*: per-replica
state blobs as cuts complete, per-source offsets at injection, sink
acks at terminal alignment.  When every live sink has acked epoch
``e`` the coordinator commits: the manifest is written atomically
(durability/store.py), ``checkpoint_epoch``/``epoch_commit`` flight
events fire with the epoch id, transactional sink buffers release, and
the ``Durability`` stats block (-> ``/metrics``
``windflow_epoch{,_lag_seconds,_commit_seconds}``) updates.

Rescale interaction: barriers and rescales serialize **per epoch** --
``hold_epochs`` stops announcing and waits for in-flight epochs to
commit (the graph keeps flowing meanwhile), the rescale runs, then
``rewire`` refreshes aligner producer counts for the new channel set
and ``release_epochs`` resumes the cadence.  No global lock couples a
barrier in flight to a rescale in flight.
"""
from __future__ import annotations

import threading
import time as _time
from typing import Dict, List, Optional, Tuple

from .store import EpochStore


class _PendingEpoch:
    __slots__ = ("states", "offsets", "acks", "injected", "t0",
                 "stall_reported")

    def __init__(self, now: float):
        self.states: Dict[str, bytes] = {}
        self.offsets: Dict[str, float] = {}
        self.acks: set = set()
        self.injected: set = set()
        self.t0 = now
        self.stall_reported = False


class EpochCoordinator(threading.Thread):
    def __init__(self, graph):
        super().__init__(name=f"windflow-epochs-{graph.name}", daemon=True)
        self.graph = graph
        dcfg = graph.config.durability
        self.interval_s = max(0.005, float(dcfg.epoch_interval_s))
        self.stall_s = max(self.interval_s * float(dcfg.stall_factor), 0.5)
        self.store = EpochStore(dcfg.path, dcfg.retained)
        # FaultPlan.fail_write("manifest"/"blob") injection point
        self.store.fault_plan = getattr(graph.config, "fault_plan", None)
        # incremental snapshots (durability/delta.py): keyed replicas
        # capture per-key and this thread's encoders turn each capture
        # into content-addressed blob chains, O(changed keys) per commit
        self.delta = bool(getattr(dcfg, "delta", False))
        self._chain_max = int(getattr(dcfg, "delta_chain_max", 8))
        self._encoders: Dict[str, object] = {}
        self.delta_bytes = 0      # blob+manifest bytes of last commit
        # monotone announce counter, read lock-free by source injectors.
        # Epoch ids continue ACROSS restarts (run_with_epochs stamps the
        # restored epoch on the graph before start): if numbering reset
        # per attempt, a second failure could find a stale higher-
        # numbered manifest from the first run and rewind past effects
        # the second run already released -- duplicates
        restored = getattr(graph, "_epoch_restored", None)
        self.epoch_seq = int(restored or 0)
        self.committed = int(restored or 0)
        self.commits = 0
        self.aborts = 0
        self.last_commit_s = 0.0
        self._last_commit_t: Optional[float] = None
        self.stalled = False
        self.restored_from: Optional[int] = (int(restored)
                                             if restored else None)
        self._pending: Dict[int, _PendingEpoch] = {}
        # end-of-stream bookkeeping: nodes past their final barrier and
        # their final states (valid for every later epoch -- a finished
        # replica processed its whole input)
        self._finished: set = set()
        self._final_states: Dict[str, bytes] = {}
        self._sources: List[str] = []
        self._sinks: set = set()
        self._txn_sinks: List = []
        # distributed plane (distributed/; docs/DISTRIBUTED.md): wire
        # edges act as pseudo-sinks (a barrier leaving the worker) and
        # pseudo-sources (a barrier arriving off the wire).  A worker
        # with no local sources is a FOLLOWER: it never announces
        # epochs itself -- epoch ids are global, owned by the source
        # worker's coordinator, and observed here via remote_epoch.
        self._wire_sinks: set = set()
        self._wire_sources: List[str] = []
        self.follower = False
        self._gap = 0                 # >0: epoch announcing held (rescale)
        # epoch currently inside _commit (popped from _pending but not
        # yet durable): checkpoint_now/hold_epochs must not mistake the
        # manifest-write window for "dropped"/"drained"
        self._committing: Optional[int] = None
        self._cond = threading.Condition()
        self._stopping = False
        self.last_manifest: Optional[dict] = None

    # -- wiring (PipeGraph.start / after a rescale) --------------------
    def attach(self) -> None:
        """First wiring pass; additionally enforces that every source
        is barrier-capable (driven by a SourceLoopLogic step loop) and
        uniquely named (offset/state capture is keyed by replica name,
        and parallel source replicas share one -- a silent collision
        would restore only one replica's offset and break
        exactly-once)."""
        import warnings
        from .barrier import iter_named_logics
        from ..runtime.node import source_loop_of
        from ..utils.checkpoint import _is_stateful
        src_names = []
        for n in self.graph._all_nodes():
            if n.channel is not None:
                continue
            src_names.append(n.name)
            if source_loop_of(n.logic) is None:
                raise RuntimeError(
                    f"durability: source node {n.name!r} is not driven "
                    "by a SourceLoopLogic generation loop, so epoch "
                    "barriers cannot be injected at it "
                    "(docs/RESILIENCE.md)")
            if not any(_is_stateful(lg)
                       for _name, lg in iter_named_logics(n)):
                # epochs still commit (and measure) fine, but a restart
                # cannot rewind this source: it would replay from the
                # beginning against state restored at the epoch --
                # duplicates.  DurabilityConfig(strict=True) makes this
                # fatal (exactly-once must not silently degrade);
                # otherwise loud, not fatal: overhead benches and
                # commit-only runs legitimately use stateless sources.
                msg = (f"durability: source {n.name!r} has no "
                       "state_dict (offset not checkpointable) -- "
                       "restarts will replay it from the start, "
                       "degrading exactly-once to at-least-once "
                       "(docs/RESILIENCE.md)")
                if getattr(self.graph.config.durability, "strict",
                           False):
                    raise RuntimeError(
                        msg + "; DurabilityConfig(strict=True) forbids "
                        "this -- give the source a checkpointable "
                        "offset or drop strict")
                warnings.warn(msg, RuntimeWarning, stacklevel=3)
        dups = sorted({x for x in src_names if src_names.count(x) > 1})
        if dups:
            raise RuntimeError(
                f"durability: source replicas share node names {dups} "
                "(source parallelism > 1): epoch offsets/states are "
                "keyed by replica name, so the manifest would keep "
                "only one replica's position.  Use parallelism-1 "
                "sources (or uniquely named ones) under the durability "
                "plane (docs/RESILIENCE.md)")
        self.rewire()
        if self.committed:
            # restored run: epoch-aware sinks resume their numbering
            # from the restored epoch (idempotent effects before the
            # first new barrier belong to epoch committed+1)
            for n in self.graph._all_nodes():
                for _name, logic in iter_named_logics(n):
                    resume = getattr(logic, "epoch_resume", None)
                    if resume is not None:
                        resume(self.committed)

    def attach_node(self, node) -> None:
        """Aligner wiring for one rescale-created replica, BEFORE its
        thread starts (elastic/rescale.py ``_grow`` -- the consume
        loop resolves the durable dispatch path once); ``rewire()``
        refreshes the rest of the plane after the rescale completes.
        The audit plane's ``GraphAuditor.attach_node`` is the
        precedent."""
        from .barrier import EpochAligner
        from ..audit.ledger import unwrap
        node.epoch_coord = self
        node.epochs = EpochAligner(
            node, self, getattr(unwrap(node.channel), "n_producers", 1))

    def rewire(self) -> None:
        """(Re)attach aligners/injectors to the live node set.  Called
        at start and after every rescale (under an epoch gap, so no
        alignment is in flight): existing aligners keep their
        ``finished`` sets -- retired producers announced themselves
        with final barriers -- and only refresh their producer counts;
        new replicas get fresh aligners."""
        from .barrier import EpochAligner, EpochInjector, iter_named_logics
        from ..audit.ledger import unwrap
        from ..runtime.node import source_loop_of
        g = self.graph
        sinks, sources, txn = set(), [], []
        wire_out = set(getattr(g, "_wire_out_edges", ()))
        wire_in = list(getattr(g, "_wire_in_edges", ()))
        with self._cond:
            for n in g._all_nodes():
                n.epoch_coord = self
                if not n.outlets:
                    sinks.add(n.name)
                if n.channel is not None:
                    n_prod = getattr(unwrap(n.channel), "n_producers", 1)
                    if n.epochs is None:
                        n.epochs = EpochAligner(n, self, n_prod)
                    else:
                        n.epochs.n_producers = max(1, int(n_prod))
                else:
                    src = source_loop_of(n.logic)
                    if src is not None:
                        if getattr(src, "epoch_injector", None) is None:
                            src.epoch_injector = EpochInjector(n, self)
                        sources.append(n.name)
                for name, logic in iter_named_logics(n):
                    if hasattr(logic, "commit_epoch"):
                        txn.append(logic)
                        # per-sink EOS defers release to the final
                        # commit below (transaction.py); release-time
                        # sink-fn errors quarantine per effect
                        logic._coordinated = True
                        logic._dead_letters = g.dead_letters
                        logic._name = name
            self._wire_sinks = wire_out
            self._wire_sources = wire_in
            self.follower = not sources and bool(wire_in)
            self._sinks = sinks | wire_out
            self._sources = sources + wire_in
            self._txn_sinks = txn
        # the transport acks/finishes through the coordinator: bind it
        dist = getattr(g, "_dist", None)
        if dist is not None:
            for s in dist.senders.values():
                s.epoch_coord = self

    # -- collection (replica threads) ----------------------------------
    def add_snapshot(self, epoch: int, states: Dict[str, bytes]) -> None:
        with self._cond:
            p = self._pending.get(epoch)
            if p is not None:
                p.states.update(states)

    def source_offset(self, epoch: int, name: str, frontier) -> None:
        with self._cond:
            p = self._pending.get(epoch)
            if p is not None:
                p.offsets[name] = frontier
                p.injected.add(name)

    def sink_ack(self, epoch: int, name: str) -> None:
        with self._cond:
            p = self._pending.get(epoch)
            if p is not None:
                p.acks.add(name)
                self._cond.notify_all()

    def node_finished(self, name: str, states: Dict[str, bytes]) -> None:
        """EOS hook (RtNode.run): the node's final state backfills any
        epoch it will never cut for."""
        with self._cond:
            self._finished.add(name)
            for k, v in states.items():
                self._final_states[k] = v
            self._cond.notify_all()

    def remote_epoch(self, epoch: int, name: str, frontier=None) -> None:
        """A barrier for ``epoch`` arrived off the wire (distributed
        plane, receiver thread, BEFORE the barrier enters the consumer
        channel).  Epoch ids are global -- announced by the source
        worker's coordinator -- so a follower catches its ``epoch_seq``
        up here, creating the pending entries the local cuts will fill;
        a worker that also has local sources (the leader hearing its
        own epochs echoed through a cycle) just records the injection."""
        if epoch < 1:
            return
        first = False
        with self._cond:
            if epoch > self.epoch_seq:
                for e in range(self.epoch_seq + 1, epoch + 1):
                    if e > self.committed and e not in self._pending:
                        self._pending[e] = _PendingEpoch(_time.monotonic())
                        first = True
                self.epoch_seq = epoch
            p = self._pending.get(epoch)
            if p is not None:
                p.injected.add(name)
                if frontier is not None:
                    p.offsets[name] = frontier
            self._cond.notify_all()
        if first:
            self.graph.flight.record("epoch_observe", epoch=epoch,
                                     edge=name)

    # -- epoch cadence -------------------------------------------------
    def begin_epoch(self) -> int:
        g = self.graph
        with self._cond:
            self.epoch_seq += 1
            e = self.epoch_seq
            self._pending[e] = _PendingEpoch(_time.monotonic())
        g.flight.record("epoch_begin", epoch=e)
        return e

    def run(self) -> None:
        next_tick = _time.monotonic() + self.interval_s
        while True:
            with self._cond:
                self._cond.wait(timeout=max(
                    0.005, min(next_tick - _time.monotonic(), 0.25)))
                if self._stopping:
                    return
            g = self.graph
            if g._ended or g._cancel.cancelled:
                return
            now = _time.monotonic()
            if now >= next_tick:
                with self._cond:
                    clear = self._gap == 0 and not self._stopping
                pausing = (g._pause_ctl is not None
                           and g._pause_ctl.pausing)
                # a distributed follower never announces: its epochs
                # arrive off the wire with the leader's global ids
                if clear and not pausing and not self.follower:
                    try:
                        self.begin_epoch()
                    except Exception:  # pragma: no cover - never die
                        import traceback
                        traceback.print_exc()
                next_tick = now + self.interval_s
            try:
                self.drive()
            except Exception:  # pragma: no cover - keep the cadence
                import traceback
                traceback.print_exc()

    def drive(self) -> None:
        """Commit every ready pending epoch (oldest first), drop
        unreachable ones, refresh the stall gauge, publish."""
        while True:
            action = None
            with self._cond:
                if self._pending:
                    e = min(self._pending)
                    p = self._pending[e]
                    live_sinks = self._sinks - self._finished
                    live_sources = [s for s in self._sources
                                    if s not in self._finished]
                    if not live_sinks:
                        # stream ended past this epoch: the sinks'
                        # eos_flush released everything, nothing to
                        # commit (clean end is the implicit final
                        # commit)
                        del self._pending[e]
                        self._cond.notify_all()
                        continue
                    if p.acks >= live_sinks:
                        states = dict(self._final_states)
                        states.update(p.states)
                        action = ("commit", e, states, dict(p.offsets))
                        del self._pending[e]
                        self._committing = e
                    elif not live_sources and not p.injected:
                        # announced after every source finished: no
                        # barrier ever materialized
                        del self._pending[e]
                        self._cond.notify_all()
                        continue
            if action is None:
                break
            try:
                self._commit(action[1], action[2], action[3])
            finally:
                with self._cond:
                    self._committing = None
                    self._cond.notify_all()
        self._check_stall()
        self.publish()

    def _encode_states(self, states: Dict[str, object]):
        """Turn a collected state map into its manifest form: inline
        bytes pass through; ``KeyedCapture`` objects run through the
        per-replica delta encoders (durability/delta.py) and become
        ``{"keyed_chain": [...]}`` entries, with the epoch's fresh
        blobs staged in the returned ``blob_writes``."""
        from .delta import DeltaEncoder, KeyedCapture
        blob_writes: Dict[str, bytes] = {}
        enc: Dict[str, object] = {}
        for name, v in states.items():
            if isinstance(v, KeyedCapture):
                encoder = self._encoders.get(name)
                if encoder is None:
                    encoder = self._encoders[name] = DeltaEncoder(
                        self._chain_max)
                enc[name] = {"keyed_chain": encoder.encode(
                    v, blob_writes)}
            else:
                enc[name] = v
        return enc, blob_writes

    def _commit(self, epoch: int, states: Dict[str, bytes],
                offsets: Dict[str, float]) -> None:
        g = self.graph
        t0 = _time.perf_counter()
        states, blob_writes = self._encode_states(states)
        plan = getattr(g.config, "fault_plan", None)
        if plan is not None and epoch in getattr(plan, "torn_commit_epochs",
                                                 ()):
            # injected torn commit: a truncated manifest lands at the
            # FINAL path (simulating a non-atomic writer dying
            # mid-commit) and the "process" dies -- the next restart's
            # tolerant reader must fall back to the previous epoch
            path = self.store.write_torn(epoch, states, offsets)
            self.aborts += 1
            g.flight.record("epoch_abort", epoch=epoch,
                            reason="torn_commit", path=path)
            from ..resilience.errors import NodeFailureError
            g._cancel.cancel(
                NodeFailureError(
                    f"injected torn manifest commit at epoch {epoch}"),
                origin="epoch-coordinator")
            return
        try:
            path, nbytes = self.store.commit(
                epoch, states, offsets,
                meta={"graph": g.name, "committed_at": _time.time()},
                blob_writes=blob_writes)
        except OSError as e:
            # disk full (or any filesystem refusal) mid-commit: degrade,
            # do not die.  The last committed epoch stays the recovery
            # point, transactional sinks keep buffering until a later
            # commit succeeds, and the delta encoders reset so the next
            # epoch writes a fresh base chain -- their shadows may
            # reference blobs this commit never made durable.
            self.aborts += 1
            self._encoders.clear()
            g.flight.record("epoch_abort", epoch=epoch,
                            reason="disk_full", error=str(e),
                            committed=self.committed)
            return
        self.delta_bytes = nbytes
        g.flight.record("checkpoint_epoch", epoch=epoch, path=path,
                        replicas=len(states), bytes=nbytes)
        released = 0
        for logic in self._txn_sinks:
            try:
                released += logic.commit_epoch(epoch)
            except Exception:  # pragma: no cover - sink fn failure
                import traceback
                traceback.print_exc()
        self.last_commit_s = _time.perf_counter() - t0
        self._last_commit_t = _time.monotonic()
        self.last_manifest = {"epoch": epoch, "states": states,
                              "offsets": offsets}
        # publication order is load-bearing: checkpoint_now polls
        # `committed` and then reads `last_manifest`, so the manifest
        # must be visible first
        self.committed = epoch
        self.commits += 1
        self.stalled = False
        # sink progress rides the commit event so the non-stop property
        # is auditable offline: gets strictly increasing across commits
        # proves the graph kept flowing through every epoch
        sink_gets = 0
        for n in g._all_nodes():
            if not n.outlets and n.channel is not None:
                sink_gets += getattr(n.channel, "gets", 0)
        g.flight.record("epoch_commit", epoch=epoch,
                        commit_s=round(self.last_commit_s, 6),
                        effects=released, sink_gets=sink_gets,
                        offsets=offsets)

    def _check_stall(self) -> None:
        now = _time.monotonic()
        with self._cond:
            oldest = min(self._pending) if self._pending else None
            p = self._pending.get(oldest) if oldest is not None else None
        if p is None:
            self.stalled = False
            return
        if now - p.t0 > self.stall_s:
            self.stalled = True
            if not p.stall_reported:
                p.stall_reported = True
                self.graph.flight.record(
                    "epoch_stall", epoch=oldest,
                    age_s=round(now - p.t0, 3),
                    acks=sorted(p.acks), committed=self.committed)

    # -- rescale serialization (PipeGraph.rescale / quiesce) -----------
    def hold_epochs(self, timeout: float = 30.0) -> None:
        """Stop announcing epochs and wait until none is in flight.
        Refcounted (a rescale's inner quiesce nests).  The graph keeps
        processing while we wait -- in-flight barriers drain to the
        sinks and commit normally."""
        deadline = _time.monotonic() + timeout
        with self._cond:
            self._gap += 1
            while self._pending or self._committing is not None:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    self._gap -= 1
                    raise RuntimeError(
                        "durability: in-flight epochs "
                        f"{sorted(self._pending)} failed to drain "
                        f"within {timeout}s (committed={self.committed})")
                self._cond.wait(min(remaining, 0.05))

    def release_epochs(self) -> None:
        with self._cond:
            self._gap = max(0, self._gap - 1)
            self._cond.notify_all()

    # -- supervised replica restart (durability/supervision.py) --------
    def abort_epochs(self, reason: str, timeout: float = 30.0) -> None:
        """Drop every in-flight epoch WITHOUT waiting for it to drain
        -- the supervisor's counterpart to ``hold_epochs``, for when a
        replica died mid-alignment and its barriers will never arrive
        (waiting would deadlock).  Only an in-progress manifest write
        is waited out (it is about to become the committed rewind
        point).  Announcing stays held until ``release_epochs``;
        stale barriers/acks for the dropped epochs no-op against the
        missing pending entries."""
        deadline = _time.monotonic() + timeout
        with self._cond:
            self._gap += 1
            while self._committing is not None:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    break  # commit is durable-or-not; do not deadlock
                self._cond.wait(min(remaining, 0.05))
            pending = sorted(self._pending)
            self._pending.clear()
            self._cond.notify_all()
        for e in pending:
            self.aborts += 1
            self.graph.flight.record("epoch_abort", epoch=e,
                                     reason=reason,
                                     committed=self.committed)

    def resolve_manifest_states(self, m: Optional[dict]
                                ) -> Dict[str, bytes]:
        """The ``states`` of a manifest-shaped dict as inline pickled
        bytes, whatever their stored form: inline bytes pass through,
        blob chains resolve from the store, raw ``KeyedCapture``
        objects (final states never committed yet) pack directly."""
        from .delta import KeyedCapture, pack_keyed
        out: Dict[str, bytes] = {}
        for name, v in ((m or {}).get("states", {}) or {}).items():
            if isinstance(v, KeyedCapture):
                out[name] = pack_keyed(v.entries)
            elif isinstance(v, dict) and "keyed_chain" in v:
                out[name] = self.store.resolve_states({name: v})[name]
            else:
                out[name] = v
        return out

    # -- on-demand epoch (PipeGraph.live_checkpoint) -------------------
    def checkpoint_now(self, timeout: float = 60.0
                       ) -> Tuple[int, Dict[str, bytes]]:
        """Force one epoch and wait for its commit -- the non-stop
        replacement for the quiesce-based live checkpoint.  Returns
        (epoch, pickled-state map).  Falls back to the final states
        when the stream ended before the barrier could materialize."""
        deadline = _time.monotonic() + timeout
        with self._cond:
            # serialize with rescales exactly like the cadence: a
            # forced barrier riding a half-rewired topology would
            # align against stale producer counts
            while self._gap > 0:
                if _time.monotonic() > deadline:
                    raise RuntimeError(
                        "durability: a rescale held the epoch plane "
                        f"for the whole {timeout}s checkpoint window")
                self._cond.wait(0.05)
            self.epoch_seq += 1
            target = self.epoch_seq
            self._pending[target] = _PendingEpoch(_time.monotonic())
            self._cond.notify_all()
        self.graph.flight.record("epoch_begin", epoch=target, forced=True)
        while True:
            with self._cond:
                if self.committed >= target:
                    return self.committed, self.resolve_manifest_states(
                        self.last_manifest)
                if target not in self._pending \
                        and target != self._committing:
                    # dropped (not mid-commit: drive() pops the pending
                    # entry BEFORE the manifest write, and mistaking
                    # that window for a drop would return empty state):
                    # the stream ended under the barrier -- the final
                    # states are the (complete) snapshot
                    return self.committed, self.resolve_manifest_states(
                        {"states": self._final_states})
                if _time.monotonic() > deadline:
                    raise RuntimeError(
                        f"durability: forced epoch {target} did not "
                        f"commit within {timeout}s")
                self._cond.wait(0.05)

    # -- publication / shutdown ----------------------------------------
    def publish(self) -> None:
        now = _time.monotonic()
        with self._cond:
            oldest = min(self._pending) if self._pending else None
            lag = (now - self._pending[oldest].t0) if oldest is not None \
                else 0.0
            block = {
                "Committed_epoch": self.committed,
                "Begun_epoch": self.epoch_seq,
                "Pending_epochs": len(self._pending),
                "Epoch_lag_s": round(lag, 3),
                "Last_commit_s": round(self.last_commit_s, 6),
                "Commits": self.commits,
                "Aborts": self.aborts,
                "Stalled": self.stalled,
                "Interval_s": self.interval_s,
                "Restored_from": self.restored_from,
                "Path": self.store.dir,
                "Delta": self.delta,
                "Last_commit_bytes": self.delta_bytes,
            }
            sup = getattr(self.graph, "_supervisor", None)
            if sup is not None:
                block["Replica_restarts"] = sup.heals
        self.graph.stats.set_durability(block)

    def stop(self, clean: bool = True) -> None:
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self.is_alive():
            self.join(timeout=5.0)
        if clean:
            self._final_commit()
        if not clean:
            # a failed/cancelled run strands its in-flight epochs: the
            # restart recovers from the last COMMITTED one, so record
            # the aborts next to the failure for the post-mortem
            with self._cond:
                pending = sorted(self._pending)
                self._pending.clear()
            for e in pending:
                self.aborts += 1
                self.graph.flight.record("epoch_abort", epoch=e,
                                         reason="graph_failure",
                                         committed=self.committed)
        self.publish()

    def _final_commit(self) -> None:
        """Graph-level clean end (every replica joined without error):
        persist the final states as one last manifest, then release the
        sinks' remaining buffers.  Release happens HERE, not at each
        sink's own EOS -- one branch ending cleanly is not a commit
        point while another branch can still crash (its restart would
        regenerate whatever an eager flush released: duplicates)."""
        g = self.graph
        with self._cond:
            self._pending.clear()
            self.epoch_seq += 1
            epoch = self.epoch_seq
            states = dict(self._final_states)
        try:
            states, blob_writes = self._encode_states(states)
            path, nbytes = self.store.commit(
                epoch, states, {},
                meta={"graph": g.name, "final": True,
                      "committed_at": _time.time()},
                blob_writes=blob_writes)
            g.flight.record("checkpoint_epoch", epoch=epoch, path=path,
                            replicas=len(states), bytes=nbytes,
                            final=True)
            self.committed = epoch
            self.commits += 1
            self.last_manifest = {"epoch": epoch, "states": states,
                                  "offsets": {}}
        except OSError as e:
            # disk full at the final manifest: the run's OUTPUT is
            # complete either way (the finally below still releases the
            # sinks); only a later restart loses this last rewind point
            self.aborts += 1
            self._encoders.clear()
            g.flight.record("epoch_abort", epoch=epoch,
                            reason="disk_full", error=str(e),
                            committed=self.committed, final=True)
        finally:
            # the stream completed either way: the buffered effects ARE
            # the output (a failed manifest write only affects restarts
            # that will never need it)
            released = 0
            for logic in self._txn_sinks:
                try:
                    released += logic.final_release()
                except Exception:  # pragma: no cover - sink fn failure
                    import traceback
                    traceback.print_exc()
            g.flight.record("epoch_commit", epoch=epoch,
                            effects=released, final=True)
