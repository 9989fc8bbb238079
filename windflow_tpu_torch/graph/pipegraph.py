"""PipeGraph: the application container.

Re-design of reference ``wf/pipegraph.hpp`` (915 LoC): owns the
application tree of MultiPipes (AppNode :67-79), ``add_source`` :560-574,
``run`` = start + wait_end :580-736, split/merge executors :289-503, and
the dropped-tuple counter :104/:763-766.
"""
from __future__ import annotations

import threading
import time as _time
from typing import List, Optional, Sequence

from ..core.basic import Mode, RuntimeConfig
from ..operators.base import Operator
from ..resilience.cancel import CancelToken
# NodeFailureError's historical home is this module; it now lives in
# resilience.errors (shared with the watchdog) and is re-exported here
from ..resilience.errors import NodeFailureError, StallError  # noqa: F401
from ..resilience.policies import DeadLetterStore
from ..runtime.emitters import SplittingEmitter
from ..runtime.node import RtNode
from .multipipe import MultiPipe


class _AppNode:
    """Application-tree node (pipegraph.hpp:67-79)."""

    def __init__(self, mp: Optional[MultiPipe] = None, parent=None):
        self.mp = mp
        self.parent = parent
        self.children: List["_AppNode"] = []


class PipeGraph:
    def __init__(self, name: str = "pipegraph", mode: Mode = Mode.DEFAULT,
                 config: RuntimeConfig = None):
        self.name = name
        self.mode = mode
        self.config = config or RuntimeConfig(mode=mode)
        self.config.mode = mode
        self.root = _AppNode()
        self.pipes: List[MultiPipe] = []
        self._dropped = 0
        self._dropped_lock = threading.Lock()
        self._pause_ctl = None  # SourcePauseControl, attached at start()
        from ..monitoring.stats import GraphStats
        self.stats = GraphStats(name)
        self._started = False
        self._ended = False
        self._monitor = None
        self._pipe_seq = 0
        # failure containment (resilience/): graph-wide cancellation,
        # dead-letter quarantine, stall watchdog
        self._cancel = CancelToken()
        self.dead_letters = DeadLetterStore()
        self._watchdog = None
        # telemetry plane (telemetry/; docs/OBSERVABILITY.md): the
        # always-on bounded flight recorder (record() no-ops when the
        # capacity is configured 0) and the tracing hub, built at
        # start() when tracing sampling is enabled
        from ..telemetry import FlightRecorder
        self.flight = FlightRecorder(self.config.flight_recorder_events)
        self.telemetry = None
        # pooled zero-copy interchange (core/tuples.ColumnPool): one
        # arena per graph, shared by partition sub-batches, SynthChunk
        # materialization and the batched consume loops
        if self.config.buffer_pool:
            from ..core.tuples import ColumnPool
            self.buffer_pool = ColumnPool()
        else:
            self.buffer_pool = None
        # names of nodes the LEVEL2 compile pass fused (graph/fuse.py),
        # filled at start()
        self.fused_nodes: List[str] = []
        # elastic scaling plane (elastic/; docs/ELASTIC.md): registry of
        # rescalable operators (name -> ElasticHandle, filled at
        # wiring), one rescale at a time, and the load-driven
        # controller thread (started at start() when the registry is
        # non-empty)
        self.elastic = {}
        self._rescale_lock = threading.Lock()
        self._controller = None
        # supervised replica self-healing (durability/supervision.py;
        # docs/RESILIENCE.md): registry of restartable operators
        # (key -> SupervisedGroup, filled at wiring) and the healing
        # thread, built at start() when RuntimeConfig.supervision is
        # set on top of the durability plane
        self.supervised = {}
        self._supervisor = None
        # audit plane (audit/; docs/OBSERVABILITY.md): the online
        # flow-conservation ledger + frontier tracker + skew census
        # thread, built at start() when RuntimeConfig.audit is on
        self.auditor = None
        # diagnosis plane (diagnosis/; docs/OBSERVABILITY.md): critical-
        # path attribution, bottleneck walk, gauge history + regression
        # bands, built at start() when RuntimeConfig.diagnosis is on
        self.diagnosis = None
        # durability plane (durability/; docs/RESILIENCE.md): aligned
        # epoch barriers + manifest commits + exactly-once sink
        # release, built at start() when RuntimeConfig.durability is set
        self.durability = None
        # tiered keyed state (state/; docs/RESILIENCE.md "Tiered state
        # & memory pressure"): the TieredStateManager splitting
        # RuntimeConfig.state_budget_bytes across capable keyed
        # replicas, built at start() when the budget is set
        self.tiered_state = None
        # distributed runtime plane (distributed/; docs/DISTRIBUTED.md):
        # the partition plan (node name -> worker id, computed before
        # the fusion pass) and the live transport handle, built at
        # start() when RuntimeConfig.distributed is set
        self._dist_plan = None
        self._dist = None
        # online re-planner (graph/replanner.py; docs/PLANNER.md):
        # built at start() when RuntimeConfig.replan is on
        self.replanner = None

    # -- construction ------------------------------------------------------
    def _new_pipe(self) -> MultiPipe:
        mp = MultiPipe(self, f"pipe{self._pipe_seq}")
        self._pipe_seq += 1
        self.pipes.append(mp)
        return mp

    def add_source(self, source: Operator) -> MultiPipe:
        """Create a root MultiPipe fed by ``source``
        (pipegraph.hpp:560-574)."""
        mp = self._new_pipe()
        mp.add_source(source)
        self.root.children.append(_AppNode(mp, self.root))
        return mp

    def _count_dropped(self, n: int) -> None:
        with self._dropped_lock:
            self._dropped += n

    def get_num_dropped_tuples(self) -> int:
        return self._dropped

    # -- split / merge executors (pipegraph.hpp:289-503) -------------------
    def _find_app_node(self, node: _AppNode, mp: MultiPipe) -> Optional[_AppNode]:
        if node.mp is mp:
            return node
        for c in node.children:
            found = self._find_app_node(c, mp)
            if found is not None:
                return found
        return None

    def _execute_split(self, mp: MultiPipe, split_fn, n_branches: int) -> MultiPipe:
        """Open n child MultiPipes fed through a SplittingEmitter
        (pipegraph.hpp:289-328)."""
        if n_branches < 2:
            raise ValueError("split requires >= 2 branches")
        app = self._find_app_node(self.root, mp)
        if app is None:
            raise RuntimeError("MultiPipe not part of this graph")
        children = []
        for b in range(n_branches):
            child = self._new_pipe()
            child.name = f"{mp.name}.b{b}"
            child.has_source = True  # fed by the parent, not by a Source op
            children.append(child)
            app.children.append(_AppNode(child, app))
        # wire: each tail gets a SplittingEmitter whose branch b leads to
        # the (future) first operator of child b.  We defer binding by
        # giving each child a relay channel the parent writes into.
        from ..runtime.queues import make_channel
        from ..runtime.node import NodeLogic, Outlet

        class _Relay(NodeLogic):
            def svc(self, item, channel_id, emit):
                emit(item)

        relay_nodes = []
        for child in children:
            ch = make_channel(self.config)
            relay = RtNode(f"{child.name}/relay", _Relay(), ch, [])
            child.nodes.append(relay)
            child.tails = [relay]
            relay_nodes.append((ch, relay))
        for tail in mp.tails:
            em = SplittingEmitter(split_fn, n_branches)
            em.set_n_destinations(n_branches)
            dests = [(ch, ch.register_producer()) for ch, _ in relay_nodes]
            tail.outlets.append(Outlet(em, dests))
        mp.children = children
        mp.tails = []
        return mp

    def _execute_merge(self, mp: MultiPipe,
                       others: Sequence[MultiPipe]) -> MultiPipe:
        """Merge sibling MultiPipes into a fresh one whose first operator
        receives the union of their streams (pipegraph.hpp:331-503; the
        merge-full/ind/partial distinction collapses here because wiring
        is explicit)."""
        all_pipes = [mp, *others]
        # validity checks (pipegraph.hpp:186-286 analogues)
        seen_ids = set()
        for p in all_pipes:
            if id(p) in seen_ids:
                raise RuntimeError("cannot merge a MultiPipe with itself")
            seen_ids.add(id(p))
            if p.graph is not self:
                raise RuntimeError(
                    "cannot merge MultiPipes from different PipeGraphs")
            if p.merged_into is not None:
                raise RuntimeError(
                    f"MultiPipe {p.name} was already merged")
            if p.children:
                raise RuntimeError(
                    f"MultiPipe {p.name} was split; merge its branches "
                    "(select(i)) instead")
            if p.has_sink:
                raise RuntimeError("cannot merge a terminated MultiPipe")
            if not p.tails:
                raise RuntimeError(f"MultiPipe {p.name} has no open tail")
        merged = self._new_pipe()
        merged.name = "+".join(p.name for p in all_pipes)
        merged.has_source = True
        merged.tails = [t for p in all_pipes for t in p.tails]
        app = self._find_app_node(self.root, mp)
        parent = app.parent if app is not None else self.root
        parent.children.append(_AppNode(merged, parent))
        for p in all_pipes:
            p.merged_into = merged
        return merged

    # -- execution (pipegraph.hpp:580-736) ---------------------------------
    def _all_nodes(self) -> List[RtNode]:
        seen = set()
        out = []
        for p in self.pipes:
            for n in p.nodes:
                if id(n) not in seen:
                    seen.add(id(n))
                    out.append(n)
        return out

    def start(self) -> None:
        if self._started:
            raise RuntimeError("PipeGraph already started")
        for p in self.pipes:
            if not p.has_sink and not p.children and p.merged_into is None \
                    and p.tails:
                raise RuntimeError(
                    f"MultiPipe {p.name} has no sink; terminate every "
                    "branch before run()")
        self._started = True
        if self.config.tracing:
            from ..monitoring.monitor import MonitoringThread
            self._monitor = MonitoringThread(self)
            self._monitor.start()
        # telemetry hub (telemetry/trace.py): sampled end-to-end
        # tracing + latency histograms ride the tracing surface;
        # trace_sample=0 with no per-source with_tracing override keeps
        # the counter plane with ZERO per-item stamping (node.telemetry
        # stays None).  A positive per-source override builds the hub
        # even under a global 0 -- the builder docs promise it wins.
        if self.config.tracing and (
                self.config.trace_sample > 0
                or any((n.trace_sample or 0) > 0
                       for n in self._all_nodes() if n.channel is None)):
            from ..telemetry import TelemetryHub
            self.telemetry = TelemetryHub(self.stats,
                                          self.config.trace_sample)
            self.stats.enable_histograms()
        # wire the live-checkpoint pause gate into every source replica
        # and every node (consumer idle ticks pause with the barrier),
        # plus the failure-containment plumbing: the CancelToken learns
        # every channel, every node learns the token / dead-letter
        # store / any bound fault-injection state
        from ..runtime.node import FusedLogic, SourcePauseControl, \
            source_loop_of
        self._pause_ctl = SourcePauseControl()
        # distributed runtime (distributed/partition.py): the partition
        # plan must exist BEFORE the fusion pass (its partition barrier
        # keeps fused nodes inside one worker) and is a pure function
        # of the wired pre-fusion topology + pins, so every worker
        # computes the same plan independently
        if self.config.distributed is not None \
                and self._dist_plan is None:
            from ..distributed.partition import plan_partition
            plan_partition(self)
        # graph compile pass (graph/fuse.py): at OptLevel.LEVEL2 (the
        # default; RuntimeConfig.opt_level opts out) adjacent
        # single-producer FORWARD stages fuse into single replicas.
        # Runs BEFORE the ingest wiring so credit proxies wrap the
        # post-fusion channel set, and BEFORE the binding loop below so
        # fault plans bind per fused segment.
        from .fuse import fuse_graph
        self.fused_nodes = fuse_graph(self)
        # distributed runtime (distributed/wiring.py): prune to this
        # worker's partition and wire the shuffle transport -- AFTER
        # fusion (the node set is final) and BEFORE the planner /
        # ingest wiring / audit attachment, so those planes see only
        # the owned nodes and the post-distribution destination set
        if self.config.distributed is not None:
            from ..distributed.wiring import distribute_graph
            distribute_graph(self)
        # cost-based placement planner (graph/planner.py;
        # docs/PLANNER.md): resolve every window engine's lane
        # ('auto' -> measured cost model; pins pass through), hand the
        # device lanes the measured RTT floor for the adaptive batch
        # resize, and give placed engines stats records so per-launch
        # device timing is observable without tracing.  AFTER fusion
        # (segments carry the engines now), BEFORE any thread starts.
        from .planner import plan_graph
        self.placements = plan_graph(self)
        for d in self.placements:
            self.flight.record("placement", **d)
        # online re-planning (graph/replanner.py; docs/PLANNER.md):
        # the start-time decision becomes a running hypothesis -- a
        # re-planner riding the diagnosis tick flips a lane mid-run
        # when the measured launch walls contradict the projection
        if self.config.replan and self.placements:
            if not self.config.diagnosis:
                raise RuntimeError(
                    "RuntimeConfig.replan needs the diagnosis plane: "
                    "re-planning rides the diagnosis tick (leave "
                    "RuntimeConfig.diagnosis at its default True)")
            from .replanner import RePlanner
            self.replanner = RePlanner(self)
        # whole-partition device step (graph/device_step.py; ROADMAP
        # item 3): AFTER fusion + placement (it lowers the post-fusion
        # node set by resolved lane), BEFORE the binding loop / ingest
        # wiring so step nodes bind like any other fused node.  Merges
        # forward edges into device-eligible consumers (including
        # source heads) and puts every device-lane window engine under
        # chunk-granular launch control: one launch per ingest chunk.
        from .device_step import lower_device_steps
        self.step_nodes = lower_device_steps(self)
        for name in self.step_nodes:
            self.flight.record("device_step", node=name)
        # attach the column pool to every node and emitter (pooled
        # materialization + partition sub-batches)
        if self.buffer_pool is not None:
            for n in self._all_nodes():
                n.pool = self.buffer_pool
                for o in n.outlets:
                    o.emitter.pool = self.buffer_pool
        # ingest plane (ingest/wiring.py): wrap ingest outlet channels
        # in credit proxies, register gates/stages with the CancelToken
        # and bind the microbatch controller to downstream engines --
        # BEFORE the channel loop below so consumers register their
        # (proxied) channels with the token
        from ..ingest.wiring import wire_ingest
        wire_ingest(self)
        fault_plan = getattr(self.config, "fault_plan", None)
        hub = self.telemetry
        # global-scheduler plane (scheduler/leases.py): the tenant's
        # fair-share lease gates every consume loop and unblocks on
        # cancel like any registered channel (it exposes poison())
        sched_lease = getattr(self.config, "sched_lease", None)
        if sched_lease is not None:
            self._cancel.register(sched_lease)
        for n in self._all_nodes():
            n.pause_ctl = self._pause_ctl
            n.cancel_token = self._cancel
            n.sched_lease = sched_lease
            n.dead_letters = self.dead_letters
            # telemetry plane: every node/logic learns the flight
            # recorder; under active tracing sampling the hub is bound
            # too (source nodes get a deterministic 1-in-N sampler,
            # consumers stamp hops / close traces)
            n.flight = self.flight
            n.logic.flight = self.flight
            if getattr(n.logic, "uses_dead_letters", False):
                # late-data quarantine (eventtime/ logics, K-slack
                # collectors): the logic itself dead-letters event-time
                # drops with its runtime identity attached
                n.logic.dead_letters = self.dead_letters
                n.logic.node_name = n.name
            if hub is not None:
                n.telemetry = hub
                n.logic.telemetry = hub
                if n.channel is None:
                    # per-source builder override (with_tracing): an
                    # explicit 0 opts this source out, None defers to
                    # the global period (which may itself be 0)
                    eff = n.trace_sample \
                        if n.trace_sample is not None \
                        else self.config.trace_sample
                    if eff > 0:
                        if isinstance(n.logic, FusedLogic):
                            # fused source head: emissions go segment
                            # to segment, never through RtNode._emit,
                            # so the first segment's exit samples
                            n.logic.trace_sampler = hub.sampler_for(
                                n.logic.segments[0].name, eff)
                        else:
                            n.trace_sampler = hub.sampler_for(
                                n.name, eff)
            if isinstance(n.logic, FusedLogic):
                # per-segment identity: dead letters, fault clocks (a
                # FaultPlan targeting a fused-away operator still fires)
                for seg in n.logic.segments:
                    seg.dead_letters = self.dead_letters
                    seg.logic.flight = self.flight
                    if getattr(seg.logic, "uses_dead_letters", False):
                        seg.logic.dead_letters = self.dead_letters
                        seg.logic.node_name = seg.name
                    if hub is not None:
                        seg.logic.telemetry = hub
                    if fault_plan is not None:
                        seg.faults = fault_plan.for_node(seg.name)
            elif fault_plan is not None:
                n.faults = fault_plan.for_node(n.name)
            if fault_plan is not None:
                # put-level faults (drop_put/dup_put) act at the
                # Outlet layer, with or without the audit plane
                n.bind_outlet_faults()
            if n.channel is not None:
                self._cancel.register(n.channel)
            if n.channel is None:
                src = source_loop_of(n.logic)
                if src is not None:
                    src.pause_control = self._pause_ctl
                    # cancellation check at generation-step boundaries:
                    # a fully fused source chain has no channel whose
                    # poisoning could unblock it (runtime/node.py
                    # SourceLoopLogic.eos_flush)
                    src.cancel_token = self._cancel
                    # adaptive-skew watermarked bodies
                    # (eventtime/watermarks.py skew="auto") announce
                    # their bound revisions on the flight recorder
                    uf = getattr(src, "user_fn", None)
                    if getattr(uf, "_wants_flight", False):
                        uf.flight = self.flight
                        uf.source_name = n.name
        # tiered keyed state (state/; docs/RESILIENCE.md "Tiered state
        # & memory pressure"): under RuntimeConfig.state_budget_bytes,
        # swap capable keyed logics' dict stores for TieredKeyedStores
        # (hot/warm/cold under the keyed_state_dict contract).  AFTER
        # flight/dead-letter/fault binding (the stores record
        # state_pressure/spill_abort and shed into dead_letters),
        # BEFORE the audit plane (the auditor hands its hot-key
        # sketches to the stores it finds)
        if getattr(self.config, "state_budget_bytes", None):
            from ..state import attach_tiered_state
            self.tiered_state = attach_tiered_state(self)
        # audit plane (audit/; docs/OBSERVABILITY.md): attach the
        # per-edge delivery books, outlet put-fault state and KEYBY
        # hot-key sketches AFTER fusion/ingest wiring and fault binding
        # (books align with the post-fusion channel set; put faults
        # bind to the segment whose emissions cross the channel) and
        # BEFORE any replica thread emits
        if self.config.audit:
            from ..audit import GraphAuditor
            self.auditor = GraphAuditor(self)
            self.auditor.attach()
        # diagnosis plane (diagnosis/; docs/OBSERVABILITY.md): built
        # after the wiring above so its one-time topology snapshot sees
        # the post-fusion operator chains.  No thread of its own --
        # ticks ride the monitor/auditor cadences and explain() calls
        if self.config.diagnosis:
            from ..diagnosis import DiagnosisPlane
            self.diagnosis = DiagnosisPlane(self)
            self.stats.set_topology(self.diagnosis.edges)
        elif self.config.slo is not None:
            # the SLO plane has no tick of its own -- it rides the
            # diagnosis tick; a declared objective that silently never
            # evaluates would be worse than a loud refusal
            raise RuntimeError(
                "RuntimeConfig.slo needs the diagnosis plane: SLO "
                "burn rates are evaluated on the diagnosis tick "
                "(leave RuntimeConfig.diagnosis at its default True)")
        # durability plane (durability/; docs/RESILIENCE.md): the epoch
        # coordinator + per-node barrier aligners/injectors.  AFTER the
        # audit books (barriers ride Outlet.send_to, so per-edge
        # delivery books count them symmetrically) and fault binding
        # (crash_at_epoch fires through the bound NodeFaults), BEFORE
        # any replica thread runs
        if self.config.durability is not None:
            from ..durability import EpochCoordinator
            self.durability = EpochCoordinator(self)
            self.durability.attach()
        # supervised replica self-healing (durability/supervision.py):
        # opt-in via RuntimeConfig.supervision, and only on top of the
        # durability plane -- the heal rewinds the graph to the last
        # committed epoch, which does not exist without one.  Built
        # BEFORE the replica threads start: the supervisor's pre-start
        # state capture is the rewind point until the first commit.
        if self.config.supervision is not None:
            if self.durability is None:
                raise RuntimeError(
                    "RuntimeConfig.supervision needs the durability "
                    "plane: a supervised restart rewinds to the last "
                    "committed epoch (set RuntimeConfig.durability)")
            if self.supervised:
                from ..durability.supervision import ReplicaSupervisor
                self._supervisor = ReplicaSupervisor(self)
                for grp in self.supervised.values():
                    for n in grp.replicas:
                        n.supervisor = self._supervisor
        for n in self._all_nodes():
            n.start()
        if self.auditor is not None:
            self.auditor.start()
        if self.durability is not None:
            self.durability.start()
        if self._supervisor is not None:
            self._supervisor.start()
        # watchdog AFTER the replica threads: it treats "no node alive"
        # as graph completion, so starting it first would let it exit
        # before the first node ever ran
        if self.config.watchdog_timeout_s:
            from ..resilience.watchdog import StallWatchdog
            self._watchdog = StallWatchdog(
                self, self.config.watchdog_timeout_s,
                cancel=self.config.watchdog_cancel)
            self._watchdog.start()
        # elastic controller LAST: its sampler reads live replica
        # stats, and its decisions call rescale() on a running graph
        if self.elastic:
            from ..elastic.controller import start_controller
            self._controller = start_controller(self)

    def cancel(self, reason: Optional[BaseException] = None) -> bool:
        """Poison every channel: blocked replicas unwind and wait_end
        returns.  Idempotent; returns False if already cancelled."""
        return self._cancel.cancel(reason, origin="user")

    def _join_all(self):
        """Join every node; once the graph is cancelled, give each
        remaining thread a bounded grace period (a replica stuck inside
        user code cannot be killed from Python -- it is recorded as
        stuck and abandoned; threads are daemonic).  Returns
        (errors, stuck) lists."""
        grace = self.config.cancel_grace_s
        errors, stuck = [], []
        # dedup by node OBJECT (held in the set): an id()-keyed set
        # could skip a rescale-added replica that reuses a freed
        # retired node's address
        joined = set()
        while True:
            # re-list each pass: a concurrent elastic rescale may add
            # replica nodes while this join loop is already running
            pending = [n for n in self._all_nodes() if n not in joined]
            if not pending:
                break
            for n in pending:
                joined.add(n)
                grace_deadline = None
                while n.is_alive():
                    n.join(timeout=0.1)
                    if not n.is_alive():
                        break
                    if self._cancel.cancelled:
                        now = _time.monotonic()
                        if grace_deadline is None:
                            grace_deadline = now + grace
                        elif now > grace_deadline:
                            stuck.append(n.name)
                            break
                if n.error is not None:
                    errors.append((n.name, n.error))
        return errors, stuck

    def wait_end(self) -> None:
        errors, stuck = self._join_all()
        if self._supervisor is not None:
            # a heal in flight holds the sources paused, so _join_all
            # cannot return mid-heal; stopping here just retires the
            # healing thread (and any replica it swapped in joined
            # through the re-listing join loop above)
            self._supervisor.stop()
        self._ended = True
        if self.replanner is not None:
            self.replanner.stop()
        if self._dist is not None:
            # distributed plane: flush the wire tails (acks settle the
            # senders' replay buffers, so the ledger closes over the
            # socket edges) before the auditor's final check
            self._dist.stop(
                clean=not errors and not self._cancel.cancelled)
        if self._controller is not None:
            self._controller.stop()
        if self._watchdog is not None:
            self._watchdog.stop()
        if self.durability is not None:
            # a failed/cancelled run strands its in-flight epochs;
            # stop() records them as epoch_abort next to the failure
            self.durability.stop(
                clean=not errors and not self._cancel.cancelled)
        if self.auditor is not None:
            # final ledger closure BEFORE the monitor's last snapshot
            # and the stats dump, so both carry the settled books.
            # Only a cleanly-ended graph must balance: a failure or
            # cancellation legitimately strands in-flight tuples.
            self.auditor.stop()
            if not errors and not self._cancel.cancelled:
                final = self.auditor.final_check()
                if final:
                    # post-mortem evidence next to the violation events
                    self.flight.dump(self.config.log_dir, self.name,
                                     keep=self.config.snapshot_keep)
        if self._monitor is not None:
            self._monitor.stop()
        if self.config.tracing:
            self._dump_logs()
        if self.config.trace_runtime:
            self._dump_runtime_stats()
        if errors:
            # post-mortem history first: the flight recorder's last-N
            # events (rescales, resizes, sheds, svc failures...) next
            # to the failure that ends the graph
            self.flight.record(
                "node_failure", nodes=[name for name, _e in errors],
                stuck=stuck)
            self.flight.dump(self.config.log_dir, self.name,
                             keep=self.config.snapshot_keep)
            err = NodeFailureError.from_pairs(errors, stuck)
            raise err from errors[0][1]
        if self._cancel.cancelled:
            # cancelled without any replica error: a watchdog stall or
            # a user cancel() -- surface the recorded reason
            reason = self._cancel.reason
            if isinstance(reason, BaseException):
                raise reason
            raise NodeFailureError(
                f"graph {self.name!r} was cancelled "
                f"(origin: {self._cancel.origin})")

    def _dump_runtime_stats(self) -> None:
        """Raw channel stats per consumer node (the -DTRACE_FASTFLOW
        queue/thread dump, pipegraph.hpp:711-733).  Counters are
        best-effort under concurrent producers (tracing-grade)."""
        import json
        import os
        rows = []
        for n in self._all_nodes():
            ch = n.channel
            if ch is None:
                continue
            rows.append({
                "node": n.name,
                "channel_impl": type(ch).__name__,
                "capacity": getattr(ch, "capacity", None),
                "producers": ch.n_producers,
                "puts": getattr(ch, "puts", 0),
                "gets": getattr(ch, "gets", 0),
                "high_watermark": getattr(ch, "high_watermark", 0),
                "residual": ch.qsize(),
            })
        from ..distributed.identity import worker_suffix
        os.makedirs(self.config.log_dir, exist_ok=True)
        path = os.path.join(
            self.config.log_dir,
            f"{os.getpid()}_{self.name}{worker_suffix()}_runtime.json")
        with open(path, "w") as f:
            json.dump({"graph": self.name, "channels": rows}, f, indent=1)
        from ..monitoring.monitor import rotate_snapshots
        rotate_snapshots(self.config.log_dir, self.config.snapshot_keep)

    def _dump_logs(self) -> None:
        """Write per-graph stats JSON + graphviz DOT + a rendered SVG
        diagram under log_dir (pipegraph.hpp:683-709 dumps
        <pid>_<op>.json + a PDF/SVG diagram)."""
        import os
        from ..monitoring.monitor import graph_to_dot, graph_to_svg
        self.refresh_gauges()
        if self.diagnosis is not None:
            # final tick: the dumped Diagnosis/History blocks carry the
            # end-of-run state (sustained-pressure EWMAs survive the
            # drain, so an offline doctor still names the bottleneck)
            self.diagnosis.maybe_tick(force=True)
        from ..distributed.identity import worker_suffix
        d = self.config.log_dir
        os.makedirs(d, exist_ok=True)
        # worker-id component (distributed/identity.py): two workers of
        # one graph on one box must never clobber each other's dumps
        stem = f"{os.getpid()}_{self.name}{worker_suffix()}"
        with open(os.path.join(d, f"{stem}.json"), "w") as f:
            f.write(self.stats.to_json(self.get_num_dropped_tuples(),
                                       self.dead_letters.count(),
                                       flight_events=self.flight.snapshot()))
        with open(os.path.join(d, f"{stem}.dot"), "w") as f:
            f.write(graph_to_dot(self))
        with open(os.path.join(d, f"{stem}.svg"), "w") as f:
            f.write(graph_to_svg(self))
        from ..monitoring.monitor import rotate_snapshots
        rotate_snapshots(d, self.config.snapshot_keep)

    def run(self) -> None:
        if not self._started:
            from .native_lowering import try_run_native
            if try_run_native(self):
                return
        self.start()
        self.wait_end()

    def thread_count(self) -> int:
        return len(self._all_nodes())

    # -- live checkpoint barrier (mid-stream quiesce/snapshot; the
    # reference has no checkpointing at all, SURVEY.md §5) -------------
    def _source_nodes(self):
        return [n for n in self._all_nodes() if n.channel is None]

    def _wait_drained(self, deadline: float) -> None:
        """Block until the pipeline is drained: every channel empty and
        every consumer node between items, stable across several polls.
        Cooperative single-process drain detection, not a distributed
        snapshot protocol: a thread descheduled for the whole stability
        window exactly between channel pop and its in-flight counter
        could in principle evade it."""
        import time
        consumers = [n for n in self._all_nodes() if n.channel is not None]
        stable = 0
        last_done = -1
        while stable < 5:
            if time.monotonic() > deadline:
                raise RuntimeError("live checkpoint: pipeline failed to "
                                   "drain (timeout)")
            total_done = sum(n.done for n in consumers)
            idle = all(n.taken == n.done for n in consumers
                       if n.is_alive())
            empty = all(n.channel.qsize() == 0 for n in consumers
                        if n.is_alive())
            # durability plane: items parked in a barrier aligner's
            # holdback buffer are in flight even though taken == done
            aligned = all(n.epochs is None or not n.epochs.busy
                          for n in consumers if n.is_alive())
            if idle and empty and aligned and total_done == last_done:
                stable += 1
            else:
                stable = 0
            last_done = total_done
            time.sleep(0.002)

    def quiesce(self, timeout: float = 120.0) -> None:
        """Pause sources at a step boundary and drain the pipeline to a
        globally quiescent state: channels empty, nodes between items,
        no device batches in flight (each window engine's ``quiesce``
        hook drains its dispatcher, whose emissions are drained in
        turn).  The graph must be started and not ended."""
        import time
        if not self._started or self._ended:
            raise RuntimeError("quiesce() needs a running graph")
        deadline = time.monotonic() + timeout
        if self.durability is not None:
            # serialize with the epoch plane FIRST: an epoch held open
            # across the source pause could never align (parked sources
            # inject no barriers) and its holdback buffers would defeat
            # the drain.  hold_epochs stops the cadence and waits for
            # in-flight epochs to commit while the graph keeps flowing.
            self.durability.hold_epochs(timeout)
        self._pause_ctl.request_pause()
        # wait for every still-running source to ack the pause
        while True:
            alive = [n for n in self._source_nodes() if n.is_alive()]
            with self._pause_ctl._cond:
                acked = self._pause_ctl.paused_count
            if acked >= len(alive):
                break
            if time.monotonic() > deadline:
                self._pause_ctl.resume()
                if self.durability is not None:
                    self.durability.release_epochs()
                raise RuntimeError("live checkpoint: sources failed to "
                                   "pause (timeout)")
            time.sleep(0.002)
        try:
            while True:
                self._wait_drained(deadline)
                emitted = False
                for n in self._all_nodes():
                    q = getattr(n.logic, "quiesce", None)
                    if q is not None and n.is_alive():
                        emitted = bool(q(n._emit)) or emitted
                if not emitted:
                    return
        except BaseException:
            # a failed drain must not leave the sources parked forever
            self._pause_ctl.resume()
            if self.durability is not None:
                self.durability.release_epochs()
            raise

    def resume(self) -> None:
        self._pause_ctl.resume()
        if self.durability is not None:
            self.durability.release_epochs()

    # -- elastic scaling plane (elastic/; docs/ELASTIC.md) --------------
    def rescale(self, operator: str, new_parallelism: int,
                trigger: str = "manual", timeout: float = 60.0):
        """Rescale a running elastic operator to ``new_parallelism``
        replicas with the pause-drain-migrate protocol
        (elastic/rescale.py): quiesce, repartition keyed state by the
        emitter's ``hash % parallelism`` contract, rebuild/retire
        replica threads and rewire channels, resume.  In-flight tuples
        are conserved (the pipeline is drained before any rewiring).

        ``operator`` is the registry key (``"<pipe>/<name>"``) or any
        unique substring of one (e.g. the builder name).  Returns the
        recorded :class:`~windflow_tpu_torch.elastic.RescaleEvent`, or None
        when already at ``new_parallelism``."""
        if not self._started:
            raise RuntimeError("rescale() needs a started graph")
        if self._ended:
            raise RuntimeError("rescale() after wait_end()")
        handle = self.elastic.get(operator)
        if handle is None:
            matches = [h for k, h in self.elastic.items() if operator in k]
            if len(matches) != 1:
                raise KeyError(
                    f"no unique elastic operator matching {operator!r}; "
                    f"registered: {sorted(self.elastic)}")
            handle = matches[0]
        from ..elastic.rescale import rescale_operator
        dur = self.durability
        if dur is not None:
            # durability plane: barriers and rescales serialize PER
            # EPOCH, not under one global lock -- stop the epoch
            # cadence, let in-flight epochs commit while the graph
            # keeps flowing, then rescale inside the gap
            dur.hold_epochs(timeout)
        try:
            with self._rescale_lock:
                event = rescale_operator(self, handle, new_parallelism,
                                         trigger, timeout)
            if dur is not None:
                # refresh aligner producer counts for the rewired
                # channel set (retired producers already announced
                # themselves with final barriers) and give the new
                # replicas aligners before the cadence resumes
                dur.rewire()
        finally:
            if dur is not None:
                dur.release_epochs()
        if event is not None:
            self.flight.record("rescale", **event.to_dict())
        return event

    # -- online re-planning (graph/replanner.py; docs/PLANNER.md) -------
    def replace_lane(self, operator: str, lane: str,
                     trigger: str = "manual", timeout: float = 60.0,
                     evidence: Optional[dict] = None):
        """Flip a placed window engine's lane device<->host mid-run
        with zero lost tuples: serialize with elastic rescales under
        the rescale lock, hold the epoch cadence (a flip between two
        epochs restores exactly-once, like a rescale), drain the
        pipeline to a quiescent cut -- channels empty, no device
        batches in flight -- then swap the engine and resume.  Keyed
        window state lives in the host staging store on both lanes
        (resident device state is derivable from it and dropped on a
        host flip), so the swap migrates nothing and loses nothing.

        Records a ``replacement`` flight event the doctor explains.
        Returns the event dict, or None when already on ``lane``."""
        if lane not in ("device", "host"):
            raise ValueError(f"lane must be 'device' or 'host', "
                             f"not {lane!r}")
        if not self._started:
            raise RuntimeError("replace_lane() needs a started graph")
        if self._ended:
            raise RuntimeError("replace_lane() after wait_end()")
        target = None
        for name, logic, _entry in getattr(self, "placed_engines", []):
            if name == operator:
                target = logic
                break
        if target is None:
            raise KeyError(
                f"no placed window engine named {operator!r}; placed: "
                f"{sorted(n for n, _l, _e in getattr(self, 'placed_engines', []))}")
        old = target.resolved_placement
        if old == lane:
            return None
        dur = self.durability
        if dur is not None:
            dur.hold_epochs(timeout)
        t0 = _time.monotonic()
        try:
            with self._rescale_lock:
                self.quiesce(timeout)
                try:
                    target.apply_placement(lane)
                    if lane == "device":
                        # re-promote eligible engines onto the
                        # resident lane (the host flip dropped it)
                        maybe = getattr(target,
                                        "maybe_enable_resident", None)
                        if maybe is not None:
                            maybe()
                finally:
                    self.resume()
            if dur is not None:
                dur.rewire()
        finally:
            if dur is not None:
                dur.release_epochs()
        event = {"operator": operator, "old": old, "new": lane,
                 "trigger": trigger,
                 "duration_ms": round((_time.monotonic() - t0) * 1e3, 1)}
        if evidence:
            event["evidence"] = evidence
        self.flight.record("replacement", **event)
        return event

    # -- SLO plane (slo/; docs/OBSERVABILITY.md "SLO plane") ------------
    def with_slo(self, p99_ms: Optional[float] = None,
                 min_throughput_rps: Optional[float] = None,
                 max_frontier_lag_s: Optional[float] = None,
                 **kw) -> "PipeGraph":
        """Declare this graph's service-level objectives (chainable,
        before ``start``).  Shorthand for setting
        ``RuntimeConfig.slo = SloConfig(...)``; extra keywords
        (``target``, ``window_scale``, ``fast_burn``...) pass through.
        The SLO is evaluated on the diagnosis tick, so it needs
        ``RuntimeConfig.diagnosis`` (the default) to stay on."""
        if self._started:
            raise RuntimeError("with_slo() must be called before start()")
        from ..slo import SloConfig
        self.config.slo = SloConfig(
            p99_ms=p99_ms, min_throughput_rps=min_throughput_rps,
            max_frontier_lag_s=max_frontier_lag_s, **kw)
        return self

    def refresh_gauges(self) -> None:
        """Update the per-replica gauge fields of the stats records
        (inbound channel depth; ingest credit-wait seconds) from the
        live runtime objects.  Called before every stats JSON render
        (monitoring reporter + log dump); cheap -- lock-free depth
        reads (runtime/queues.Channel.depth)."""
        from ..runtime.node import FusedLogic
        if self._dist is not None:
            # distributed plane: refresh the per-edge wire books
            # (stats-JSON ``Wire`` block, merged cross-worker by
            # distributed/observe.py)
            self.stats.set_wire(self._dist.wire_block())
        for n in self._all_nodes():
            logic = n.logic
            rec = n.stats
            if rec is None and isinstance(logic, FusedLogic):
                # the channel consumer inside a fused node is its first
                # segment; gauge attribution follows
                rec = logic.segments[0].stats
                logic = logic.segments[0].logic
            if rec is None:
                continue
            ch = n.channel
            if ch is not None:
                rec.queue_depth = ch.depth
                # measured on both channel planes
                # (runtime/queues.py:73 / native.py:209), exported here
                rec.queue_high_watermark = getattr(ch,
                                                   "high_watermark", 0)
            # resident-lane gauge (docs/PLANNER.md "Resident state"):
            # bytes of per-key window state living in device memory --
            # every fused segment's engine reports into its own record
            pairs = ([(seg.logic, seg.stats)
                      for seg in n.logic.segments]
                     if isinstance(n.logic, FusedLogic)
                     else [(logic, rec)])
            for lg, r in pairs:
                resid = getattr(lg, "device_resident_bytes", None)
                if resid is not None and r is not None:
                    try:
                        r.device_state_bytes = resid()
                    except Exception:
                        pass  # engine mid-swap: keep the last reading
            gate = getattr(logic, "gate", None)  # ingest source replicas
            if gate is not None:
                wait = gate.wait_time_s
                # flight-recorder credit-stall events: one per refresh
                # interval in which the source spent noticeable time
                # blocked on credits (>50 ms of new wait since the last
                # gauge refresh)
                last = getattr(rec, "_flight_wait_s", 0.0)
                if wait - last > 0.05:
                    self.flight.record("credit_stall", node=n.name,
                                       wait_s=round(wait, 3),
                                       delta_s=round(wait - last, 3))
                rec._flight_wait_s = wait
                rec.credit_wait_s = wait

    # -- diagnosis plane (diagnosis/; docs/OBSERVABILITY.md) ------------
    def explain(self) -> dict:
        """The structured doctor report for this graph: dominant
        bottleneck per sink, critical-path hop-class breakdown of the
        traced e2e latency, active regression episodes, conservation /
        skew status and the flight-recorder tail.  Works on a running
        graph (live gauges) and after ``wait_end`` (the sustained
        EWMAs and high-watermarks keep the verdict through the drain);
        the same pure fold backs the dashboard's ``GET /explain``."""
        if not self._started:
            raise RuntimeError("explain() needs a started graph")
        import json as _json
        from ..diagnosis.report import build_report
        self.refresh_gauges()
        if self.diagnosis is not None:
            self.diagnosis.maybe_tick(force=True)
        stats = _json.loads(self.stats.to_json(
            self.get_num_dropped_tuples(), self.dead_letters.count()))
        return build_report(stats, self.flight.snapshot())

    def live_checkpoint(self, path: str, timeout: float = 120.0) -> int:
        """Mid-stream snapshot to a ``restore_graph``-compatible file.

        With the durability plane on (``RuntimeConfig.durability``)
        this is NON-STOP: it forces one aligned epoch and waits for its
        commit -- no source pause, no drain, the graph keeps emitting
        throughout -- then mirrors the committed states to ``path``.
        Without it, the legacy barrier applies: quiesce (pause sources,
        drain channels and in-flight device batches), snapshot, resume.
        Returns the number of replicas captured.  Restores pair with
        source replay from the captured offsets."""
        import pickle
        from ..utils.checkpoint import write_snapshot
        if not self._started or self._ended:
            # both paths need a live graph: the legacy barrier pauses
            # running sources, and a forced epoch can only commit while
            # the coordinator thread and the sinks are alive
            raise RuntimeError("live_checkpoint() needs a running graph")
        if self.durability is not None:
            epoch, blobs = self.durability.checkpoint_now(timeout)
            states = {name: pickle.loads(b) for name, b in blobs.items()}
            write_snapshot(path, states, epoch=epoch)
            self.flight.record("checkpoint_epoch", path=path, epoch=epoch,
                               replicas=len(states), non_stop=True)
            return len(states)
        from ..utils.checkpoint import graph_state
        # serialize with elastic rescales: SourcePauseControl is a
        # non-counting boolean, so a concurrent rescale's resume()
        # would un-park sources mid-snapshot (and vice versa)
        with self._rescale_lock:
            self.quiesce(timeout)
            try:
                state = graph_state(self)
                write_snapshot(path, state)
            finally:
                self.resume()
        self.flight.record("checkpoint_epoch", path=path,
                           replicas=len(state))
        return len(state)
