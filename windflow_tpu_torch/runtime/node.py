"""Runtime nodes: the threaded executors of the host plane.

The reference makes every operator replica an ``ff_node`` with a
``svc()`` called per queue item (SURVEY.md §3.2).  windflow_tpu_torch splits
that into a passive **NodeLogic** (the operator semantics: svc /
eos_flush / svc_end) and an active **RtNode** thread owning the input
channel and an **Outlet** (emitter + destination channels).  This keeps
operator logic runtime-agnostic: the same logic objects are driven by
Python threads here and by the native C++ executor when built.
"""
from __future__ import annotations

import threading
import time as _time
import traceback
from typing import Any, Callable, Optional, Sequence

from ..core.tuples import DeferredBatch, SynthChunk
from ..resilience.cancel import GraphCancelled
from ..resilience.policies import POLICY_DEAD_LETTER, POLICY_FAIL
from ..telemetry.profiler import spanned
from ..telemetry.trace import attach_if_absent
from .queues import Channel, CHANNEL_TIMEOUT, GET_MANY_MAX, Watermark


class EOSMarker:
    """A tuple travelling as an EOS marker (reference wraps the per-key
    last tuple with an eos flag, meta.hpp:770-783 + wf_nodes.hpp:207-227):
    it updates window triggering state downstream but carries no data."""

    __slots__ = ("record",)

    def __init__(self, record: Any):
        self.record = record


class NodeLogic:
    """Base class for operator replica logic."""

    stats = None  # replica StatsRecord, attached by RtNode under tracing
    # telemetry plane (telemetry/): the graph FlightRecorder (always
    # bound at PipeGraph.start; record() is a no-op when disabled) and,
    # for logics that stamp trace hops themselves (FusedLogic, the
    # device window engines), the graph TelemetryHub
    flight = None
    telemetry = None

    # True (the default) promises every ``emit`` happens before the
    # ``svc``/``eos_flush`` call that received the callback returns.
    # Logics that stash ``emit`` and call it later from another thread
    # (the window engines' async dispatcher) set False, which disables
    # the runtime's batched-emission fast path for their node.
    sync_emit = True

    def svc_init(self) -> None:
        pass

    def svc(self, item: Any, channel_id: int, emit: Callable[[Any], None]) -> None:
        raise NotImplementedError

    def eos_flush(self, emit: Callable[[Any], None]) -> None:
        """Called once when all input producers reached EOS (the
        ``eosnotify`` cascade, e.g. win_seq.hpp:514-579)."""

    def svc_end(self) -> None:
        pass

    # -- checkpoint hooks (utils/checkpoint.py; absent in the reference,
    # SURVEY.md §5 "Checkpoint / resume") ---------------------------------
    def state_dict(self):
        """Picklable snapshot of this replica's state; None = stateless."""
        return None

    def load_state(self, state) -> None:
        raise NotImplementedError(f"{type(self).__name__} is stateless")

    # -- keyed-state hooks (elastic/rescale.py): a logic whose state is
    # a per-key mapping exposes it so a runtime rescale can repartition
    # keys over a new replica count -------------------------------------
    def keyed_state_dict(self):
        """``{key: state}`` snapshot for key repartitioning; None =
        stateless (nothing to migrate at rescale)."""
        return None

    def load_keyed_state(self, kv) -> None:
        """Replace this replica's per-key state with ``kv`` (the keys
        this replica owns under the new routing); clears keys it no
        longer owns."""
        raise NotImplementedError(
            f"{type(self).__name__} has no keyed state")

    # -- audit-plane hooks (audit/; docs/OBSERVABILITY.md).  Both are
    # read from the auditor thread against a LIVE replica, so
    # implementations must be lock-free gauge-grade reads (len() of a
    # dict, a monotone counter) -- never a full-state iteration --------
    def keyed_state_census(self):
        """``(key_count, bytes_estimate)`` for the keyed-state census,
        or None when this logic holds no keyed state."""
        return None

    def progress_frontier(self):
        """Monotone source position (replay offset / synth index /
        socket chunk seq) for progress tracking; None defers to the
        generic emitted-items frontier.  Only meaningful on source
        logics."""
        return None

    # -- event-time hook (eventtime/; docs/EVENTTIME.md).  A logic that
    # DEFINES ``on_watermark(wm, emit)`` receives every advanced
    # min-merged watermark before the runtime forwards it downstream
    # (fire windows / close sessions / evict join state -- emissions
    # precede the watermark in every destination channel).  Logics
    # without the hook never see watermarks: the RtNode intercepts and
    # forwards them generically.  Deliberately NOT defined on the base
    # class so ``getattr(logic, "on_watermark", None)`` stays a cheap
    # one-time probe.  A logic whose results may leave after its hook
    # returns (a window engine's dispatcher thread) sets
    # ``forwards_watermarks = True`` and emits the watermark itself,
    # behind them; the runtime then does not forward it.


def forwards_watermarks(logic) -> bool:
    """True when ``logic`` emits the watermarks it is offered itself."""
    return getattr(logic, "forwards_watermarks", False)


class ChainedLogic(NodeLogic):
    """Thread fusion of two logics: b consumes a's emissions inline
    (the reference's combine_with_laststage, multipipe.hpp:381, and the
    ff_comb PLQ/WLQ fusion of optimize_PaneFarm, pane_farm.hpp:222-250)."""

    def __init__(self, a: NodeLogic, b: NodeLogic,
                 b_name: Optional[str] = None):
        self.a = a
        self.b = b
        # profiler span of b's svc (telemetry/profiler.py), resolved at
        # svc_init: b's operator name (None: b's work counts in the
        # span around a); span_kind is the thread the chain runs on,
        # set by the enclosing chain through span_kinds
        self.b_name = b_name
        self.span_kind = "op"
        self._b_svc = b.svc
        # the chain accepts synth-chunk descriptors iff its first half
        # does (the runtime materializes them otherwise)
        self.accepts_synth_chunks = getattr(a, "accepts_synth_chunks",
                                            False)
        # a chain emits synchronously only if BOTH halves do: an async
        # half (device engine dispatcher) calls the wrapped emit after
        # svc returns, so the runtime must not hand the chain a
        # buffered emit
        self.sync_emit = (getattr(a, "sync_emit", True)
                          and getattr(b, "sync_emit", True))
        self.forwards_watermarks = (forwards_watermarks(a)
                                    or forwards_watermarks(b))
        # delegate idle ticks only when a half defines them: RtNode
        # probes hasattr, and unconditional definition would put every
        # fused map chain on timed gets for nothing
        if hasattr(a, "idle_tick") or hasattr(b, "idle_tick"):
            self.idle_tick = self._idle_tick

    def _idle_tick(self, emit):
        ta = getattr(self.a, "idle_tick", None)
        if ta is not None:
            ta(lambda x: self.b.svc(x, 0, emit))
        tb = getattr(self.b, "idle_tick", None)
        if tb is not None:
            tb(emit)

    def svc_init(self):
        # the RtNode attaches the replica StatsRecord to the OUTER
        # logic only; forward it so fused stages report device metrics
        self.a.stats = self.stats
        self.b.stats = self.stats
        _, kind = span_kinds((self.a, self.b), self.span_kind)
        if self.b_name is not None:
            self._b_svc = spanned(f"windflow/{kind}/{self.b_name}",
                                  self.b.svc)
        self.a.svc_init()
        self.b.svc_init()

    def _feed_b(self, x, emit):
        # watermarks emitted inside the chain (a watermarked source
        # half) must not reach b.svc: offer b's event-time hook, then
        # pass the watermark through (eventtime/; docs/EVENTTIME.md)
        if isinstance(x, Watermark):
            hook = getattr(self.b, "on_watermark", None)
            if hook is not None:
                hook(x, emit)
            if not forwards_watermarks(self.b):
                emit(x)
            return
        self._b_svc(x, 0, emit)

    def svc(self, item, channel_id, emit):
        self.a.svc(item, channel_id,
                   lambda x: self._feed_b(x, emit))

    def on_watermark(self, wm, emit):
        """Channel watermark: both halves observe it in chain order."""
        ha = getattr(self.a, "on_watermark", None)
        if ha is not None:
            ha(wm, lambda x: self._feed_b(x, emit))
        if forwards_watermarks(self.a):
            return  # a's own watermark reaches b through _feed_b
        hb = getattr(self.b, "on_watermark", None)
        if hb is not None:
            hb(wm, emit)

    def eos_flush(self, emit):
        self.a.eos_flush(lambda x: self._feed_b(x, emit))
        self.b.eos_flush(emit)

    def svc_end(self):
        self.a.svc_end()
        self.b.svc_end()

    def quiesce(self, emit) -> bool:
        """Live-barrier hook: drain both halves' in-flight device work
        (a's emissions feed b inline, exactly like svc)."""
        emitted = False
        qa = getattr(self.a, "quiesce", None)
        if qa is not None:
            emitted = bool(qa(lambda x: self.b.svc(x, 0, emit)))
        qb = getattr(self.b, "quiesce", None)
        if qb is not None:
            emitted = bool(qb(emit)) or emitted
        return emitted

    # -- checkpoint: delegate to both halves ---------------------------
    def state_dict(self):
        sa, sb = self.a.state_dict(), self.b.state_dict()
        if sa is None and sb is None:
            return None
        return {"a": sa, "b": sb}

    def load_state(self, state):
        if state.get("a") is not None:
            self.a.load_state(state["a"])
        if state.get("b") is not None:
            self.b.load_state(state["b"])


class _FusedDownstreamError(BaseException):
    """Carrier for an exception crossing a fused-segment boundary
    upstream.  Deliberately a BaseException: an upstream segment's
    ``except Exception`` policy guard must never swallow a DOWNSTREAM
    segment's failure (at LEVEL0 it happens in another thread, out of
    the upstream policy's scope).  FusedLogic unwraps it at the top."""

    def __init__(self, error: BaseException):
        self.error = error
        super().__init__(str(error))


def span_kinds(logics, kind: str = "op") -> list:
    """The thread each of ``logics``, run inline one after another,
    runs on, as its profiler span names it (telemetry/profiler.py): the
    first on a thread of ``kind``, and every one behind a logic that
    emits asynchronously on that window engine's dispatcher thread
    (``"emit"``).  A ChainedLogic among them takes its kind here, for
    its own halves at its svc_init."""
    kinds = []
    for logic in logics:
        kinds.append(kind)
        if isinstance(logic, ChainedLogic):
            logic.span_kind = kind
        if not getattr(logic, "sync_emit", True):
            kind = "emit"
    return kinds


class FusedSegment:
    """One operator replica inside a :class:`FusedLogic`: the logic plus
    the runtime identity it had (or would have had) as its own RtNode --
    name, error policy, stats record, fault state, dead-letter store.
    The fusion pass (graph/fuse.py) builds these; PipeGraph.start binds
    faults per segment so a FaultPlan targeting a fused-away operator
    still fires."""

    __slots__ = ("logic", "name", "policy", "stats", "faults",
                 "dead_letters", "taken", "accepts_chunks")

    def __init__(self, logic: NodeLogic, name: str,
                 policy: str = POLICY_FAIL):
        self.logic = logic
        self.name = name
        self.policy = policy
        self.stats = None
        self.faults = None
        self.dead_letters = None
        self.taken = 0  # items entering this segment (1-based fault clock)
        self.accepts_chunks = getattr(logic, "accepts_synth_chunks", False)


class FusedLogic(NodeLogic):
    """N-ary stage fusion: the segments run inline in one replica thread,
    each emission feeding the next segment's ``svc`` directly (the
    graph-wide generalization of :class:`ChainedLogic`, realizing
    ``OptLevel.LEVEL2`` -- reference ``ff_comb``, multipipe.hpp:345-390
    and pane_farm.hpp:222-250).

    Unlike ``ChainedLogic`` (whose halves share the node's single error
    policy, which is why ``chain()`` refuses policied operators), every
    segment keeps its own error policy, stats record, fault-injection
    state and checkpoint identity: a skip/dead_letter segment
    quarantines its own tuples without swallowing its neighbours'
    errors, and snapshots restore across fusion-level changes because
    state stays keyed by the original node names
    (utils/checkpoint.graph_state flattens segments)."""

    def __init__(self, segments):
        self.segments: list = []
        for seg in segments:
            if isinstance(seg.logic, FusedLogic):  # flatten nested fusion
                self.segments.extend(seg.logic.segments)
            else:
                self.segments.append(seg)
        first = self.segments[0]
        self.accepts_synth_chunks = first.accepts_chunks
        self.sync_emit = all(getattr(s.logic, "sync_emit", True)
                             for s in self.segments)
        self.forwards_watermarks = any(forwards_watermarks(s.logic)
                                       for s in self.segments)
        self.pool = None            # graph ColumnPool (boundary
        #                             materialization), set at fuse time
        self._emit_out = None       # the node's outward emit, set per call
        self._obs_left = 1          # sampled whole-chain service timing
        # trace context inside the chain -- THREAD-LOCAL: in a chain
        # with an async-emitting segment the dispatcher thread runs
        # the downstream entries/exits concurrently with the consume
        # thread, and a shared slot would attach (and double-close)
        # one thread's in-flight context onto the other's emissions
        self._live = threading.local()
        # set by RtNode.run on terminal (outlet-less) nodes: the LAST
        # segment's entry closes traces, so an async engine segment's
        # results still measure the device leg before closure
        self.closes_traces = False
        # set by PipeGraph.start on fused SOURCE heads: the first
        # segment's emissions never traverse RtNode._emit, so the
        # 1-in-N trace sampler runs in the first segment's exit instead
        self.trace_sampler = None
        self._entry0 = None
        self._exits = None
        self._span_labels = None
        self._build_chain()
        # idle ticks delegate only when some segment defines them (the
        # RtNode probes hasattr, exactly like ChainedLogic)
        if any(hasattr(s.logic, "idle_tick") for s in self.segments):
            self.idle_tick = self._idle_tick

    # -- inline chain construction (closures built once) ----------------
    def _build_chain(self):
        segs = self.segments
        n = len(segs)
        # profiler span names (telemetry/profiler.py)
        kinds = span_kinds([seg.logic for seg in segs])
        labels = [f"windflow/{kind}/{seg.name}"
                  for kind, seg in zip(kinds, segs)]
        self._span_labels = labels
        exits = [None] * n
        entry_next = None
        for k in range(n - 1, -1, -1):
            seg = segs[k]
            exits[k] = self._make_exit(seg, entry_next, first=(k == 0))
            entry_next = self._make_entry(seg, exits[k], labels[k],
                                          first=(k == 0),
                                          last=(k == n - 1))
        self._exits = exits
        self._entry0 = entry_next

    def _make_exit(self, seg: FusedSegment, entry_next,
                   first: bool = False):
        if entry_next is None:      # last segment: leave the fused node
            def exit_(item):
                if seg.faults is not None:
                    seg.faults.before_put()
                if seg.stats is not None:
                    seg.stats.outputs_sent += 1
                lc = getattr(self._live, "ctx", None)
                if lc is not None:
                    attach_if_absent(item, lc)
                self._emit_out(item)
        else:
            def exit_(item):
                if first:
                    # fused SOURCE head: its emissions never reach
                    # RtNode._emit, so the 1-in-N sampler runs here
                    s = self.trace_sampler
                    if s is not None:
                        s.maybe_attach(item)
                if seg.faults is not None:
                    seg.faults.before_put()
                if seg.stats is not None:
                    seg.stats.outputs_sent += 1
                lc = getattr(self._live, "ctx", None)
                if lc is not None:
                    attach_if_absent(item, lc)
                try:
                    entry_next(item, 0)
                except Exception as e:
                    # escaping the downstream guard means its policy is
                    # 'fail': carry it past the UPSTREAM guards (whose
                    # policies must not apply to a downstream failure)
                    raise _FusedDownstreamError(e) from e
        return exit_

    def _make_entry(self, seg: FusedSegment, exit_, label: str,
                    first: bool = False, last: bool = False):
        svc = spanned(label, seg.logic.svc)
        # live-context inheritance is SAME-THREAD state: an async-
        # emitting segment (sync_emit=False, the device dispatcher)
        # runs exits from its own thread, which must not read the
        # consume thread's in-flight context (the engine carries its
        # context across the dispatcher itself -- win_seq_tpu.py)
        inherit = getattr(seg.logic, "sync_emit", True)
        forwards = forwards_watermarks(seg.logic)

        def entry(item, cid):
            if isinstance(item, Watermark):
                # event-time control item generated INSIDE the chain (a
                # fused watermarked source head): offer this segment's
                # hook, then pass it through -- it must never reach a
                # plain segment's svc (docs/EVENTTIME.md)
                hook = getattr(seg.logic, "on_watermark", None)
                if hook is not None:
                    hook(item, exit_)
                if not forwards:
                    exit_(item)
                return
            if isinstance(item, SynthChunk) and not seg.accepts_chunks:
                item = item.materialize(self.pool)  # plane boundary
            seg.taken += 1
            if seg.faults is not None:
                # outside the policy guard: an injected crash is a
                # replica death, never a skippable tuple failure
                seg.faults.on_tuple(seg.taken)
            st = seg.stats
            if st is not None:
                st.inputs_received += 1
            # per-segment trace attribution (telemetry/): residency is
            # a channel property so only the first segment records it;
            # every segment stamps its own hop.  An inner segment's
            # hop interval includes its downstream segments' inline
            # work (documented in docs/OBSERVABILITY.md)
            ctx = None if self.telemetry is None \
                else getattr(item, "trace", None)
            if ctx is not None:
                t_in = _time.perf_counter()
                if first and st is not None \
                        and st.residency_hist is not None:
                    st.residency_hist.observe((t_in - ctx.last) * 1e6)
                if inherit:
                    live = self._live
                    prev = getattr(live, "ctx", None)
                    live.ctx = ctx
            try:
                svc(item, cid, exit_)
            except Exception as e:
                if seg.policy == POLICY_FAIL:
                    raise
                if st is not None:
                    st.svc_failures += 1
                if self.flight is not None:
                    self.flight.record("svc_failure", node=seg.name,
                                       error=repr(e))
                if seg.policy == POLICY_DEAD_LETTER \
                        and seg.dead_letters is not None:
                    seg.dead_letters.add(seg.name, item, e)
            finally:
                if ctx is not None:
                    if inherit:
                        live.ctx = prev
                    t_done = _time.perf_counter()
                    ctx.hop(seg.name, t_in, t_done)
                    if last and self.closes_traces:
                        # terminal fused node: the trace ends when the
                        # item (or an engine result carrying its
                        # context) reaches the final segment
                        self.telemetry.close(ctx, st, t_done)
        return entry

    # -- NodeLogic surface ----------------------------------------------
    def svc_init(self):
        for seg in self.segments:
            # device logics write launch metrics into their own record
            seg.logic.stats = seg.stats
            seg.logic.svc_init()

    def svc(self, item, channel_id, emit):
        self._emit_out = emit
        try:
            st0 = self.segments[0].stats
            if st0 is not None:
                self._obs_left -= 1
                if self._obs_left <= 0:
                    t0 = _time.perf_counter()
                    self._entry0(item, channel_id)
                    st0.observe((_time.perf_counter() - t0) * 1e6)
                    self._obs_left = 1 if st0.samples < 64 else 16
                    return
            self._entry0(item, channel_id)
        except _FusedDownstreamError as w:
            raise w.error

    def on_watermark(self, wm, emit):
        """Channel watermark against a fused node: every segment with
        the event-time hook observes it in chain order, emissions
        feeding the downstream segments inline (the runtime forwards
        the watermark itself afterwards, like any other logic)."""
        self._emit_out = emit
        try:
            for k, seg in enumerate(self.segments):
                hook = getattr(seg.logic, "on_watermark", None)
                if hook is not None:
                    hook(wm, self._exits[k])
                if forwards_watermarks(seg.logic):
                    break  # its watermark feeds the segments after it
        except _FusedDownstreamError as w:
            raise w.error

    def eos_flush(self, emit):
        self._emit_out = emit
        try:
            for k, seg in enumerate(self.segments):
                seg.logic.eos_flush(self._exits[k])
        except _FusedDownstreamError as w:
            raise w.error

    def svc_end(self):
        first_err = None
        for seg in self.segments:
            try:
                seg.logic.svc_end()
            except BaseException as e:  # run every teardown hook
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err

    def set_segments_terminated(self):
        """Clean-EOS hook (RtNode.run): mark every segment's record."""
        for seg in self.segments:
            if seg.stats is not None:
                seg.stats.set_terminated()

    def _idle_tick(self, emit):
        self._emit_out = emit
        try:
            for k, seg in enumerate(self.segments):
                tick = getattr(seg.logic, "idle_tick", None)
                if tick is not None:
                    tick(self._exits[k])
        except _FusedDownstreamError as w:
            raise w.error

    def quiesce(self, emit) -> bool:
        """Live-barrier hook: drain every segment's in-flight device
        work; emissions feed the downstream segments inline."""
        self._emit_out = emit
        emitted = False
        try:
            for k, seg in enumerate(self.segments):
                q = getattr(seg.logic, "quiesce", None)
                if q is not None:
                    emitted = bool(q(self._exits[k])) or emitted
        except _FusedDownstreamError as w:
            raise w.error
        return emitted

    # -- checkpoint: per-segment, keyed by original node name ----------
    def state_dict(self):
        states = {}
        for seg in self.segments:
            getter = getattr(seg.logic, "state_dict", None)
            st = getter() if getter is not None else None
            if st is not None:
                states[seg.name] = st
        return {"fused": states} if states else None

    def load_state(self, state):
        states = state.get("fused", state)
        for seg in self.segments:
            if seg.name in states:
                seg.logic.load_state(states[seg.name])


def source_loop_of(logic) -> Optional["SourceLoopLogic"]:
    """The SourceLoopLogic driving a channel-less node, seen through
    fusion/chaining wrappers (PipeGraph.start attaches the pause gate
    to it)."""
    if isinstance(logic, SourceLoopLogic):
        return logic
    if isinstance(logic, FusedLogic):
        return source_loop_of(logic.segments[0].logic)
    if isinstance(logic, ChainedLogic):
        return source_loop_of(logic.a)
    return None


class Outlet:
    """Output side of a node: an emitter routing items to destination
    channels.  ``dests`` is a list of (channel, producer_id).

    Audit plane (audit/ledger.py): when the graph auditor is enabled,
    ``audit_cells`` holds one :class:`~windflow_tpu_torch.audit.EdgeCell` per
    destination -- the producer-side delivery books (``sent`` counted
    before the put = intent, ``delivered`` after it returns,
    ``inflight`` True in between).  Books are written only by the
    node's single emitting thread (the runtime's emission contract),
    so plain int adds suffice.  ``faults`` carries the node's
    put-level fault state (FaultPlan drop_put/dup_put): an injected
    drop/duplication lands exactly between the two books, which is the
    divergence the flow-conservation ledger must detect."""

    __slots__ = ("emitter", "dests", "audit_cells", "faults")

    def __init__(self, emitter, dests: Sequence):
        self.emitter = emitter
        self.dests = list(dests)
        self.audit_cells = None
        self.faults = None

    @property
    def n_destinations(self) -> int:
        return len(self.dests)

    def send_to(self, dest_idx: int, item: Any) -> None:
        ch, pid = self.dests[dest_idx]
        cells = self.audit_cells
        if cells is None:
            f = self.faults
            if f is not None:
                act = f.put_action()
                if act is not None:
                    if act == "drop":
                        return
                    ch.put(pid, item)  # dup: deliver twice
            ch.put(pid, item)
            return
        cell = cells[dest_idx]
        cell.inflight = True
        cell.sent += 1
        f = self.faults
        if f is not None:
            act = f.put_action()
            if act is not None:
                if act == "drop":
                    # lost on the wire: intent counted, never delivered
                    cell.inflight = False
                    return
                ch.put(pid, item)  # dup: one intent, two deliveries
        ch.put(pid, item)
        cell.delivered += 1
        cell.inflight = False

    def send_many_to(self, dest_idx: int, items) -> None:
        """Ship a same-destination run of items as one bulk transfer
        (one channel lock round trip instead of one per item).  Put
        faults never reach this path: RtNode._flush_emits falls back to
        per-item sends whenever put-level faults are bound."""
        ch, pid = self.dests[dest_idx]
        cells = self.audit_cells
        cell = None
        if cells is not None:
            cell = cells[dest_idx]
            cell.inflight = True
            cell.sent += len(items)
        pm = getattr(ch, "put_many", None)
        if pm is not None:
            pm(pid, items)
        else:
            for item in items:
                ch.put(pid, item)
        if cell is not None:
            cell.delivered += len(items)
            cell.inflight = False

    def send(self, item: Any) -> None:
        if type(item) is DeferredBatch:
            # a filter's deferred selection never enters a channel: its
            # gathers belong to this thread, and its input's columns
            # must not stay alive in a queue
            item = item.materialize()
        if len(self.dests) > 1 and isinstance(item, SynthChunk):
            # routing emitters read key/id columns: materialize the
            # descriptor before fan-out (single-destination outlets
            # pass it through; the consuming node decides there)
            item = item.materialize(self.emitter.pool)
        self.emitter.emit(item, self.send_to)

    def send_many(self, items) -> None:
        """Batched send: route a whole emission buffer, accumulating
        same-destination items into single transfers.  Emitters that
        implement ``emit_many`` (StandardEmitter) group; others fall
        back to per-item ``send``."""
        if any(type(it) is DeferredBatch for it in items):
            # as in send: gathered here, before any channel
            items = [it.materialize() if type(it) is DeferredBatch
                     else it for it in items]
        emit_many = getattr(self.emitter, "emit_many", None)
        if emit_many is None:
            for item in items:
                self.send(item)
            return
        if len(self.dests) > 1:
            pool = self.emitter.pool
            items = [it.materialize(pool) if isinstance(it, SynthChunk)
                     else it for it in items]
        emit_many(items, self.send_to, self.send_many_to)

    def flush_eos(self) -> None:
        """Let the emitter publish trailing items (e.g. WF per-key EOS
        markers), then close every destination once."""
        self.emitter.eos(self.send_to)
        for ch, pid in self.dests:
            ch.close(pid)


class SourcePauseControl:
    """Cooperative source pause: the live-checkpoint barrier's first
    phase.  Sources call ``gate()`` between generation steps; while a
    pause is requested they ack and block until ``resume()``."""

    def __init__(self):
        self._cond = threading.Condition()
        self.pausing = False
        self.paused_count = 0

    def gate(self) -> None:
        with self._cond:
            if not self.pausing:
                return
            self.paused_count += 1
            self._cond.notify_all()
            while self.pausing:
                self._cond.wait()
            self.paused_count -= 1
            self._cond.notify_all()

    def request_pause(self) -> None:
        with self._cond:
            self.pausing = True

    def resume(self) -> None:
        with self._cond:
            self.pausing = False
            self._cond.notify_all()


class RtNode(threading.Thread):
    """One operator replica = one host thread (FastFlow analogue; thread
    count report mirrors pipegraph.hpp:610-612)."""

    def __init__(self, name: str, logic: NodeLogic, channel: Optional[Channel],
                 outlets: Sequence[Outlet]):
        super().__init__(name=name, daemon=True)
        self.logic = logic
        self.channel = channel
        self.outlets = list(outlets)
        self.error: Optional[BaseException] = None
        self.cancelled = False  # unwound by graph cancellation, no error
        self.stats = None  # StatsRecord when tracing is enabled
        self.group = None  # complex-nesting group id (multipipe grouping)
        # wiring marks collector nodes (ordering/K-slack/farm merge)
        # structurally; the fusion pass must never fuse across them
        self.is_collector = False
        # distributed runtime (distributed/partition.py): the builder's
        # .with_worker(i) pin, copied from the operator at wiring; the
        # partition planner and the fusion pass's partition barrier
        # read it.  None = placed automatically.
        self.worker_pin = None
        # elastic-operator membership (elastic/rescale.py): the handle
        # key when this replica belongs to a runtime-rescalable stage.
        # The compile pass must not fuse such nodes (rescale rebuilds
        # replica threads and rewires their channels at runtime), and
        # chain() falls back to add() for them.
        self.elastic_group = None
        # drain detection for the live-checkpoint barrier: an item is
        # in flight while taken != done
        self.taken = 0
        self.done = 0
        # the graph's SourcePauseControl (attached at start): idle
        # ticks must not fire while a live-checkpoint barrier is
        # pausing -- any launch they start strictly precedes a barrier
        # drain pass only if no NEW ticks begin after the pause request
        self.pause_ctl = None
        # failure containment (attached by PipeGraph.start): the graph
        # CancelToken, this operator's error policy, the graph
        # dead-letter store, and any bound fault-injection state
        self.cancel_token = None
        self.error_policy = POLICY_FAIL
        self.dead_letters = None
        self.faults = None
        # per-graph ColumnPool (attached at start; None = allocate fresh)
        self.pool = None
        # global-scheduler plane (scheduler/leases.py): the tenant's
        # fair-share lease, bound by PipeGraph.start from
        # RuntimeConfig.sched_lease.  None (the default) = ungated.
        self.sched_lease = None
        # sampled service-time observation: stride 1 for the first 64
        # samples, then 1/16 -- tracing must not cost a perf_counter
        # pair per tuple on the hot path
        self._obs_left = 1
        # telemetry plane (telemetry/; docs/OBSERVABILITY.md): the
        # graph TelemetryHub (None = tracing off -> zero per-item
        # stamping), a TraceSampler on source nodes, the builder's
        # per-source sample-period override, the graph FlightRecorder,
        # and the context of the traced item currently inside svc (so
        # emissions it produces inherit the trace)
        self.telemetry = None
        self.trace_sampler = None
        self.trace_sample = None
        self.flight = None
        self._live_trace = None
        self._terminal = False    # no outlets: traces close here
        self._fused = False       # FusedLogic: segments stamp their hops
        self._hop_rec = None      # record taking residency observations
        self._e2e_rec = None      # record taking e2e closures
        # outlet-level put faults (drop_put/dup_put): resolved once per
        # thread in run(); forces the per-item emission fallback
        self._outlet_put_faults = False
        # durability plane (durability/; docs/RESILIENCE.md): the graph
        # EpochCoordinator (None = epochs off -> zero per-item cost),
        # the per-consumer barrier aligner, and the barrier counters
        # the ledger's graph-wide roll-up subtracts (per-edge books
        # count barriers symmetrically; the sources/sinks totals must
        # not)
        self.epoch_coord = None
        self.epochs = None
        self.epoch_barriers_in = 0
        self.epoch_barriers_out = 0
        # event-time plane (eventtime/; docs/EVENTTIME.md): per-producer
        # watermark maxima, the min-merged watermark last forwarded, the
        # logic's resolved on_watermark hook, and the control-item
        # counters the ledger's graph-wide roll-up subtracts (exactly
        # like the epoch-barrier pair above).  The per-producer map is
        # deliberately NOT checkpointed: watermarks regenerate from the
        # replayed data and the merge is monotone from -inf.
        self._wm_chan: dict = {}
        self._wm_out_ts = float("-inf")
        self._wm_hook = None
        # supervised replica self-healing (durability/supervision.py):
        # the graph ReplicaSupervisor and this replica's group key,
        # bound at start for .with_restartable() stages under
        # RuntimeConfig.supervision.  An accepted crash exits WITHOUT
        # the svc_end/flush_eos teardown -- the rebuilt replica reuses
        # this node's outlets, so their producer slots must stay open
        self.supervisor = None
        self.supervised_group = None
        self._supervised_handoff = False
        self.watermarks_in = 0
        self.watermarks_out = 0
        self._accepts_chunks = False  # resolved per thread (durable path)
        self._sync_emit = True
        self._svc = None  # the logic's svc, spanned or not (run)

    def bind_outlet_faults(self) -> None:
        """Propagate put-level fault state (FaultPlan drop_put /
        dup_put) to the Outlet layer, where channel deliveries happen.
        Fused nodes bind the LAST segment's faults -- the operator
        whose emissions actually cross the channel.  Called by
        PipeGraph.start and the elastic rescale after per-node fault
        binding; independent of the audit plane, so an injected
        transport fault fires with or without the ledger books."""
        f = self.faults
        if isinstance(self.logic, FusedLogic):
            f = self.logic.segments[-1].faults
        if f is not None and f.put_rules:
            for o in self.outlets:
                o.faults = f

    def _emit(self, item: Any) -> None:
        if isinstance(item, Watermark):
            # event-time control item leaving this node: emitters
            # broadcast it to every destination, so count one per
            # destination cell -- the same shape as the per-edge
            # delivery books the ledger subtracts it from
            self.watermarks_out += sum(o.n_destinations
                                       for o in self.outlets)
        s = self.trace_sampler
        if s is not None:         # source replica: 1-in-N trace starts
            s.maybe_attach(item)
        else:
            lt = self._live_trace
            if lt is not None:
                # a traced input's emissions inherit its context even
                # when the logic built a fresh item (window results)
                attach_if_absent(item, lt)
        if self.stats is not None:
            self.stats.outputs_sent += 1
        if self.faults is not None:
            self.faults.before_put()
        for o in self.outlets:
            o.send(item)

    def _svc_guarded(self, item: Any, cid: int) -> None:
        """One svc call under this node's error policy: 'fail' lets the
        exception kill the replica (and cancel the graph); 'skip' and
        'dead_letter' quarantine the offending tuple and keep going.
        GraphCancelled and non-Exception BaseExceptions always
        propagate -- a shutdown signal is not a tuple failure."""
        stats = self.stats
        try:
            if stats is not None:
                stats.inputs_received += 1
                self._obs_left -= 1
                if self._obs_left <= 0:
                    t0 = _time.perf_counter()
                    self._svc(item, cid, self._emit)
                    stats.observe((_time.perf_counter() - t0) * 1e6)
                    self._obs_left = 1 if stats.samples < 64 else 16
                else:
                    self._svc(item, cid, self._emit)
            else:
                self._svc(item, cid, self._emit)
        except Exception as e:
            if self.error_policy == POLICY_FAIL:
                raise
            if stats is not None:
                stats.svc_failures += 1
            if self.flight is not None:
                self.flight.record("svc_failure", node=self.name,
                                   error=repr(e))
            if self.error_policy == POLICY_DEAD_LETTER \
                    and self.dead_letters is not None:
                self.dead_letters.add(self.name, item, e)

    def _flush_emits(self, buf) -> None:
        """Deliver a buffered emission run as grouped bulk channel
        transfers.  Under a bound FaultPlan, fall back to the per-item
        path: a put-targeted fault must interleave its clock with the
        actual deliveries (crash at tick k delivers exactly the k-1
        item prefix, as at LEVEL0) -- batching the ticks ahead of the
        sends would lose the whole batch instead.  Outlet-level put
        faults (drop_put/dup_put, bound per outlet even when the node
        itself carries none -- fused nodes) force the same fallback so
        the per-delivery fault clock stays exact."""
        if self.faults is not None or self._outlet_put_faults:
            for item in buf:
                self._emit(item)
            return
        if self.stats is not None:
            self.stats.outputs_sent += len(buf)
        for o in self.outlets:
            o.send_many(buf)

    def _svc_batch(self, got, accepts_chunks: bool, faults, pool) -> None:
        """Process one get_many batch with buffered emissions: outputs
        accumulate in a list and leave in grouped bulk puts afterwards
        (only for logics whose ``sync_emit`` contract holds).  Error
        policies, fault clocks and drain accounting match the per-item
        loop; ``done`` advances only after the flush so the quiesce
        barrier never sees buffered emissions as drained."""
        buf: list = []
        append = buf.append
        stats = self.stats
        svc = self._svc
        tele = self.telemetry
        processed = 0
        t0 = _time.perf_counter() if stats is not None else 0.0
        try:
            for cid, item in got:
                if isinstance(item, Watermark):
                    # buffered path: hook emissions and the forwarded
                    # watermark ride the SAME buffer, so per-destination
                    # order relative to surrounding data is preserved
                    self._handle_watermark(cid, item, append)
                    continue
                if not accepts_chunks and isinstance(item, SynthChunk):
                    item = item.materialize(pool)  # plane boundary
                self.taken += 1
                processed += 1
                if faults is not None:
                    faults.on_tuple(self.taken)  # may raise
                if stats is not None:
                    stats.inputs_received += 1
                ctx = None if tele is None else getattr(item, "trace",
                                                        None)
                if ctx is None:
                    out_cb = append
                else:
                    t_in = _time.perf_counter()
                    rec = self._hop_rec
                    if rec is not None and rec.residency_hist is not None:
                        rec.residency_hist.observe(
                            (t_in - ctx.last) * 1e6)

                    def out_cb(x, _c=ctx):   # emissions inherit ctx
                        attach_if_absent(x, _c)
                        append(x)
                try:
                    svc(item, cid, out_cb)
                except Exception as e:
                    if self.error_policy == POLICY_FAIL:
                        raise
                    if stats is not None:
                        stats.svc_failures += 1
                    if self.flight is not None:
                        self.flight.record("svc_failure", node=self.name,
                                           error=repr(e))
                    if self.error_policy == POLICY_DEAD_LETTER \
                            and self.dead_letters is not None:
                        self.dead_letters.add(self.name, item, e)
                if ctx is not None:
                    t_done = _time.perf_counter()
                    if not self._fused:
                        # fused nodes stamp per-SEGMENT hops inline and
                        # close traces in their last segment's entry
                        ctx.hop(self.name, t_in, t_done)
                        if self._terminal:
                            tele.close(ctx, self._e2e_rec, t_done)
        finally:
            try:
                if buf:
                    self._flush_emits(buf)
            finally:
                self.done += processed
        if stats is not None and processed:
            # one amortized observation per batch, not per tuple
            stats.observe((_time.perf_counter() - t0) * 1e6 / processed)

    def _handle_watermark(self, cid: int, wm: Watermark, emit) -> None:
        """Min-merge a watermark arriving on producer ``cid`` and, when
        the merged low-watermark advances, offer it to the logic's
        event-time hook and forward it downstream (eventtime/;
        docs/EVENTTIME.md).  Emissions the hook produces go out BEFORE
        the watermark -- per-channel FIFO then guarantees downstream
        consumers see fired results before the trigger that fired them.
        Watermarks advance no fault clock and neither ``taken`` nor
        ``done``: they are control items, invisible to the quiesce
        barrier's in-flight arithmetic (per-edge delivery books still
        count them symmetrically; the ledger's graph-wide identity
        subtracts ``watermarks_in/out`` at the sinks/sources)."""
        self.watermarks_in += 1
        m = self._wm_chan
        prev = m.get(cid)
        if prev is None or wm.ts > prev:
            m[cid] = wm.ts
        # the merged watermark is defined only once EVERY producer has
        # reported one (min over a partial view would overshoot)
        n_prod = getattr(self.channel, "n_producers", 1) or 1
        if len(m) < n_prod:
            return
        cur = min(m.values())
        if cur <= self._wm_out_ts:
            return
        self._wm_out_ts = cur
        out = wm if wm.ts == cur else Watermark(cur)
        hook = self._wm_hook
        if hook is not None:
            hook(out, emit)
        if self.outlets and not forwards_watermarks(self.logic):
            emit(out)

    def _process_one(self, cid: int, item: Any) -> None:
        """One guarded svc call: the per-item consume body, factored
        out for the durability plane's dispatch path (barrier-aware
        routing + the aligner's held-item replay).  Must stay
        semantically identical to the inline loop below -- the inline
        copy exists so the epochs-off hot path pays no extra call."""
        if isinstance(item, Watermark):
            self._handle_watermark(cid, item, self._emit)
            return
        if not self._accepts_chunks and isinstance(item, SynthChunk):
            item = item.materialize(self.pool)  # plane boundary
        self.taken += 1
        if self.faults is not None:
            self.faults.on_tuple(self.taken)  # may raise InjectedFailure
        tele = self.telemetry
        ctx = None if tele is None else getattr(item, "trace", None)
        if ctx is not None:
            t_in = _time.perf_counter()
            rec = self._hop_rec
            if rec is not None and rec.residency_hist is not None:
                rec.residency_hist.observe((t_in - ctx.last) * 1e6)
            if self._sync_emit:
                self._live_trace = ctx
        try:
            self._svc_guarded(item, cid)
        finally:
            self.done += 1
            if ctx is not None:
                self._live_trace = None
                t_done = _time.perf_counter()
                if not self._fused:
                    ctx.hop(self.name, t_in, t_done)
                    if self._terminal:
                        tele.close(ctx, self._e2e_rec, t_done)

    def _consume_loop(self) -> None:
        # logics with an idle_tick hook (time-bounded device launches on
        # stalled streams) take timed gets so the tick fires without input
        tick = getattr(self.logic, "idle_tick", None)
        accepts_chunks = getattr(self.logic, "accepts_synth_chunks", False)
        faults = self.faults
        channel = self.channel
        pool = self.pool
        get_many = getattr(channel, "get_many", None)
        # buffered emissions require the logic's emits to happen inside
        # the svc call (sync_emit); the async window engines opt out.
        # The durability plane opts out too: the epoch cut must emit
        # (fence results, forward the barrier) in stream order, which
        # buffered emission runs would reorder around the barrier.
        sync_emit = getattr(self.logic, "sync_emit", True)
        aligner = self.epochs
        buffered = get_many is not None and sync_emit and aligner is None
        tele = self.telemetry
        # event-time hook resolved once per thread (None on logics
        # without it -- watermarks then just merge-and-forward)
        self._wm_hook = getattr(self.logic, "on_watermark", None)
        self._accepts_chunks = accepts_chunks
        self._sync_emit = sync_emit
        # fair-share gate resolved once per thread: a lease-less graph
        # (the default) pays a single None check per batch
        lease = self.sched_lease
        stats = self.stats
        timeout = 0.025 if tick else None
        while True:
            if get_many is not None:
                got = get_many(GET_MANY_MAX, timeout)
            else:  # duck-typed channel without the bulk surface
                got = channel.get(timeout) if tick else channel.get()
                if isinstance(got, tuple):
                    got = [got]
            if got is CHANNEL_TIMEOUT:
                if not (self.pause_ctl is not None
                        and self.pause_ctl.pausing):
                    tick(self._emit)
                continue
            if got is None:
                break
            if lease is not None:
                # weighted fair share across co-resident tenants:
                # charge the batch, block while over-share (solo
                # tenants never wait -- scheduler/leases.py)
                waited = lease.acquire(len(got))
                if waited and stats is not None:
                    stats.sched_wait_s += waited
            if buffered and len(got) > 1:
                self._svc_batch(got, accepts_chunks, faults, pool)
                continue
            if aligner is not None:
                # durable dispatch: barriers route to the aligner
                # (alignment, epoch cut, holdback replay); everything
                # else takes the factored per-item body
                process = self._process_one
                for cid, item in got:
                    if not aligner.offer(cid, item, process):
                        process(cid, item)
                continue
            for cid, item in got:
                if isinstance(item, Watermark):
                    self._handle_watermark(cid, item, self._emit)
                    continue
                if not accepts_chunks and isinstance(item, SynthChunk):
                    item = item.materialize(pool)  # plane boundary
                self.taken += 1
                if faults is not None:
                    faults.on_tuple(self.taken)  # may raise InjectedFailure
                ctx = None if tele is None else getattr(item, "trace",
                                                        None)
                if ctx is not None:
                    t_in = _time.perf_counter()
                    rec = self._hop_rec
                    if rec is not None and rec.residency_hist is not None:
                        rec.residency_hist.observe(
                            (t_in - ctx.last) * 1e6)
                    if sync_emit:
                        # same-thread inheritance only: an async-
                        # emitting logic's dispatcher thread calls
                        # _emit concurrently and must not pick up the
                        # consume thread's in-flight context (the
                        # engine carries its own across the dispatcher)
                        self._live_trace = ctx
                try:
                    self._svc_guarded(item, cid)
                finally:
                    # count failed tuples as done too: the quiesce
                    # barrier's in-flight detection must not see a
                    # skipped tuple as forever in flight
                    self.done += 1
                    if ctx is not None:
                        self._live_trace = None
                        t_done = _time.perf_counter()
                        if not self._fused:
                            # fused nodes stamp per-SEGMENT hops inline
                            # and close traces in their last segment
                            ctx.hop(self.name, t_in, t_done)
                            if self._terminal:
                                tele.close(ctx, self._e2e_rec, t_done)

    def run(self) -> None:
        try:
            # logics that track device metrics (launches, staged bytes)
            # write them into the replica's record directly
            self.logic.stats = self.stats
            self._fused = isinstance(self.logic, FusedLogic)
            # the operator's profiler span (telemetry/profiler.py);
            # a fused node's segments carry their own
            self._svc = self.logic.svc if self._fused else \
                spanned(f"windflow/op/{self.name}", self.logic.svc)
            # telemetry wiring resolved once per thread, not per item:
            # fused nodes attribute residency to their first segment and
            # e2e closures to their last (per-segment records)
            if self._fused:
                # segments observe residency and close traces in their
                # own entries -- the consume loops must NOT observe too
                # (it would double-count every traced arrival)
                self._hop_rec = self._e2e_rec = None
            else:
                self._hop_rec = self._e2e_rec = self.stats
            self._terminal = self.telemetry is not None \
                and not self.outlets
            self._outlet_put_faults = any(o.faults is not None
                                          for o in self.outlets)
            if self._fused:
                self.logic.closes_traces = self._terminal
            self.logic.svc_init()
            if self.channel is not None:
                self._consume_loop()
            self.logic.eos_flush(self._emit)
            if self.epoch_coord is not None:
                # durability plane: hand the coordinator this replica's
                # final state (it backfills epochs this node will never
                # cut for) and tell downstream aligners no further
                # barriers come from here -- BEFORE flush_eos closes
                # the producer slots
                from ..durability.barrier import (broadcast_final,
                                                  capture_states)
                self.epoch_coord.node_finished(self.name,
                                               capture_states(self))
                broadcast_final(self)
            if self.stats is not None:
                self.stats.set_terminated()
            term = getattr(self.logic, "set_segments_terminated", None)
            if term is not None:  # fused node: per-segment records
                term()
        except GraphCancelled:
            self.cancelled = True  # clean unwind, not a failure
        except BaseException as e:  # surfaced by PipeGraph.wait_end
            if self.supervisor is not None and isinstance(e, Exception) \
                    and self.supervisor.report_failure(self, e):
                # supervised replica (durability/supervision.py): the
                # supervisor rebuilds this replica in place from the
                # last committed epoch -- no error, no graph cancel,
                # and no teardown (the flag below skips the finally
                # block: the rebuilt node reuses these outlets, so
                # svc_end/flush_eos must not close their producer
                # slots downstream)
                self._supervised_handoff = True
            else:
                self.error = e
                traceback.print_exc()
                # poison every channel of the graph so blocked peers
                # unwind instead of deadlocking on this dead replica's
                # channel
                if self.cancel_token is not None:
                    self.cancel_token.cancel(e, origin=self.name)
        finally:
            if not self._supervised_handoff:
                # svc_end BEFORE closing outlets: teardown hooks (e.g.
                # the device dispatcher abort) must stop emitting before
                # the EOS sentinel is enqueued downstream
                try:
                    self.logic.svc_end()
                except GraphCancelled:
                    self.cancelled = True
                except BaseException as e:
                    if self.error is None:
                        self.error = e
                        if self.cancel_token is not None:
                            self.cancel_token.cancel(e, origin=self.name)
                    traceback.print_exc()
                try:
                    for o in self.outlets:
                        o.flush_eos()
                except GraphCancelled:
                    # downstream already poisoned: nobody is listening
                    self.cancelled = True


class SourceLoopLogic(NodeLogic):
    """Drives a generation function with no input channel: the function
    is called until it returns False (reference source.hpp:175-252).

    ``pause_control`` (a SourcePauseControl, attached by
    PipeGraph.start) gates every generation step so a live checkpoint
    can halt production at a step boundary.  ``epoch_injector``
    (durability/barrier.py, attached by the EpochCoordinator) injects
    aligned epoch barriers at the same boundaries -- BEFORE the pause
    gate, so an epoch held open can never deadlock against a parked
    source (PipeGraph.quiesce drains epochs before pausing).
    ``cancel_token`` (attached by PipeGraph.start) is checked at the
    same boundary: an unfused source learns of cancellation from its
    poisoned outlet channel, but a FULLY fused source->...->sink chain
    owns no channel at all, so without this check its replica thread
    would spin forever after cancel() -- the exact leak the serving
    plane's lifecycle census caught (repeated submit/evict of an
    endless fused tenant stranded one thread per cycle)."""

    pause_control = None
    epoch_injector = None
    cancel_token = None
    # the source's profiler span around each generation step
    # (telemetry/profiler.py; named by PipeGraph.start)
    span_label = None

    def __init__(self, step: Callable[[Callable[[Any], None]], bool]):
        self.step = step

    def svc(self, item, channel_id, emit):  # pragma: no cover
        raise RuntimeError("source has no inputs")

    def eos_flush(self, emit):
        step = self.step if self.span_label is None \
            else spanned(self.span_label, self.step)
        while True:
            tok = self.cancel_token
            if tok is not None and tok.cancelled:
                raise GraphCancelled("source cancelled")
            inj = self.epoch_injector
            if inj is not None:
                inj.maybe_inject()
            ctl = self.pause_control
            if ctl is not None:
                ctl.gate()
            if not step(emit):
                break
