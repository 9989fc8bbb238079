"""Graph compile pass: whole-partition device step (ROADMAP item 3).

Runs inside ``PipeGraph.start`` AFTER LEVEL2 fusion (graph/fuse.py) and
the placement planner (graph/planner.py), on the post-fusion node set
with every window engine's lane resolved.  It is the logical end of
LEVEL2: where fusion removed the *channel hop* between adjacent stages,
this pass removes the *launch* between adjacent device work -- an
entire device-placed segment (decode -> filter/map -> KEYBY partition
-> resident window update+query -> fired-result extraction) executes as
ONE device launch per ingest chunk, with all window state
living in the engines' donated carry (ops/window_compute.py resident
lane).  Python touches the stream once per chunk, not once per
operator-trigger.

Two steps, to a fixpoint:

1. **Merge** -- a producer whose single FORWARD destination (plain
   ``StandardEmitter``, or a degenerate ``KFEmitter`` at parallelism 1,
   which routes identically) is a device-eligible consumer absorbs it,
   exactly like ``fuse._merge``.  Unlike LEVEL2 this includes SOURCE
   heads ahead of ticking window engines: the tick-safety bar existed
   because a channel-less fused node never idle-ticks, but under
   chunk-granular flushing nothing is left staged *between* chunks --
   every chunk boundary launches what the chunk fired, and the async
   dispatcher drains its own in-flight batches.

2. **Upgrade** -- every node containing a device-lane
   ``WinSeqTPULogic`` swaps its logic for a :class:`DeviceStepLogic`
   (a ``FusedLogic`` subclass, so segment identity, checkpoint keys,
   fault clocks, per-segment stats and the binding loop all behave
   identically).  The step logic holds the engines' intra-chunk launch
   triggers (``chunk_hold``) while a chunk traverses the inline chain
   and flushes each engine ONCE at the chunk boundary.

Never lowered: ingest heads (credit-accounting boundary), collectors,
elastic/supervised replicas, partition-split edges, async-emitting
producers -- the same barriers as LEVEL2, minus tick safety.

Everything downstream keeps working because nothing about the node
contract changes: audit conservation reads per-segment stats under the
original names, epochs fence at the chunk boundary via the existing
quiesce hook, checkpoints stay keyed by pre-fusion node names
(fusion-invariance), the replanner still flips individual
engines device<->host through the segment list (a host-flipped engine
simply flushes its host program once per chunk), and bitwise
equivalence vs the unfused LEVEL2 graph holds because launch *grouping*
was never semantically observable (the wall-clock partial-launch
trigger already grouped nondeterministically).

Opt out with ``RuntimeConfig.device_step=False`` / WINDFLOW_DEVICE_STEP=0.
"""
from __future__ import annotations

from typing import List

from ..core.basic import OptLevel
from ..core.tuples import SynthChunk, TupleBatch
from ..operators.tpu.win_seq_tpu import WinSeqTPULogic
from ..runtime.emitters import StandardEmitter
from ..runtime.node import (FusedLogic, RtNode, _FusedDownstreamError,
                            source_loop_of)
from ..runtime.win_routing import KFEmitter
from ..telemetry.profiler import spanned
from .fuse import (_consumers_by_channel, _has_async_emit, _is_collector,
                   _is_elastic, _is_ingest_head, _merge, _partition_splits,
                   _segments_of)


class DeviceStepLogic(FusedLogic):
    """A fused chain driven at chunk granularity: while a data chunk
    (TupleBatch / SynthChunk) traverses the inline segments, every
    window engine's intra-chunk launch trigger is held
    (``WinSeqTPULogic.chunk_hold``); at the chunk boundary each engine
    flushes everything the chunk fired as ONE launch.  Control items
    (watermarks, epoch barriers, EOS markers, records) pass through
    unheld -- they are boundaries, not stream data.

    ``chunks_in`` / ``chunk_launches`` are the dispatcher-side counters
    the ``19_device_step`` bench asserts launches-per-chunk from."""

    def __init__(self, segments):
        super().__init__(segments)
        # (segment index, engine, its chunk flush) for every window
        # engine in the chain, computed AFTER the base class flattened
        # nested fusion; the flush is the engine's work, so it runs in
        # the engine segment's profiler span (telemetry/profiler.py)
        self._step_engines = [
            (k, s.logic, spanned(self._span_labels[k], s.logic.flush_chunk))
            for k, s in enumerate(self.segments)
            if isinstance(s.logic, WinSeqTPULogic)]
        self.chunks_in = 0
        self.chunk_launches = 0

    # -- chunk boundary helpers -----------------------------------------
    def _hold(self):
        for _k, eng, _f in self._step_engines:
            eng.chunk_hold = True

    def _release(self):
        for _k, eng, _f in self._step_engines:
            eng.chunk_hold = False

    def _flush_boundary(self):
        """One launch per engine for everything the chunk fired.  An
        engine's flush emits through its own exit, so downstream
        segments (and the node's outward emit) see results exactly as
        they would from an intra-chunk launch."""
        launches = 0
        for k, _eng, flush in self._step_engines:
            launches += flush(self._exits[k])
        self.chunk_launches += launches

    # -- NodeLogic surface ----------------------------------------------
    def svc(self, item, channel_id, emit):
        if not self._step_engines \
                or not isinstance(item, (TupleBatch, SynthChunk)):
            super().svc(item, channel_id, emit)
            return
        self.chunks_in += 1
        self._hold()
        try:
            super().svc(item, channel_id, emit)
        finally:
            # released even when the chain raised -- but the boundary
            # flush below is then skipped: a crashing chunk must not
            # launch its partial firings (recovery replays the chunk)
            self._release()
        try:
            self._flush_boundary()
        except _FusedDownstreamError as w:
            raise w.error

    def eos_flush(self, emit):
        """Channel-less step head: the source generation loop runs in
        here (runtime/node.py SourceLoopLogic), every ``step(emit)``
        call emitting one chunk into segment 0's exit.  Wrap that exit
        so each generated chunk gets the same hold -> traverse -> flush
        cycle as the channel-fed path; epoch barriers / watermarks are
        injected between steps and pass through at the boundary."""
        if not self._step_engines or source_loop_of(self) is None:
            super().eos_flush(emit)
            return
        self._emit_out = emit
        exit0 = self._exits[0]

        def step_exit(item):
            if not isinstance(item, (TupleBatch, SynthChunk)):
                exit0(item)
                return
            self.chunks_in += 1
            self._hold()
            try:
                exit0(item)
            finally:
                self._release()
            self._flush_boundary()

        try:
            for k, seg in enumerate(self.segments):
                seg.logic.eos_flush(step_exit if k == 0
                                    else self._exits[k])
        except _FusedDownstreamError as w:
            raise w.error


# ---------------------------------------------------------------------------
# the compile pass
# ---------------------------------------------------------------------------

def _logics_of(node: RtNode) -> list:
    if isinstance(node.logic, FusedLogic):
        return [s.logic for s in node.logic.segments]
    return [node.logic]


def _has_device_engine(node: RtNode) -> bool:
    return any(isinstance(lg, WinSeqTPULogic)
               and getattr(lg, "resolved_placement", "host") != "host"
               for lg in _logics_of(node))


def _foreign_tickers(node: RtNode) -> bool:
    """A ticking logic that is NOT a window engine: chunk-boundary
    flushing cannot stand in for its idle ticks, so it bars the
    source-head merge (the merged node would never tick)."""
    return any(hasattr(lg, "idle_tick")
               and not isinstance(lg, WinSeqTPULogic)
               for lg in _logics_of(node))


def _forward_dest(node: RtNode):
    """(channel,) when this node forwards everything, unmodified and in
    order, to exactly one destination channel it exclusively produces
    into.  Like fuse._single_forward_dest plus the degenerate KEYBY
    case: a KFEmitter at parallelism 1 sends every item to its one
    worker untouched, so absorbing across it is exact."""
    if len(node.outlets) != 1:
        return None
    outlet = node.outlets[0]
    em = outlet.emitter
    if type(em) is not StandardEmitter and \
            not (type(em) is KFEmitter and em.pardegree == 1):
        return None
    if len(outlet.dests) != 1:
        return None
    ch = outlet.dests[0][0]
    if ch.n_producers != 1:
        return None
    return ch


def _try_step_merge(graph, consumers: dict) -> bool:
    for a in graph._all_nodes():
        if _is_ingest_head(a) or _is_collector(a) or _is_elastic(a) \
                or _has_async_emit(a):
            continue
        ch = _forward_dest(a)
        if ch is None:
            continue
        b = consumers.get(id(ch))
        if b is None or b is a or _is_collector(b) or _is_elastic(b) \
                or _partition_splits(graph, a, b):
            continue
        if not _has_device_engine(b):
            continue
        if a.channel is None and (_foreign_tickers(a)
                                  or _foreign_tickers(b)):
            continue  # source head: merged node never idle-ticks
        _merge(graph, a, b)
        return True
    return False


def lower_device_steps(graph) -> List[str]:
    """Run the pass; returns the step node names (report)."""
    if getattr(graph.config, "opt_level", OptLevel.LEVEL2) \
            < OptLevel.LEVEL2:
        return []
    if not getattr(graph.config, "device_step", True):
        return []
    changed = True
    while changed:
        changed = _try_step_merge(graph, _consumers_by_channel(graph))
    stepped = []
    for node in graph._all_nodes():
        if isinstance(node.logic, DeviceStepLogic) \
                or not _has_device_engine(node):
            continue
        logic = DeviceStepLogic(_segments_of(node))
        logic.pool = getattr(graph, "buffer_pool", None)
        node.logic = logic
        node.error_policy = "fail"  # segments guard themselves
        node.stats = None           # per-segment records instead
        stepped.append(node.name)
    return stepped
