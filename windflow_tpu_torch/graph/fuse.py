"""Graph compile pass: automatic stage fusion (OptLevel.LEVEL2).

Runs inside ``PipeGraph.start`` on the fully wired RtNode/channel graph,
before any thread starts and before the ingest plane wraps channels in
credit proxies.  It realizes what the reference does with ``ff_comb``
thread fusion at opt-level 2 (multipipe.hpp:345-390, the
``optimize_PaneFarm`` fusion of pane_farm.hpp:222-250), but graph-wide
and automatic: maximal runs of adjacent stages collapse into single
replica threads whose segments feed each other inline, removing the
channel hop (one condition-variable round trip per item) between them.

Two shapes fuse, to a fixpoint:

1. **Linear (1:1)** -- node A's only outlet is a plain StandardEmitter
   with ONE destination channel, that channel has A as its ONLY
   producer, and its consumer B is an ordinary replica.  A absorbs B.
   This is exact: B received precisely A's emissions, in order, with
   channel_id 0.
2. **Parallel stage pattern (n:n)** -- n tails each round-robin a
   non-keyed FORWARD StandardEmitter over the same n consumer channels
   (same parallelism).  Tail i absorbs consumer i pairwise.  Item ->
   replica assignment changes from round-robin interleave to 1:1, which
   is unobservable for FORWARD stages (their consumers already receive
   arbitrary interleavings); the output multiset is unchanged.

Never fused:

* ordering/K-slack collectors (``OrderingLogic``/``KSlackLogic``) and
  farm collector nodes -- the "collector-free" rule: their channel_id /
  merge semantics are the channel's;
* ingest sources (``IngestSourceLogic``) as the absorbing head -- their
  outlet channel is the credit-accounting boundary (ingest/wiring.py
  wraps it after this pass runs);
* anything routed by a non-Standard emitter (broadcast, splitting,
  tree, window multicast) or with multiple outlets.

Contracts preserved per fused segment (see runtime.node.FusedLogic):
error policy + dead-letter attribution, fault-injection clocks
(a FaultPlan targeting a fused-away operator still fires), per-operator
stats records, quiesce/checkpoint (snapshots stay keyed by the original
node names, so they restore across fusion-level changes).
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Tuple

from ..core.basic import OptLevel
from ..runtime.emitters import StandardEmitter
from ..runtime.node import FusedLogic, FusedSegment, RtNode
from ..runtime.ordering import KSlackLogic, OrderingLogic


def _is_collector(node: RtNode) -> bool:
    # structural flag set by multipipe._append_stage at wiring; the
    # logic-type check is defense in depth for collectors wired by
    # other paths
    return getattr(node, "is_collector", False) \
        or isinstance(node.logic, (OrderingLogic, KSlackLogic))


def _is_elastic(node: RtNode) -> bool:
    # elastic replicas (elastic/rescale.py) are a fusion barrier like
    # the ingest credit boundary: the rescale protocol rebuilds replica
    # threads and rewires their channels at runtime, which requires the
    # operator's nodes to stay their own threads with their own
    # channels.  Supervised replicas (durability/supervision.py) are
    # barred for the same reason: the supervisor rebuilds a crashed
    # replica in place, reusing its channel and outlets.
    return getattr(node, "elastic_group", None) is not None \
        or getattr(node, "supervised_group", None) is not None


def _partition_splits(graph, a: RtNode, b: RtNode) -> bool:
    """Distributed-runtime fusion barrier (distributed/partition.py):
    a fused node runs as ONE replica thread in ONE worker process, so
    two nodes the partition plan assigns to different workers must not
    fuse -- the edge between them is exactly the cut the shuffle
    transport carries.  No-op outside distributed runs (plan absent)."""
    plan = getattr(graph, "_dist_plan", None)
    if plan is None:
        return False
    from ..distributed.partition import node_owner
    try:
        return node_owner(a, plan) != node_owner(b, plan)
    except KeyError:
        return False  # node outside the plan (defensive): fuse freely


def _is_ingest_head(node: RtNode) -> bool:
    try:
        from ..ingest.sources import IngestSourceLogic
    except ImportError:  # pragma: no cover - ingest plane always present
        return False
    logic = node.logic
    if isinstance(logic, FusedLogic):
        logic = logic.segments[0].logic
    return isinstance(logic, IngestSourceLogic)


def _segments_of(node: RtNode) -> List[FusedSegment]:
    if isinstance(node.logic, FusedLogic):
        return node.logic.segments
    seg = FusedSegment(node.logic, node.name, node.error_policy)
    seg.stats = node.stats  # keep the operator's registered record:
    #                         monitoring attribution survives fusion
    return [seg]


def _has_idle_tick(node: RtNode) -> bool:
    logic = node.logic
    if isinstance(logic, FusedLogic):
        return any(hasattr(s.logic, "idle_tick") for s in logic.segments)
    return hasattr(logic, "idle_tick")


def _has_async_emit(node: RtNode) -> bool:
    logic = node.logic
    if isinstance(logic, FusedLogic):
        return not logic.sync_emit
    return not getattr(logic, "sync_emit", True)


def _tick_safe(a: RtNode, b: RtNode) -> bool:
    """Idle ticks (time-bounded device launches on stalled streams) are
    driven by the consuming node's timed channel gets, on the consume
    thread.  Two shapes would break that contract:

    * a SOURCE head absorbing a ticking logic -- the fused node has no
      channel, so ticks never fire and a stalled source withholds
      fired windows;
    * an ASYNC-emitting segment (device engine dispatcher) upstream of
      a ticking one -- the downstream segment's svc would run on the
      dispatcher thread while its idle_tick runs on the consume
      thread, racing on unsynchronized engine state (at LEVEL0 the
      downstream node's channel serialized both).

    Keep such consumers on their own thread.  (Async upstream of a
    NON-ticking segment is fine: all its svc calls serialize on the
    dispatcher thread, and eos_flush runs after the dispatcher join.)"""
    if not _has_idle_tick(b):
        return True
    return a.channel is not None and not _has_async_emit(a)


def _single_forward_dest(node: RtNode):
    """(channel, outlet) when this node forwards everything to exactly
    one destination channel it exclusively produces into."""
    if len(node.outlets) != 1:
        return None
    outlet = node.outlets[0]
    if type(outlet.emitter) is not StandardEmitter:
        return None
    if len(outlet.dests) != 1:
        return None
    ch = outlet.dests[0][0]
    if ch.n_producers != 1:
        return None
    return ch, outlet


def _merge(graph, a: RtNode, b: RtNode) -> None:
    """Fuse consumer ``b`` into producer ``a`` (both unstarted)."""
    segments = _segments_of(a) + _segments_of(b)
    fused = FusedLogic(segments)
    fused.pool = getattr(graph, "buffer_pool", None)
    a.logic = fused
    a.outlets = b.outlets
    # the fused node reports under a joined name; per-segment identity
    # (policies, stats, faults, checkpoint keys) stays on the segments
    a.name = f"{a.name}+{b.name.rsplit('/', 1)[-1]}"
    a.error_policy = "fail"  # segments guard themselves
    a.stats = None           # per-segment records instead
    for pipe in graph.pipes:
        if b in pipe.nodes:
            pipe.nodes.remove(b)
        if b in pipe.tails:
            pipe.tails[pipe.tails.index(b)] = a


def _consumers_by_channel(graph) -> dict:
    return {id(n.channel): n for n in graph._all_nodes()
            if n.channel is not None}


def _try_linear(graph, consumers: dict) -> bool:
    for a in graph._all_nodes():
        if _is_ingest_head(a) or _is_collector(a) or _is_elastic(a):
            continue
        sfd = _single_forward_dest(a)
        if sfd is None:
            continue
        ch, _outlet = sfd
        b = consumers.get(id(ch))
        if b is None or b is a or _is_collector(b) or _is_elastic(b) \
                or not _tick_safe(a, b) or _partition_splits(graph, a, b):
            continue
        _merge(graph, a, b)
        return True
    return False


def _try_stage_pattern(graph, consumers: dict) -> bool:
    """n:n FORWARD fusion: n tails round-robining over the same n
    channels pair off with the n consumers."""
    nodes = graph._all_nodes()
    # group candidate producers by their (identical) destination set
    groups: dict = {}
    for a in nodes:
        if _is_ingest_head(a) or _is_collector(a) or _is_elastic(a):
            continue
        if len(a.outlets) != 1:
            continue
        outlet = a.outlets[0]
        em = outlet.emitter
        if type(em) is not StandardEmitter or em.keyed:
            continue
        if len(outlet.dests) < 2:
            continue
        key = tuple(id(ch) for ch, _pid in outlet.dests)
        groups.setdefault(key, []).append(a)
    for key, producers in groups.items():
        n = len(key)
        if len(producers) != n:
            continue
        chans = [producers[0].outlets[0].dests[i][0] for i in range(n)]
        if any(ch.n_producers != n for ch in chans):
            continue  # someone else also feeds these consumers
        cons = [consumers.get(cid) for cid in key]
        if any(c is None or _is_collector(c) or _is_elastic(c)
               for c in cons):
            continue
        if len({id(c) for c in cons}) != n or \
                any(c in producers for c in cons):
            continue
        if any(not _tick_safe(a, b) for a, b in zip(producers, cons)):
            continue
        if any(_partition_splits(graph, a, b)
               for a, b in zip(producers, cons)):
            continue
        for a, b in zip(producers, cons):
            a.outlets = []      # drop the fan-out wiring first
            _merge(graph, a, b)
        return True
    return False


def fuse_graph(graph) -> List[str]:
    """Run the compile pass; returns the fused node names (report)."""
    if getattr(graph.config, "opt_level", OptLevel.LEVEL2) \
            < OptLevel.LEVEL2:
        return []
    changed = True
    while changed:
        consumers = _consumers_by_channel(graph)
        changed = _try_linear(graph, consumers)
        if not changed:
            changed = _try_stage_pattern(graph, consumers)
    return [n.name for n in graph._all_nodes()
            if isinstance(n.logic, FusedLogic)]


# ---------------------------------------------------------------------------
# Introspection helpers: fusion-transparent logic lookup (tests, wiring,
# checkpoint all need "the WinSeqTPULogic of this graph" regardless of
# whether the pass folded it into a neighbour).
# ---------------------------------------------------------------------------

def iter_logics(graph) -> Iterator[Tuple[str, object]]:
    """Yield (original_node_name, logic) for every operator replica,
    seeing through FusedLogic wrappers."""
    for node in graph._all_nodes():
        if isinstance(node.logic, FusedLogic):
            for seg in node.logic.segments:
                yield seg.name, seg.logic
        else:
            yield node.name, node.logic


def find_logic(graph, pred: Callable[[object], bool],
               name_substr: str = "") -> Optional[object]:
    """First replica logic matching ``pred`` (and, optionally, whose
    original node name contains ``name_substr``)."""
    for name, logic in iter_logics(graph):
        if name_substr in name and pred(logic):
            return logic
    return None
