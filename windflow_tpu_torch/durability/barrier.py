"""Per-replica barrier mechanics: the epoch cut, the source injector
and the multi-producer aligner (docs/RESILIENCE.md "Exactly-once
epochs").

The protocol is the streaming adaptation of Chandy-Lamport snapshots
(Carbone et al., "Lightweight Asynchronous Snapshots for Distributed
Dataflows", the Flink aligned-barrier design): the coordinator
announces epoch ``e``; every source replica injects an
:class:`~windflow_tpu_torch.runtime.queues.EpochBarrier` at a generation-step
boundary after capturing its offset; the barrier rides the channels as
an ordinary item; each consumer **aligns** -- input from producers that
already delivered barrier ``e`` is held back until every producer has
-- then takes the **epoch cut**: fence in-flight device batches
(``quiesce`` hook: async-dispatcher results land downstream *before*
the barrier), seal transactional sink buffers (``epoch_mark``),
snapshot per-segment state, and forward the barrier to every outlet
destination.  The graph is never globally quiesced: each replica pauses
only for its own cut while the rest keep flowing.

Accounting: barriers travel through ``Outlet.send_to``, so the audit
plane's per-edge delivery books count them symmetrically and every edge
stays balanced by construction; the graph-wide roll-up subtracts the
per-node ``epoch_barriers_in/out`` counters (audit/ledger.py).
"""
from __future__ import annotations

import pickle
from typing import Dict

from ..runtime.queues import EpochBarrier


def iter_named_logics(node):
    """(original-node-name, logic) pairs of one runtime node, seeing
    through fusion -- the same naming contract as
    ``graph.fuse.iter_logics`` / ``utils.checkpoint.graph_state``, so
    epoch-manifest states restore into any fusion level."""
    from ..runtime.node import FusedLogic
    if isinstance(node.logic, FusedLogic):
        for seg in node.logic.segments:
            yield seg.name, seg.logic
    else:
        yield node.name, node.logic


def capture_states(node) -> Dict[str, object]:
    """Per-replica state at the barrier point, keyed by pre-fusion
    node name.  Serialized IMMEDIATELY on the replica's own thread:
    several ``state_dict`` implementations alias live stores
    (AccumulatorLogic), and the stream keeps mutating them the moment
    the cut completes.

    Values are pickled ``state_dict`` bytes -- except under
    ``DurabilityConfig(delta=True)`` for logics with the full keyed
    contract, which capture as :class:`~windflow_tpu_torch.durability.delta.
    KeyedCapture` (per-key pickled values) so the coordinator's delta
    encoder can diff them against the previous epoch's chain."""
    coord = getattr(node, "epoch_coord", None)
    delta_on = coord is not None and getattr(coord, "delta", False)
    out: Dict[str, object] = {}
    for name, logic in iter_named_logics(node):
        if delta_on:
            from .delta import KeyedCapture, keyed_capable
            if keyed_capable(logic):
                out[name] = KeyedCapture.capture(logic)
                continue
        getter = getattr(logic, "state_dict", None)
        st = getter() if getter is not None else None
        if st is not None:
            out[name] = pickle.dumps(st, protocol=pickle.HIGHEST_PROTOCOL)
    return out


def _fire_epoch_faults(node, epoch: int) -> None:
    """crash_at_epoch (resilience/faults.py): a seeded crash INSIDE the
    barrier window -- after alignment, before the cut -- deterministic
    on the epoch id, independent of stream timing."""
    from ..runtime.node import FusedLogic
    if node.faults is not None:
        node.faults.on_epoch(epoch)
    if isinstance(node.logic, FusedLogic):
        for seg in node.logic.segments:
            if seg.faults is not None:
                seg.faults.on_epoch(epoch)


def epoch_cut(node, epoch: int, coord) -> None:
    """The aligned cut on one replica: fault hook, device fence,
    transactional seal, state capture, barrier forward (or sink ack).
    Runs on the replica's own thread -- between items for consumers,
    at a generation-step boundary for sources -- so touching logic
    state is safe by the same contract as ``quiesce``."""
    _fire_epoch_faults(node, epoch)
    # fence: every in-flight device batch of THIS epoch lands (its
    # results emit downstream, pre-barrier) before the barrier passes
    # the async dispatcher -- otherwise a restored run would lose the
    # windows that were on the wire to the device at the cut.  The
    # fence emits through the node's OUTWARD path: on a fused node the
    # quiesce hook feeds downstream segments inline itself, so handing
    # it an inner-chain emit would loop the chain into itself
    q = getattr(node.logic, "quiesce", None)
    if q is not None:
        q(node._emit)
    for _name, logic in iter_named_logics(node):
        mark = getattr(logic, "epoch_mark", None)
        if mark is not None:
            mark(epoch)
    coord.add_snapshot(epoch, capture_states(node))
    if node.outlets:
        b = EpochBarrier(epoch)
        n = 0
        for o in node.outlets:
            for di in range(len(o.dests)):
                o.send_to(di, b)
                n += 1
        node.epoch_barriers_out += n
    else:
        coord.sink_ack(epoch, node.name)


def broadcast_final(node) -> None:
    """End-of-stream barrier: before a node closes its outlets it tells
    every downstream aligner that this producer will inject no further
    epochs (the aligner counts it as permanently arrived), so a
    finished branch can never stall another branch's alignment."""
    b = EpochBarrier(-1, final=True)
    for o in node.outlets:
        for di in range(len(o.dests)):
            o.send_to(di, b)
            node.epoch_barriers_out += 1


class EpochInjector:
    """Source-side barrier injection, polled at every generation-step
    boundary (SourceLoopLogic.eos_flush -- which is also the ingest
    transport poll loop).  Lock-free: reads the coordinator's monotone
    ``epoch_seq`` and catches up one epoch at a time, capturing the
    source offset for the manifest before each cut."""

    __slots__ = ("node", "coord", "last")

    def __init__(self, node, coord):
        self.node = node
        self.coord = coord
        self.last = coord.epoch_seq

    def maybe_inject(self) -> None:
        seq = self.coord.epoch_seq
        while self.last < seq:
            self.last += 1
            from ..audit.progress import source_frontier
            self.coord.source_offset(self.last, self.node.name,
                                     source_frontier(self.node))
            epoch_cut(self.node, self.last, self.coord)


class EpochAligner:
    """Multi-producer barrier alignment for one consumer node (KEYBY
    shuffles, merges, farm collectors).  Single-threaded: driven only
    by the owning node's consume loop, so no locking.

    While epoch ``e`` is aligning, items from producers that already
    delivered their ``e`` barrier are **held back** (the Flink
    alignment buffer) so the cut separates pre- from post-barrier input
    exactly; they replay in arrival order once the cut completes.
    ``final`` barriers mark a producer permanently arrived."""

    __slots__ = ("node", "coord", "n_producers", "waiting", "arrived",
                 "finished", "held", "_replay", "_draining")

    def __init__(self, node, coord, n_producers: int):
        from collections import deque
        self.node = node
        self.coord = coord
        self.n_producers = max(1, int(n_producers))
        self.waiting = None           # epoch currently aligning
        self.arrived = set()          # producer ids that delivered it
        self.finished = set()         # producers past their final barrier
        self.held = []                # [(cid, item)] parked during alignment
        self._replay = deque()        # holdback items being replayed
        self._draining = False

    @property
    def busy(self) -> bool:
        """True while an alignment is open or items are parked
        (including mid-replay) -- the drain detector and the frontier
        tracker must not call the node caught up then."""
        return (self.waiting is not None or bool(self.held)
                or bool(self._replay))

    def reset(self) -> None:
        """Abandon any open alignment and drop parked items (the
        replica supervisor's epoch abort: a crashed peer's barrier
        will never arrive, and held-back post-barrier input is
        regenerated by the source rewind).  ``finished`` producers and
        the producer count survive -- they are structural facts, not
        epoch state."""
        self.waiting = None
        self.arrived = set()
        self.held = []
        self._replay.clear()

    def offer(self, cid, item, process) -> bool:
        """Dispatch one channel item.  Returns True when the aligner
        consumed it (a barrier, or an item held back during alignment);
        False means the caller processes it normally."""
        if type(item) is not EpochBarrier:
            if self.waiting is not None and (cid in self.arrived
                                             or cid in self.finished):
                self.held.append((cid, item))
                return True
            return False
        # counted once, on arrival from the channel: a future epoch's
        # barrier parked in ``held`` re-enters _on_barrier on replay
        # without a second count, so the ledger's subtraction of
        # epoch_barriers_in matches the channel's gets exactly
        self.node.epoch_barriers_in += 1
        self._on_barrier(cid, item, process)
        return True

    def _on_barrier(self, cid, b: EpochBarrier, process) -> None:
        if b.final:
            self.finished.add(cid)
            if self.waiting is not None:
                self._maybe_complete(process)
            return
        if self.waiting is None:
            self.waiting = b.epoch
            self.arrived = {cid}
        elif b.epoch == self.waiting:
            self.arrived.add(cid)
        else:
            # a future epoch's barrier from a producer already aligned
            # for the current one (per-producer FIFO guarantees its
            # current-epoch barrier came first): park it for replay
            self.held.append((cid, b))
            return
        self._maybe_complete(process)

    def _maybe_complete(self, process) -> None:
        if len(self.arrived | self.finished) < self.n_producers:
            return
        epoch = self.waiting
        self.waiting = None
        self.arrived = set()
        held, self.held = self.held, []
        epoch_cut(self.node, epoch, self.coord)
        # replay the alignment buffer in arrival order through the
        # _replay deque, which stays visible to `busy` the whole time
        # (the frontier tracker / drain detector must never see parked
        # items as caught up).  PREPENDING keeps per-producer FIFO when
        # a nested completion lands mid-drain: its re-held items must
        # run before the remaining (later-arrived) replay items.  Only
        # the outermost frame drains -- a parked next-epoch barrier
        # re-enters offer(), may complete the next alignment, and that
        # nested call just prepends.
        self._replay.extendleft(reversed(held))
        if self._draining:
            return
        self._draining = True
        try:
            while self._replay:
                hcid, hitem = self._replay.popleft()
                if type(hitem) is EpochBarrier:
                    self._on_barrier(hcid, hitem, process)
                elif not self.offer(hcid, hitem, process):
                    process(hcid, hitem)
        finally:
            self._draining = False
