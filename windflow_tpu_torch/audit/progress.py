"""Progress/frontier tracking: Naiad-style low-watermarks over the
wired graph, computed passively from counters the runtime already
keeps (docs/OBSERVABILITY.md "Progress tracking").

Each source replica publishes a monotone **frontier** -- its transport
position (``NodeLogic.progress_frontier``: replay offset, socket raw
tuples, synth index) or, generically, the items it has shipped into
its outlet channels (the ledger's intent book, so no extra hot-path
counter exists).  Operators inherit the min over their inputs as a
**low-watermark**, but only advance it at instants where they are
provably caught up (empty inbound channel and between items:
``depth == 0 and taken == done``); otherwise the watermark holds and
its age becomes ``Frontier_lag_ms``.  Fused nodes are one consumer
(segments share the node's watermark); KEYBY shuffles are ordinary
multi-producer edges, so min-over-inputs covers them naturally.

The **stalled-frontier detector** flags an operator whose watermark
has not advanced for ``RuntimeConfig.frontier_stall_s`` while work is
pending (backlog or upstream ahead) and its own completion counter is
frozen -- the "could advance but does not" condition, distinct from
mere load (a busy-but-progressing operator re-stamps ``done`` every
pass and is never flagged).  Stalls are recorded once per episode as
``frontier_stall`` flight-recorder events and feed the watchdog's
stall report.
"""
from __future__ import annotations

import time as _time
from typing import Dict, List, Optional

from .ledger import unwrap


def source_frontier(node) -> float:
    """The monotone position of a source node: the logic's own
    ``progress_frontier`` hook when it defines one (seen through
    fusion/chaining wrappers), else the ledger intent book."""
    from ..runtime.node import ChainedLogic, FusedLogic
    logic = node.logic
    while True:
        if isinstance(logic, FusedLogic):
            logic = logic.segments[0].logic
        elif isinstance(logic, ChainedLogic):
            logic = logic.a
        else:
            break
    probe = getattr(logic, "progress_frontier", None)
    if probe is not None:
        try:
            v = probe()
        except (RuntimeError, TypeError):
            v = None
        if v is not None:
            return float(v)
    total = 0
    for o in node.outlets:
        cells = o.audit_cells
        if cells:
            total += sum(c.sent for c in cells)
    return float(total)


def watermark_of(source) -> float:
    """The current EVENT-TIME promise of a source (eventtime/;
    docs/EVENTTIME.md) -- distinct from the transport frontier above,
    which counts items, not event time.

    Accepts a :class:`~windflow_tpu_torch.eventtime.watermarks.
    WatermarkedSource` (or anything exposing ``current_watermark``),
    a running RtNode (its last min-merged outbound watermark), or any
    node as a fallback through :func:`source_frontier`.  Returns
    ``-inf`` before the first promise."""
    wm = getattr(source, "current_watermark", None)
    if wm is not None:
        return float(wm)
    out = getattr(source, "_wm_out_ts", None)
    if out is not None and out > float("-inf"):
        return float(out)
    if hasattr(source, "outlets"):
        return source_frontier(source)
    return float("-inf")


class _Progress:
    __slots__ = ("wm", "wm_t", "last_done", "stall_reported")

    def __init__(self, now: float):
        self.wm = 0.0
        self.wm_t = now
        self.last_done = -1
        self.stall_reported = False


class FrontierTracker:
    """Per-graph watermark state across audit passes."""

    def __init__(self, stall_s: float):
        self.stall_s = stall_s
        self._state: Dict[str, _Progress] = {}
        # latest per-node view: name -> {frontier, lag_ms, stalled}
        self.frontiers: Dict[str, dict] = {}

    def update(self, nodes, now: Optional[float] = None) -> List[dict]:
        """One propagation pass; returns NEW stall events."""
        if now is None:
            now = _time.monotonic()
        # producer adjacency over the live topology (rebuilt per pass:
        # elastic rescales rewire channels at runtime)
        owner = {}
        for n in nodes:
            if n.channel is not None:
                owner[id(unwrap(n.channel))] = n
        producers: Dict[int, List] = {id(n): [] for n in nodes}
        indeg: Dict[int, int] = {id(n): 0 for n in nodes}
        consumers_of: Dict[int, List] = {id(n): [] for n in nodes}
        for n in nodes:
            seen = set()
            for o in n.outlets:
                for ch, _pid in o.dests:
                    c = owner.get(id(unwrap(ch)))
                    if c is None or id(c) in seen or c is n:
                        continue
                    seen.add(id(c))
                    producers[id(c)].append(n)
                    consumers_of[id(n)].append(c)
                    indeg[id(c)] += 1
        # Kahn topological order (the wired graph is a DAG)
        order = [n for n in nodes if indeg[id(n)] == 0]
        qi = 0
        while qi < len(order):
            n = order[qi]
            qi += 1
            for c in consumers_of[id(n)]:
                indeg[id(c)] -= 1
                if indeg[id(c)] == 0:
                    order.append(c)
        stalls: List[dict] = []
        wms: Dict[int, float] = {}
        for n in order:
            st = self._state.get(n.name)
            if st is None:
                st = self._state[n.name] = _Progress(now)
            ups = producers[id(n)]
            if n.channel is None and not ups:
                wm = source_frontier(n)
                if wm > st.wm:
                    st.wm = wm
                    st.wm_t = now
                    st.stall_reported = False
                pending = False
            else:
                cand = min((wms.get(id(p), 0.0) for p in ups),
                           default=st.wm)
                depth = getattr(n.channel, "depth", 0) \
                    if n.channel is not None else 0
                # durability plane: items parked in a barrier aligner's
                # holdback buffer are unprocessed input even though
                # they were dequeued (depth 0) and never taken
                aligner = getattr(n, "epochs", None)
                caught_up = depth == 0 and n.taken == n.done \
                    and (aligner is None or not aligner.busy)
                if caught_up and cand > st.wm:
                    st.wm = cand
                    st.wm_t = now
                    st.stall_reported = False
                pending = (not caught_up) or cand > st.wm
            wms[id(n)] = st.wm
            lag_ms = (now - st.wm_t) * 1e3 if pending else 0.0
            done = n.done
            if (pending and not st.stall_reported
                    and now - st.wm_t > self.stall_s
                    and done == st.last_done and n.is_alive()):
                st.stall_reported = True
                stalls.append({"node": n.name,
                               "frontier": round(st.wm, 1),
                               "lag_ms": round(lag_ms, 1)})
            st.last_done = done
            self.frontiers[n.name] = {
                "frontier": st.wm,
                "lag_ms": lag_ms,
                "stalled": st.stall_reported,
            }
            # gauge export: the replica's stats record (fused nodes
            # attribute to their first segment, like refresh_gauges)
            rec = n.stats
            if rec is None:
                segs = getattr(n.logic, "segments", None)
                if segs:
                    rec = segs[0].stats
            if rec is not None:
                rec.frontier = st.wm
                rec.frontier_lag_ms = lag_ms
        return stalls
