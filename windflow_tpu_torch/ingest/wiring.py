"""Graph-start wiring of the ingest plane (called by PipeGraph.start).

Four jobs, all cross-layer and therefore done here rather than inside
any single module:

1. every ingest source replica learns its runtime identity (node name,
   CancelToken, DeadLetterStore) and inherits the graph's
   ``latency_target_ms`` unless the builder set its own;
2. the source's outlet channels are wrapped in
   :class:`~.credits.CreditedChannel` proxies (consumer side too), so
   downstream ``get``s return credits to the emitting replica's gate;
3. gates and stages register with the CancelToken -- cancellation must
   unblock a source stuck in ``acquire`` or a full stage, not just in
   channel ops;
4. directly-fed device window engines are bound to the microbatch
   controller (launch-delay steering) and, when the combine is
   provably pane-decomposable, the coalescer gets a
   :class:`~.coalesce.PanePreReducer` ("ship partials, not tuples" at
   the ingest boundary).
"""
from __future__ import annotations

import math
from typing import Dict, List

from ..core.basic import Mode, Role, WinType
from .coalesce import PanePreReducer
from .credits import CreditedChannel
from .sources import IngestSourceLogic

# pane pre-reduction only pays once a pane spans this many tuples
MIN_PREREDUCE_PANE = 16


def wire_ingest(graph) -> None:
    nodes = graph._all_nodes()
    ingest_nodes = [n for n in nodes
                    if isinstance(n.logic, IngestSourceLogic)]
    if not ingest_nodes:
        return
    cfg = graph.config
    proxies: Dict[int, CreditedChannel] = {}
    for n in ingest_nodes:
        logic = n.logic
        logic.node_name = n.name
        logic.cancel_token = graph._cancel
        logic.dead_letters = graph.dead_letters
        if logic.controller.latency_target_ms is None \
                and cfg.latency_target_ms:
            logic.controller.latency_target_ms = cfg.latency_target_ms
        if not logic.credits_explicit \
                and cfg.ingest_credits != logic.gate.budget:
            logic.gate.resize(cfg.ingest_credits)
            logic.coalescer.stage_cap = cfg.ingest_credits
            # the AIMD ceiling was derived from the default budget at
            # logic init; track the configured one
            logic.controller.set_max_batch(
                max(cfg.ingest_credits, logic.controller.max_batch))
        graph._cancel.register(logic.gate)
        graph._cancel.register(logic.coalescer)
        consumers: Dict[int, object] = {}
        for outlet in n.outlets:
            for di, (ch, pid) in enumerate(outlet.dests):
                if getattr(ch, "is_wire_sender", False):
                    # distributed plane: a cross-worker destination has
                    # its OWN credit window spanning the socket
                    # (distributed/transport.py); the in-process proxy
                    # would starve -- its releases happen in another
                    # process
                    continue
                proxy = proxies.get(id(ch))
                if proxy is None:
                    proxy = proxies[id(ch)] = CreditedChannel(ch)
                    for cn in nodes:        # consumer reads the proxy
                        if cn.channel is ch:
                            cn.channel = proxy
                for cn in nodes:
                    if cn.channel is proxy:
                        consumers[id(cn)] = cn
                proxy.bind_gate(pid, logic.gate)
                outlet.dests[di] = (proxy, pid)
        _bind_downstream(graph, logic, list(consumers.values()))


def _bind_downstream(graph, logic: IngestSourceLogic,
                     consumers: List) -> None:
    """Controller steering + pane pre-reduction for directly-fed device
    window engines.  A consumer the LEVEL2 compile pass fused is seen
    through its FIRST segment -- that is the logic the source's items
    actually enter (later segments receive window results, not raw
    tuples, so they do not constrain granularity)."""
    from ..operators.tpu.win_seq_tpu import WinSeqTPULogic
    from ..runtime.node import FusedLogic

    def entry_logic(c):
        if isinstance(c.logic, FusedLogic):
            return c.logic.segments[0].logic
        return c.logic

    engines = [entry_logic(c) for c in consumers
               if isinstance(entry_logic(c), WinSeqTPULogic)]
    for eng in engines:
        logic.controller.bind_engine(eng)
    if logic.pre_reduce_mode in (False, None) or not consumers:
        return
    if len(engines) != len(consumers):
        return  # some consumer sees raw tuples: cannot change granularity
    if graph.mode != Mode.DEFAULT:
        return  # collectors would reorder/renumber pseudo-tuples
    if not all(_pane_sum_eligible(e) for e in engines):
        return
    panes = {math.gcd(e.win_len, e.slide_len) for e in engines}
    if len(panes) != 1:
        return
    pane = panes.pop()
    if pane < MIN_PREREDUCE_PANE:
        return
    logic.coalescer.pre_reduce = PanePreReducer(pane, bin_col="ts")


def _pane_sum_eligible(eng) -> bool:
    """True when collapsing tuples to per-pane ``sum`` partials is
    provably result-identical for this engine: pane-aligned TB window
    extents (pane divides win and slide by construction), identity
    window-id config, no renumbering/delay, and a combine for which
    pane partials are exact (sum)."""
    cfg = eng.config
    return (eng.engine.kind == "sum"
            and eng.role == Role.SEQ
            and eng.win_type == WinType.TB
            and eng.triggering_delay == 0
            and not eng.renumbering
            and cfg.n_outer == 1 and cfg.n_inner == 1
            and cfg.id_outer == 0 and cfg.id_inner == 0)
