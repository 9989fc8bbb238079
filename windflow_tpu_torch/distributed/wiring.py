"""Graph-start wiring of the distributed plane (called by
``PipeGraph.start`` when ``RuntimeConfig.distributed`` is set).

Every worker builds the full logical graph; this module then applies
the partition plan to ONE worker's copy:

1. nodes owned by other workers are pruned (their threads never start,
   their stats records leave the report);
2. every outlet destination pointing at a remote consumer is swapped
   for a :class:`~.transport.RemoteEdgeSender` (the producer ids the
   destination already registered are kept, so both sides agree on
   channel identity without negotiation);
3. a :class:`~.transport.ShuffleServer` is started when any owned
   consumer is fed from a remote worker, with the expected
   (worker, producer-id) sets derived from the same pruned wiring;
4. FaultPlan network actions bind to the transport (``drop_link`` /
   ``delay_link`` per sender, ``kill_worker`` on the worker's
   transport tuple clock), senders register with the CancelToken, and
   the durability plane learns the wire pseudo-sinks/sources so epoch
   barriers commit across the boundary.

Runs after the fusion pass (the plan is fusion-consistent by the
pass's partition barrier) and before the ingest wiring / audit
attachment, so credit proxies skip wire senders and the ledger's books
attach to the post-distribution destination set.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List

from ..audit.ledger import unwrap
from .partition import node_owner
from .transport import EdgeState, RemoteEdgeSender, ShuffleServer

# exit code of an injected kill_worker (distinct from failure=1 so the
# chaos suite can assert the kill fired, not a genuine crash)
KILL_EXIT = 17


class DistRuntime:
    """Per-worker handle on the live transport: senders, server, the
    kill_worker tuple clock and the stats-JSON ``Wire`` block."""

    def __init__(self, graph, spec, senders: Dict[str, RemoteEdgeSender],
                 server, kill_at=None):
        self.graph = graph
        self.spec = spec
        self.senders = senders
        self.server = server
        self.kill_at = kill_at
        # live cluster view (observe.py): the StatsPusher feeding the
        # coordinator's ClusterObserver, when the spec names one
        self.pusher = None
        self._lock = threading.Lock()
        self.transport_tuples = 0

    def count_transport(self, n: int) -> None:
        """The worker's transport tuple clock (sender + receiver side):
        the deterministic trigger of ``FaultPlan.kill_worker``."""
        with self._lock:
            self.transport_tuples += n
            fire = (self.kill_at is not None
                    and self.transport_tuples >= self.kill_at)
        if fire:
            self.graph.flight.record(
                "kill_worker_injected", worker=self.spec.worker_id,
                at_tuple=self.kill_at)
            os._exit(KILL_EXIT)

    def wire_block(self) -> dict:
        """The stats-JSON ``Wire`` block: producer- and consumer-side
        per-edge delivery books (the raw inputs of the cross-process
        conservation identity the merge closes)."""
        rows_in: List[dict] = []
        if self.server is not None:
            for edge in self.server.edges.values():
                rows_in.extend(edge.blocks())
        return {
            "Worker": self.spec.worker_id,
            "out": [s.block() for s in self.senders.values()],
            "in": rows_in,
            "transport_tuples": self.transport_tuples,
        }

    def stop(self, clean: bool = True) -> None:
        if clean:
            # generous but SHARED: a clean end legitimately waits out
            # a slow remote consumer draining the credit window (the
            # flush loop still exits early on poison/CANCEL), but one
            # deadline covers every sender -- K wedged edges must not
            # stack K x 60s past run_distributed's own timeout.  A
            # timeout surfaces as residual_items at the final check.
            import time as _t
            deadline = _t.monotonic() + 60.0
            for s in self.senders.values():
                s.flush(timeout=max(0.0, deadline - _t.monotonic()))
        for s in self.senders.values():
            s._close_sock()
        if self.server is not None:
            self.server.stop()
        if self.pusher is not None:
            # LAST: its stop() pushes one final frame, so the live
            # merged view carries the settled wire books
            self.pusher.stop()


def distribute_graph(graph) -> DistRuntime:
    """Apply the partition plan to this worker's copy of the graph."""
    spec = graph.config.distributed
    plan = graph._dist_plan
    me = int(spec.worker_id)
    if graph.elastic:
        # structured rejection (scheduler/errors.py): name the elastic
        # operators, the worker that owns them under the plan, and the
        # fleet-level path that DOES support elasticity -- plus a
        # sched_rejected flight event so doctor explains the refusal
        # instead of a bare traceback.
        from ..scheduler.errors import SchedulerError
        ops = sorted(graph.elastic)
        owners = sorted({node_owner(n, plan)
                         for n in graph._all_nodes()
                         if n.elastic_group in graph.elastic})
        owner = owners[0] if len(owners) == 1 else None
        hint = ("run the tenant under scheduler.FleetServer: the "
                "fleet places it WHOLE onto one worker, where rescale "
                "and the arbiter's elastic squeezes work unchanged "
                "(docs/SERVING.md 'Global scheduler')")
        graph.flight.record(
            "sched_rejected", operators=ops, worker=owner,
            workers=owners, path="scheduler.FleetServer", hint=hint)
        raise SchedulerError(
            f"distributed runtime: elastic operators {ops} are not "
            f"supported across workers (owned by worker"
            f"{'s' if len(owners) != 1 else ''} {owners}; "
            f"docs/DISTRIBUTED.md); {hint}",
            worker=owner, operators=ops, hint=hint)
    nodes = graph._all_nodes()
    owners = {id(n): node_owner(n, plan) for n in nodes}
    consumer = {}
    for n in nodes:
        if n.channel is not None:
            consumer[id(unwrap(n.channel))] = n

    if graph.config.durability is not None:
        src_owners = {owners[id(n)] for n in nodes if n.channel is None}
        if len(src_owners) > 1:
            raise RuntimeError(
                "distributed durability: all sources must live on ONE "
                f"worker (found sources on workers {sorted(src_owners)}); "
                "the epoch leader is the source worker and followers "
                "observe epochs off the wire (docs/DISTRIBUTED.md)")

    # -- pass 1: classify every edge ------------------------------------
    from ..diagnosis.topology import _op_chain
    out_pids: Dict[str, set] = {}          # edge -> local producer pids
    out_worker: Dict[str, int] = {}        # edge -> consumer's worker
    inbound: Dict[str, Dict[int, set]] = {}  # edge -> worker -> pids
    wire_edges = set()                     # (producer_op, consumer_op)
    for p in nodes:
        wp = owners[id(p)]
        for o in p.outlets:
            for ch, pid in o.dests:
                c = consumer.get(id(unwrap(ch)))
                if c is None or c is p:
                    continue
                wc = owners[id(c)]
                if wp == wc:
                    continue
                wire_edges.add((_op_chain(p)[-1], _op_chain(c)[0]))
                if wp == me:
                    out_pids.setdefault(c.name, set()).add(pid)
                    out_worker[c.name] = wc
                elif wc == me:
                    inbound.setdefault(c.name, {}).setdefault(
                        wp, set()).add(pid)

    # -- senders + dest swap --------------------------------------------
    fault_plan = getattr(graph.config, "fault_plan", None)
    kill_at = None
    if fault_plan is not None:
        kill_at = fault_plan.kill_tuple_for(me) \
            if hasattr(fault_plan, "kill_tuple_for") else None
    senders: Dict[str, RemoteEdgeSender] = {}
    runtime = DistRuntime(graph, spec, senders, None, kill_at)
    for edge, pids in out_pids.items():
        host, port = spec.endpoints[out_worker[edge]]
        s = RemoteEdgeSender(edge, host, int(port), graph, pids, spec,
                             runtime)
        if fault_plan is not None and hasattr(fault_plan, "for_link"):
            s.faults = fault_plan.for_link(edge)
        graph._cancel.register(s)
        senders[edge] = s
    for p in nodes:
        if owners[id(p)] != me:
            continue
        for o in p.outlets:
            for di, (ch, pid) in enumerate(o.dests):
                c = consumer.get(id(unwrap(ch)))
                if c is None or c is p:
                    continue
                if owners[id(c)] != me:
                    o.dests[di] = (senders[c.name], pid)

    # -- receivers -------------------------------------------------------
    server = None
    if inbound:
        by_name = {n.name: n for n in nodes}
        edges = {edge: EdgeState(edge, unwrap(by_name[edge].channel),
                                 per_worker)
                 for edge, per_worker in inbound.items()}
        server = ShuffleServer(graph, spec, edges, runtime)
        runtime.server = server
        server.start()

    # -- prune unowned nodes (threads, stats, sources) -------------------
    removed = [n for n in nodes if owners[id(n)] != me]
    removed_recs = set()
    from ..runtime.node import FusedLogic
    for n in removed:
        if n.stats is not None:
            removed_recs.add(id(n.stats))
        if isinstance(n.logic, FusedLogic):
            for seg in n.logic.segments:
                if seg.stats is not None:
                    removed_recs.add(id(seg.stats))
    for pipe in graph.pipes:
        pipe.nodes = [n for n in pipe.nodes if owners[id(n)] == me]
        pipe.tails = [t for t in pipe.tails
                      if id(t) in {id(n) for n in pipe.nodes}]
    if removed_recs:
        with graph.stats.lock:
            recs = graph.stats.records
            for op in list(recs):
                recs[op] = [r for r in recs[op]
                            if id(r) not in removed_recs]
                if not recs[op]:
                    del recs[op]

    # -- plane hooks -----------------------------------------------------
    graph.stats.worker = me
    graph._wire_out_edges = sorted(s.edge_name for s in senders.values())
    graph._wire_in_edges = sorted(f"wire:{e}" for e in inbound)
    # diagnosis topology: cross-worker operator edges (appended by
    # topology.operator_edges), so the merged report's bottleneck walk
    # crosses the boundary to a remote worker's operator
    graph._wire_topology = sorted([a, b, "wire"]
                                  for a, b in wire_edges)
    graph._dist = runtime
    # live cluster view (observe.py): push stats + flight deltas to
    # the coordinator's ClusterObserver mid-run, so the merged doctor
    # verdict is nameable without touching any stats file
    obs = getattr(spec, "observe_endpoint", None)
    if obs:
        from .observe import attach_pusher
        runtime.pusher = attach_pusher(
            graph, obs[0], int(obs[1]),
            float(getattr(spec, "push_interval_s", 0.5)))
    graph.flight.record(
        "distribute", worker=me, nodes=len(nodes) - len(removed),
        pruned=len(removed), wire_out=len(senders), wire_in=len(inbound))
    return runtime
