"""Flow-conservation ledger: per-edge delivery books and the checks
that prove them (docs/OBSERVABILITY.md "Audit plane").

The runtime already counts per-channel ``puts``/``gets``/``depth`` on
both channel planes (runtime/queues.py:71-74, runtime/native.py:206-210,
forwarded by the CreditedChannel proxies).  This module promotes those
counters into a two-book ledger per edge:

* the **producer book** lives in :class:`EdgeCell` objects attached to
  every Outlet destination: ``sent`` is incremented immediately before
  the channel ``put`` (the intent), ``delivered`` immediately after it
  returns, and ``inflight`` is True in between.  Cells are written only
  by the node's single emitting thread, so plain int adds suffice and
  ``sent - delivered`` is exactly the one item currently mid-put (or a
  bulk run mid-``put_many``) -- anything more is a lost delivery.
* the **channel book** is the channel's own ``puts`` counter plus the
  consumer side (``gets`` + residual ``depth``).

The per-edge conservation equation the auditor proves online (and
exactly at ``wait_end``)::

    sum(sent) == sum(delivered) == puts == gets + depth      (per edge)

which composes graph-wide into the ledger identity::

    sources_emitted == sinks_consumed + dead_letters + sheds + in_flight

for the transport plane (operator-level expansion/absorption -- maps,
filters, window folds -- happens *inside* nodes, between edges, and is
accounted by the per-node ``taken``/``done``/shed/dead-letter
counters).

False-positive discipline: every online rule is gated on the
``inflight`` flags, so a producer legitimately blocked mid-put (full
channel, exhausted credits, a descheduled thread) is never reported;
an injected ``drop_put``/``dup_put`` fault (resilience/faults.py)
diverges the two books permanently and is flagged on the first audit
pass that observes the edge quiet (in practice: within one interval).
"""
from __future__ import annotations

import time as _time
from typing import Dict, List, Optional

# per-edge rows kept in the stats-JSON Conservation block
MAX_EDGE_ROWS = 64
# violations kept in the block (the full list stays on the auditor)
MAX_VIOLATION_ROWS = 32


class EdgeCell:
    """Producer-side delivery books for one (outlet, destination) pair.
    Single-writer (the owning node's emitting thread); read lock-free
    by the auditor."""

    __slots__ = ("sent", "delivered", "inflight")

    def __init__(self):
        self.sent = 0
        self.delivered = 0
        self.inflight = False


def unwrap(ch):
    """The raw channel under a CreditedChannel proxy (the ledger keys
    edges by the physical channel; producers may hold the proxy while
    the consumer holds the same proxy object, or vice versa)."""
    return getattr(ch, "inner", ch)


class _Edge:
    """One audit pass's view of a channel edge."""

    __slots__ = ("key", "channel", "consumer", "cells")

    def __init__(self, key, channel, consumer):
        self.key = key
        self.channel = channel
        self.consumer = consumer          # RtNode or None (untracked)
        self.cells = []                   # (producer RtNode, EdgeCell)


def _op_of(node_name: str) -> str:
    """Operator name of a replica node name ('pipe0/map.1' -> 'pipe0/map')."""
    head, _, tail = node_name.rpartition(".")
    return head if head and tail.isdigit() else node_name


class FlowLedger:
    """Owns cell attachment, the per-pass topology snapshot and the
    conservation checks.  One per GraphAuditor."""

    def __init__(self, graph):
        self.graph = graph
        # channel-key -> (delivered, sent, producers) folded from
        # retired elastic replicas (their cells leave the topology when
        # the rescale removes the node, but the channel's cumulative
        # puts keep their history)
        self.retired: Dict[int, List[int]] = {}
        # deliveries a SOURCE node made into channels that later left
        # the topology (scale-down trims the upstream fan-out): the
        # graph-wide Sources_emitted roll-up must keep counting them
        self.retired_source_sent = 0
        # report-once state: (id(cell)|edge key, kind) -> count reported
        self._reported: Dict[tuple, int] = {}

    # -- attachment ----------------------------------------------------
    def attach_node(self, node) -> None:
        """Give every outlet destination of ``node`` a fresh EdgeCell.
        (Put-fault binding is the runtime's job --
        ``RtNode.bind_outlet_faults`` -- so an injected drop_put /
        dup_put fires with or without the ledger books.)"""
        for o in node.outlets:
            if o.audit_cells is None:
                o.audit_cells = [EdgeCell() for _ in o.dests]
            elif len(o.audit_cells) != len(o.dests):
                # defensive: align after an unmirrored dests mutation
                while len(o.audit_cells) < len(o.dests):
                    o.audit_cells.append(EdgeCell())
                del o.audit_cells[len(o.dests):]

    def fold_trimmed(self, outlet, cells) -> None:
        """Scale-down trims ``outlet.dests[new_n:]``: the trimmed
        edges vanish with their (drained) channels, but a source's
        deliveries into them stay part of Sources_emitted."""
        for n in self.graph._all_nodes():
            if outlet in n.outlets:
                if n.channel is None:
                    self.retired_source_sent += sum(c.sent
                                                    for c in cells)
                return

    def fold_retired(self, node) -> None:
        """Fold a retiring replica's delivery books into the per-channel
        retired ledger before the rescale drops the node from the
        topology -- without this, every scale-down would leave
        ``puts > sum(delivered)`` on the downstream edges forever (a
        false duplication)."""
        for o in node.outlets:
            cells = o.audit_cells
            if cells is None:
                continue
            for (ch, _pid), cell in zip(o.dests, cells):
                raw = unwrap(ch)
                # the 4th slot PINS the channel object: entries are
                # keyed by id(), and a freed channel's address could
                # otherwise be reused by a later rescale's fresh
                # channel, which would inherit the dead books
                acc = self.retired.setdefault(id(raw), [0, 0, 0, raw])
                acc[0] += cell.delivered
                acc[1] += cell.sent
                acc[2] += 1

    # -- topology snapshot ---------------------------------------------
    def edges(self, nodes=None) -> List[_Edge]:
        graph = self.graph
        if nodes is None:
            nodes = graph._all_nodes()
        owner = {}
        for n in nodes:
            if n.channel is not None:
                owner[id(unwrap(n.channel))] = n
        table: Dict[int, _Edge] = {}
        for n in nodes:
            for o in n.outlets:
                cells = o.audit_cells
                if cells is None:
                    continue
                for di, (ch, _pid) in enumerate(o.dests):
                    if di >= len(cells):
                        continue  # mid-rescale append; next pass sees it
                    k = id(unwrap(ch))
                    e = table.get(k)
                    if e is None:
                        e = table[k] = _Edge(k, ch, owner.get(k))
                    e.cells.append((n, cells[di]))
        return list(table.values())

    # -- checks --------------------------------------------------------
    def _edge_name(self, edge: _Edge) -> str:
        if edge.consumer is not None:
            return edge.consumer.name
        # distributed plane: a wire sender names its edge after the
        # remote consumer it feeds (distributed/transport.py)
        name = getattr(edge.channel, "edge_name", None)
        if name is not None:
            return name
        return f"channel@{edge.key:x}"

    def _report(self, key: tuple, count: int, make) -> Optional[dict]:
        """Report-once-per-level: a violation is (re-)emitted only when
        its count grows past what was already reported."""
        prev = self._reported.get(key, 0)
        if count <= prev:
            return None
        self._reported[key] = count
        v = make(count)
        v["at"] = round(_time.time(), 6)
        return v

    def check_pass(self, edges: List[_Edge]) -> List[dict]:
        """One online conservation pass; returns NEW violations."""
        out: List[dict] = []
        for edge in edges:
            ch = edge.channel
            name = self._edge_name(edge)
            # channel book FIRST (an enqueue between the two reads can
            # only make P stale-low, never inflate the dup gap)
            puts = getattr(ch, "puts", 0)
            delivered = sent = 0
            any_inflight = False
            for prod, cell in edge.cells:
                # read order is load-bearing: sent, THEN inflight, THEN
                # delivered.  The producer's cycle is inflight=True ->
                # sent++ -> put -> delivered++ -> inflight=False, so an
                # inflight==False read proves every cycle counted in
                # the earlier `sent` read has its delivered increment
                # visible to the LATER `delivered` read -- the gap can
                # only understate, never invent, a drop.  (Reading
                # delivered first would let a full producer cycle slip
                # between the reads and mint a permanent false
                # positive.)
                s = cell.sent
                infl = cell.inflight
                d = cell.delivered
                delivered += d
                sent += s
                any_inflight = any_inflight or infl
                gap = s - d
                if gap > 0 and not infl:
                    # the emitting thread is not mid-put, so the gap is
                    # not in transit: those deliveries were dropped
                    v = self._report(
                        (id(cell), "lost"), gap,
                        lambda c, _p=prod.name: {
                            "kind": "lost_delivery", "edge": name,
                            "producer": _p, "count": c})
                    if v is not None:
                        out.append(v)
            r = self.retired.get(edge.key)
            if r is not None:
                delivered += r[0]
                sent += r[1]
            n_prod = getattr(ch, "n_producers", None)
            covered = (n_prod is not None
                       and len(edge.cells) + (r[2] if r else 0) == n_prod)
            extra = puts - delivered
            if covered and extra > 0 and not any_inflight:
                v = self._report(
                    (edge.key, "extra"), extra,
                    lambda c: {"kind": "extra_delivery", "edge": name,
                               "count": c})
                if v is not None:
                    out.append(v)
        return out

    def final_check(self, edges: List[_Edge]) -> List[dict]:
        """Exact closure at a cleanly-ended graph: every thread joined,
        nothing in flight -- the books must balance to the tuple."""
        out: List[dict] = []
        for edge in edges:
            ch = edge.channel
            name = self._edge_name(edge)
            puts = getattr(ch, "puts", 0)
            gets = getattr(ch, "gets", 0)
            try:
                depth = ch.qsize()
            except (OSError, RuntimeError):
                depth = 0
            delivered = sent = 0
            for prod, cell in edge.cells:
                delivered += cell.delivered
                sent += cell.sent
                gap = cell.sent - cell.delivered
                if gap > 0:
                    v = self._report(
                        (id(cell), "lost"), gap,
                        lambda c, _p=prod.name: {
                            "kind": "lost_delivery", "edge": name,
                            "producer": _p, "count": c, "final": True})
                    if v is not None:
                        out.append(v)
            r = self.retired.get(edge.key)
            if r is not None:
                delivered += r[0]
                sent += r[1]
            n_prod = getattr(ch, "n_producers", None)
            covered = (n_prod is not None
                       and len(edge.cells) + (r[2] if r else 0) == n_prod)
            if covered and puts != delivered:
                kind = ("extra_delivery" if puts > delivered
                        else "channel_mismatch")
                v = self._report(
                    (edge.key, "extra"), abs(puts - delivered),
                    lambda c, _k=kind: {"kind": _k, "edge": name,
                                        "count": c, "final": True})
                if v is not None:
                    out.append(v)
            if depth != 0:
                v = self._report(
                    (edge.key, "residual"), depth,
                    lambda c: {"kind": "residual_items", "edge": name,
                               "count": c, "final": True})
                if v is not None:
                    out.append(v)
            elif gets + depth != puts:
                v = self._report(
                    (edge.key, "consumer"), abs(puts - gets - depth),
                    lambda c: {"kind": "consumer_loss", "edge": name,
                               "count": c, "final": True})
                if v is not None:
                    out.append(v)
        return out

    # -- reporting -----------------------------------------------------
    def conservation_block(self, edges: List[_Edge], nodes,
                           violations: List[dict], passes: int,
                           final: bool) -> dict:
        """The stats-JSON ``Conservation`` block: per-edge rows + the
        graph-wide ledger identity inputs."""
        graph = self.graph
        # rows are built for EVERY edge (the balance summary must not
        # depend on serialization truncation); only the first
        # MAX_EDGE_ROWS ship in the JSON
        rows = []
        for edge in edges:
            ch = edge.channel
            puts = getattr(ch, "puts", 0)
            gets = getattr(ch, "gets", 0)
            depth = getattr(ch, "depth", 0)
            delivered = sum(c.delivered for _n, c in edge.cells)
            sent = sum(c.sent for _n, c in edge.cells)
            r = self.retired.get(edge.key)
            if r is not None:
                delivered += r[0]
                sent += r[1]
            rows.append({
                "edge": self._edge_name(edge),
                "producers": len(edge.cells),
                "sent": sent, "delivered": delivered,
                "enqueued": puts, "dequeued": gets, "depth": depth,
                "balanced": (sent == delivered == puts
                             == gets + depth),
            })
        sources_emitted = self.retired_source_sent
        sinks_consumed = 0
        processing = 0
        device_batches = 0
        for n in nodes:
            if n.channel is None:
                for o in n.outlets:
                    if o.audit_cells:
                        sources_emitted += sum(c.sent
                                               for c in o.audit_cells)
                # durability plane: epoch barriers ride the same outlet
                # send path (so per-edge books balance by construction)
                # but are control items, not stream tuples -- the
                # graph-wide identity subtracts them on both ends
                sources_emitted -= getattr(n, "epoch_barriers_out", 0)
                # event-time plane: watermarks ride the same outlet
                # send path as barriers and get the same subtraction
                sources_emitted -= getattr(n, "watermarks_out", 0)
            elif not n.outlets:
                sinks_consumed += getattr(n.channel, "gets", 0)
                sinks_consumed -= getattr(n, "epoch_barriers_in", 0)
                sinks_consumed -= getattr(n, "watermarks_in", 0)
            processing += max(0, n.taken - n.done)
            probe = getattr(n.logic, "audit_in_flight", None)
            if probe is not None:
                try:
                    device_batches += int(probe().get("device_batches", 0))
                except (RuntimeError, TypeError, ValueError):
                    pass
        depth_total = sum(row["depth"] for row in rows)
        return {
            "Violations_total": len(violations),
            "Violations": violations[-MAX_VIOLATION_ROWS:],
            "Edges": rows[:MAX_EDGE_ROWS],
            "Edges_total": len(edges),
            "Edges_balanced": all(row["balanced"] for row in rows),
            "Sources_emitted": sources_emitted,
            "Sinks_consumed": sinks_consumed,
            "In_flight": {"channels": depth_total,
                          "processing": processing,
                          "device_batches": device_batches},
            "Shed_tuples": sum(
                r.tuples_shed
                for rs in list(graph.stats.records.values())
                for r in rs),
            "Dead_letters": graph.dead_letters.count(),
            "Audit_passes": passes,
            "Final_check": final,
        }
