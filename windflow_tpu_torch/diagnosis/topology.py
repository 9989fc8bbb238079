"""Operator-level topology extraction for the diagnosis plane.

The stats JSON reports operators as a flat list, which is enough for
counters but not for a root-cause walk: "who feeds whom" is what turns
a set of pressured gauges into a named bottleneck.  This module reads
the *wired* graph once (channels + fused segment chains, the same
objects the auditor walks) and publishes the operator-level edge list
into the stats JSON ``Topology`` block, so the walk works identically
on a live graph, a dashboard report and an offline dump.

Edges are ``[producer_op, consumer_op, kind]`` with kind ``channel``
(a real bounded queue sits between them -- the queueing gauges apply)
or ``fused`` (LEVEL2 segments inside one replica thread -- no queue,
pressure propagates as service time).  Operator names match the stats
records (replica suffixes stripped), so gauge lookup is a dict hit.
"""
from __future__ import annotations

from typing import List

from ..audit.ledger import _op_of, unwrap


def _op_chain(node) -> List[str]:
    """The ordered operator names living inside one runtime node: the
    fused segment chain, or the single operator itself."""
    from ..runtime.node import FusedLogic
    if isinstance(node.logic, FusedLogic):
        return [_op_of(seg.name) for seg in node.logic.segments]
    return [_op_of(node.name)]


def operator_edges(graph) -> List[List[str]]:
    """Operator-level edge list of the wired graph.  Stable across
    elastic rescales (replica counts change, operators do not)."""
    nodes = graph._all_nodes()
    owner = {}
    for n in nodes:
        if n.channel is not None:
            owner[id(unwrap(n.channel))] = n
    seen = set()
    edges: List[List[str]] = []

    def add(a: str, b: str, kind: str) -> None:
        if a != b and (a, b) not in seen:
            seen.add((a, b))
            edges.append([a, b, kind])

    for n in nodes:
        chain = _op_chain(n)
        for a, b in zip(chain, chain[1:]):
            add(a, b, "fused")
        for o in n.outlets:
            for ch, _pid in o.dests:
                c = owner.get(id(unwrap(ch)))
                if c is None or c is n:
                    continue
                add(chain[-1], _op_chain(c)[0], "channel")
    # distributed plane (distributed/wiring.py): cross-worker edges --
    # the consumer lives in another process, so the channel walk above
    # cannot see it; the wiring recorded the operator pair instead.
    # Kind "wire": no local queue, pressure propagates through the
    # credit window.
    for a, b, kind in getattr(graph, "_wire_topology", ()):
        add(a, b, kind)
    return edges


def ancestors_of(edges, start: str) -> set:
    """Every operator upstream of ``start`` (inclusive) over the edge
    list -- the candidate set of a per-sink bottleneck walk."""
    preds = {}
    for a, b, _k in edges:
        preds.setdefault(b, []).append(a)
    out = {start}
    stack = [start]
    while stack:
        for p in preds.get(stack.pop(), ()):
            if p not in out:
                out.add(p)
                stack.append(p)
    return out


def depth_ranks(edges) -> dict:
    """Longest-path-from-root rank per operator (the web UI's layout
    rule): higher rank == more downstream.  Used to pick the most
    downstream pressured operator when backpressure cascades."""
    rank = {}
    names = {n for e in edges for n in e[:2]}
    for name in names:
        rank.setdefault(name, 0)
    for _ in range(len(names) + 1):
        changed = False
        for a, b, _k in edges:
            if rank[b] < rank[a] + 1:
                rank[b] = rank[a] + 1
                changed = True
        if not changed:
            break
    return rank


def sinks_of(edges, operators) -> List[str]:
    """Operators with no outgoing edge (falls back to the last listed
    operator when the dump carries no topology)."""
    outs = {a for a, _b, _k in edges}
    named = [op for op in operators if op not in outs] if edges else []
    if named:
        return named
    return list(operators)[-1:]


def sources_of(edges, operators) -> List[str]:
    ins = {b for _a, b, _k in edges}
    named = [op for op in operators if op not in ins] if edges else []
    if named:
        return named
    return list(operators)[:1]
