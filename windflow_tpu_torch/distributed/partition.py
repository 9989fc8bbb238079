"""Operator-to-worker partitioning of one logical PipeGraph
(docs/DISTRIBUTED.md "Partitioning").

Every worker process builds the SAME wired graph (the user's build
function is deterministic by contract) and runs this planner over it,
so all workers agree on ownership without shipping a plan: the plan is
a pure function of the wired topology, the ``.with_worker(i)`` pins
and the spec's assignment overrides.

The cut rule follows the fusion pass's grain: nodes connected by any
edge that is NOT a shuffle edge stay **co-located** (fused FORWARD
runs, farm collectors, broadcast/splitting/window-multicast wiring --
none of those can cross a process without changing semantics or
wasting a hop), and only KEYBY shuffle edges -- whose routing is a
pure ``hash % n`` of the item, independent of which process computes
it -- are eligible cut points.  An explicit ``.with_worker(i)`` pin
additionally cuts the edge between two differently-pinned operators
(the fusion pass refuses to fuse across such a pin for the same
reason).

Groups are assigned to workers deterministically: pinned groups go
where they point; unpinned groups go to the least-loaded worker (by
node count, ties to the lowest id) in topology order.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..audit.ledger import unwrap
from ..runtime.emitters import StandardEmitter


class PartitionError(ValueError):
    """Inconsistent pins / unpartitionable graph."""


def _pin_of(node, overrides: Optional[Dict[str, int]]) -> Optional[int]:
    """Effective pin of one (pre-fusion) node: spec assignment
    overrides beat builder pins.  Longest matching substring wins
    (then lexicographic, for determinism), so a more specific override
    -- {"fold": 0, "fold_heavy": 1} -- is never shadowed by its
    prefix."""
    if overrides:
        for sub in sorted(overrides, key=lambda s: (-len(s), s)):
            if sub in node.name:
                return int(overrides[sub])
    return getattr(node, "worker_pin", None)


def _is_shuffle_edge(outlet) -> bool:
    """True when the edge routed by ``outlet`` may cross processes:
    per-key hash routing is location-independent by construction --
    the KEYBY StandardEmitter and the Key_Farm emitter under its
    default ``hash % n`` (a custom routing callable might close over
    process-local state, so it pins its stage to its producers)."""
    from ..runtime.win_routing import KFEmitter
    em = outlet.emitter
    if type(em) is StandardEmitter:
        return bool(getattr(em, "keyed", False))
    if isinstance(em, KFEmitter):
        return bool(getattr(em, "_default_routing", False))
    return False


def plan_partition(graph, n_workers: Optional[int] = None,
                   overrides: Optional[Dict[str, int]] = None
                   ) -> Dict[str, int]:
    """Compute (and memoize on ``graph._dist_plan``) the node-name ->
    worker-id assignment of an UNSTARTED, fully wired graph.  Runs
    before the fusion pass; the fusion pass consults the plan so fused
    nodes never straddle workers."""
    spec = getattr(graph.config, "distributed", None)
    if n_workers is None:
        n_workers = int(getattr(spec, "n_workers", 1) or 1)
    if overrides is None:
        overrides = dict(getattr(spec, "assignment", None) or {})
    nodes = graph._all_nodes()
    index = {id(n): i for i, n in enumerate(nodes)}
    consumer = {}
    for n in nodes:
        if n.channel is not None:
            consumer[id(unwrap(n.channel))] = n
    pins = {id(n): _pin_of(n, overrides) for n in nodes}
    for nid, pin in pins.items():
        if pin is not None and not 0 <= pin < n_workers:
            raise PartitionError(
                f"with_worker({pin}) is outside the worker range "
                f"[0, {n_workers})")

    # union-find over co-location constraints
    parent = {id(n): id(n) for n in nodes}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for n in nodes:
        for o in n.outlets:
            for ch, _pid in o.dests:
                c = consumer.get(id(unwrap(ch)))
                if c is None or c is n:
                    continue
                pa, pb = pins[id(n)], pins[id(c)]
                pinned_apart = (pa is not None and pb is not None
                                and pa != pb)
                if pinned_apart:
                    continue  # explicit cut, even on a FORWARD edge
                if not _is_shuffle_edge(o):
                    union(id(n), id(c))

    groups: Dict[int, List] = {}
    for n in nodes:
        groups.setdefault(find(id(n)), []).append(n)
    ordered = sorted(groups.values(),
                     key=lambda members: min(index[id(m)] for m in members))

    load = [0] * n_workers
    plan: Dict[str, int] = {}
    for members in ordered:
        gp = {pins[id(m)] for m in members if pins[id(m)] is not None}
        if len(gp) > 1:
            named = sorted(m.name for m in members
                           if pins[id(m)] is not None)
            raise PartitionError(
                "conflicting .with_worker pins inside one co-located "
                f"group (members {named} pin to {sorted(gp)}); only "
                "KEYBY shuffle edges can cut between workers "
                "(docs/DISTRIBUTED.md)")
        w = gp.pop() if gp else min(range(n_workers),
                                    key=lambda i: (load[i], i))
        load[w] += len(members)
        for m in members:
            plan[m.name] = w
    graph._dist_plan = plan
    return plan


def node_owner(node, plan: Dict[str, int]) -> int:
    """Owner of one (possibly fused) runtime node under ``plan``.  A
    fused node's segments must agree -- the fusion pass guarantees it;
    this assert is the defense against a pass regression."""
    from ..runtime.node import FusedLogic
    if isinstance(node.logic, FusedLogic):
        owners = {plan[seg.name] for seg in node.logic.segments
                  if seg.name in plan}
        if len(owners) != 1:
            raise PartitionError(
                f"fused node {node.name!r} straddles workers "
                f"{sorted(owners)}; the fusion pass must not fuse "
                "across the partition")
        return owners.pop()
    return plan[node.name]
