"""Pure tenant->worker placement policy.

The policy is a function, not a service: given the fleet's worker
capacities, the tenants already placed, and the incoming requests, it
returns ``{tenant: worker}`` -- no sockets, no clocks, no globals --
so every placement decision is unit-testable and replayable from a
flight event.

Shape of the decision (mirrors the credit discipline everywhere else
in windflow_tpu_torch):

* **credits are a hard reservation** -- a worker's ``Server`` refuses
  admission past its capacity, so the policy never plans a placement
  that would be refused;
* **device lanes are a soft reservation** -- lanes can be
  oversubscribed (the arbiter resolves contention at run time by
  demoting a low-priority lane device->host), but the policy avoids
  creating contention when an uncontended worker exists;
* **priority-weighted bin-packing** -- requests are placed highest
  priority first (then largest reservation first), and among feasible
  workers the one with the lowest normalized load after placement
  wins, which spreads tenants instead of piling them onto worker 0.

The live cluster view (PR 13's ``ClusterObserver``) enters as the
``live`` map: workers missing from it or marked dead are excluded, so
re-placement after a crash is the SAME code path as first placement.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

from .errors import SchedulerError


@dataclass(frozen=True)
class WorkerCaps:
    """Static capacity envelope of one worker process."""
    worker: int
    credits: int
    device_lanes: int = 1


@dataclass(frozen=True)
class PlacementRequest:
    """One tenant's declared demand (from its TenantSpec)."""
    name: str
    credits: int
    devices: int = 0        # declared device-lane demand
    priority: int = 0
    weight: float = 1.0


@dataclass(frozen=True)
class Placement:
    """An existing tenant->worker assignment (the policy's memory)."""
    name: str
    worker: int
    credits: int
    devices: int = 0


@dataclass
class _Load:
    credits: int = 0
    devices: int = 0
    tenants: int = 0


def _loads(workers: Sequence[WorkerCaps],
           placed: Iterable[Placement]) -> Dict[int, _Load]:
    loads = {w.worker: _Load() for w in workers}
    for p in placed:
        ld = loads.get(p.worker)
        if ld is None:      # placement on a dead/unknown worker: ignore
            continue
        ld.credits += p.credits
        ld.devices += p.devices
        ld.tenants += 1
    return loads


def plan_placement(requests: Sequence[PlacementRequest],
                   workers: Sequence[WorkerCaps],
                   *,
                   placed: Iterable[Placement] = (),
                   live: Optional[Mapping[int, bool]] = None,
                   ) -> Dict[str, int]:
    """Choose a worker for every request; raise SchedulerError if any
    request cannot be placed.

    ``live`` maps worker id -> alive; workers absent from a non-None
    map are treated as dead (the observer has never heard from them or
    their process exited).
    """
    if live is not None:
        workers = [w for w in workers if live.get(w.worker, False)]
    if not workers:
        raise SchedulerError(
            "no live workers in the fleet",
            hint="spawn workers before submitting tenants")

    loads = _loads(workers, placed)
    caps = {w.worker: w for w in workers}
    out: Dict[str, int] = {}

    order = sorted(requests,
                   key=lambda r: (-r.priority, -r.credits, r.name))
    for req in order:
        best = None
        best_key = None
        for w in workers:
            ld = loads[w.worker]
            if ld.credits + req.credits > w.credits:
                continue    # hard: the worker Server would refuse this
            lanes = max(1, w.device_lanes)
            dev_over = max(0, ld.devices + req.devices - lanes) \
                if req.devices else 0
            norm = (ld.credits + req.credits) / max(1, w.credits)
            key = (dev_over, norm, ld.tenants, w.worker)
            if best_key is None or key < best_key:
                best, best_key = w, key
        if best is None:
            free = {w.worker: w.credits - loads[w.worker].credits
                    for w in workers}
            raise SchedulerError(
                f"no worker can host tenant {req.name!r} "
                f"(needs {req.credits} credits; free: {free})",
                tenant=req.name,
                hint="raise worker capacity or evict a tenant")
        ld = loads[best.worker]
        ld.credits += req.credits
        ld.devices += req.devices
        ld.tenants += 1
        out[req.name] = best.worker
    return out


def request_for(name: str, spec) -> PlacementRequest:
    """Build a PlacementRequest from a serving TenantSpec."""
    return PlacementRequest(
        name=name,
        credits=int(spec.credits),
        devices=int(getattr(spec, "devices", 0)),
        priority=int(spec.priority),
        weight=float(spec.weight),
    )
