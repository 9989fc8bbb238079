"""Fair segment scheduling: weighted executor leases per worker.

Co-resident tenants in one worker process share cores by whatever the
OS thread scheduler does -- which is to say, not by tenant weight at
all.  The ``FairShareRegistry`` turns the consume loops into a
weighted fair queue: every tenant's loops hold a ``FairShareLease``
and must ``acquire(k)`` before processing a batch of ``k`` items.

The gate is a **weighted deficit bound**, not an absolute token rate:
a tenant may run ahead of the slowest *active* tenant's normalized
consumption (items/weight) by at most ``burst`` items.  Consequences:

* a tenant running ALONE never waits (the floor is undefined) -- the
  plane is pay-for-what-you-use and scheduler-on/off results are
  identical for a single-tenant graph;
* when two tenants contend, their throughputs converge to the ratio
  of their weights regardless of per-item cost;
* a tenant that stops consuming (finished, stalled upstream) ages out
  of the floor after ``active_window_s`` so it cannot park the
  survivors at its last position.

Waits are timed and surfaced as the per-replica ``Sched_wait_s``
gauge so the diagnosis plane can name *scheduling* -- not queueing,
not credits -- as the bottleneck.  Leases register with the graph's
CancelToken (they expose ``poison()``) so cancellation never leaves a
consume loop blocked in the gate.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

# Re-check cadence while gated: long enough to stay off the lock under
# contention, short enough that activity expiry is observed promptly.
_WAIT_SLICE_S = 0.02


class FairShareLease:
    """One tenant's handle on the worker's fair-share gate."""

    def __init__(self, registry: "FairShareRegistry", tenant: str,
                 weight: float) -> None:
        self._reg = registry
        self.tenant = tenant
        self.weight = max(1e-6, float(weight))
        self.consumed = 0
        self.wait_s = 0.0
        self._last_active = 0.0   # monotonic; 0 = never ran
        self._poisoned = False

    # -- consume-loop side ------------------------------------------------
    def acquire(self, k: int) -> float:
        """Charge ``k`` items; block while this tenant is over its
        fair share.  Returns seconds spent waiting (0.0 normally)."""
        reg = self._reg
        waited = 0.0
        with reg._cond:
            now = time.monotonic()
            self._last_active = now
            while not self._poisoned:
                floor = reg._floor(exclude=self, now=now)
                if floor is None:
                    break       # running alone: no gate at all
                ahead = (self.consumed + k) / self.weight - floor
                if ahead <= reg.burst / self.weight:
                    break
                t0 = now
                reg._cond.wait(_WAIT_SLICE_S)
                now = time.monotonic()
                waited += now - t0
                self._last_active = now
            self.consumed += k
            self.wait_s += waited
            if waited or reg._gated:
                reg._cond.notify_all()
        return waited

    def poison(self) -> None:
        """CancelToken hook: unblock any consume loop in acquire()."""
        with self._reg._cond:
            self._poisoned = True
            self._reg._cond.notify_all()

    def block(self) -> dict:
        return {
            "Tenant": self.tenant,
            "Weight": round(self.weight, 3),
            "Consumed": self.consumed,
            "Sched_wait_s": round(self.wait_s, 3),
        }


class FairShareRegistry:
    """Per-worker registry of tenant leases (the shared gate state)."""

    def __init__(self, *, burst: int = 4096,
                 active_window_s: float = 1.0) -> None:
        self.burst = int(burst)
        self.active_window_s = float(active_window_s)
        self._cond = threading.Condition()
        self._leases: Dict[str, FairShareLease] = {}
        self._gated = False     # any lease ever waited (notify hint)

    def lease(self, tenant: str, weight: float = 1.0) -> FairShareLease:
        with self._cond:
            ls = self._leases.get(tenant)
            if ls is None:
                ls = FairShareLease(self, tenant, weight)
                # Join at the current floor, not at zero: a late tenant
                # must not park established tenants until it catches up.
                floor = self._floor(exclude=ls, now=time.monotonic())
                if floor is not None:
                    ls.consumed = int(floor * ls.weight)
                self._leases[tenant] = ls
            self._cond.notify_all()
            return ls

    def release(self, tenant: str) -> None:
        with self._cond:
            ls = self._leases.pop(tenant, None)
            if ls is not None:
                ls._poisoned = True
            self._cond.notify_all()

    def _floor(self, exclude: FairShareLease,
               now: float) -> Optional[float]:
        """Minimum normalized consumption among OTHER active leases.

        None when no other lease is active -- the caller is alone and
        must not be gated.  Called with the condition held.
        """
        floor = None
        horizon = now - self.active_window_s
        for ls in self._leases.values():
            if ls is exclude or ls._poisoned:
                continue
            if ls._last_active < horizon:
                continue        # idle: aged out of the floor
            norm = ls.consumed / ls.weight
            if floor is None or norm < floor:
                floor = norm
        if floor is not None:
            self._gated = True
        return floor

    def block(self) -> dict:
        with self._cond:
            rows = [ls.block() for ls in self._leases.values()]
        return {
            "Burst": self.burst,
            "Leases": rows,
            "Sched_wait_s": round(sum(r["Sched_wait_s"] for r in rows), 3),
        }
