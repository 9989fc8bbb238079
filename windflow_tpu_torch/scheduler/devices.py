"""Tenant-aware device placement: the per-worker DeviceLeaseRegistry.

The placement planner (graph/planner.py) decides *host vs device* per
operator but is per-graph: two tenants in one worker can both resolve
``device`` and silently share the CUDA card through its stream queue.
The registry makes the card a *scheduled* resource.  Each lease row
names the device its lane is bound to (``"cuda:0"``, ``"cuda:1"``, or
``"cpu"`` under ``RuntimeConfig(device="cpu")``); the registry's own
chip, ``"cuda:0"`` by default, names the card of its block and of a
lease acquired without one:

* the planner ``acquire()``s a lease for every lane it resolves to
  the device (including resident FFAT engines, which are recorded as
  non-demotable);
* leases are GRANTED even past capacity -- oversubscription is legal,
  it is just *visible*: ``contended()`` flips once holders exceed the
  worker's lanes, and every lease row carries the contention bit;
* the arbiter consults the rows to find, on a contended chip, the
  lowest-priority demotable neighbour of a breaching tenant and flips
  that lane device->host through the replace_lane quiesce path.

Grant-and-record (rather than block-or-refuse) is deliberate: a lease
denial at plan time would fail a graph that might run fine off-peak,
while recorded oversubscription lets the SLO plane decide *at run
time* whether contention actually hurts anyone.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple


class DeviceLeaseRegistry:
    """Per-worker ledger of device-lane leases."""

    def __init__(self, lanes: int = 1, chip: str = "cuda:0") -> None:
        self.lanes = max(1, int(lanes))
        self.chip = chip
        self._lock = threading.Lock()
        # (tenant, operator) -> {"Priority":…, "Resident":…}
        self._leases: Dict[Tuple[str, str], dict] = {}

    # -- planner side -----------------------------------------------------
    def acquire(self, tenant: str, operator: str, *,
                priority: int = 0, resident: bool = False,
                chip: Optional[str] = None) -> dict:
        """Grant (and record) a device lease for one lane on ``chip``
        (the device the lane is bound to; the registry's chip when
        None).

        Returns the grant the planner annotates into its placement
        entry: the chip, whether the chip is now contended, and the
        holder count at grant time.
        """
        chip = str(chip) if chip is not None else self.chip
        with self._lock:
            self._leases[(str(tenant), str(operator))] = {
                "Chip": chip,
                "Priority": int(priority),
                "Resident": bool(resident),
            }
            n = len(self._leases)
        return {"chip": chip, "holders": n,
                "contended": n > self.lanes}

    def release(self, tenant: str, operator: Optional[str] = None) -> int:
        """Drop one lease, or every lease of a tenant; returns count."""
        with self._lock:
            if operator is not None:
                return 1 if self._leases.pop(
                    (str(tenant), str(operator)), None) else 0
            gone = [k for k in self._leases if k[0] == str(tenant)]
            for k in gone:
                del self._leases[k]
            return len(gone)

    # -- arbiter / observability side ------------------------------------
    def contended(self) -> bool:
        with self._lock:
            return len(self._leases) > self.lanes

    def holders(self) -> int:
        with self._lock:
            return len(self._leases)

    def rows(self) -> List[dict]:
        with self._lock:
            n = len(self._leases)
            contended = n > self.lanes
            return [{
                "Tenant": t, "Operator": op, "Chip": meta["Chip"],
                "Priority": meta["Priority"],
                "Resident": meta["Resident"],
                "Contended": contended,
            } for (t, op), meta in sorted(self._leases.items())]

    def tenant_rows(self, tenant: str) -> List[dict]:
        return [r for r in self.rows() if r["Tenant"] == str(tenant)]

    def block(self) -> dict:
        rows = self.rows()
        return {"Chip": self.chip, "Lanes": self.lanes,
                "Holders": len(rows),
                "Contended": len(rows) > self.lanes,
                "Leases": rows}
