"""Tenant identity and resource contract (docs/SERVING.md).

A :class:`TenantSpec` is everything the serving plane needs to know
about one hosted pipeline that is not derivable from its graph: how
many ingest credits it may hold under the server's global capacity cap
(admission control happens against that cap at ``submit``), how it
ranks against its neighbours when the cross-tenant arbiter has to take
resources from someone (``priority`` strictly, then ``weight``), what
service-level objectives it declares (ridden by the existing SLO
plane, slo/plane.py), and how far the arbiter may squeeze it when it
is the donor.

Isolation that needs no spec field because it is per-graph by
construction: every tenant's PipeGraph owns its own
:class:`~windflow_tpu_torch.resilience.policies.DeadLetterStore` (admission
shedding under the tenant's own budget quarantines into the tenant's
own ledger-visible dead letters, never a neighbour's) and its own
:class:`~windflow_tpu_torch.core.tuples.ColumnPool` arena (bounded per
tenant via ``pool_buffers``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

# default credit allocation a spec-less tenant reserves under the cap
DEFAULT_TENANT_CREDITS = 1 << 14


class TenantState:
    """Lifecycle of a submitted tenant (string constants, not an enum:
    they travel through stats JSON)."""

    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"   # clean end (sources exhausted)
    STOPPED = "STOPPED"       # handle.stop() / Server.evict()
    FAILED = "FAILED"         # a replica error ended the graph

    TERMINAL = (COMPLETED, STOPPED, FAILED)


class AdmissionError(RuntimeError):
    """submit() rejected: the tenant's declared resources do not fit
    under the server's global capacity cap.  Admission is strict by
    design -- over-committing the cap would let one tenant's burst
    shed into a neighbour's latency instead of its own dead letters."""


@dataclass(frozen=True)
class TenantSpec:
    """Per-tenant resource budget + arbitration standing.

    * ``credits``       -- ingest-credit allocation reserved under the
                           server's global cap; split across the
                           tenant's credit gates after start.
    * ``priority``      -- arbiter ordering, higher = protected longer;
                           a donor is never squeezed for a victim of
                           strictly lower priority.
    * ``weight``        -- tie-break inside one priority class: the
                           lowest-weight eligible donor donates first.
    * ``donor``         -- False exempts the tenant from donating
                           entirely (it can still be a victim).
    * ``slo``           -- :class:`~windflow_tpu_torch.slo.SloConfig` or a
                           kwargs dict for ``PipeGraph.with_slo``; the
                           arbiter only ever defends tenants that
                           declared objectives.
    * ``min_credits``   -- floor below which the arbiter never shrinks
                           this tenant's credit allocation.
    * ``pool_buffers``  -- per-(dtype, bucket) ColumnPool arena bound
                           (``max_per_bucket``); None keeps the library
                           default.
    * ``devices``       -- declared device-lane demand, an input to the
                           fleet scheduler's placement policy (the
                           planner still resolves actual lanes; this
                           only steers which WORKER hosts the tenant so
                           device-hungry tenants spread before they
                           contend).
    """

    credits: int = DEFAULT_TENANT_CREDITS
    priority: int = 0
    weight: float = 1.0
    donor: bool = True
    slo: Any = None
    min_credits: int = 256
    pool_buffers: Optional[int] = None
    devices: int = 0

    def __post_init__(self):
        if self.credits < 1:
            raise ValueError("TenantSpec.credits must be >= 1")
        if self.weight <= 0:
            raise ValueError("TenantSpec.weight must be positive")
        if not 1 <= self.min_credits <= self.credits:
            raise ValueError(
                "TenantSpec.min_credits must be in [1, credits]")
        if self.pool_buffers is not None and self.pool_buffers < 1:
            raise ValueError("TenantSpec.pool_buffers must be >= 1")
        if self.devices < 0:
            raise ValueError("TenantSpec.devices must be >= 0")

    def block(self) -> dict:
        """The static half of the stats-JSON ``Tenant`` block (the
        server adds the live fields: state, granted credits,
        arbitration count)."""
        return {
            "Priority": self.priority,
            "Weight": self.weight,
            "Donor": self.donor,
            "Min_credits": self.min_credits,
            "Devices": self.devices,
        }
