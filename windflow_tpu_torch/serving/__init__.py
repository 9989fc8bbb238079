"""Multi-tenant serving plane (docs/SERVING.md).

Many PipeGraphs in one shared runtime process: dynamic graph
submission/teardown (:class:`Server` / :class:`TenantHandle`),
per-tenant credit budgets + admission control under a global capacity
cap (:class:`TenantSpec` / :class:`AdmissionError`), and the
SLO-driven cross-tenant arbiter (:class:`CrossTenantArbiter` /
:class:`ArbiterConfig`) that scales a donor tenant down to restore a
breaching victim's SLO -- every decision an ``arbitration`` flight
event the doctor explains.
"""
from .arbiter import (ArbiterConfig, CrossTenantArbiter, Donation,
                      TenantView, plan_arbitration, plan_restitution)
from .server import Server, TenantHandle, process_census
from .tenant import AdmissionError, TenantSpec, TenantState

__all__ = [
    "AdmissionError", "ArbiterConfig", "CrossTenantArbiter",
    "Donation", "Server", "TenantHandle", "TenantSpec", "TenantState",
    "TenantView", "plan_arbitration", "plan_restitution",
    "process_census",
]
