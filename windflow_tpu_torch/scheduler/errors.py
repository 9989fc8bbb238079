"""Structured scheduler failures.

A placement or actuation failure is an *operational* event, not a
programming error: the caller needs to know which worker owns the
resource, which operators are involved, and what the fleet-level
remedy is.  ``SchedulerError`` carries those fields so the serving
plane can record a ``sched_rejected`` flight event and the doctor can
explain the rejection instead of printing a bare traceback.
"""
from __future__ import annotations

from typing import Optional, Sequence


class SchedulerError(RuntimeError):
    """A scheduling decision could not be made or actuated.

    Attributes
    ----------
    worker:     the worker that owns the contended/rejecting resource
                (``None`` when no single worker is responsible, e.g.
                "no worker has capacity").
    tenant:     the tenant whose request failed, when known.
    operators:  operator names involved in the rejection.
    hint:       the fleet-level path that WOULD handle the request.
    """

    def __init__(self, message: str, *,
                 worker: Optional[int] = None,
                 tenant: Optional[str] = None,
                 operators: Sequence[str] = (),
                 hint: str = "") -> None:
        super().__init__(message)
        self.worker = worker
        self.tenant = tenant
        self.operators = list(operators)
        self.hint = hint

    def block(self) -> dict:
        """Structured form for flight events and doctor output."""
        d = {"Error": str(self)}
        if self.worker is not None:
            d["Worker"] = self.worker
        if self.tenant is not None:
            d["Tenant"] = self.tenant
        if self.operators:
            d["Operators"] = list(self.operators)
        if self.hint:
            d["Hint"] = self.hint
        return d
