"""Global scheduler: the fleet-level control plane.

Ported so far: :mod:`errors` -- ``SchedulerError``, the structured
failure the distributed wiring raises when it refuses an elastic
operator across workers.  Placement, the fair-share and device leases,
``FleetServer`` and its worker processes wait for ROADMAP.md A10h;
their names raise an ``AttributeError`` that says so.
"""
from .errors import SchedulerError

__all__ = ["SchedulerError"]

# the reference package's other scheduler names, ported with the
# serving plane
_NOT_YET = ("Placement", "PlacementRequest", "WorkerCaps",
            "plan_placement", "request_for", "FairShareLease",
            "FairShareRegistry", "DeviceLeaseRegistry", "FleetServer")


def __getattr__(name):
    if name in _NOT_YET:
        from .._unported import unported
        raise AttributeError(str(unported(
            f"windflow_tpu_torch.scheduler.{name}", "serving")))
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
