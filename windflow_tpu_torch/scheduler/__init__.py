"""Global scheduler: the fleet-level control plane.

Promotes the serving plane's single-process ``Server`` to a cluster
scheduler:

* :mod:`policy`  -- pure tenant->worker placement (bin-pack by credit
  reservation + declared device demand, priority-weighted);
* :mod:`leases`  -- weighted fair-share executor leases gating the
  consume loops of co-resident tenants (``Sched_wait_s``);
* :mod:`devices` -- per-worker leases on the CUDA card that the planner
  takes for every lane it resolves to the device, and the arbiter reads
  to demote a low-priority neighbour on a contended card;
* :mod:`fleet`   -- ``FleetServer``: spawns worker processes, places
  tenants via the policy against the live ``ClusterObserver`` view,
  re-places victims when a worker dies;
* :mod:`worker`  -- the worker-process entry point hosting a
  fair-share ``Server``
  (``python -m windflow_tpu_torch.scheduler.worker``);
* :mod:`errors`  -- ``SchedulerError``, the structured refusal.
"""
from .errors import SchedulerError
from .policy import (Placement, PlacementRequest, WorkerCaps,
                     plan_placement, request_for)
from .leases import FairShareLease, FairShareRegistry
from .devices import DeviceLeaseRegistry

__all__ = [
    "SchedulerError",
    "Placement", "PlacementRequest", "WorkerCaps",
    "plan_placement", "request_for",
    "FairShareLease", "FairShareRegistry",
    "DeviceLeaseRegistry",
    "FleetServer",
]


def __getattr__(name):
    # FleetServer pulls in serving + distributed; keep the import lazy
    # so `from windflow_tpu_torch.scheduler import plan_placement`
    # stays cheap.
    if name == "FleetServer":
        from .fleet import FleetServer
        return FleetServer
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
