"""Failure containment for PipeGraphs (a layer the reference lacks,
SURVEY.md §5: "failure detection / elastic recovery: Absent").

Four cooperating pieces:

* :mod:`~windflow_tpu_torch.resilience.cancel` -- graph-wide CancelToken +
  poisoned channels, so a dead replica can never deadlock the graph;
* :mod:`~windflow_tpu_torch.resilience.policies` -- per-operator error
  policies (``fail`` / ``skip`` / ``dead_letter``) and the graph
  dead-letter store;
* :mod:`~windflow_tpu_torch.resilience.watchdog` -- the stall watchdog
  (progress monitoring, channel/thread dumps, optional cancellation);
* :mod:`~windflow_tpu_torch.resilience.faults` -- the deterministic seeded
  fault-injection harness the recovery tests drive.

See docs/RESILIENCE.md for the user-facing guide.
"""
from .cancel import CancelToken, GraphCancelled
from .errors import NodeFailureError, StallError
from .faults import FaultPlan, InjectedFailure, NodeFaults
from .policies import (DeadLetterEntry, DeadLetterStore, ERROR_POLICIES,
                       POLICY_DEAD_LETTER, POLICY_FAIL, POLICY_SKIP,
                       validate_policy)
from .watchdog import StallWatchdog, dump_stall_report, stall_report

__all__ = [
    "CancelToken", "GraphCancelled", "NodeFailureError", "StallError",
    "FaultPlan", "InjectedFailure", "NodeFaults", "DeadLetterEntry",
    "DeadLetterStore", "ERROR_POLICIES", "POLICY_DEAD_LETTER",
    "POLICY_FAIL", "POLICY_SKIP", "validate_policy", "StallWatchdog",
    "dump_stall_report", "stall_report",
]
