"""Audit plane: online flow-conservation ledger, progress/frontier
tracking, and keyed-state skew census (docs/OBSERVABILITY.md).

The telemetry plane lets an operator see how *fast* the runtime
is; this package lets the runtime observe its own *correctness* while
it runs.  Three pillars, one :class:`GraphAuditor` thread per graph
(``RuntimeConfig.audit``, on by default):

* **Flow-conservation ledger** (ledger.py) -- every channel edge keeps
  two independent delivery books (producer intent at the Outlet layer
  vs the channel's own put/get counters, both planes + CreditedChannel
  proxies), folded with admission sheds, dead letters, in-flight
  device batches and elastic-rescale migrations; a periodic graph-wide
  pass (and an exact closure check at ``wait_end``) proves per-edge
  ``sent == delivered == enqueued == dequeued + depth``.  Violations
  land in the FlightRecorder (``conservation_violation``), the stats
  JSON ``Conservation`` block and ``/metrics``.
* **Progress/frontier tracking** (progress.py) -- per-source monotone
  frontiers (replay offset / synth index / emitted position)
  propagated topologically as min-over-inputs low-watermarks through
  operators, fused segments and KEYBY shuffles; per-operator
  ``Frontier`` / ``Frontier_lag_ms`` gauges and a stalled-frontier
  detector (``frontier_stall`` flight events) -- the groundwork
  event-time triggering (ROADMAP item 4) will stand on.
* **Keyed-state census** (census.py) -- per-replica key counts + byte
  estimates from the ``keyed_state_census`` hooks, plus a space-saving
  top-K hot-key sketch on the KEYBY emitters, rendered as a ``Skew``
  block and exposed to the elastic controller as a skew signal.
"""
from .auditor import GraphAuditor
from .census import SpaceSavingSketch
from .ledger import EdgeCell, FlowLedger
from .progress import FrontierTracker

__all__ = [
    "GraphAuditor",
    "EdgeCell", "FlowLedger",
    "FrontierTracker",
    "SpaceSavingSketch",
]
