"""Diagnosis plane: critical-path latency attribution, backpressure
root-cause analysis, rolling gauge history, online regression
detection and the doctor report (docs/OBSERVABILITY.md "Diagnosis
plane").

The telemetry plane measures and the audit plane verifies; this package *explains*: which hop class (service /
queueing / device transport / device compute) each traced microsecond
went to, which operator is the root cause behind a pressured sink,
how the gauges trended, and whether any series just broke its
EWMA+MAD band.  One :class:`DiagnosisPlane` per graph
(``RuntimeConfig.diagnosis``, on by default), ticking on the existing
monitor/auditor cadences; :func:`build_report` is the pure fold every
surface shares (``PipeGraph.explain()``, the dashboard ``/explain``
endpoint).
"""
from .anomaly import RegressionMonitor
from .attribution import (AttributionAccumulator, attribution_from_stats,
                          trace_breakdown)
from .bottleneck import bottleneck_from_stats, find_bottlenecks
from .history import GaugeHistory
from .plane import DiagnosisPlane
from .report import build_report, render_text
from .topology import operator_edges

__all__ = [
    "DiagnosisPlane",
    "build_report", "render_text",
    "trace_breakdown", "AttributionAccumulator", "attribution_from_stats",
    "find_bottlenecks", "bottleneck_from_stats",
    "GaugeHistory", "RegressionMonitor",
    "operator_edges",
]
