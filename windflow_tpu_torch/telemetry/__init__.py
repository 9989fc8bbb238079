"""Telemetry plane: end-to-end latency tracing, lock-free log-bucketed
histograms, flight recorder and OpenMetrics export
(docs/OBSERVABILITY.md).

The stats plane (monitoring/) reproduces the reference's counter
surface; this package adds the latency dimension a production runtime
is operated on: sampled source-to-sink trace contexts, per-operator
service/residency/e2e histograms with p50/p95/p99/max, a bounded
structured-event ring dumped on failure, and a Prometheus-scrapable
``/metrics`` endpoint on the dashboard HTTP server.
"""
from .histogram import LogHistogram, bucket_le_us
from .metrics import CONTENT_TYPE, render_openmetrics
from .profiler import span
from .recorder import FlightRecorder
from .trace import (DEFAULT_TRACE_SAMPLE, TelemetryHub, TraceContext,
                    TraceSampler, attach_if_absent, get_trace)

__all__ = [
    "LogHistogram", "bucket_le_us",
    "TraceContext", "TraceSampler", "TelemetryHub",
    "get_trace", "attach_if_absent", "DEFAULT_TRACE_SAMPLE",
    "FlightRecorder",
    "render_openmetrics", "CONTENT_TYPE",
    "span",
]
