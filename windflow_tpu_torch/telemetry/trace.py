"""Sampled end-to-end tuple tracing (docs/OBSERVABILITY.md).

A :class:`TraceContext` is attached to a deterministic 1-in-N sample of
items at the source (``TraceSampler``), rides the item through
channels, KEYBY shuffles, fused segments and the device dispatcher
(the ``trace`` slot on TupleBatch / SynthChunk / BasicRecord, which
``take``/``concat``/``materialize`` propagate), collects one
(operator, arrive, done) hop stamp per operator it crosses, and is
closed at the sink into the per-replica latency histograms:

* **channel residency** per consuming operator:
  ``arrive - previous hop's done`` (time parked in the channel plus
  the emit->enqueue skew of the upstream batch flush);
* **end-to-end**: ``sink done - source stamp`` into the sink replica's
  e2e histogram (graph-wide after the report-time merge).

Per-operator *service* histograms are fed independently by the
runtime's existing sampled ``StatsRecord.observe`` path, so they cover
every replica even between trace samples.

A context forked by a KEYBY partition rides every sub-batch; each path
that reaches a sink closes once (one e2e sample per path).  Hop lists
and ``last`` stamps are then shared across threads -- list.append is
GIL-atomic and the stamps are gauge-grade, like every other telemetry
read in this plane.
"""
from __future__ import annotations

import time as _time
from typing import Optional

from .histogram import LogHistogram

# default 1-in-N source sampling period (RuntimeConfig.trace_sample)
DEFAULT_TRACE_SAMPLE = 128
# hop stamps kept per context (a pathological graph cannot grow it)
MAX_HOPS = 64


class TraceContext:
    """Per-sampled-item trace state: source stamp + per-hop stamps.

    ``trace_id`` names the trace across process boundaries: the
    sampler stamps ``<source>#<n>`` (deterministic per source
    replica), the wire codec ships it in the frame header, and the
    cross-worker merge (distributed/observe.stitch_traces) joins
    per-worker partial records back into one e2e record by it."""

    __slots__ = ("src", "t0", "last", "hops", "trace_id")

    def __init__(self, src: str, t0: float,
                 trace_id: Optional[str] = None):
        self.src = src
        self.t0 = t0
        self.last = t0          # most recent 'done' stamp (residency base)
        self.hops: list = []    # (operator, t_arrive, t_done)
        self.trace_id = trace_id

    def hop(self, name: str, t_in: float, t_done: float,
            meta: Optional[dict] = None) -> None:
        """Record one hop stamp.  ``meta`` (optional, gauge-grade)
        rides as a trailing dict on the serialized hop -- the device
        engines use it to carry launch count + transfer bytes on their
        ``@device`` hops so a whole-partition step (graph/device_step)
        stays attributable as ONE launch per chunk.  Readers index
        ``hop[0..2]`` and must ignore extra elements."""
        if len(self.hops) < MAX_HOPS:
            self.hops.append((name, t_in, t_done) if meta is None
                             else (name, t_in, t_done, meta))
        self.last = t_done

    def to_dict(self, t_end: float) -> dict:
        t0 = self.t0
        d = {
            "src": self.src,
            "e2e_ms": round((t_end - t0) * 1e3, 3),
            "hops": [[name, round((a - t0) * 1e3, 3),
                      round((d - t0) * 1e3, 3), *rest]
                     for name, a, d, *rest in self.hops],
        }
        if self.trace_id is not None:
            d["id"] = self.trace_id
        return d


def get_trace(item) -> Optional[TraceContext]:
    """The context riding ``item``, or None (unset slot / untraceable
    type both read as None)."""
    return getattr(item, "trace", None)


def attach(item, ctx: TraceContext) -> bool:
    """Attach ``ctx`` to ``item`` if its type carries a trace slot."""
    try:
        item.trace = ctx
        return True
    except AttributeError:
        return False


def attach_if_absent(item, ctx: TraceContext) -> None:
    if getattr(item, "trace", None) is None:
        try:
            item.trace = ctx
        except AttributeError:
            pass


class TraceSampler:
    """Deterministic 1-in-N sampling at a source replica: the N-th,
    2N-th, ... emitted item starts a trace (independent of wall time,
    so a rerun of the same stream samples the same items)."""

    __slots__ = ("period", "src", "_n", "started")

    def __init__(self, period: int, src: str):
        self.period = max(1, int(period))
        self.src = src
        self._n = 0
        self.started = 0

    def maybe_attach(self, item) -> None:
        self._n += 1
        if self._n >= self.period:
            # the slot is only consumed by an item that can carry a
            # context -- an untraceable item (dict, control marker)
            # landing on the N-th emission defers the sample to the
            # next attachable one instead of silently eating it
            ctx = TraceContext(self.src, _time.perf_counter(),
                               trace_id=f"{self.src}#{self.started + 1}")
            if attach(item, ctx):
                self._n = 0
                self.started += 1


class TelemetryHub:
    """Per-graph tracing coordinator: owns the sampling period, hands
    samplers to source nodes, and closes contexts at sinks into the
    histogram plane (monitoring/stats.py)."""

    def __init__(self, stats, sample_period: int = DEFAULT_TRACE_SAMPLE):
        self.stats = stats
        self.sample_period = max(1, int(sample_period))
        self.samplers: list = []
        self.closed = 0

    def sampler_for(self, node_name: str,
                    period: Optional[int] = None) -> TraceSampler:
        s = TraceSampler(period or self.sample_period, node_name)
        self.samplers.append(s)
        return s

    def close(self, ctx: TraceContext, rec, t_end: float) -> None:
        """Close one trace at a sink replica: e2e sample into the
        replica's histogram (or the graph-level fallback when the sink
        is untraced) plus a bounded recent-trace record.  The record
        keeps the LIVE context and serializes at report time: in a
        fused chain the upstream segments' hop stamps land moments
        AFTER the sink segment closes (their entries unwind outward),
        so an eager to_dict here would drop them."""
        self.closed += 1
        h = None
        if rec is not None:
            h = rec.e2e_hist
            if h is None:
                h = rec.e2e_hist = LogHistogram()
        if h is None:
            h = self.stats.e2e_extra
        if h is not None:
            h.observe((t_end - ctx.t0) * 1e6)
        self.stats.add_trace_record((ctx, t_end))
