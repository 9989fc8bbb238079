"""DiagnosisPlane: the per-graph diagnosis coordinator
(docs/OBSERVABILITY.md "Diagnosis plane").

One per started PipeGraph when ``RuntimeConfig.diagnosis`` is on (the
default).  It owns no thread: ``maybe_tick`` rides the cadences that
already exist -- the monitoring reporter (1 Hz), the auditor pass
(``audit_interval_s``) and on-demand ``PipeGraph.explain()`` calls --
rate-limited to ``diagnosis_interval_s`` so stacked callers cannot
multiply the cost.  A tick is pure observation: counter deltas, gauge
reads, and folding traces the telemetry plane already closed.

Per tick it

* drains newly-closed trace records into the critical-path
  :class:`~windflow_tpu_torch.diagnosis.attribution.AttributionAccumulator`,
* appends one row to the rolling :class:`GaugeHistory` ring,
* feeds the throughput / e2e-p99 / frontier-lag series through the
  EWMA+MAD :class:`RegressionMonitor` (band breaks become
  ``regression`` flight events),
* re-runs the backpressure root-cause walk over the live gauges
  (keeping a per-operator EWMA of depth_frac so the verdict survives
  the end-of-run drain),
* publishes the ``Diagnosis`` and ``History`` stats-JSON blocks.

The elastic controller reads :meth:`bottleneck_score` as its
attribution-aware scale signal (docs/ELASTIC.md).
"""
from __future__ import annotations

import threading
import time as _time
from collections import deque
from typing import Dict, Optional

from .anomaly import RegressionMonitor
from .attribution import (DEVICE_HOP_SUFFIX, AttributionAccumulator,
                          trace_breakdown)
from .bottleneck import find_bottlenecks
from .history import GaugeHistory
from .topology import operator_edges

# EWMA weight of the per-operator sustained depth_frac signal
SUSTAINED_ALPHA = 0.35
# trace keys remembered for dedup (the stats ring holds 16)
SEEN_TRACES = 64
# a closed trace is folded only once it is at least this old: fused
# upstream segments stamp their hops moments AFTER the sink closes
# (entries unwind outward), and an eager fold would charge their
# service time to queueing -- and the dedup key would freeze the
# truncated record forever
TRACE_SETTLE_S = 0.05
# anomaly series -> breach direction
WATCHED = (("throughput_rps", "low"),
           ("e2e_p99_us", "high"),
           ("frontier_lag_ms", "high"))


class DiagnosisPlane:
    def __init__(self, graph):
        self.graph = graph
        cfg = graph.config
        self.interval_s = max(0.05, float(cfg.diagnosis_interval_s))
        self.history = GaugeHistory(cfg.history_len)
        self.attribution = AttributionAccumulator()
        self.monitor = RegressionMonitor(k=cfg.anomaly_band_k,
                                         warmup=cfg.anomaly_warmup)
        # SLO plane (slo/; docs/OBSERVABILITY.md "SLO plane"): the
        # burn-rate tracker rides this tick -- no thread of its own
        self.slo = None
        if getattr(cfg, "slo", None) is not None:
            from ..slo import SloTracker
            self.slo = SloTracker(cfg.slo)
        self.edges = operator_edges(graph)
        self.ticks = 0
        self._lock = threading.Lock()
        self._last_tick = 0.0
        self._seen = set()
        self._seen_order: deque = deque(maxlen=SEEN_TRACES)
        self._last_sink_inputs: Optional[int] = None
        self._last_t: Optional[float] = None
        self._sustained: Dict[str, float] = {}
        self._scores: Dict[str, float] = {}
        self._rtt_ms: Optional[float] = None
        self._rtt_probed = False
        self._sink_ops = None

    # -- signals for other planes --------------------------------------
    def bottleneck_score(self, operator: str) -> float:
        """Pressure score of ``operator`` from the latest walk (0.0 =
        unknown / unpressured) -- the elastic controller's
        attribution-aware scale signal."""
        return self._scores.get(operator, 0.0)

    # -- tick ----------------------------------------------------------
    def maybe_tick(self, force: bool = False) -> bool:
        now = _time.monotonic()
        if not force and now - self._last_tick < self.interval_s:
            return False
        with self._lock:
            if not force and now - self._last_tick < self.interval_s:
                return False
            self._last_tick = now
            try:
                self._tick(now)
            except Exception:  # pragma: no cover - diagnosis must
                import traceback  # never take the graph down
                traceback.print_exc()
        return True

    def _rtt_floor_ms(self) -> Optional[float]:
        """Transport floor for the device transport/compute split:
        the planner's recorded decisions first, the (cached) probe as
        a fallback once a device hop actually shows up."""
        if self._rtt_ms is not None:
            return self._rtt_ms
        for p in getattr(self.graph, "placements", None) or []:
            if isinstance(p, dict) and p.get("rtt_floor_ms") is not None:
                self._rtt_ms = float(p["rtt_floor_ms"])
                return self._rtt_ms
        if not self._rtt_probed:
            self._rtt_probed = True
            try:
                from ..graph.planner import rtt_floor_ms
                self._rtt_ms = float(rtt_floor_ms())
            except Exception:
                self._rtt_ms = None
        return self._rtt_ms

    def _drain_traces(self) -> None:
        stats = self.graph.stats
        pairs = list(stats.trace_records)
        # t_end stamps share perf_counter with the hop stamps
        cutoff = _time.perf_counter() - TRACE_SETTLE_S
        fresh = []
        for ctx, t_end in pairs:
            if t_end > cutoff:
                continue  # still unwinding; next tick folds it
            key = (id(ctx), t_end)
            if key in self._seen:
                continue
            fresh.append((key, ctx, t_end))
        recs = [(key, ctx.to_dict(t_end)) for key, ctx, t_end in fresh]
        rtt = None
        if any(str(hop[0]).endswith(DEVICE_HOP_SUFFIX)
               for _key, rec in recs for hop in rec.get("hops") or []
               if hop):
            # only a device hop reads the floor: a graph with no device
            # lane never probes (nor opens) the card
            rtt = self._rtt_floor_ms()
        for key, rec in recs:
            if len(self._seen_order) == self._seen_order.maxlen:
                self._seen.discard(self._seen_order[0])
            self._seen.add(key)
            self._seen_order.append(key)
            self.attribution.add(trace_breakdown(rec, rtt))

    def _operator_rows(self):
        """Minimal stats-JSON-shaped operator rows straight from the
        live records (gauge-grade reads; the lock only guards the
        records dict against a concurrent rescale registration)."""
        stats = self.graph.stats
        with stats.lock:
            items = [(name, list(reps))
                     for name, reps in stats.records.items()]
        rows = []
        for name, reps in items:
            rows.append({"Operator_name": name, "Replicas": [
                {"Queue_depth": r.queue_depth,
                 "Queue_high_watermark": r.queue_high_watermark,
                 "Frontier_lag_ms": r.frontier_lag_ms,
                 "Credit_wait_s": r.credit_wait_s,
                 "Service_time_usec": r.service_time_us}
                for r in reps]})
        return rows

    def _gauges(self) -> Dict[str, float]:
        from ..monitoring.stats import get_mem_usage_kb
        from ..telemetry.histogram import LogHistogram
        g = self.graph
        stats = g.stats
        if self._sink_ops is None:
            outs = {a for a, _b, _k in self.edges}
            named = {n for e in self.edges for n in e[:2]}
            self._sink_ops = {n for n in named if n not in outs}
        sink_inputs = 0
        with stats.lock:
            recs = [(name, list(reps))
                    for name, reps in stats.records.items()]
            e2e = None
            if stats.histograms:
                e2e = LogHistogram.merged(
                    r.e2e_hist for _n, rs in recs for r in rs)
                if stats.e2e_extra is not None:
                    e2e.merge_from(stats.e2e_extra)
        depth = wait = lag = 0.0
        for name, reps in recs:
            for r in reps:
                depth += r.queue_depth
                wait += r.credit_wait_s
                if r.frontier_lag_ms > lag:
                    lag = r.frontier_lag_ms
            if name in self._sink_ops:
                sink_inputs += sum(r.inputs_received for r in reps)
        now = _time.monotonic()
        tput = 0.0
        if self._last_t is not None and now > self._last_t:
            tput = max(0, sink_inputs - (self._last_sink_inputs or 0)) \
                / (now - self._last_t)
        self._last_t = now
        self._last_sink_inputs = sink_inputs
        # ColumnPool arena occupancy: memory-pressure evidence next to
        # the process RSS (docs/OBSERVABILITY.md "SLO plane")
        pool = getattr(g, "buffer_pool", None)
        ps = pool.stats() if pool is not None else None
        return {
            # results/s: sink items (one TupleBatch counts once), the
            # dashboard result-rate unit -- NOT tuples/s on the batch
            # plane (see diagnosis/history.py SERIES)
            "throughput_rps": round(tput, 1),
            "e2e_p50_us": e2e.percentile(0.50) if e2e is not None else 0.0,
            "e2e_p99_us": e2e.percentile(0.99) if e2e is not None else 0.0,
            "frontier_lag_ms": round(lag, 1),
            "queue_depth": depth,
            "credit_wait_s": round(wait, 3),
            "mem_kb": get_mem_usage_kb(),
            "pool_kb": (ps["bytes"] // 1024) if ps else 0,
            "pool_buffers": ps["buffers"] if ps else 0,
        }

    def _tick(self, now: float) -> None:
        g = self.graph
        g.refresh_gauges()
        self._drain_traces()
        rows = self._operator_rows()
        gauges = self._gauges()
        wall = _time.time()
        self.history.append(wall, gauges)
        for series, direction in WATCHED:
            ev = self.monitor.update(series, gauges[series], direction,
                                     wall)
            if ev is not None:
                kind = ev.pop("event")
                g.flight.record(kind, **ev)
        # SLO plane: judge this gauge row against the declared
        # objectives and advance the burn-rate windows; breach /
        # recovery episodes land in the flight ring
        if self.slo is not None:
            ev = self.slo.update(wall, gauges)
            if ev is not None:
                kind = ev.pop("event")
                g.flight.record(kind, **ev)
            g.stats.set_slo(self.slo.block())
        pool = getattr(g, "buffer_pool", None)
        g.stats.set_pool({
            "Buffers": gauges["pool_buffers"],
            "Bytes": gauges["pool_kb"] * 1024,
            "Hits": pool.hits, "Misses": pool.misses,
        } if pool is not None else None)
        cap = g.config.queue_capacity
        for row in rows:
            name = row["Operator_name"]
            reps = row["Replicas"]
            d = sum(r["Queue_depth"] for r in reps) \
                / (max(1, cap) * max(1, len(reps)))
            prev = self._sustained.get(name, 0.0)
            self._sustained[name] = prev + SUSTAINED_ALPHA * (
                min(1.0, d) - prev)
        attribution = self.attribution.block()
        bottleneck = find_bottlenecks(rows, self.edges, cap,
                                      self._sustained, attribution)
        self._scores = {r["operator"]: r["score"]
                        for r in bottleneck.get("Sinks", [])
                        if r.get("operator")}
        # online re-planner (graph/replanner.py): decision-only here --
        # measures launch deltas and queues any lane flip onto its own
        # worker thread (a flip quiesces the graph for seconds and
        # must not stall this cadence)
        rp = getattr(g, "replanner", None)
        if rp is not None:
            rp.tick()
        self.ticks += 1
        block = {
            "Ticks": self.ticks,
            "Queue_capacity": cap,
            "Rtt_floor_ms": self._rtt_ms,
            "Bottleneck": bottleneck,
            "Attribution": attribution,
            "Anomalies": self.monitor.active(),
            "Anomalies_total": self.monitor.opened_total,
            "Sustained_depth": {k: round(v, 4)
                                for k, v in self._sustained.items()
                                if v >= 0.005},
        }
        g.stats.set_diagnosis(block, self.history.block())
