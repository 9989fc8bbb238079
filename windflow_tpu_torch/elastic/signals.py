"""Load signals for the elastic scaling plane (docs/ELASTIC.md).

The controller's decisions are only as good as its load estimate, so
this module concentrates the measurement side: per elastic operator a
:class:`LoadReport` is derived from three existing instrumentation
sources, none of which was added for elasticity --

* **service-time EWMAs** from the replicas' :class:`StatsRecord`
  (monitoring/stats.py): ``inputs_received`` deltas times the sampled
  mean service time give the DS2-style "useful time" utilization
  estimate (Kalavri et al., OSDI '18);
* **channel depth gauges** (``Channel.depth``, runtime/queues.py): a
  lock-free read of each replica's inbound queue -- sustained backlog
  means the operator is the bottleneck even when the utilization
  estimate is noisy;
* **credit-wait time** from the ingest plane's :class:`CreditGate`
  (ingest/credits.py): a source blocked on credits is upstream evidence
  that some consumer cannot keep up.

A :class:`SignalSampler` thread owns the sampling cadence and publishes
the latest report per operator; the controller (elastic/controller.py)
reads them and decides.
"""
from __future__ import annotations

import threading
import time as _time
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class LoadReport:
    """One sampling window's aggregated view of an elastic operator."""

    operator: str
    replicas: int
    util: float              # EWMA busy fraction per replica (can be > 1)
    depth: int               # tuples parked in the replicas' inbound channels
    depth_frac: float        # depth / total bounded capacity
    credit_wait_frac: float  # fraction of wall time feeding sources spent
    #                          blocked on credits during the window
    rate: float              # channel items/s entering the operator
    at: float                # monotonic sample time
    # audit plane (audit/census.py): estimated share of the hottest
    # key in the operator's KEYBY input stream.  A share near 1.0
    # means one replica owns the hot key regardless of parallelism --
    # scaling out cannot relieve it -- so the controller records the
    # signal with every decision it makes on this operator
    skew: float = 0.0
    # diagnosis plane (diagnosis/bottleneck.py): the root-cause walk's
    # pressure score when IT named this operator the bottleneck behind
    # a sink (0.0 otherwise).  Attribution-aware scaling: unlike the
    # raw depth_frac above, this only fires for the operator where the
    # backpressure actually originates, so a cascade of full queues
    # scales the culprit instead of every operator on the path
    bottleneck: float = 0.0


class OperatorSignals:
    """Per-operator EWMA state over successive samples of its replicas.

    Replica sets change at rescale: totals are tracked as sums over the
    CURRENT replicas, deltas clamped at zero, and ``reset()`` re-primes
    the baselines right after a rescale so the first post-rescale window
    never mixes the two configurations."""

    def __init__(self, handle, alpha: float = 0.5):
        self.handle = handle
        self.alpha = alpha
        self.util = 0.0
        self._last_t: Optional[float] = None
        self._last_inputs = 0
        self._last_wait = 0.0

    def reset(self) -> None:
        self._last_t = None
        self.util = 0.0

    def _gates(self):
        """Credit gates feeding this operator, discovered through the
        CreditedChannel proxies wrapped around the replicas' inbound
        channels (ingest/wiring.py; rescale mirrors the wrap)."""
        gates = {}
        for node in self.handle.replicas:
            ch_gates = getattr(node.channel, "gates", None)
            if ch_gates:
                for gate in ch_gates.values():
                    gates[id(gate)] = gate
        return list(gates.values())

    def sample(self, now: Optional[float] = None) -> Optional[LoadReport]:
        """One sampling window; returns None on the priming call (no
        previous baseline to difference against)."""
        if now is None:
            now = _time.monotonic()
        nodes = list(self.handle.replicas)
        inputs = 0
        svc_sum, svc_n = 0.0, 0
        depth = 0
        cap = 0
        for n in nodes:
            rec = n.stats
            if rec is not None:
                inputs += rec.inputs_received
                if rec.samples:
                    svc_sum += rec.service_time_us
                    svc_n += 1
            ch = n.channel
            if ch is not None:
                depth += ch.depth
                cap += getattr(ch, "capacity", None) or 1 << 20
        gates = self._gates()
        wait = sum(g.wait_time_s for g in gates)
        if self._last_t is None:
            self._last_t = now
            self._last_inputs = inputs
            self._last_wait = wait
            return None
        dt = max(now - self._last_t, 1e-6)
        d_in = max(0, inputs - self._last_inputs)
        d_wait = max(0.0, wait - self._last_wait)
        self._last_t = now
        self._last_inputs = inputs
        self._last_wait = wait
        mean_svc = (svc_sum / svc_n) if svc_n else 0.0
        raw = d_in * mean_svc / (dt * 1e6 * max(1, len(nodes)))
        # clamp the raw sample: a burst consumed from backlog can claim
        # >1 busy fraction, which is signal (scale up), but unbounded
        # spikes would dominate the EWMA for many windows
        raw = min(raw, 4.0)
        self.util = self.alpha * raw + (1.0 - self.alpha) * self.util
        # hot-key skew from the audit plane's KEYBY sketches (0.0 when
        # the auditor is off or the operator is not KEYBY-fed)
        skew = 0.0
        graph = self.handle.pipe.graph
        auditor = getattr(graph, "auditor", None)
        if auditor is not None:
            skew = auditor.skew_of(self.handle.name)
        # root-cause score from the diagnosis plane's bottleneck walk
        # (0.0 when the plane is off or another operator is the cause)
        bottleneck = 0.0
        diag = getattr(graph, "diagnosis", None)
        if diag is not None:
            bottleneck = diag.bottleneck_score(self.handle.name)
        return LoadReport(
            operator=self.handle.name,
            replicas=len(nodes),
            util=self.util,
            depth=depth,
            depth_frac=depth / cap if cap else 0.0,
            credit_wait_frac=min(d_wait / (dt * max(1, len(gates))), 1.0),
            rate=d_in / dt,
            at=now,
            skew=skew,
            bottleneck=bottleneck,
        )


class SignalSampler(threading.Thread):
    """Samples every elastic operator at a fixed cadence and publishes
    the latest LoadReport per operator (thread-safe snapshot via
    ``latest()``)."""

    def __init__(self, elastic: Dict[str, object], period_s: float,
                 alpha: float):
        super().__init__(name="windflow-elastic-sampler", daemon=True)
        self._signals = {name: OperatorSignals(h, alpha)
                         for name, h in elastic.items()}
        self.period_s = period_s
        self._stop_evt = threading.Event()
        self._lock = threading.Lock()
        self._reports: Dict[str, LoadReport] = {}

    def latest(self) -> Dict[str, LoadReport]:
        with self._lock:
            return dict(self._reports)

    def reset(self, name: str) -> None:
        """Drop an operator's baselines and last report (called by the
        controller right after rescaling it)."""
        sig = self._signals.get(name)
        if sig is not None:
            sig.reset()
        with self._lock:
            self._reports.pop(name, None)

    def sample_once(self, now: Optional[float] = None) -> None:
        for name, sig in self._signals.items():
            report = sig.sample(now)
            if report is not None:
                with self._lock:
                    self._reports[name] = report

    def run(self) -> None:
        while not self._stop_evt.wait(self.period_s):
            self.sample_once()

    def stop(self) -> None:
        self._stop_evt.set()
        # join so repeated start/teardown cycles in one process leave
        # no sampler thread behind (the serving plane's census test)
        if self.is_alive() and threading.current_thread() is not self:
            self.join(timeout=5.0)
