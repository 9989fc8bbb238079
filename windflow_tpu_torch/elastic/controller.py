"""Hysteresis scaling policy + the controller thread (docs/ELASTIC.md).

Per elastic operator the controller keeps utilization inside a band
around the operator's declared ``target_util``: persistent load above
the band (or a backlog / credit-starvation trigger) scales up toward
``ceil(n * util / target)`` (the DS2 proportional rule, Kalavri et al.
OSDI '18); load below the band with empty queues scales down.  A
per-operator cooldown after every rescale prevents oscillation while
the pipeline re-equilibrates, and every decision is clamped into the
operator's ``[min_replicas, max_replicas]`` interval.

The controller never touches replica threads itself: it calls
``PipeGraph.rescale``, whose pause-drain-migrate mechanics live in
elastic/rescale.py.
"""
from __future__ import annotations

import math
import threading
import time as _time
import warnings
from dataclasses import dataclass
from typing import Optional, Tuple

from .signals import LoadReport, SignalSampler


@dataclass
class ElasticityConfig:
    """Graph-level controller tuning (``RuntimeConfig.elasticity``)."""

    enabled: bool = True
    sample_period_s: float = 0.2
    ewma_alpha: float = 0.5
    # no further rescale of the same operator for this long after one
    cooldown_s: float = 2.0
    # band half-width around each operator's target_util
    hysteresis: float = 0.15
    # backlog trigger: scale up once inbound depth exceeds this fraction
    # of the bounded capacity, regardless of the utilization estimate
    depth_high_frac: float = 0.5
    # credit-starvation trigger: fraction of source wall time spent
    # blocked on credits that counts as upstream pressure
    credit_wait_high: float = 0.5
    # attribution trigger: diagnosis-plane bottleneck score from which
    # being named the root cause behind a sink counts as pressure
    # (fires only for the culprit operator, not the cascade behind it)
    bottleneck_high: float = 0.6
    # max replicas added/removed per decision (0 = jump straight to the
    # proportional estimate)
    max_step: int = 0
    # drain budget handed to PipeGraph.rescale per decision
    quiesce_timeout_s: float = 60.0


def decide(report: LoadReport, spec, cfg: ElasticityConfig) \
        -> Optional[Tuple[int, str]]:
    """(new_parallelism, trigger) or None to hold."""
    n = report.replicas
    hi = spec.target_util + cfg.hysteresis
    lo = spec.target_util - cfg.hysteresis
    pressured = (report.depth_frac >= cfg.depth_high_frac
                 or report.credit_wait_frac >= cfg.credit_wait_high
                 or report.bottleneck >= cfg.bottleneck_high)
    desired = n
    if report.util > hi or pressured:
        base = max(report.util, spec.target_util)  # backlog with a noisy
        #                       low util estimate still adds a replica
        desired = max(n + 1, math.ceil(n * base / spec.target_util))
    elif report.util < lo and report.depth_frac < 0.05 \
            and report.credit_wait_frac < 0.05:
        if report.util > 0.0:
            desired = min(n - 1, max(1, math.ceil(
                n * report.util / spec.target_util)))
        else:
            desired = spec.min_replicas
    if cfg.max_step > 0:
        desired = max(n - cfg.max_step, min(n + cfg.max_step, desired))
    desired = max(spec.min_replicas, min(spec.max_replicas, desired))
    if desired == n:
        return None
    trigger = (f"util={report.util:.2f} depth={report.depth} "
               f"depth_frac={report.depth_frac:.2f} "
               f"credit_wait={report.credit_wait_frac:.2f} "
               f"rate={report.rate:.0f}/s")
    if report.skew > 0.0:
        # audit-plane skew signal: recorded with the decision so an
        # operator diagnosing a scale-up that did not help can see the
        # hot key was the bottleneck, not replica count
        trigger += f" skew={report.skew:.2f}"
    if report.bottleneck > 0.0:
        # diagnosis-plane attribution: the root-cause walk named this
        # operator the bottleneck behind a sink with this score
        trigger += f" bottleneck={report.bottleneck:.2f}"
    return desired, trigger


class ElasticController(threading.Thread):
    """Owns the sampler and applies scaling decisions to the graph."""

    def __init__(self, graph, cfg: Optional[ElasticityConfig] = None):
        super().__init__(name="windflow-elastic-controller", daemon=True)
        self.graph = graph
        self.cfg = cfg or ElasticityConfig()
        self.sampler = SignalSampler(graph.elastic,
                                     self.cfg.sample_period_s,
                                     self.cfg.ewma_alpha)
        self._stop_evt = threading.Event()
        self._cooldown_until: dict = {}
        # (operator, target_n, exc) per failed decision, for operators
        # diagnosing why the controller is holding
        self.failed_rescales: list = []

    def run(self) -> None:
        self.sampler.start()
        try:
            while not self._stop_evt.wait(self.cfg.sample_period_s):
                g = self.graph
                if g._ended or g._cancel.cancelled:
                    return
                now = _time.monotonic()
                for name, report in self.sampler.latest().items():
                    if now < self._cooldown_until.get(name, 0.0):
                        continue
                    handle = g.elastic.get(name)
                    if handle is None:
                        continue
                    d = decide(report, handle.spec, self.cfg)
                    if d is None:
                        continue
                    new_n, trigger = d
                    try:
                        g.rescale(name, new_n, trigger=trigger,
                                  timeout=self.cfg.quiesce_timeout_s)
                    except RuntimeError as exc:
                        # the graph ended/cancelled under us, or the
                        # drain timed out (sources were resumed by the
                        # rescale path); hold and retry after cooldown.
                        # A RescaleError can also mean a PARTIALLY
                        # applied rescale (e.g. a retired replica that
                        # failed to unwind) -- never drop that silently
                        self.failed_rescales.append((name, new_n, exc))
                        warnings.warn(
                            f"elastic rescale of {name!r} to {new_n} "
                            f"failed: {exc!r}; holding for cooldown",
                            RuntimeWarning, stacklevel=1)
                    self.sampler.reset(name)
                    self._cooldown_until[name] = \
                        _time.monotonic() + self.cfg.cooldown_s
        finally:
            self.sampler.stop()

    def stop(self) -> None:
        self._stop_evt.set()
        self.sampler.stop()
        if self.is_alive():
            self.join(timeout=10.0)


def start_controller(graph) -> Optional[ElasticController]:
    """PipeGraph.start hook: spin up the controller when the graph has
    elastic operators and the config does not disable it."""
    cfg = getattr(graph.config, "elasticity", None)
    if cfg is not None and not getattr(cfg, "enabled", True):
        return None
    ctl = ElasticController(graph, cfg)
    ctl.start()
    return ctl
