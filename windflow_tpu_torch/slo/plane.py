"""Multi-window error-budget burn-rate tracking
(docs/OBSERVABILITY.md "SLO plane").

The model is the SRE burn-rate alert: the graph declares objectives
(:class:`SloConfig`) and a *target* compliance fraction (default 0.99
-- at most 1% of observed stream time may violate any objective).  The
complement ``1 - target`` is the **error budget**.  Every diagnosis
tick the current gauges are judged good or bad per objective; the
**burn rate** over a window is::

    burn = (bad time fraction in the window) / (1 - target)

so ``burn == 1`` means the budget is being consumed exactly as fast as
the target permits, and ``burn == 1 / (1 - target)`` (100x at the
default target) means every observed second violates.

Two windows are kept, the classic fast+slow pair: the **fast** window
(1 min of stream time) reacts within seconds of an onset, the **slow**
window (1 hr equivalent) keeps one transient wobble from paging.  Both
scale by ``window_scale`` so replayed / accelerated streams (and
tests) evaluate in *stream* time rather than wall time.  A breach
opens only when the fast burn exceeds ``fast_burn`` AND the slow burn
exceeds ``slow_burn``, sustained ``BREACH_TICKS`` consecutive ticks
(the same debounce discipline as the anomaly bands); it closes after
``CLEAR_TICKS`` compliant ticks.  Episodes surface as
``FlightRecorder("slo_breach")`` / ``"slo_recovered"`` events, the
``Slo`` stats block, and the ``windflow_slo_*`` metric families.

Evaluation windows early in a run (or right after onset) hold fewer
samples than the nominal span; the burn is computed over the samples
that exist (min 2), which is what makes a sustained violation
detectable within a few ticks of onset instead of a full window later.

Everything here is pure bookkeeping over gauge reads -- the tracker
never touches the item path, so results with the plane on are bitwise
identical to off (bench ``13_slo_overhead`` asserts it).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

# consecutive burning ticks before an episode opens (debounce)
BREACH_TICKS = 2
# consecutive compliant ticks before it closes
CLEAR_TICKS = 3
# samples kept (prunes also by slow-window age; 4096 ~ 1 hr at 1 Hz)
MAX_SAMPLES = 4096
# a window needs at least this many samples to produce a burn rate
MIN_SAMPLES = 2


@dataclass(frozen=True)
class SloConfig:
    """Per-graph service-level objectives (``RuntimeConfig.slo`` /
    ``PipeGraph.with_slo``).  At least one objective must be set.

    * ``p99_ms``             -- traced end-to-end p99 budget (needs
                                ``tracing`` with a sampling period);
    * ``min_throughput_rps`` -- sink results/s floor (the history
                                plane's ``throughput_rps`` unit);
    * ``max_frontier_lag_s`` -- frontier-lag ceiling (audit plane).
    """

    p99_ms: Optional[float] = None
    min_throughput_rps: Optional[float] = None
    max_frontier_lag_s: Optional[float] = None
    # objective compliance fraction; 1 - target is the error budget
    target: float = 0.99
    # nominal window spans, scaled by window_scale into stream time
    fast_window_s: float = 60.0
    slow_window_s: float = 3600.0
    window_scale: float = 1.0
    # burn-rate thresholds: breach needs fast AND slow to concur
    fast_burn: float = 10.0
    slow_burn: float = 1.0
    # ticks ignored at graph start (gauges settle: first throughput
    # delta, first traced closures)
    warmup_ticks: int = 3

    def __post_init__(self):
        if (self.p99_ms is None and self.min_throughput_rps is None
                and self.max_frontier_lag_s is None):
            raise ValueError(
                "SloConfig needs at least one objective (p99_ms, "
                "min_throughput_rps or max_frontier_lag_s)")
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"SLO target must be in (0, 1), "
                             f"got {self.target}")
        for name in ("fast_window_s", "slow_window_s", "window_scale"):
            if getattr(self, name) <= 0:
                raise ValueError(f"SloConfig.{name} must be positive")

    def objectives(self) -> Dict[str, float]:
        return {k: getattr(self, k)
                for k in ("p99_ms", "min_throughput_rps",
                          "max_frontier_lag_s")
                if getattr(self, k) is not None}


def evaluate_objectives(cfg: SloConfig, gauges: Dict[str, float],
                        flow_seen: bool = True) -> List[str]:
    """Names of the objectives the current gauge row violates.  An
    objective whose signal is absent does not count either way: no
    traced closures yet for the p99, and -- via ``flow_seen`` -- no
    first result yet for the throughput floor (a cold start spending
    seconds in a device compile is not an outage; once flow HAS been
    seen, a zero-throughput tick is a genuine violation)."""
    bad: List[str] = []
    if cfg.p99_ms is not None:
        p99_us = float(gauges.get("e2e_p99_us") or 0.0)
        if p99_us > 0 and p99_us / 1e3 > cfg.p99_ms:
            bad.append("e2e_p99")
    if cfg.min_throughput_rps is not None and flow_seen:
        if float(gauges.get("throughput_rps") or 0.0) \
                < cfg.min_throughput_rps:
            bad.append("throughput")
    if cfg.max_frontier_lag_s is not None:
        if float(gauges.get("frontier_lag_ms") or 0.0) / 1e3 \
                > cfg.max_frontier_lag_s:
            bad.append("frontier_lag")
    return bad


class SloTracker:
    """Burn-rate state over the diagnosis tick cadence.  ``update``
    returns a flight-event dict when an episode opens or closes."""

    def __init__(self, cfg: SloConfig):
        self.cfg = cfg
        self.fast_s = cfg.fast_window_s * cfg.window_scale
        self.slow_s = cfg.slow_window_s * cfg.window_scale
        self.budget = 1.0 - cfg.target
        self._samples: deque = deque(maxlen=MAX_SAMPLES)  # (t, bad)
        self.ticks = 0
        self.bad_ticks = 0
        self.breached = False
        self.breaches_total = 0
        self.since: Optional[float] = None
        self._breach_run = 0
        self._clear_run = 0
        self._violating: List[str] = []
        self._burn_fast = 0.0
        self._burn_slow = 0.0
        self._budget_burned = 0.0
        self._values: Dict[str, float] = {}
        self._flow_seen = False

    # -- burn-rate math (pure; unit-tested against hand-computed
    # windows in tests/test_slo.py) -----------------------------------
    def _window(self, now: float, span: float) -> Tuple[int, int, float]:
        """(bad, total, observed_span_s) of the samples within
        ``span`` seconds of ``now``."""
        lo = now - span
        bad = total = 0
        oldest = now
        for t, b in self._samples:
            if t < lo:
                continue
            total += 1
            if b:
                bad += 1
            if t < oldest:
                oldest = t
        return bad, total, max(0.0, now - oldest)

    def burn_rate(self, now: float, span: float) -> float:
        """Bad-time fraction over the window, normalized by the error
        budget.  0.0 until the window holds ``MIN_SAMPLES`` samples."""
        bad, total, _ = self._window(now, span)
        if total < MIN_SAMPLES:
            return 0.0
        return (bad / total) / self.budget

    def budget_burned(self, now: float) -> float:
        """Fraction of the slow window's error budget already consumed
        (can exceed 1.0: the budget is overdrawn)."""
        bad, total, observed = self._window(now, self.slow_s)
        if total < MIN_SAMPLES or observed <= 0.0:
            return 0.0
        bad_time = (bad / total) * min(observed, self.slow_s)
        return bad_time / (self.budget * self.slow_s)

    # -- tick ----------------------------------------------------------
    def update(self, now: float,
               gauges: Dict[str, float]) -> Optional[dict]:
        self.ticks += 1
        # remember flow BEFORE the warmup early-return: a pipeline
        # that bursts during warmup and then wedges must be judged
        # against the throughput floor from the first post-warmup tick
        if float(gauges.get("throughput_rps") or 0.0) > 0.0:
            self._flow_seen = True
        if self.ticks <= self.cfg.warmup_ticks:
            return None
        violating = evaluate_objectives(self.cfg, gauges,
                                        self._flow_seen)
        self._violating = violating
        # latest judged values ride the block so the verdict can cite
        # them even in a merged view (which carries no History block)
        self._values = {
            "e2e_p99_ms": round(
                float(gauges.get("e2e_p99_us") or 0.0) / 1e3, 3),
            "throughput_rps": round(
                float(gauges.get("throughput_rps") or 0.0), 1),
            "frontier_lag_ms": round(
                float(gauges.get("frontier_lag_ms") or 0.0), 1),
        }
        bad = bool(violating)
        if bad:
            self.bad_ticks += 1
        # prune by slow-window age so the deque never serves stale time
        lo = now - self.slow_s
        while self._samples and self._samples[0][0] < lo:
            self._samples.popleft()
        self._samples.append((now, bad))
        self._burn_fast = round(self.burn_rate(now, self.fast_s), 3)
        self._burn_slow = round(self.burn_rate(now, self.slow_s), 3)
        self._budget_burned = round(self.budget_burned(now), 4)
        burning = (self._burn_fast >= self.cfg.fast_burn
                   and self._burn_slow >= self.cfg.slow_burn)
        event = None
        if burning:
            self._clear_run = 0
            self._breach_run += 1
            if not self.breached and self._breach_run >= BREACH_TICKS:
                self.breached = True
                self.breaches_total += 1
                self.since = now
                event = {"event": "slo_breach",
                         "violating": list(violating),
                         "burn_fast": self._burn_fast,
                         "burn_slow": self._burn_slow,
                         "budget_burned": self._budget_burned}
        else:
            self._breach_run = 0
            if self.breached:
                self._clear_run += 1
                if self._clear_run >= CLEAR_TICKS:
                    self.breached = False
                    event = {"event": "slo_recovered",
                             "burn_fast": self._burn_fast,
                             "budget_burned": self._budget_burned}
        return event

    def block(self) -> dict:
        """The stats-JSON ``Slo`` block (every field optional to
        readers, like every block in the report)."""
        return {
            "Objectives": self.cfg.objectives(),
            "Target": self.cfg.target,
            "Windows": {"fast_s": round(self.fast_s, 3),
                        "slow_s": round(self.slow_s, 3)},
            "Ticks": self.ticks,
            "Bad_ticks": self.bad_ticks,
            "Burn_rate_fast": self._burn_fast,
            "Burn_rate_slow": self._burn_slow,
            "Budget_burned": self._budget_burned,
            "Breached": self.breached,
            "Breaches_total": self.breaches_total,
            "Violating": list(self._violating),
            "Values": dict(self._values),
            "Since": round(self.since, 3) if self.since else None,
        }


def merge_slo(blocks: List[dict]) -> Optional[dict]:
    """Fold per-worker ``Slo`` blocks into the cluster view: worst
    news wins (any breach breaches the merged view; burn rates and the
    burned budget take the max; episode counts sum).  Tolerant of
    heterogeneous/missing fields like every stats reader."""
    blocks = [b for b in blocks if isinstance(b, dict)]
    if not blocks:
        return None
    first = blocks[0]
    violating: List[str] = []
    for b in blocks:
        for v in b.get("Violating") or ():
            if v not in violating:
                violating.append(v)
    sinces = [b.get("Since") for b in blocks
              if b.get("Breached") and b.get("Since")]
    values: Dict[str, float] = {}
    for b in blocks:
        for k, v in (b.get("Values") or {}).items():
            try:
                v = float(v)
            except (TypeError, ValueError):
                continue
            # element-wise worst: latency/lag take the max, the
            # throughput floor the min
            if k == "throughput_rps":
                values[k] = min(values.get(k, v), v)
            else:
                values[k] = max(values.get(k, v), v)
    return {
        "Objectives": first.get("Objectives"),
        "Target": first.get("Target"),
        "Windows": first.get("Windows"),
        "Ticks": max(int(b.get("Ticks", 0) or 0) for b in blocks),
        "Bad_ticks": sum(int(b.get("Bad_ticks", 0) or 0)
                         for b in blocks),
        "Burn_rate_fast": max(float(b.get("Burn_rate_fast", 0) or 0)
                              for b in blocks),
        "Burn_rate_slow": max(float(b.get("Burn_rate_slow", 0) or 0)
                              for b in blocks),
        "Budget_burned": max(float(b.get("Budget_burned", 0) or 0)
                             for b in blocks),
        "Breached": any(b.get("Breached") for b in blocks),
        "Breaches_total": sum(int(b.get("Breaches_total", 0) or 0)
                              for b in blocks),
        "Violating": violating,
        "Values": values,
        "Since": min(sinces) if sinces else None,
        "Workers": len(blocks),
    }
