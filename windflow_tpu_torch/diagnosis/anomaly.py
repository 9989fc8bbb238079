"""Online regression/anomaly detection: EWMA+MAD bands over gauge
series (docs/OBSERVABILITY.md "Diagnosis plane").

Per watched series the monitor keeps two exponentially-weighted
estimates -- the level (EWMA of the value) and the spread (EWMA of the
absolute deviation, the streaming stand-in for a MAD) -- and a band of
``level +/- k * 1.4826 * spread`` (the MAD-to-sigma constant, so ``k``
reads in sigmas for roughly-normal noise).  The spread is floored at a
fraction of the level so a perfectly steady warmup cannot produce a
zero-width band that flags the first wobble.

Direction matters: throughput regresses *below* its band, latency and
frontier lag regress *above*.  A breach must persist ``BREACH_TICKS``
consecutive ticks to open an episode (debounce) and the series must
read in-band ``CLEAR_TICKS`` consecutive ticks to close it.  While an
episode is open the baselines adapt at ``alpha / 8`` -- slow enough
that the flag survives long enough to be seen, fast enough that a
legitimate new operating point (a rescale, a workload shift) re-centers
the band instead of alarming forever.

Episodes surface as ``FlightRecorder("regression")`` events (opened)
and ``regression_cleared`` (closed), the ``Diagnosis.Anomalies`` list
in the stats JSON, and the ``windflow_regressions_active`` gauge on
``/metrics``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

# MAD -> sigma for normal noise
MAD_SIGMA = 1.4826
# consecutive out-of-band ticks before an episode opens
BREACH_TICKS = 2
# consecutive in-band ticks before it closes
CLEAR_TICKS = 3
# spread floor as a fraction of the level (plus an absolute epsilon)
SPREAD_FLOOR_FRAC = 0.05


class _SeriesState:
    __slots__ = ("level", "spread", "n", "active", "breaches", "clears",
                 "since", "last_value", "last_band")

    def __init__(self):
        self.level = 0.0
        self.spread = 0.0
        self.n = 0
        self.active = False
        self.breaches = 0
        self.clears = 0
        self.since = 0.0
        self.last_value = 0.0
        self.last_band = (0.0, 0.0)


class RegressionMonitor:
    """EWMA+MAD band state over named series.  ``update`` returns an
    event dict when an episode opens or closes, else None."""

    def __init__(self, k: float = 4.0, warmup: int = 12,
                 alpha: float = 0.2):
        self.k = max(0.5, float(k))
        self.warmup = max(2, int(warmup))
        self.alpha = min(1.0, max(0.01, float(alpha)))
        self._state: Dict[str, _SeriesState] = {}
        self.opened_total = 0

    def _band(self, st: _SeriesState) -> tuple:
        spread = max(st.spread,
                     SPREAD_FLOOR_FRAC * abs(st.level), 1e-9)
        w = self.k * MAD_SIGMA * spread
        return (st.level - w, st.level + w)

    def update(self, name: str, value: float, direction: str,
               now: float) -> Optional[dict]:
        """``direction``: 'low' flags a value below the band
        (throughput), 'high' a value above it (latency, lag)."""
        st = self._state.get(name)
        if st is None:
            st = self._state[name] = _SeriesState()
        st.last_value = value
        if st.n < self.warmup:
            # prime the baselines; the first sample seeds them outright
            a = 1.0 if st.n == 0 else self.alpha
            st.level += a * (value - st.level)
            st.spread += a * (abs(value - st.level) - st.spread)
            st.n += 1
            st.last_band = self._band(st)
            return None
        lo, hi = self._band(st)
        st.last_band = (lo, hi)
        breached = value < lo if direction == "low" else value > hi
        event = None
        if breached:
            st.clears = 0
            st.breaches += 1
            if not st.active and st.breaches >= BREACH_TICKS:
                st.active = True
                st.since = now
                self.opened_total += 1
                event = {"event": "regression", "series": name,
                         "value": round(value, 3),
                         "band": [round(lo, 3), round(hi, 3)],
                         "direction": direction}
        else:
            st.breaches = 0
            if st.active:
                st.clears += 1
                if st.clears >= CLEAR_TICKS:
                    st.active = False
                    event = {"event": "regression_cleared", "series": name,
                             "value": round(value, 3)}
            st.clears = 0 if not st.active else st.clears
        # adapt: full alpha in-band, alpha/8 on any breached tick or
        # open episode -- a full-rate update on the FIRST breach tick
        # would re-center the band past the step before the debounce
        # tick can confirm it (the episode would never open)
        a = self.alpha / 8.0 if (st.active or breached) else self.alpha
        st.level += a * (value - st.level)
        st.spread += a * (abs(value - st.level) - st.spread)
        st.n += 1
        return event

    def active(self) -> List[dict]:
        """Currently-open episodes (the ``Anomalies`` block)."""
        out = []
        for name, st in self._state.items():
            if st.active:
                out.append({"series": name,
                            "value": round(st.last_value, 3),
                            "band": [round(st.last_band[0], 3),
                                     round(st.last_band[1], 3)],
                            "since": round(st.since, 3)})
        return out
