"""Rolling gauge history: a bounded ring of periodic snapshot rows so
trends are queryable in-process (docs/OBSERVABILITY.md "Diagnosis
plane").

Every diagnosis tick (riding the monitor/auditor cadence, rate-limited
by ``RuntimeConfig.diagnosis_interval_s``) appends one row of the
gauges an operator actually trends on; the ring
(``RuntimeConfig.history_len`` rows) serializes columnar into the
stats-JSON ``History`` block -- timestamps once, one array per series
-- which is exactly the shape the web UI's sparklines and the anomaly
detector consume.  Nothing here touches the item path: every value is
a counter delta or a gauge read the runtime already keeps.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

# serialized series, in display order
SERIES = (
    # sink-consumed RESULTS/s over the tick window (items, not tuples:
    # one emitted TupleBatch counts once, the same unit as the
    # dashboard's result-rate tile -- on the batch plane multiply by
    # the batch size for tuples/s)
    "throughput_rps",
    "e2e_p50_us",          # merged traced end-to-end latency
    "e2e_p99_us",
    "frontier_lag_ms",     # most held-back operator (audit plane)
    "queue_depth",         # tuples parked across all inbound channels
    "credit_wait_s",       # cumulative source credit-wait
    "mem_kb",              # process RSS
    "pool_kb",             # ColumnPool arena bytes held (KiB)
    "pool_buffers",        # ColumnPool buffers held
)


class GaugeHistory:
    """Bounded ring of (t, {series: value}) snapshot rows."""

    def __init__(self, maxlen: int):
        self.rows: deque = deque(maxlen=max(2, int(maxlen)))

    def append(self, t: float, values: Dict[str, float]) -> None:
        self.rows.append((t, values))

    def __len__(self) -> int:
        return len(self.rows)

    def series(self, name: str) -> List[float]:
        return [v.get(name, 0.0) for _t, v in self.rows]

    def last(self, name: str) -> Optional[float]:
        if not self.rows:
            return None
        return self.rows[-1][1].get(name)

    def block(self) -> Optional[dict]:
        """The stats-JSON ``History`` block (columnar; timestamps are
        unix seconds rounded to ms)."""
        rows = list(self.rows)
        if not rows:
            return None
        return {
            "Len": len(rows),
            "T": [round(t, 3) for t, _v in rows],
            "Series": {name: [round(v.get(name, 0.0), 3) for _t, v in rows]
                       for name in SERIES},
        }
