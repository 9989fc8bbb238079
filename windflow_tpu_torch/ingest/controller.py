"""Latency-targeting adaptive microbatch controller (AIMD).

Static ``microbatch`` / ``inflight_depth`` knobs force one operating
point onto every load level: big batches amortize per-batch overhead
but park tuples in staging, small batches bound latency but starve the
columnar plane.  For ingest-fed runs this controller replaces them
with a classic AIMD loop (the TCP congestion-control shape, which
Flink's buffer debloating and adaptive batching schemes also use)
against an explicit ``RuntimeConfig.latency_target_ms`` budget:

* the **signal** is the queue-residency latency of emitted batches
  (spend -> release time measured by the :class:`~.credits.CreditGate`),
  i.e. how long ingested data waits before the downstream operator
  takes it -- the component of end-to-end latency the ingest plane
  controls;
* while the observed p-high latency stays under budget, batch size
  grows **additively** (amortizing per-batch costs) and the flush
  interval relaxes toward its cap;
* one over-budget adjustment window **multiplicatively** halves both,
  so bursts drain quickly and the operating point oscillates just
  under the target.

The controller also steers the downstream device window engine for
ingest-fed graphs: `wiring.py` binds any directly-fed
``WinSeqTPULogic`` and the controller rewrites its
``max_batch_delay_ms`` launch bound to a fraction of the latency
budget, so the engine's launch cadence and the ingest batch cadence
track the same target instead of two hand-tuned constants.
"""
from __future__ import annotations

import threading
import time as _time
from collections import deque
from typing import List, Optional, Tuple

DEFAULT_MIN_BATCH = 1 << 10
DEFAULT_MAX_BATCH = 1 << 20
DEFAULT_FLUSH_MS = 5.0
MAX_FLUSH_MS = 100.0
# fraction of the latency budget granted to the engine's launch delay
ENGINE_DELAY_FRACTION = 0.25


class MicrobatchController:
    """AIMD on (coalesced batch size, flush interval) vs a latency
    target.  Thread-safe: samples arrive from the consumer thread
    (credit releases), decisions are read from the source/flusher
    thread."""

    def __init__(self, latency_target_ms: Optional[float] = None,
                 min_batch: int = DEFAULT_MIN_BATCH,
                 max_batch: int = DEFAULT_MAX_BATCH,
                 initial_batch: Optional[int] = None,
                 adjust_interval_s: float = 0.1,
                 percentile: float = 0.95):
        self.latency_target_ms = latency_target_ms
        self.min_batch = max(1, min_batch)
        self.max_batch = max(self.min_batch, max_batch)
        self.batch_size = min(self.max_batch,
                              initial_batch or (self.min_batch * 4))
        self.flush_interval_ms = DEFAULT_FLUSH_MS
        self.adjust_interval_s = adjust_interval_s
        self.percentile = percentile
        self._lock = threading.Lock()
        self._samples: List[float] = []
        self._last_adjust = _time.monotonic()
        # additive step: a fraction of the span so convergence does not
        # depend on the absolute batch scale
        self._step = max(self.min_batch,
                         (self.max_batch - self.min_batch) // 32)
        # (monotonic time, batch_size) decision trace for the
        # monitoring JSON / web UI: a ROLLING window (maxlen), so a
        # long-running source keeps its most recent decisions instead
        # of freezing at the first 4096 (the old append-guard behaviour)
        self.trace: deque = deque([(_time.monotonic(), self.batch_size)],
                                  maxlen=4096)
        self.adjustments = 0

    # -- signal (called by CreditGate.release, consumer thread) --------
    def observe(self, latency_s: float) -> None:
        with self._lock:
            if len(self._samples) < 4096:
                self._samples.append(latency_s)
            now = _time.monotonic()
            if now - self._last_adjust >= self.adjust_interval_s:
                self._adjust_locked(now)

    def _adjust_locked(self, now: float) -> None:
        samples = self._samples
        if not samples:
            return
        self._samples = []
        self._last_adjust = now
        if self.latency_target_ms is None:
            return  # no budget: keep the static operating point
        samples.sort()
        p_high = samples[min(len(samples) - 1,
                             int(len(samples) * self.percentile))]
        target_s = self.latency_target_ms / 1e3
        if p_high > target_s:
            # multiplicative decrease: drain the backlog fast
            self.batch_size = max(self.min_batch, self.batch_size // 2)
            self.flush_interval_ms = max(0.5, self.flush_interval_ms / 2)
        else:
            # additive increase: feel for the throughput ceiling
            self.batch_size = min(self.max_batch,
                                  self.batch_size + self._step)
            self.flush_interval_ms = min(
                MAX_FLUSH_MS, self.latency_target_ms * 0.5,
                self.flush_interval_ms * 1.25)
        self.adjustments += 1
        self.trace.append((now, self.batch_size))

    # -- decisions (read by the source / flusher thread) ---------------
    def target_batch(self) -> int:
        return self.batch_size

    def set_max_batch(self, max_batch: int) -> None:
        """Pre-start rebudget (wiring mirrors a credit-gate resize here
        so a RuntimeConfig-sized budget also widens the AIMD ceiling)."""
        self.max_batch = max(self.min_batch, max_batch)
        self.batch_size = min(self.batch_size, self.max_batch)
        self._step = max(self.min_batch,
                         (self.max_batch - self.min_batch) // 32)

    def flush_deadline_s(self) -> float:
        return self.flush_interval_ms / 1e3

    # -- downstream engine steering (wiring.py) ------------------------
    def bind_engine(self, engine_logic) -> None:
        """Rewrite a directly-fed device window engine's static launch
        bound from the shared latency budget (ingest-fed runs only:
        graphs without an ingest source keep their configured knobs)."""
        if self.latency_target_ms is None:
            return
        delay = max(0.5, self.latency_target_ms * ENGINE_DELAY_FRACTION)
        engine_logic.max_batch_delay_ms = min(
            engine_logic.max_batch_delay_ms, delay)

    def trace_tail(self, n: int = 32) -> List[Tuple[float, int]]:
        with self._lock:
            return list(self.trace)[-n:]
