"""Lock-free log-bucketed latency histograms (docs/OBSERVABILITY.md).

HDR-style fixed bucket array: 4 sub-buckets per power of two over
[1 us, ~2^28 us ≈ 268 s] plus one overflow bucket, so any latency this
runtime can produce lands in a constant-time increment with <= 19%
relative quantile error (the 2^(1/4) bucket ratio).

Concurrency model (the reason there is no lock): every histogram has
exactly ONE writer -- the replica thread that owns its StatsRecord --
and `merged()` combines the per-replica instances at report time.
Readers (monitoring thread, /metrics renderer) see gauge-grade
snapshots: a read racing a write may lag by one observation, which is
the same contract as the channel depth gauges (runtime/queues.py).
"""
from __future__ import annotations

from math import log2
from typing import Iterable, List, Optional

# sub-buckets per octave; bucket i spans [2^(i/SUB), 2^((i+1)/SUB)) us
SUB = 4
# 28 octaves: 2^28 us ~ 268 s, far beyond any sane streaming latency
N_BUCKETS = 28 * SUB + 1  # +1 overflow


def bucket_le_us(i: int) -> float:
    """Inclusive upper bound (microseconds) of bucket ``i``."""
    if i >= N_BUCKETS - 1:
        return float("inf")
    return 2.0 ** ((i + 1) / SUB)


class LogHistogram:
    """Fixed-array log2 histogram over microsecond latencies."""

    __slots__ = ("counts", "count", "sum_us", "max_us")

    def __init__(self):
        self.counts: List[int] = [0] * N_BUCKETS
        self.count = 0
        self.sum_us = 0.0
        self.max_us = 0.0

    def observe(self, v_us: float) -> None:
        """Record one latency (microseconds).  Single-writer."""
        if v_us < 0.0:
            # gauge-grade stamps can race a few us backwards (a fused
            # producer stamps ctx.last after its emit); a negative
            # duration must not drive sum_us backwards -- Prometheus
            # reads any _sum decrease as a counter reset
            v_us = 0.0
        self.count += 1
        self.sum_us += v_us
        if v_us > self.max_us:
            self.max_us = v_us
        i = int(log2(v_us) * SUB) if v_us > 1.0 else 0
        if i >= N_BUCKETS:
            i = N_BUCKETS - 1
        self.counts[i] += 1

    # -- merge plane (report-time aggregation across replicas) ----------
    def merge_from(self, other: "LogHistogram") -> None:
        oc = other.counts
        c = self.counts
        for i in range(N_BUCKETS):
            c[i] += oc[i]
        self.count += other.count
        self.sum_us += other.sum_us
        if other.max_us > self.max_us:
            self.max_us = other.max_us

    @classmethod
    def merged(cls, hists: Iterable[Optional["LogHistogram"]]) \
            -> "LogHistogram":
        out = cls()
        for h in hists:
            if h is not None:
                out.merge_from(h)
        return out

    # -- queries ---------------------------------------------------------
    def percentile(self, q: float) -> float:
        """Upper bucket bound (us) of the q-quantile (q in [0, 1]).
        The overflow bucket reports the observed max instead of inf."""
        n = self.count
        if n == 0:
            return 0.0
        target = max(1, int(q * n + 0.9999999))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                le = bucket_le_us(i)
                return self.max_us if le == float("inf") else le
        return self.max_us

    def bucket_pairs(self) -> List[List[float]]:
        """Sparse non-cumulative [le_us, count] pairs (non-empty
        buckets only); the OpenMetrics renderer cumulates them."""
        out = []
        for i, c in enumerate(self.counts):
            if c:
                le = bucket_le_us(i)
                out.append([round(le, 3) if le != float("inf") else -1.0,
                            c])
        return out

    def to_dict(self, buckets: bool = False) -> dict:
        d = {
            "n": self.count,
            "mean_us": round(self.sum_us / self.count, 1) if self.count
            else 0.0,
            "p50_us": round(self.percentile(0.50), 1),
            "p95_us": round(self.percentile(0.95), 1),
            "p99_us": round(self.percentile(0.99), 1),
            "max_us": round(self.max_us, 1),
        }
        if buckets:
            d["sum_us"] = round(self.sum_us, 1)
            # le -1.0 encodes the overflow (+Inf) bucket in JSON
            d["buckets"] = self.bucket_pairs()
        return d
