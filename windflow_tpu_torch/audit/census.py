"""Keyed-state census + hot-key skew sketch
(docs/OBSERVABILITY.md "Keyed-state census").

Two independent skew views:

* **State census** -- each replica whose logic implements
  ``keyed_state_census()`` (AccumulatorLogic's fold store, the device
  window engines' per-key window state) reports ``(key_count,
  bytes_estimate)`` as a lock-free gauge read; rows land in the stats
  JSON ``Skew.Census`` table.
* **Hot-key sketch** -- a space-saving top-K sketch (Metwally et al.,
  the classic bounded heavy-hitters structure) attached to every KEYBY
  ``StandardEmitter``.  The batch plane offers one sampled
  ``np.unique`` per S batches (default 1-in-8), the record plane one
  sampled key per 16 items, so the hot path pays a counter test.  The
  top-1 share is the **skew signal** the elastic plane reads: a 0.9
  share means scaling out cannot help -- one replica owns the hot key
  no matter the parallelism.
"""
from __future__ import annotations

from typing import Dict, List, Optional

# sampling strides (the sketch estimates shares, not exact counts)
BATCH_SAMPLE = 8
SCALAR_SAMPLE = 16


class SpaceSavingSketch:
    """Bounded top-K heavy hitters.  Single-writer (the emitting
    thread); the auditor snapshots ``counts`` via ``dict()`` (atomic
    under the GIL)."""

    __slots__ = ("k", "counts", "errs", "total", "_batches", "_items")

    def __init__(self, k: int = 16):
        self.k = max(1, int(k))
        self.counts: Dict = {}
        self.errs: Dict = {}
        self.total = 0
        self._batches = 0
        self._items = 0

    # -- hot-path offers ----------------------------------------------
    def offer_batch(self, keys) -> None:
        """Columnar KEYBY path: sampled per-batch key histogram."""
        self._batches += 1
        if self._batches % BATCH_SAMPLE:
            return
        import numpy as np
        u, c = np.unique(keys, return_counts=True)
        for key, cnt in zip(u.tolist(), c.tolist()):
            self._offer(key, cnt * BATCH_SAMPLE)

    def offer(self, key) -> None:
        """Record KEYBY path: sampled 1-in-N scalar offer."""
        self._items += 1
        if self._items % SCALAR_SAMPLE:
            return
        self._offer(key, SCALAR_SAMPLE)

    def _offer(self, key, w: int) -> None:
        self.total += w
        counts = self.counts
        cur = counts.get(key)
        if cur is not None:
            counts[key] = cur + w
            return
        if len(counts) < self.k:
            counts[key] = w
            self.errs[key] = 0
            return
        # space-saving eviction: replace the current minimum, carrying
        # its count as the newcomer's overestimation error
        victim = min(counts, key=counts.get)
        floor = counts.pop(victim)
        self.errs.pop(victim, None)
        counts[key] = floor + w
        self.errs[key] = floor

    # -- reads ---------------------------------------------------------
    def top(self, n: Optional[int] = None) -> List[list]:
        counts = dict(self.counts)
        errs = dict(self.errs)
        rows = sorted(counts.items(), key=lambda kv: -kv[1])
        if n is not None:
            rows = rows[:n]
        return [[k, c, errs.get(k, 0)] for k, c in rows]

    def top_share(self) -> float:
        """Estimated share of the hottest key in the observed stream."""
        if not self.counts or not self.total:
            return 0.0
        key, cnt = max(self.counts.items(), key=lambda kv: kv[1])
        cnt -= self.errs.get(key, 0)  # conservative: strip overcount
        return max(0.0, min(1.0, cnt / self.total))


def take_census(nodes) -> List[dict]:
    """Per-replica keyed-state rows from the ``keyed_state_census``
    hooks (fused nodes report per segment under original names).  A
    hook may return ``(keys, bytes)`` or -- tiered stores
    (state/tiers.py) -- ``(keys, bytes, extras)`` where ``extras``
    carries per-tier splits and spill/promotion/shed counters that
    land verbatim on the row."""
    from ..runtime.node import FusedLogic
    rows: List[dict] = []

    def probe(logic, name):
        fn = getattr(logic, "keyed_state_census", None)
        if fn is None:
            return
        try:
            got = fn()
        except (RuntimeError, TypeError):
            return
        if got is None:
            return
        keys, nbytes = got[0], got[1]
        row = {"replica": name, "keys": int(keys),
               "bytes_est": int(nbytes)}
        if len(got) > 2 and isinstance(got[2], dict):
            row.update(got[2])
        rows.append(row)

    for n in nodes:
        if isinstance(n.logic, FusedLogic):
            for seg in n.logic.segments:
                probe(seg.logic, seg.name)
        else:
            probe(n.logic, n.name)
    return rows
