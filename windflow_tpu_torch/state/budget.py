"""Per-store memory-budget governor (docs/RESILIENCE.md "Tiered state
& memory pressure").

One :class:`StateBudget` per :class:`~windflow_tpu_torch.state.tiers.
TieredKeyedStore`: a hard byte ceiling (the replica's share of
``RuntimeConfig.state_budget_bytes``) with two watermarks below it::

    0 ........ demote ........ spill ........ budget
                 (0.7B)         (0.85B)        (B)

* above **demote**: hot keys (live objects) are demoted to warm
  (pickled host bytes) -- cheap, reversible, frees the object graph;
* above **spill**: warm keys move to cold disk segments in batches;
* above the **budget** itself: admission-style shed -- the coldest
  keys are dropped into ``dead_letters`` with a ``state_pressure``
  flight event.  Degraded, loud, and alive beats an allocator crash.

Process RSS (``monitoring/stats.get_mem_usage_kb``) is deliberately
NOT the enforcement signal: it is process-global (shared by pools,
JAX, every other replica) and lags the allocator.  The governor
enforces the store's own byte accounting; RSS stays what the History
gauges assert in the soak test -- the independent evidence that the
accounting tracks reality.
"""
from __future__ import annotations


class StateBudget:
    __slots__ = ("limit", "demote_at", "spill_at")

    def __init__(self, limit: int, demote_frac: float = 0.7,
                 spill_frac: float = 0.85):
        self.limit = max(1, int(limit))
        demote_frac = min(max(float(demote_frac), 0.05), 1.0)
        spill_frac = min(max(float(spill_frac), demote_frac), 1.0)
        self.demote_at = int(self.limit * demote_frac)
        self.spill_at = int(self.limit * spill_frac)

    def pressure(self, mem_bytes: int) -> str:
        """Band of ``mem_bytes`` (hot + warm accounting) on the
        ladder: 'ok' | 'demote' | 'spill' | 'shed'."""
        if mem_bytes > self.limit:
            return "shed"
        if mem_bytes > self.spill_at:
            return "spill"
        if mem_bytes > self.demote_at:
            return "demote"
        return "ok"
