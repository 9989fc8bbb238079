"""Tiered keyed-state backend (docs/RESILIENCE.md "Tiered state &
memory pressure").

Keyed stores that do not fit in memory: hot keys stay live Python
objects (or device-resident: the resident FFAT forest), warm keys are
pickled host bytes, cold keys spill to disk in crash-safe segments.
The whole tier ladder lives UNDER the existing ``keyed_state_dict``
contract, so every plane built on that contract -- delta epoch
snapshots, rescale repartition, supervision rewind, census -- composes
without knowing tiers exist.

* :class:`~windflow_tpu_torch.state.tiers.TieredKeyedStore` -- the dict-like
  store a keyed logic adopts via ``enable_tiered_state``;
* :class:`~windflow_tpu_torch.state.spill.SpillStore` -- append-friendly
  immutable on-disk segments (atomic-rename protocol, digest-named so
  a torn segment is detected on read);
* :class:`~windflow_tpu_torch.state.budget.StateBudget` -- the per-store
  watermark governor under ``RuntimeConfig.state_budget_bytes``;
* :class:`TieredStateManager` -- graph-level wiring: splits the graph
  budget across capable replicas and re-enables tiering on replicas
  born later (elastic ``_grow``, supervised heals).
"""
from __future__ import annotations

import os
import re
from typing import Dict, Optional

from .budget import StateBudget
from .spill import SpillStore
from .tiers import TieredKeyedStore

__all__ = ["SpillStore", "StateBudget", "TieredKeyedStore",
           "TieredStateManager", "attach_tiered_state"]

_SAFE = re.compile(r"[^A-Za-z0-9_.-]+")


def _safe(name: str) -> str:
    return _SAFE.sub("_", name)


class TieredStateManager:
    """Per-graph tiered-state wiring, attached by ``PipeGraph.start``
    as ``graph.tiered_state``.

    Splits ``RuntimeConfig.state_budget_bytes`` evenly across the
    replicas that expose ``enable_tiered_state`` and owns the spill
    root (``<log_dir>/state_spill/<graph>/<replica>/``).  Kept on the
    graph so replicas created AFTER start -- elastic ``_grow`` growth,
    supervised heals -- get the same enablement as their build-time
    siblings (``enable(logic, replica_name)`` is idempotent per
    name: re-enabling wipes the previous incarnation's spill
    segments, which are a runtime working set, not a durability
    surface)."""

    def __init__(self, graph, capable: int):
        cfg = graph.config
        self.graph = graph
        self.budget_bytes = int(cfg.state_budget_bytes)
        self.share = max(1, self.budget_bytes // max(1, capable))
        self.tier_cfg = cfg.state_tiers
        self.spill_root = os.path.join(
            cfg.log_dir or "log", "state_spill", _safe(graph.name))
        self.stores: Dict[str, TieredKeyedStore] = {}

    def enable(self, logic, replica_name: str) -> Optional[TieredKeyedStore]:
        hook = getattr(logic, "enable_tiered_state", None)
        if hook is None:
            return None
        g = self.graph
        spill = SpillStore(os.path.join(self.spill_root,
                                        _safe(replica_name)))
        spill.fault_plan = g.config.fault_plan
        tc = self.tier_cfg
        store = TieredKeyedStore(
            budget=StateBudget(
                self.share,
                demote_frac=getattr(tc, "demote_frac", 0.7),
                spill_frac=getattr(tc, "spill_frac", 0.85)),
            spill=spill,
            node=replica_name,
            flight=g.flight,
            dead_letters=g.dead_letters,
            hot_max_keys=getattr(tc, "hot_max_keys", None),
            maintain_every=getattr(tc, "maintain_every", 64),
            spill_batch=getattr(tc, "spill_batch", 256))
        hook(store)
        self.stores[replica_name] = store
        return store

    def release(self, replica_name: str) -> None:
        """Drop a retired replica's store (rescale shrink): its keys
        migrated with the keyed-state merge, so the spill segments on
        disk are dead weight."""
        store = self.stores.pop(replica_name, None)
        if store is not None:
            store.spill.clear()


def attach_tiered_state(graph) -> Optional[TieredStateManager]:
    """Wire tiered keyed state across ``graph`` (called by
    ``PipeGraph.start`` once fault/flight/dead-letter binding is done,
    BEFORE the audit plane attaches -- the auditor hands its hot-key
    sketches to the stores it finds).  Returns the manager, or None
    when no ``state_budget_bytes`` is configured or no logic is
    capable."""
    if not getattr(graph.config, "state_budget_bytes", None):
        return None
    from ..runtime.node import FusedLogic

    def capable_logics(node):
        if isinstance(node.logic, FusedLogic):
            for seg in node.logic.segments:
                if getattr(seg.logic, "enable_tiered_state", None):
                    yield seg.logic, seg.name
        elif getattr(node.logic, "enable_tiered_state", None):
            yield node.logic, node.name

    targets = [(lg, name) for n in graph._all_nodes()
               for lg, name in capable_logics(n)]
    if not targets:
        return None
    mgr = TieredStateManager(graph, len(targets))
    for lg, name in targets:
        mgr.enable(lg, name)
    return mgr
