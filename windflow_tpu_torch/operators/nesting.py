"""Complex nesting: Win_Farm / Key_Farm replicating Pane_Farm or
Win_MapReduce instances -- host or device variants.

Re-design of the reference's nesting constructors (win_farm.hpp:259-378
for WF(PF), :379-... for WF(WMR); key_farm.hpp:254-... for KF(PF/WMR);
device nesting win_farm_gpu.hpp:73-76,:111-117 and key_farm_gpu.hpp:254
for WF_GPU(PF_GPU)/KF_GPU(WMR_GPU)) and MultiPipe's complex-nesting
dispatch (multipipe.hpp:1014-1099).  The same grouped-stage wiring
serves both planes: a device inner just contributes WinSeqTPULogic
replicas instead of WinSeqLogic ones.

Construction follows the reference exactly:
* WF(inner): R copies of the inner operator, copy i configured with
  ``WinOperatorConfig(0, 1, slide, i, R, slide)`` and private slide
  ``slide * R`` (win_farm.hpp:326: each copy owns every R-th window);
  the outer WFEmitter multicasts tuples to the copies whose windows
  contain them; the inner stages are **group-wired** so copy i's
  second stage consumes only copy i's first stage.
* KF(inner): R copies with identity configs; the outer KFEmitter sends
  each key's whole substream to one copy (keys never cross copies).
* CB windows inside a complex nesting require the broadcast +
  TS-renumbering plane (multipipe.hpp:1039-1051), available in
  DETERMINISTIC/PROBABILISTIC modes; MultiPipe rejects CB nesting in
  DEFAULT mode just like plain Win_Farm.
"""
from __future__ import annotations

from typing import List, Union

from ..core.basic import (OptLevel, Pattern, Role, RoutingMode, WinOperatorConfig)
from ..runtime.emitters import StandardEmitter, TreeEmitter
from ..runtime.win_routing import KFEmitter, WFEmitter, WidOrderCollector
from .base import Operator, StageSpec
from .pane_farm import PaneFarm
from .win_mapreduce import WinMapReduce
from .tpu.farms_tpu import PaneFarmTPU, WinMapReduceTPU

InnerOp = Union[PaneFarm, WinMapReduce, PaneFarmTPU, WinMapReduceTPU]


def _clone_inner(inner: InnerOp, idx: int, n_replicas: int,
                 outer_slide: int, private_slide: int) -> InnerOp:
    """Build copy ``idx`` of the inner operator with the nested config
    (the panewrap_farm_t construction, win_farm.hpp:324-374; the device
    twins follow win_farm_gpu.hpp:73-76 -- same arithmetic, device
    engine replicas)."""
    cfg = WinOperatorConfig(0, 1, outer_slide, idx, n_replicas, outer_slide)
    if isinstance(inner, PaneFarm):
        return PaneFarm(
            inner.plq_func, inner.wlq_func, inner.win_len, private_slide,
            inner.win_type, inner.plq_parallelism, inner.wlq_parallelism,
            inner.triggering_delay, inner.plq_incremental,
            inner.wlq_incremental, f"{inner.name}_{idx}",
            inner.result_factory, inner.closing_func, ordered=False,
            opt_level=inner.opt_level, config=cfg)
    if isinstance(inner, WinMapReduce):
        return WinMapReduce(
            inner.map_func, inner.reduce_func, inner.win_len, private_slide,
            inner.win_type, inner.map_parallelism, inner.reduce_parallelism,
            inner.triggering_delay, inner.map_incremental,
            inner.reduce_incremental, f"{inner.name}_{idx}",
            inner.result_factory, inner.closing_func, ordered=False,
            opt_level=inner.opt_level, config=cfg)
    if isinstance(inner, PaneFarmTPU):
        return PaneFarmTPU(
            inner.plq, inner.wlq, inner.win_len, private_slide,
            inner.win_type, inner.plq_par, inner.wlq_par,
            plq_on_tpu=inner.plq_on_tpu, wlq_on_tpu=not inner.plq_on_tpu,
            batch_len=inner.batch_len,
            max_buffer_elems=inner.max_buffer_elems,
            inflight_depth=inner.inflight_depth,
            max_batch_delay_ms=inner.max_batch_delay_ms,
            emit_batches=inner.emit_batches,
            triggering_delay=inner.triggering_delay,
            name=f"{inner.name}_{idx}", result_factory=inner.result_factory,
            value_of=inner.value_of, ordered=False,
            opt_level=inner.opt_level, config=cfg, device=inner.device)
    if isinstance(inner, WinMapReduceTPU):
        return WinMapReduceTPU(
            inner.map_stage, inner.reduce_stage, inner.win_len,
            private_slide, inner.win_type, inner.map_par, inner.reduce_par,
            map_on_tpu=inner.map_on_tpu, batch_len=inner.batch_len,
            max_buffer_elems=inner.max_buffer_elems,
            inflight_depth=inner.inflight_depth,
            max_batch_delay_ms=inner.max_batch_delay_ms,
            triggering_delay=inner.triggering_delay,
            name=f"{inner.name}_{idx}", result_factory=inner.result_factory,
            value_of=inner.value_of, ordered=False, config=cfg,
            device=inner.device)
    raise TypeError(f"cannot nest {type(inner).__name__}")


def _grouped_stages(copies: List[InnerOp], name: str) -> List[StageSpec]:
    """Flatten the copies' stages into grouped StageSpecs: stage s of
    the result holds stage s of every copy, with group ids wiring each
    copy's pipeline end-to-end."""
    per_copy = [c.stages() for c in copies]
    n_stages = len(per_copy[0])
    out: List[StageSpec] = []
    for s in range(n_stages):
        replicas, groups, group_emitters, group_collectors = [], [], [], []
        ordering = per_copy[0][s].ordering_mode
        for g, stages in enumerate(per_copy):
            st = stages[s]
            replicas.extend(st.replicas)
            groups.extend([g] * len(st.replicas))
            group_emitters.append(st.emitter_proto)
            group_collectors.append(st.collector)
        if all(c is None for c in group_collectors):
            group_collectors = None
        out.append(StageSpec(
            f"{name}_s{s}", replicas,
            emitter_proto=StandardEmitter(),  # replaced for stage 0 below
            routing=RoutingMode.COMPLEX, ordering_mode=ordering,
            groups=groups, group_emitters=group_emitters,
            group_collectors=group_collectors))
    return out


class NestedWinFarm(Operator):
    """Win_Farm whose workers are Pane_Farm / Win_MapReduce copies."""

    def __init__(self, inner: InnerOp, num_replicas: int,
                 name: str = "wf_nested", ordered: bool = True,
                 opt_level: OptLevel = OptLevel.LEVEL0):
        if num_replicas < 1:
            raise ValueError("number of inner replicas must be >= 1")
        total = num_replicas * inner.parallelism
        super().__init__(name, total, RoutingMode.COMPLEX, Pattern.WIN_FARM)
        if inner.used:
            raise RuntimeError(
                "inner operator already used in a nested structure")
        if (isinstance(inner, (PaneFarm, PaneFarmTPU))
                and inner.win_len <= inner.slide_len * num_replicas):
            # each copy runs with private slide = slide * num_replicas
            # (win_farm.hpp:326); Pane_Farm rejects slide >= win
            # (pane_farm.hpp:170-173), so fail here, eagerly, with the
            # nesting-level numbers
            raise ValueError(
                f"Win_Farm({num_replicas}) over a Pane_Farm with "
                f"win={inner.win_len} slide={inner.slide_len}: the "
                f"copies' private slide {inner.slide_len * num_replicas} "
                f">= win; Pane_Farm requires sliding windows "
                f"(pane_farm.hpp:170-173) -- reduce the replica count "
                f"or widen the window")
        inner.used = True
        self.inner = inner
        self.num_replicas = num_replicas
        self.ordered = ordered
        self.opt_level = opt_level
        self.win_type = inner.win_type
        self.win_len = inner.win_len
        self.slide_len = inner.slide_len
        self.role = Role.SEQ

    def stages(self):
        R = self.num_replicas
        slide = self.slide_len
        copies = [_clone_inner(self.inner, i, R, slide, slide * R)
                  for i in range(R)]
        stages = _grouped_stages(copies, self.name)
        # stage 0 inbound: outer WF emitter multicasting into the copies'
        # own first-stage emitters (the LEVEL2 Tree_Emitter fusion,
        # win_farm.hpp:202-227, here the only distribution mode)
        root = WFEmitter(self.win_len, slide, R, self.win_type, Role.SEQ,
                         id_outer=0, n_outer=1, slide_outer=slide)
        stages[0].emitter_proto = TreeEmitter(root,
                                              stages[0].group_emitters)
        stages[0].group_emitters = None  # stage 0 is fed ungrouped
        if self.ordered:
            stages[-1].collector = WidOrderCollector()
        return stages


class NestedKeyFarm(Operator):
    """Key_Farm whose workers are Pane_Farm / Win_MapReduce copies
    (key_farm.hpp nesting ctors :254-...)."""

    def __init__(self, inner: InnerOp, num_replicas: int,
                 name: str = "kf_nested",
                 opt_level: OptLevel = OptLevel.LEVEL0):
        if num_replicas < 1:
            raise ValueError("number of inner replicas must be >= 1")
        total = num_replicas * inner.parallelism
        super().__init__(name, total, RoutingMode.KEYBY, Pattern.KEY_FARM)
        if inner.used:
            raise RuntimeError(
                "inner operator already used in a nested structure")
        inner.used = True
        self.inner = inner
        self.num_replicas = num_replicas
        self.opt_level = opt_level
        self.win_type = inner.win_type
        self.win_len = inner.win_len
        self.slide_len = inner.slide_len

    def stages(self):
        R = self.num_replicas
        # keys are disjoint across copies: identity configs, same slide
        copies = [_clone_inner(self.inner, 0, 1, self.slide_len,
                               self.slide_len) for _ in range(R)]
        for i, c in enumerate(copies):
            c.name = f"{self.inner.name}_{i}"
        stages = _grouped_stages(copies, self.name)
        root = KFEmitter(R)
        stages[0].emitter_proto = TreeEmitter(root,
                                              stages[0].group_emitters)
        stages[0].group_emitters = None
        return stages
