"""Win_MapReduce: intra-window data parallelism.

Re-design of reference ``wf/win_mapreduce.hpp`` (1096 LoC): each
window's tuples are striped round-robin across MAP workers (WinMap
emitter, wm_nodes.hpp:62); every MAP worker runs a Win_Seq(role MAP)
over its stripe with the *same* win/slide (win_mapreduce.hpp:186-191)
and emits partials with dense striped ids (emit_counter start i, step
map_parallelism); a collector reorders partials per key; the REDUCE
stage consumes CB tumbling windows of exactly ``map_parallelism``
partials (win_mapreduce.hpp:208-221).  The ML analogue is
tensor/sequence-parallel reduction within one window (psum over the
stripe partials, SURVEY.md §2.4).
"""
from __future__ import annotations

from typing import Callable

from ..core.basic import (OptLevel, OrderingMode, Pattern, Role, RoutingMode,
                          WinOperatorConfig, WinType)
from ..core.tuples import BasicRecord
from ..runtime.emitters import StandardEmitter
from ..runtime.win_routing import WidOrderCollector, WinMapEmitter
from .base import Operator, StageSpec
from .win_farm import WinFarm
from .win_seq import WinSeqLogic


class WinMapReduce(Operator):
    def __init__(self, map_func: Callable, reduce_func: Callable,
                 win_len: int, slide_len: int, win_type: WinType,
                 map_parallelism: int = 2, reduce_parallelism: int = 1,
                 triggering_delay: int = 0, map_incremental: bool = False,
                 reduce_incremental: bool = False, name: str = "win_mr",
                 result_factory=BasicRecord, closing_func=None,
                 ordered: bool = True,
                 opt_level: OptLevel = OptLevel.LEVEL0,
                 config: WinOperatorConfig = None):
        super().__init__(name, map_parallelism + reduce_parallelism,
                         RoutingMode.COMPLEX, Pattern.WIN_MAPREDUCE)
        if win_len == 0 or slide_len == 0:
            raise ValueError("window length and slide cannot be zero")
        if map_parallelism < 1:
            raise ValueError("MAP parallelism must be >= 1")
        self.map_func = map_func
        self.reduce_func = reduce_func
        self.win_len = win_len
        self.slide_len = slide_len
        self.win_type = win_type
        self.map_parallelism = map_parallelism
        self.reduce_parallelism = reduce_parallelism
        self.triggering_delay = triggering_delay
        self.map_incremental = map_incremental
        self.reduce_incremental = reduce_incremental
        self.result_factory = result_factory
        self.closing_func = closing_func
        self.ordered = ordered
        self.opt_level = opt_level
        self.config = config or WinOperatorConfig(0, 1, slide_len,
                                                  0, 1, slide_len)

    def stages(self):
        cfg = self.config
        mp = self.map_parallelism
        stages = []
        # ---- MAP stage (win_mapreduce.hpp:180-206) ----
        map_cfg = WinOperatorConfig(cfg.id_inner, cfg.n_inner,
                                    cfg.slide_inner, 0, 1, self.slide_len)
        replicas = [WinSeqLogic(
            self.map_func, self.win_len, self.slide_len, self.win_type,
            triggering_delay=self.triggering_delay,
            incremental=self.map_incremental,
            result_factory=self.result_factory,
            closing_func=self.closing_func, config=map_cfg, role=Role.MAP,
            map_indexes=(i, mp), parallelism=mp, replica_index=i)
            for i in range(mp)]
        stages.append(StageSpec(
            f"{self.name}_map", replicas, WinMapEmitter(mp, self.win_type),
            RoutingMode.COMPLEX,
            ordering_mode=(OrderingMode.ID if self.win_type == WinType.CB
                           else OrderingMode.TS),
            collector=WidOrderCollector()))
        # ---- REDUCE stage: CB tumbling windows of mp partials
        # (win_mapreduce.hpp:208-224) ----
        if self.reduce_parallelism > 1:
            red = WinFarm(self.reduce_func, mp, mp, WinType.CB,
                          self.reduce_parallelism, 0,
                          self.reduce_incremental, f"{self.name}_reduce",
                          self.result_factory, self.closing_func,
                          ordered=self.ordered, opt_level=self.opt_level,
                          config=WinOperatorConfig(
                              cfg.id_outer, cfg.n_outer, cfg.slide_outer,
                              cfg.id_inner, cfg.n_inner, cfg.slide_inner),
                          role=Role.REDUCE)
            stages.extend(red.stages())
        else:
            logic = WinSeqLogic(
                self.reduce_func, mp, mp, WinType.CB,
                incremental=self.reduce_incremental,
                result_factory=self.result_factory,
                closing_func=self.closing_func,
                config=WinOperatorConfig(cfg.id_inner, cfg.n_inner,
                                         cfg.slide_inner, 0, 1, mp),
                role=Role.REDUCE)
            stages.append(StageSpec(
                f"{self.name}_reduce", [logic], StandardEmitter(keyed=True),
                RoutingMode.KEYBY, ordering_mode=OrderingMode.ID))
        return stages
