"""Win_Farm: window parallelism -- consecutive windows of each key are
round-robined across workers.

Re-design of reference ``wf/win_farm.hpp`` (769 LoC): farm of Win_Seq
engines each owning every ``parallelism``-th window via a private slide
``slide * parallelism`` (win_farm.hpp:171-180), a WFEmitter multicasting
tuples to the workers whose windows contain them, and an optional
ordered collector.  The enclosing config's inner level shifts to the
workers' outer level (configSeq construction, win_farm.hpp:175).
"""
from __future__ import annotations

from typing import Callable

from ..core.basic import (OptLevel, OrderingMode, Pattern, Role, RoutingMode,
                          WinOperatorConfig, WinType)
from ..core.tuples import BasicRecord
from ..runtime.win_routing import WFEmitter, WidOrderCollector
from .base import Operator, StageSpec
from .win_seq import WinSeqLogic


class WinFarm(Operator):
    def __init__(self, win_func: Callable, win_len: int, slide_len: int,
                 win_type: WinType, parallelism: int = 1,
                 triggering_delay: int = 0, incremental: bool = False,
                 name: str = "win_farm", result_factory=BasicRecord,
                 closing_func=None, ordered: bool = True,
                 opt_level: OptLevel = OptLevel.LEVEL0,
                 config: WinOperatorConfig = None, role: Role = Role.SEQ):
        super().__init__(name, parallelism, RoutingMode.COMPLEX,
                         Pattern.WIN_FARM)
        if win_len == 0 or slide_len == 0:
            raise ValueError("window length and slide cannot be zero")
        self.win_func = win_func
        self.win_len = win_len
        self.slide_len = slide_len
        self.win_type = win_type
        self.triggering_delay = triggering_delay
        self.incremental = incremental
        self.result_factory = result_factory
        self.closing_func = closing_func
        self.ordered = ordered
        self.opt_level = opt_level
        self.config = config or WinOperatorConfig(0, 1, 0, 0, 1, 0)
        self.role = role

    def stages(self):
        cfg = self.config
        par = self.parallelism
        private_slide = self.slide_len * par
        replicas = []
        for i in range(par):
            worker_cfg = WinOperatorConfig(
                cfg.id_inner, cfg.n_inner, cfg.slide_inner,
                i, par, self.slide_len)
            replicas.append(WinSeqLogic(
                self.win_func, self.win_len, private_slide, self.win_type,
                triggering_delay=self.triggering_delay,
                incremental=self.incremental,
                result_factory=self.result_factory,
                closing_func=self.closing_func, config=worker_cfg,
                role=self.role, parallelism=par, replica_index=i))
        emitter = WFEmitter(self.win_len, self.slide_len, par, self.win_type,
                            self.role, id_outer=cfg.id_inner,
                            n_outer=cfg.n_inner, slide_outer=cfg.slide_inner)
        # LEVEL1+ strips the ordered collector (optimize_WinFarm,
        # win_farm.hpp:199-201)
        collector = (WidOrderCollector()
                     if self.ordered and self.opt_level == OptLevel.LEVEL0
                     else None)
        return [StageSpec(
            self.name, replicas, emitter, self.routing,
            ordering_mode=(OrderingMode.ID if self.win_type == WinType.CB
                           else OrderingMode.TS),
            collector=collector)]
