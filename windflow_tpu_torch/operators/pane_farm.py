"""Pane_Farm: two-stage pane decomposition of sliding windows.

Re-design of reference ``wf/pane_farm.hpp`` (1107 LoC; algorithm: Li et
al., "No pane, no gain", SIGMOD 2005, cited pane_farm.hpp:33-35):
windows are split into non-overlapping panes of length
``gcd(win, slide)``; a PLQ stage computes per-pane partials (tumbling
pane windows, role PLQ, renumbered dense pane ids per key), and a WLQ
stage combines panes into windows (CB windows of ``win/pane`` panes
sliding by ``slide/pane``, role WLQ).  The ML analogue is blockwise /
two-level sequence-parallel reduction over the time axis (SURVEY.md §5).
"""
from __future__ import annotations

from typing import Callable

from ..core.basic import (OptLevel, Pattern, Role, RoutingMode,
                          WinOperatorConfig, WinType)
from ..core.tuples import BasicRecord
from ..core.win_assign import pane_length
from .base import Operator
from .win_farm import WinFarm
from .win_seq import WinSeqLogic
from ..core.basic import OrderingMode
from ..runtime.emitters import StandardEmitter
from .base import StageSpec


class PaneFarm(Operator):
    def __init__(self, plq_func: Callable, wlq_func: Callable, win_len: int,
                 slide_len: int, win_type: WinType,
                 plq_parallelism: int = 1, wlq_parallelism: int = 1,
                 triggering_delay: int = 0, plq_incremental: bool = False,
                 wlq_incremental: bool = False, name: str = "pane_farm",
                 result_factory=BasicRecord, closing_func=None,
                 ordered: bool = True,
                 opt_level: OptLevel = OptLevel.LEVEL0,
                 config: WinOperatorConfig = None):
        super().__init__(name, plq_parallelism + wlq_parallelism,
                         RoutingMode.COMPLEX, Pattern.PANE_FARM)
        if win_len == 0 or slide_len == 0:
            raise ValueError("window length and slide cannot be zero")
        if win_len <= slide_len:
            # pane_farm.hpp:170-173: with slide >= win the pane
            # decomposition degenerates (the PLQ's dense pane
            # renumbering no longer matches the WLQ's pane selection
            # once the pane stream has gaps)
            raise ValueError(
                f"Pane_Farm requires sliding windows (slide < win); got "
                f"win={win_len} slide={slide_len}. Inside a Win_Farm the "
                f"private slide is slide*replicas, so nesting needs "
                f"win > slide*replicas")
        self.plq_func = plq_func
        self.wlq_func = wlq_func
        self.win_len = win_len
        self.slide_len = slide_len
        self.win_type = win_type
        self.plq_parallelism = plq_parallelism
        self.wlq_parallelism = wlq_parallelism
        self.triggering_delay = triggering_delay
        self.plq_incremental = plq_incremental
        self.wlq_incremental = wlq_incremental
        self.result_factory = result_factory
        self.closing_func = closing_func
        self.ordered = ordered
        self.opt_level = opt_level
        # default enclosing config (pane_farm.hpp:158)
        self.config = config or WinOperatorConfig(0, 1, slide_len,
                                                  0, 1, slide_len)
        self.pane_len = pane_length(win_len, slide_len)

    def _fused_logics(self):
        """PLQ + WLQ logics for the LEVEL1/2 thread fusion (the ff_comb
        branch of optimize_PaneFarm, pane_farm.hpp:222-250): both stages
        run in ONE thread via ChainedLogic.  Only valid when both
        parallelisms are 1; the farm-farm LEVEL2 merge maps onto this
        runtime as collector stripping, which the inner WinFarms already
        do at LEVEL1+."""
        cfg = self.config
        pane = self.pane_len
        plq = WinSeqLogic(
            self.plq_func, pane, pane, self.win_type,
            triggering_delay=self.triggering_delay,
            incremental=self.plq_incremental,
            result_factory=self.result_factory,
            closing_func=self.closing_func,
            config=WinOperatorConfig(cfg.id_inner, cfg.n_inner,
                                     cfg.slide_inner, 0, 1, pane),
            role=Role.PLQ)
        wlq_win = self.win_len // pane
        wlq_slide = self.slide_len // pane
        wlq = WinSeqLogic(
            self.wlq_func, wlq_win, wlq_slide, WinType.CB,
            incremental=self.wlq_incremental,
            result_factory=self.result_factory,
            closing_func=self.closing_func,
            config=WinOperatorConfig(cfg.id_inner, cfg.n_inner,
                                     cfg.slide_inner, 0, 1, wlq_slide),
            role=Role.WLQ)
        return plq, wlq

    # (both par-1 stage branches and the LEVEL1/2 fusion build their
    # logics through _fused_logics, so the config arithmetic and the
    # incremental flags live in exactly one place)

    def stages(self):
        if (self.opt_level != OptLevel.LEVEL0
                and self.plq_parallelism == 1
                and self.wlq_parallelism == 1):
            from ..runtime.node import ChainedLogic
            plq, wlq = self._fused_logics()
            return [StageSpec(
                f"{self.name}_fused", [ChainedLogic(plq, wlq)],
                StandardEmitter(), RoutingMode.FORWARD,
                ordering_mode=(OrderingMode.ID
                               if self.win_type == WinType.CB
                               else OrderingMode.TS))]
        cfg = self.config
        pane = self.pane_len
        # par-1 stages reuse the same logic construction as the fusion
        # path -- one place owns the config arithmetic
        plq_single, wlq_single = self._fused_logics()
        stages = []
        # ---- PLQ: tumbling panes (pane_farm.hpp:181-196) ----
        if self.plq_parallelism > 1:
            plq = WinFarm(self.plq_func, pane, pane, self.win_type,
                          self.plq_parallelism, self.triggering_delay,
                          self.plq_incremental, f"{self.name}_plq",
                          self.result_factory, self.closing_func,
                          ordered=True, opt_level=self.opt_level,
                          config=WinOperatorConfig(
                              cfg.id_outer, cfg.n_outer, cfg.slide_outer,
                              cfg.id_inner, cfg.n_inner, cfg.slide_inner),
                          role=Role.PLQ)
            stages.extend(plq.stages())
        else:
            stages.append(StageSpec(
                f"{self.name}_plq", [plq_single], StandardEmitter(),
                RoutingMode.FORWARD,
                ordering_mode=(OrderingMode.ID if self.win_type == WinType.CB
                               else OrderingMode.TS)))
        # ---- WLQ: CB windows over dense pane ids (pane_farm.hpp:198-214) ----
        wlq_win = self.win_len // pane
        wlq_slide = self.slide_len // pane
        if self.wlq_parallelism > 1:
            wlq = WinFarm(self.wlq_func, wlq_win, wlq_slide, WinType.CB,
                          self.wlq_parallelism, 0, self.wlq_incremental,
                          f"{self.name}_wlq", self.result_factory,
                          self.closing_func, ordered=self.ordered,
                          opt_level=self.opt_level,
                          config=WinOperatorConfig(
                              cfg.id_outer, cfg.n_outer, cfg.slide_outer,
                              cfg.id_inner, cfg.n_inner, cfg.slide_inner),
                          role=Role.WLQ)
            stages.extend(wlq.stages())
        else:
            stages.append(StageSpec(
                f"{self.name}_wlq", [wlq_single], StandardEmitter(keyed=True),
                RoutingMode.KEYBY, ordering_mode=OrderingMode.ID))
        return stages
