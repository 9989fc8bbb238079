"""Key_Farm: key parallelism -- sub-streams sharded by key hash.

Re-design of reference ``wf/key_farm.hpp`` (754 LoC): a farm of Win_Seq
engines, each owning the *entire* window sequence of its keys
(kf_nodes routing, no collector -- key_farm.hpp:161-173).  The ML
analogue is sharding by batch/head dimension (SURVEY.md §2.4).
"""
from __future__ import annotations

from typing import Callable

from ..core.basic import (OptLevel, OrderingMode, Pattern, Role, RoutingMode,
                          WinOperatorConfig, WinType)
from ..core.tuples import BasicRecord
from ..runtime.win_routing import KFEmitter
from .base import Operator, StageSpec
from .win_seq import WinSeqLogic


class KeyFarm(Operator):
    def __init__(self, win_func: Callable, win_len: int, slide_len: int,
                 win_type: WinType, parallelism: int = 1,
                 triggering_delay: int = 0, incremental: bool = False,
                 name: str = "key_farm", result_factory=BasicRecord,
                 closing_func=None, opt_level: OptLevel = OptLevel.LEVEL0,
                 config: WinOperatorConfig = None):
        super().__init__(name, parallelism, RoutingMode.KEYBY,
                         Pattern.KEY_FARM)
        if win_len == 0 or slide_len == 0:
            raise ValueError("window length and slide cannot be zero")
        self.win_kind_name = win_func if isinstance(win_func, str) else None
        if self.win_kind_name is not None:
            from .win_seq import builtin_win_func
            win_func = builtin_win_func(self.win_kind_name)
            incremental = False
        self.win_func = win_func
        self.win_len = win_len
        self.slide_len = slide_len
        self.win_type = win_type
        self.triggering_delay = triggering_delay
        self.incremental = incremental
        self.result_factory = result_factory
        self.closing_func = closing_func
        self.opt_level = opt_level
        self.config = config or WinOperatorConfig(0, 1, 0, 0, 1, 0)
        self._renumbering = False

    def enable_renumbering(self):
        """CB windows in DEFAULT mode: per-key dense re-assignment of ids
        on arrival at the engine (win_seq.hpp:342-347)."""
        self._renumbering = True

    def stages(self):
        cfg = self.config
        par = self.parallelism
        replicas = []
        for i in range(par):
            worker_cfg = WinOperatorConfig(
                cfg.id_inner, cfg.n_inner, cfg.slide_inner,
                0, 1, self.slide_len)
            replicas.append(WinSeqLogic(
                self.win_func, self.win_len, self.slide_len, self.win_type,
                triggering_delay=self.triggering_delay,
                incremental=self.incremental,
                result_factory=self.result_factory,
                closing_func=self.closing_func, config=worker_cfg,
                role=Role.SEQ, parallelism=par, replica_index=i,
                renumbering=self._renumbering))
        return [StageSpec(
            self.name, replicas, KFEmitter(par), self.routing,
            ordering_mode=(OrderingMode.ID if self.win_type == WinType.CB
                           else OrderingMode.TS))]
