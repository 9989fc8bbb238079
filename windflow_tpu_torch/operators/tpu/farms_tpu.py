"""Device-batched composite window operators: the port of the
reference package's ``operators/tpu/farms_tpu.py``, the twins of the
GPU operator family (SURVEY.md §2.5).

* KeyFarmTPU       <- key_farm_gpu.hpp (751)
* WinFarmTPU       <- win_farm_gpu.hpp (782)
* PaneFarmTPU      <- pane_farm_gpu.hpp (1028): PLQ *or* WLQ on device
* WinMapReduceTPU  <- win_mapreduce_gpu.hpp (1046): MAP *or* REDUCE on device
* WinSeqFFATTPU    <- win_seqffat_gpu.hpp (734): lift on the host,
                      FlatFAT aggregation on the device (the ``ffat``
                      kind of ops/window_compute)
* KeyFFATTPU       <- key_ffat_gpu.hpp (345)

All reuse the CPU composites' WinOperatorConfig arithmetic; only the
engine replica type changes (WinSeqTPULogic instead of WinSeqLogic) --
mirroring how the reference swaps Win_Seq for Win_Seq_GPU inside the
same farm skeletons (win_farm_gpu.hpp:82-86).  Every device replica of
a farm runs its own engine, dispatcher thread and CUDA stream on the
one card; ``device=`` (default: the graph's ``RuntimeConfig.device``)
names it.

A device stage's window function is a ``win_kind``: a builtin combine
name ('sum'/'count'/'mean'/'max'/'min'), a torch callable
``fn(gwid, cols, mask) -> 0-d tensor`` (the __host__ __device__ functor
analogue, API:104-132; vmapped over the windows), or for FFAT ops a
(lift, combine) pair with the combine either a builtin name or a
``(torch_binary_fn, neutral)`` pair; on the card the function must be
one the FlatFAT kernels compile: ``torch.add``, ``torch.maximum`` or
``torch.minimum``.
"""

from __future__ import annotations

from typing import Any, Callable

from ...core.basic import (OptLevel, OrderingMode, Pattern, Role,
                           RoutingMode, WinOperatorConfig, WinType)
from ...core.tuples import BasicRecord
from ...core.win_assign import pane_length
from ...runtime.emitters import StandardEmitter
from ...runtime.win_routing import KFEmitter, WFEmitter, WidOrderCollector, \
    WinMapEmitter
from ..base import Operator, StageSpec
from ..win_seq import WinSeqLogic
from .win_seq_tpu import (DEFAULT_BATCH_LEN, DEFAULT_INFLIGHT_DEPTH,
                          DEFAULT_MAX_BATCH_DELAY_MS,
                          DEFAULT_MAX_BUFFER_ELEMS, WinSeqTPULogic)


def _tpu_replicas(win_kind, win_len, slide_len, win_type, par, *,
                  batch_len, triggering_delay, result_factory, value_of,
                  enclosing: WinOperatorConfig, role: Role,
                  farm_kind: str, renumbering=False, emit_batches=False,
                  max_buffer_elems=DEFAULT_MAX_BUFFER_ELEMS,
                  inflight_depth=DEFAULT_INFLIGHT_DEPTH,
                  max_batch_delay_ms=DEFAULT_MAX_BATCH_DELAY_MS,
                  placement="device", adaptive_batch=False, device=None):
    """Build the worker set with the same config conventions as the CPU
    farms (win_farm.hpp:175 / key_farm worker configs)."""
    reps = []
    for i in range(par):
        if farm_kind == "wf":
            cfg = WinOperatorConfig(enclosing.id_inner, enclosing.n_inner,
                                    enclosing.slide_inner, i, par, slide_len)
            slide = slide_len * par
        elif farm_kind == "kf":
            cfg = WinOperatorConfig(enclosing.id_inner, enclosing.n_inner,
                                    enclosing.slide_inner, 0, 1, slide_len)
            slide = slide_len
        else:  # map stage / single engine
            cfg = WinOperatorConfig(enclosing.id_inner, enclosing.n_inner,
                                    enclosing.slide_inner, 0, 1, slide_len)
            slide = slide_len
        reps.append(WinSeqTPULogic(
            win_kind, win_len, slide, win_type, batch_len=batch_len,
            triggering_delay=triggering_delay, result_factory=result_factory,
            config=cfg, role=role,
            map_indexes=(i, par) if role == Role.MAP else (0, 1),
            parallelism=par, replica_index=i, renumbering=renumbering,
            value_of=value_of, emit_batches=emit_batches,
            max_buffer_elems=max_buffer_elems, inflight_depth=inflight_depth,
            max_batch_delay_ms=max_batch_delay_ms, placement=placement,
            adaptive_batch=adaptive_batch, device=device))
    return reps


class _TPUWinOp(Operator):
    def __init__(self, name, parallelism, routing, pattern, win_type):
        super().__init__(name, parallelism, routing, pattern)
        self.win_type = win_type
        self._renumbering = False

    def enable_renumbering(self):
        self._renumbering = True

    def _ordering(self):
        return (OrderingMode.ID if self.win_type == WinType.CB
                else OrderingMode.TS)


class KeyFarmTPU(_TPUWinOp):
    """Key-sharded device windows (key_farm_gpu.hpp:751).

    ``coalesce`` (default on): replicas of this farm all dispatch to the
    SAME local device -- a key split across N engine replicas buys no
    device parallelism, it only multiplies host dispatcher threads that
    contend for the ingest core and serialize launches.  The farm
    therefore lowers to ONE engine handling every key per launch (the
    engine batches many keys natively; the double-buffer protocol of
    win_seq_gpu.hpp:267-297 rides one launch stream).  Key-partitioned
    scale-out across shards is the mesh plane's job
    (``operators/tpu/mesh_farm.KeyFarmMesh``).  ``coalesce=False`` keeps
    the literal N-replica farm (the reference's per-GPU structure)."""

    def __init__(self, win_kind, win_len, slide_len, win_type,
                 parallelism=1, batch_len=DEFAULT_BATCH_LEN,
                 triggering_delay=0, name="key_farm_tpu",
                 result_factory=BasicRecord, value_of=None,
                 config: WinOperatorConfig = None, emit_batches=False,
                 max_buffer_elems=DEFAULT_MAX_BUFFER_ELEMS,
                 coalesce=True, inflight_depth=DEFAULT_INFLIGHT_DEPTH,
                 max_batch_delay_ms=DEFAULT_MAX_BATCH_DELAY_MS,
                 placement="device", adaptive_batch=False, device=None):
        super().__init__(name, parallelism, RoutingMode.KEYBY,
                         Pattern.KEY_FARM_TPU, win_type)
        self.device = device
        self.placement = placement
        self.adaptive_batch = adaptive_batch
        self.args = (win_kind, win_len, slide_len, win_type)
        self.batch_len = batch_len
        self.triggering_delay = triggering_delay
        self.result_factory = result_factory
        self.value_of = value_of
        self.config = config or WinOperatorConfig(0, 1, 0, 0, 1, 0)
        self.emit_batches = emit_batches
        self.max_buffer_elems = max_buffer_elems
        self.coalesce = coalesce
        self.inflight_depth = inflight_depth
        self.max_batch_delay_ms = max_batch_delay_ms

    def stages(self):
        kind, win_len, slide_len, win_type = self.args
        # every kf replica runs the identical engine config (the key
        # subset comes only from the emitter hash), so one engine over
        # all keys computes the same windows
        par = 1 if self.coalesce else self.parallelism
        reps = _tpu_replicas(
            kind, win_len, slide_len, win_type, par,
            batch_len=self.batch_len, triggering_delay=self.triggering_delay,
            result_factory=self.result_factory, value_of=self.value_of,
            enclosing=self.config, role=Role.SEQ, farm_kind="kf",
            renumbering=self._renumbering, emit_batches=self.emit_batches,
            max_buffer_elems=self.max_buffer_elems,
            inflight_depth=self.inflight_depth,
            max_batch_delay_ms=self.max_batch_delay_ms,
            placement=self.placement, adaptive_batch=self.adaptive_batch,
            device=self.device)
        return [StageSpec(self.name, reps, KFEmitter(par),
                          self.routing, ordering_mode=self._ordering())]


class WinFarmTPU(_TPUWinOp):
    def __init__(self, win_kind, win_len, slide_len, win_type,
                 parallelism=1, batch_len=DEFAULT_BATCH_LEN,
                 triggering_delay=0, name="win_farm_tpu",
                 result_factory=BasicRecord, value_of=None, ordered=True,
                 opt_level=OptLevel.LEVEL0,
                 config: WinOperatorConfig = None, role: Role = Role.SEQ,
                 max_buffer_elems=DEFAULT_MAX_BUFFER_ELEMS,
                 inflight_depth=DEFAULT_INFLIGHT_DEPTH,
                 max_batch_delay_ms=DEFAULT_MAX_BATCH_DELAY_MS,
                 placement="device", adaptive_batch=False, device=None):
        super().__init__(name, parallelism, RoutingMode.COMPLEX,
                         Pattern.WIN_FARM_TPU, win_type)
        self.device = device
        self.placement = placement
        self.adaptive_batch = adaptive_batch
        self.max_buffer_elems = max_buffer_elems
        self.inflight_depth = inflight_depth
        self.max_batch_delay_ms = max_batch_delay_ms
        self.args = (win_kind, win_len, slide_len, win_type)
        self.batch_len = batch_len
        self.triggering_delay = triggering_delay
        self.result_factory = result_factory
        self.value_of = value_of
        self.ordered = ordered
        self.opt_level = opt_level
        self.config = config or WinOperatorConfig(0, 1, 0, 0, 1, 0)
        self.role = role

    def stages(self):
        kind, win_len, slide_len, win_type = self.args
        cfg = self.config
        reps = _tpu_replicas(
            kind, win_len, slide_len, win_type, self.parallelism,
            batch_len=self.batch_len, triggering_delay=self.triggering_delay,
            result_factory=self.result_factory, value_of=self.value_of,
            enclosing=cfg, role=self.role, farm_kind="wf",
            max_buffer_elems=self.max_buffer_elems,
            inflight_depth=self.inflight_depth,
            max_batch_delay_ms=self.max_batch_delay_ms,
            placement=self.placement, adaptive_batch=self.adaptive_batch,
            device=self.device)
        emitter = WFEmitter(win_len, slide_len, self.parallelism, win_type,
                            self.role, id_outer=cfg.id_inner,
                            n_outer=cfg.n_inner, slide_outer=cfg.slide_inner)
        collector = (WidOrderCollector()
                     if self.ordered and self.opt_level == OptLevel.LEVEL0
                     else None)
        return [StageSpec(self.name, reps, emitter, self.routing,
                          ordering_mode=self._ordering(),
                          collector=collector)]


class PaneFarmTPU(_TPUWinOp):
    """PLQ or WLQ on device (pane_farm_gpu.hpp:105-106): the device stage
    takes a win_kind; the host stage takes a Python callable, or -- for
    a host WLQ -- a builtin name ('sum'/'max'/'min'), which runs the
    columnar pane->window combine (pane_combine.PaneCombineLogic)
    instead of the per-record engine.  ``emit_batches`` applies to that
    columnar WLQ only; callable/device WLQ stages emit records."""

    def __init__(self, plq: Any, wlq: Any, win_len, slide_len, win_type,
                 plq_parallelism=1, wlq_parallelism=1, plq_on_tpu=True,
                 wlq_on_tpu=False, batch_len=DEFAULT_BATCH_LEN,
                 triggering_delay=0, name="pane_farm_tpu",
                 result_factory=BasicRecord, value_of=None, ordered=True,
                 opt_level=OptLevel.LEVEL0,
                 config: WinOperatorConfig = None,
                 max_buffer_elems=DEFAULT_MAX_BUFFER_ELEMS,
                 inflight_depth=DEFAULT_INFLIGHT_DEPTH,
                 max_batch_delay_ms=DEFAULT_MAX_BATCH_DELAY_MS,
                 emit_batches=False, placement="device",
                 adaptive_batch=False, device=None):
        super().__init__(name, plq_parallelism + wlq_parallelism,
                         RoutingMode.COMPLEX, Pattern.PANE_FARM_TPU,
                         win_type)
        self.device = device
        self.placement = placement
        self.adaptive_batch = adaptive_batch
        if plq_on_tpu == wlq_on_tpu:
            raise ValueError(
                "exactly one of PLQ/WLQ must run on device "
                "(pane_farm_gpu.hpp constraint, API:134)")
        if win_len <= slide_len:
            # pane_farm.hpp:170-173 (same check on the GPU twin): with
            # slide >= win the pane decomposition degenerates
            raise ValueError(
                f"Pane_Farm requires sliding windows (slide < win); got "
                f"win={win_len} slide={slide_len}. Inside a Win_Farm the "
                f"private slide is slide*replicas, so nesting needs "
                f"win > slide*replicas")
        self.plq = plq
        self.wlq = wlq
        self.win_len = win_len
        self.slide_len = slide_len
        self.plq_par = plq_parallelism
        self.wlq_par = wlq_parallelism
        self.plq_on_tpu = plq_on_tpu
        self.batch_len = batch_len
        self.triggering_delay = triggering_delay
        self.result_factory = result_factory
        self.value_of = value_of
        self.ordered = ordered
        self.opt_level = opt_level
        self.pane_len = pane_length(win_len, slide_len)
        self.max_buffer_elems = max_buffer_elems
        self.inflight_depth = inflight_depth
        self.max_batch_delay_ms = max_batch_delay_ms
        self.emit_batches = emit_batches
        # enclosing config: identity standalone, nested arithmetic when
        # replicated inside a Win_Farm/Key_Farm (win_farm_gpu.hpp:73-76)
        self.config = config or WinOperatorConfig(0, 1, slide_len,
                                                  0, 1, slide_len)
        if plq_on_tpu and isinstance(wlq, str):
            from .pane_combine import WLQ_KINDS
            if wlq not in WLQ_KINDS:
                raise ValueError(
                    f"host WLQ builtin must be one of "
                    f"{sorted(WLQ_KINDS)}: {wlq!r}")
        # a builtin-name WLQ on the host runs the columnar pane->window
        # combine instead of the per-record engine -- but only under an
        # identity config: PaneCombineLogic has no id_inner/n_inner
        # arithmetic, so nested copies (which offset and stripe window
        # ids per copy) must stay on the stock per-record WLQ
        cfg = self.config
        self._wlq_columnar = (plq_on_tpu and isinstance(wlq, str)
                              and cfg.n_outer == 1 and cfg.n_inner == 1
                              and cfg.id_outer == 0 and cfg.id_inner == 0)

    def _device_single(self, kind, win, slide, win_type, role, delay,
                       emit_batches=False):
        """One device engine replica (shared by the fused path and the
        par-1 stage branches -- the config arithmetic lives here)."""
        return _tpu_replicas(
            kind, win, slide, win_type, 1, batch_len=self.batch_len,
            triggering_delay=delay, result_factory=self.result_factory,
            value_of=self.value_of, enclosing=self.config, role=role,
            farm_kind="seq", emit_batches=emit_batches,
            max_buffer_elems=self.max_buffer_elems,
            inflight_depth=self.inflight_depth,
            max_batch_delay_ms=self.max_batch_delay_ms,
            placement=self.placement,
            adaptive_batch=self.adaptive_batch, device=self.device)[0]

    def _columnar_wlq(self, wlq_win, wlq_slide):
        from .pane_combine import PaneCombineLogic
        return PaneCombineLogic(self.wlq, wlq_win, wlq_slide,
                                result_factory=self.result_factory,
                                emit_batches=self.emit_batches)

    def _wlq_fn(self):
        """The host WLQ as a callable: builtin names map to the stock
        per-record aggregation (builtin_win_func) so nested copies
        (non-identity config) can run the per-record engine."""
        if not isinstance(self.wlq, str):
            return self.wlq
        from ..win_seq import builtin_win_func
        return builtin_win_func(self.wlq)

    def _host_single(self, fn, win, slide, win_type, role, delay=0):
        cfg = self.config
        return WinSeqLogic(
            fn, win, slide, win_type, triggering_delay=delay,
            result_factory=self.result_factory,
            config=WinOperatorConfig(cfg.id_inner, cfg.n_inner,
                                     cfg.slide_inner, 0, 1, slide),
            role=role)

    def _fused_stage(self):
        """LEVEL1/2 single/single thread fusion (ff_comb of
        optimize_PaneFarm, pane_farm.hpp:222-250): the device stage and
        the host stage run chained in one thread.  The device logic's
        async dispatcher keeps overlapping launches; the chained
        consumer runs on whichever thread flushes the batch."""
        from ...runtime.node import ChainedLogic
        pane = self.pane_len
        wlq_win = self.win_len // pane
        wlq_slide = self.slide_len // pane
        if self.plq_on_tpu:
            plq = self._device_single(self.plq, pane, pane, self.win_type,
                                      Role.PLQ, self.triggering_delay,
                                      emit_batches=self._wlq_columnar)
            wlq = (self._columnar_wlq(wlq_win, wlq_slide)
                   if self._wlq_columnar
                   else self._host_single(self._wlq_fn(), wlq_win,
                                          wlq_slide, WinType.CB, Role.WLQ))
        else:
            plq = self._host_single(self.plq, pane, pane, self.win_type,
                                    Role.PLQ, self.triggering_delay)
            wlq = self._device_single(self.wlq, wlq_win, wlq_slide,
                                      WinType.CB, Role.WLQ, 0)
        return [StageSpec(
            f"{self.name}_fused", [ChainedLogic(plq, wlq)],
            StandardEmitter(), RoutingMode.FORWARD,
            ordering_mode=(OrderingMode.ID if self.win_type == WinType.CB
                           else OrderingMode.TS))]

    def stages(self):
        if (self.opt_level != OptLevel.LEVEL0
                and self.plq_par == 1 and self.wlq_par == 1):
            return self._fused_stage()
        cfg = self.config
        pane = self.pane_len
        stages = []
        # ---- PLQ ----
        if self.plq_on_tpu:
            reps = _tpu_replicas(
                self.plq, pane, pane, self.win_type, self.plq_par,
                batch_len=self.batch_len,
                triggering_delay=self.triggering_delay,
                result_factory=self.result_factory, value_of=self.value_of,
                enclosing=cfg, role=Role.PLQ,
                farm_kind="wf" if self.plq_par > 1 else "seq",
                emit_batches=self._wlq_columnar and self.plq_par == 1,
                max_buffer_elems=self.max_buffer_elems,
                inflight_depth=self.inflight_depth,
                max_batch_delay_ms=self.max_batch_delay_ms,
                device=self.device)
            # the enclosing offsets shift pane membership when this
            # operator is a nested copy (the configSeq construction,
            # win_farm.hpp:175; emitter without them routes panes
            # relative to 0 and starves the copy's workers)
            emitter = (WFEmitter(pane, pane, self.plq_par, self.win_type,
                                 Role.PLQ, id_outer=cfg.id_inner,
                                 n_outer=cfg.n_inner,
                                 slide_outer=cfg.slide_inner)
                       if self.plq_par > 1 else StandardEmitter())
            stages.append(StageSpec(
                f"{self.name}_plq", reps, emitter, RoutingMode.COMPLEX,
                ordering_mode=self._ordering(),
                collector=WidOrderCollector() if self.plq_par > 1 else None))
        else:
            from ..pane_farm import PaneFarm  # host PLQ stage via CPU engine
            host = PaneFarm(self.plq, lambda *a: None, self.win_len,
                            self.slide_len, self.win_type, self.plq_par, 1,
                            self.triggering_delay,
                            result_factory=self.result_factory,
                            ordered=True)
            stages.append(host.stages()[0])
        # ---- WLQ: CB windows over dense pane ids ----
        wlq_win = self.win_len // pane
        wlq_slide = self.slide_len // pane
        if not self.plq_on_tpu:  # WLQ on device
            reps = _tpu_replicas(
                self.wlq, wlq_win, wlq_slide, WinType.CB, self.wlq_par,
                batch_len=self.batch_len, triggering_delay=0,
                result_factory=self.result_factory, value_of=self.value_of,
                enclosing=cfg, role=Role.WLQ,
                farm_kind="wf" if self.wlq_par > 1 else "seq",
                max_buffer_elems=self.max_buffer_elems,
                inflight_depth=self.inflight_depth,
                max_batch_delay_ms=self.max_batch_delay_ms,
                device=self.device)
            emitter = (WFEmitter(wlq_win, wlq_slide, self.wlq_par,
                                 WinType.CB, Role.WLQ,
                                 id_outer=cfg.id_inner, n_outer=cfg.n_inner,
                                 slide_outer=cfg.slide_inner)
                       if self.wlq_par > 1
                       else StandardEmitter(keyed=True))
            stages.append(StageSpec(
                f"{self.name}_wlq", reps, emitter,
                RoutingMode.COMPLEX if self.wlq_par > 1 else RoutingMode.KEYBY,
                ordering_mode=OrderingMode.ID,
                collector=(WidOrderCollector()
                           if self.wlq_par > 1 and self.ordered else None)))
        elif self._wlq_columnar:  # host columnar combine (keyed)
            # keyed sharding sends each key's whole pane stream to one
            # replica, which fires its windows in wid order -- the same
            # per-key guarantee the WidOrderCollector gives the
            # window-sharded stock branches, so no collector is needed
            reps = [self._columnar_wlq(wlq_win, wlq_slide)
                    for _ in range(self.wlq_par)]
            stages.append(StageSpec(
                f"{self.name}_wlq", reps,
                StandardEmitter(keyed=True), RoutingMode.KEYBY,
                ordering_mode=OrderingMode.ID))
        else:  # WLQ on host
            if self.wlq_par > 1:
                from ..win_farm import WinFarm
                wlq = WinFarm(self._wlq_fn(), wlq_win, wlq_slide, WinType.CB,
                              self.wlq_par, 0, False, f"{self.name}_wlq",
                              self.result_factory, None, self.ordered,
                              self.opt_level, WinOperatorConfig(
                                  cfg.id_outer, cfg.n_outer, cfg.slide_outer,
                                  cfg.id_inner, cfg.n_inner, cfg.slide_inner),
                              Role.WLQ)
                stages.extend(wlq.stages())
            else:
                stages.append(StageSpec(
                    f"{self.name}_wlq",
                    [self._host_single(self._wlq_fn(), wlq_win, wlq_slide,
                                       WinType.CB, Role.WLQ)],
                    StandardEmitter(keyed=True),
                    RoutingMode.KEYBY, ordering_mode=OrderingMode.ID))
        return stages


class WinMapReduceTPU(_TPUWinOp):
    """MAP or REDUCE on device (win_mapreduce_gpu.hpp:109-110)."""

    def __init__(self, map_stage: Any, reduce_stage: Any, win_len, slide_len,
                 win_type, map_parallelism=2, reduce_parallelism=1,
                 map_on_tpu=True, batch_len=DEFAULT_BATCH_LEN,
                 triggering_delay=0, name="win_mr_tpu",
                 result_factory=BasicRecord, value_of=None, ordered=True,
                 config: WinOperatorConfig = None,
                 max_buffer_elems=DEFAULT_MAX_BUFFER_ELEMS,
                 inflight_depth=DEFAULT_INFLIGHT_DEPTH,
                 max_batch_delay_ms=DEFAULT_MAX_BATCH_DELAY_MS,
                 device=None):
        super().__init__(name, map_parallelism + reduce_parallelism,
                         RoutingMode.COMPLEX, Pattern.WIN_MAPREDUCE_TPU,
                         win_type)
        self.device = device
        self.map_stage = map_stage
        self.reduce_stage = reduce_stage
        self.win_len = win_len
        self.slide_len = slide_len
        self.map_par = map_parallelism
        self.reduce_par = reduce_parallelism
        self.map_on_tpu = map_on_tpu
        self.batch_len = batch_len
        self.triggering_delay = triggering_delay
        self.result_factory = result_factory
        self.value_of = value_of
        self.ordered = ordered
        self.max_buffer_elems = max_buffer_elems
        self.inflight_depth = inflight_depth
        self.max_batch_delay_ms = max_batch_delay_ms
        self.config = config or WinOperatorConfig(0, 1, slide_len,
                                                  0, 1, slide_len)

    def stages(self):
        cfg = self.config
        mp = self.map_par
        stages = []
        # ---- MAP ----
        if self.map_on_tpu:
            reps = []
            for i in range(mp):
                reps.append(WinSeqTPULogic(
                    self.map_stage, self.win_len, self.slide_len,
                    self.win_type, batch_len=self.batch_len,
                    triggering_delay=self.triggering_delay,
                    result_factory=self.result_factory,
                    config=WinOperatorConfig(cfg.id_inner, cfg.n_inner,
                                             cfg.slide_inner, 0, 1,
                                             self.slide_len),
                    role=Role.MAP, map_indexes=(i, mp), parallelism=mp,
                    replica_index=i, value_of=self.value_of,
                    max_buffer_elems=self.max_buffer_elems,
                    inflight_depth=self.inflight_depth,
                    max_batch_delay_ms=self.max_batch_delay_ms,
                    device=self.device))
        else:
            reps = [WinSeqLogic(
                self.map_stage, self.win_len, self.slide_len, self.win_type,
                triggering_delay=self.triggering_delay,
                result_factory=self.result_factory,
                config=WinOperatorConfig(cfg.id_inner, cfg.n_inner,
                                         cfg.slide_inner, 0, 1,
                                         self.slide_len),
                role=Role.MAP, map_indexes=(i, mp), parallelism=mp,
                replica_index=i) for i in range(mp)]
        stages.append(StageSpec(
            f"{self.name}_map", reps, WinMapEmitter(mp, self.win_type),
            RoutingMode.COMPLEX, ordering_mode=self._ordering(),
            collector=WidOrderCollector()))
        # ---- REDUCE: CB tumbling windows of mp partials ----
        if self.map_on_tpu:  # reduce on host
            logic = [WinSeqLogic(
                self.reduce_stage, mp, mp, WinType.CB,
                result_factory=self.result_factory,
                config=WinOperatorConfig(cfg.id_inner, cfg.n_inner,
                                         cfg.slide_inner, 0, 1, mp),
                role=Role.REDUCE)]
        else:  # reduce on device
            logic = _tpu_replicas(
                self.reduce_stage, mp, mp, WinType.CB, 1,
                batch_len=self.batch_len, triggering_delay=0,
                result_factory=self.result_factory, value_of=self.value_of,
                enclosing=cfg, role=Role.REDUCE, farm_kind="seq",
                max_buffer_elems=self.max_buffer_elems,
                inflight_depth=self.inflight_depth,
                max_batch_delay_ms=self.max_batch_delay_ms,
                device=self.device)
        stages.append(StageSpec(
            f"{self.name}_reduce", logic, StandardEmitter(keyed=True),
            RoutingMode.KEYBY, ordering_mode=OrderingMode.ID))
        return stages


def _ffat_kind(combine: Any):
    """Normalize an FFAT combine spec to an engine kind."""
    if isinstance(combine, str):
        return combine  # builtin: scan / sparse-table paths
    if isinstance(combine, tuple) and len(combine) == 2:
        fn, neutral = combine
        return ("ffat", fn, float(neutral))
    raise ValueError("FFAT combine must be a builtin name or "
                     "(torch_binary_fn, neutral) tuple")


class WinSeqFFATTPU(_TPUWinOp):
    """Lift on host, associative combine on the device FlatFAT
    (win_seqffat_gpu.hpp)."""

    def __init__(self, lift: Callable, combine: Any, win_len, slide_len,
                 win_type, batch_len=DEFAULT_BATCH_LEN, triggering_delay=0,
                 name="win_seqffat_tpu", result_factory=BasicRecord,
                 max_buffer_elems=DEFAULT_MAX_BUFFER_ELEMS,
                 inflight_depth=DEFAULT_INFLIGHT_DEPTH,
                 max_batch_delay_ms=DEFAULT_MAX_BATCH_DELAY_MS,
                 device=None):
        super().__init__(name, 1, RoutingMode.FORWARD,
                         Pattern.WIN_SEQFFAT_TPU, win_type)
        self.kind = _ffat_kind(combine)
        self.lift = lift
        self.max_buffer_elems = max_buffer_elems
        self.inflight_depth = inflight_depth
        self.max_batch_delay_ms = max_batch_delay_ms
        self.device = device
        self.args = (win_len, slide_len, win_type, batch_len,
                     triggering_delay, result_factory)

    def stages(self):
        win_len, slide_len, win_type, batch_len, delay, rf = self.args
        logic = WinSeqTPULogic(
            self.kind, win_len, slide_len, win_type, batch_len=batch_len,
            triggering_delay=delay, result_factory=rf, value_of=self.lift,
            renumbering=self._renumbering,
            max_buffer_elems=self.max_buffer_elems,
            inflight_depth=self.inflight_depth,
            max_batch_delay_ms=self.max_batch_delay_ms, device=self.device)
        return [StageSpec(self.name, [logic], StandardEmitter(),
                          self.routing, ordering_mode=self._ordering())]


class KeyFFATTPU(_TPUWinOp):
    """Key-sharded device FFAT farm (key_ffat_gpu.hpp:18-35).  Replicas
    of this farm all dispatch to the SAME local device, and every
    replica runs the identical engine config (the key subset comes only
    from the emitter hash), so by default (``coalesce``) the farm lowers
    to ONE engine over every key; ``coalesce=False`` keeps the literal
    N-replica farm."""

    def __init__(self, lift: Callable, combine: Any, win_len, slide_len,
                 win_type, parallelism=1, batch_len=DEFAULT_BATCH_LEN,
                 triggering_delay=0, name="key_ffat_tpu",
                 result_factory=BasicRecord,
                 max_buffer_elems=DEFAULT_MAX_BUFFER_ELEMS, coalesce=True,
                 inflight_depth=DEFAULT_INFLIGHT_DEPTH,
                 max_batch_delay_ms=DEFAULT_MAX_BATCH_DELAY_MS,
                 device=None):
        super().__init__(name, parallelism, RoutingMode.KEYBY,
                         Pattern.KEY_FFAT_TPU, win_type)
        self.kind = _ffat_kind(combine)
        self.lift = lift
        self.max_buffer_elems = max_buffer_elems
        self.coalesce = coalesce
        self.inflight_depth = inflight_depth
        self.max_batch_delay_ms = max_batch_delay_ms
        self.device = device
        self.args = (win_len, slide_len, win_type, batch_len,
                     triggering_delay, result_factory)

    def stages(self):
        win_len, slide_len, win_type, batch_len, delay, rf = self.args
        par = 1 if self.coalesce else self.parallelism
        reps = [WinSeqTPULogic(
            self.kind, win_len, slide_len, win_type, batch_len=batch_len,
            triggering_delay=delay, result_factory=rf, value_of=self.lift,
            config=WinOperatorConfig(0, 1, 0, 0, 1, slide_len),
            parallelism=par, replica_index=i,
            renumbering=self._renumbering,
            max_buffer_elems=self.max_buffer_elems,
            inflight_depth=self.inflight_depth,
            max_batch_delay_ms=self.max_batch_delay_ms, device=self.device)
            for i in range(par)]
        return [StageSpec(self.name, reps, KFEmitter(par),
                          self.routing, ordering_mode=self._ordering())]
