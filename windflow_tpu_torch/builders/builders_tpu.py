"""Device-operator builders: the port of the reference package's
``builders/builders_tpu.py`` (itself the twin of ``wf/builders_gpu.hpp``).

The GPU builders add ``withBatch(batch_len)`` and
``withGPUConfiguration(gpu_id, n_thread_block)`` (builders_gpu.hpp:120,
:133); these builders keep ``withBatch`` and, like the reference
package, ``withTPUConfiguration(device_index)`` and the no-op marker
``withTPU()``, so code written against ``windflow_tpu`` builds
unchanged.  The device the engines run on is the graph's
``RuntimeConfig.device`` (the card by default); block shaping is the
kernels' own.
"""
from __future__ import annotations

from typing import Any, Callable

from ..operators.tpu.farms_tpu import (KeyFarmTPU, KeyFFATTPU, PaneFarmTPU,
                                       WinFarmTPU, WinMapReduceTPU,
                                       WinSeqFFATTPU)
from ..core.basic import WinType
from ..operators.tpu.win_seq_tpu import (DEFAULT_BATCH_LEN,
    DEFAULT_INFLIGHT_DEPTH, DEFAULT_MAX_BATCH_DELAY_MS,
    DEFAULT_MAX_BUFFER_ELEMS, WinSeqTPU)
from .builders import _WinBuilderBase, _alias_camel


class _TPUBuilderMixin:
    max_buffer_elems = DEFAULT_MAX_BUFFER_ELEMS
    inflight_depth = DEFAULT_INFLIGHT_DEPTH
    max_batch_delay_ms = DEFAULT_MAX_BATCH_DELAY_MS
    placement = "device"
    adaptive_batch = False
    resident = None

    def with_batch(self, batch_len: int):
        self.batch_len = batch_len
        return self

    def with_resident(self, on=True):
        """Resident pane-partial state (docs/PLANNER.md "Resident
        state"): per-key window carry stays device-resident across
        launches and only new partials ship.  True forces the resident
        lane (rejecting ineligible shapes loudly), False opts out;
        the default (None) lets the placement planner promote
        eligible device-lane engines automatically."""
        self.resident = on
        return self

    withResident = with_resident

    def with_placement(self, placement: str):
        """Engine lane: 'device' (device launches -- the default, status
        quo), 'host' (numpy host engine: no transport, no launch
        floor), or 'auto' (the cost-based placement planner resolves
        the lane at PipeGraph.start from the measured RTT floor, the
        calibrated host rate and this operator's bytes/launch --
        graph/planner.py; docs/PLANNER.md)."""
        from ..operators.tpu.win_seq_tpu import PLACEMENTS
        if placement not in PLACEMENTS:
            raise ValueError(
                f"placement must be one of {PLACEMENTS}: {placement!r}")
        self.placement = placement
        return self

    withPlacement = with_placement

    def with_adaptive_batch(self, on: bool = True):
        """x2 / /2 device-batch resize driven by observed launch
        latency vs the measured RTT floor (the adaptation loop of
        win_seq_gpu.hpp:574-592; docs/PLANNER.md)."""
        self.adaptive_batch = on
        return self

    withAdaptiveBatch = with_adaptive_batch

    def _check_placement_supported(self):
        """Builders whose operators cannot change lanes (FFAT trees,
        device MAP/REDUCE composites) reject non-default placement
        loudly instead of ignoring it."""
        if self.placement != "device" or self.adaptive_batch \
                or self.resident is not None:
            raise ValueError(
                f"{type(self).__name__} is device-pinned: "
                "with_placement/with_adaptive_batch/with_resident are "
                "not supported on this operator family (the FFAT "
                "family's resident mode is with_rebuild(False))")

    def with_max_buffer(self, elems: int):
        """Host staging-buffer capacity (elements) for the device
        engine replicas; larger buffers flush less often on the hot
        ingest path."""
        self.max_buffer_elems = elems
        return self

    def with_tpu_configuration(self, device_index: int = 0):
        self.device_index = device_index
        return self

    def with_tpu(self):
        return self

    def with_value_of(self, value_of: Callable[[Any], float]):
        """Host-side extractor tuple -> float fed to the device batch
        (the staging-format hook; defaults to ``t.value``)."""
        self.value_of = value_of
        return self

    def with_batch_output(self, on: bool = True):
        """Emit results as columnar TupleBatches (hot path)."""
        self.emit_batches = on
        return self

    def with_inflight(self, depth: int):
        """Device launches kept in flight before the oldest is flushed
        (the waitAndFlush pipeline depth, win_seq_gpu.hpp:267-297).
        Nested farms (a farm builder wrapping a PaneFarmTPU /
        WinMapReduceTPU) take their depth from the INNER operator's
        builder; this knob applies to non-nested builds."""
        self.inflight_depth = depth
        return self

    def with_max_batch_delay(self, ms: float):
        """Partial-batch launch trigger: ready windows launch at most
        this long after the previous launch (the latency half of the
        adaptive batch resize, win_seq_gpu.hpp:574-592)."""
        self.max_batch_delay_ms = ms
        return self


class _KeyShardedMixin:
    """Knobs that only make sense on key-sharded device farms."""

    def with_coalesce(self, on: bool = True):
        """Lower same-device replicas to one engine handling all keys
        per launch (default on -- see KeyFarmTPU).  Off keeps the
        literal N-replica farm.  Nested farms (KeyFarm over
        PaneFarmTPU/WinMapReduceTPU) ignore this: their replication IS
        the requested composite structure."""
        self.coalesce = on
        return self



@_alias_camel
class WinSeqTPUBuilder(_WinBuilderBase, _TPUBuilderMixin):
    """builders_gpu.hpp:50 analogue."""

    _default_name = "win_seq_tpu"

    def __init__(self, win_kind):
        super().__init__(win_kind)
        self.batch_len = DEFAULT_BATCH_LEN
        self.value_of = None
        self.device_index = 0
        self.emit_batches = False

    def build(self) -> WinSeqTPU:
        self._check_windows()
        return WinSeqTPU(self.fn, self.win_len, self.slide_len,
                         self.win_type, self.batch_len,
                         self.triggering_delay, self.name,
                         self.result_factory, self.value_of,
                         self.closing_func, self.emit_batches,
                         max_buffer_elems=self.max_buffer_elems,
                         inflight_depth=self.inflight_depth,
                         max_batch_delay_ms=self.max_batch_delay_ms,
                         placement=self.placement,
                         adaptive_batch=self.adaptive_batch,
                         resident=self.resident)


@_alias_camel
class WinFarmTPUBuilder(_WinBuilderBase, _TPUBuilderMixin):
    """builders_gpu.hpp:426 analogue."""

    _default_name = "win_farm_tpu"

    def __init__(self, win_kind):
        super().__init__(win_kind)
        self.batch_len = DEFAULT_BATCH_LEN
        self.value_of = None
        self.device_index = 0
        self.ordered = True

    def with_ordered(self, ordered: bool = True):
        self.ordered = ordered
        return self

    def build(self):
        from ..operators.nesting import NestedWinFarm
        if isinstance(self.fn, (PaneFarmTPU, WinMapReduceTPU)):
            # device nesting ctor (win_farm_gpu.hpp:73-76): replicate
            # the inner device operator; windowing comes from the inner
            self._check_placement_supported()
            return NestedWinFarm(self.fn, self.parallelism, self.name,
                                 self.ordered, self.opt_level)
        self._check_windows()
        return WinFarmTPU(self.fn, self.win_len, self.slide_len,
                          self.win_type, self.parallelism, self.batch_len,
                          self.triggering_delay, self.name,
                          self.result_factory, self.value_of, self.ordered,
                          self.opt_level,
                          max_buffer_elems=self.max_buffer_elems,
                          inflight_depth=self.inflight_depth,
                          max_batch_delay_ms=self.max_batch_delay_ms,
                          placement=self.placement,
                          adaptive_batch=self.adaptive_batch)


@_alias_camel
class KeyFarmTPUBuilder(_WinBuilderBase, _TPUBuilderMixin,
                        _KeyShardedMixin):
    """builders_gpu.hpp:713 analogue."""

    _default_name = "key_farm_tpu"

    def __init__(self, win_kind):
        super().__init__(win_kind)
        self.batch_len = DEFAULT_BATCH_LEN
        self.value_of = None
        self.device_index = 0
        self.emit_batches = False
        self.coalesce = True

    def build(self):
        from ..operators.nesting import NestedKeyFarm
        if isinstance(self.fn, (PaneFarmTPU, WinMapReduceTPU)):
            # device nesting ctor (key_farm_gpu.hpp:254-...)
            self._check_placement_supported()
            return NestedKeyFarm(self.fn, self.parallelism, self.name,
                                 self.opt_level)
        self._check_windows()
        return KeyFarmTPU(self.fn, self.win_len, self.slide_len,
                          self.win_type, self.parallelism, self.batch_len,
                          self.triggering_delay, self.name,
                          self.result_factory, self.value_of,
                          emit_batches=self.emit_batches,
                          max_buffer_elems=self.max_buffer_elems,
                          coalesce=self.coalesce,
                          inflight_depth=self.inflight_depth,
                          max_batch_delay_ms=self.max_batch_delay_ms,
                          placement=self.placement,
                          adaptive_batch=self.adaptive_batch)


@_alias_camel
class PaneFarmTPUBuilder(_WinBuilderBase, _TPUBuilderMixin):
    """builders_gpu.hpp:1217 analogue: exactly one of PLQ/WLQ on device."""

    _default_name = "pane_farm_tpu"

    def __init__(self, plq, wlq, plq_on_tpu: bool = True):
        super().__init__(plq)
        self.wlq = wlq
        self.plq_on_tpu = plq_on_tpu
        self.par1 = 1
        self.par2 = 1
        self.batch_len = DEFAULT_BATCH_LEN
        self.value_of = None
        self.device_index = 0
        self.ordered = True
        self.emit_batches = False

    def with_parallelism(self, plq: int, wlq: int = None):
        self.par1 = plq
        self.par2 = wlq if wlq is not None else plq
        return self

    withParallelism = with_parallelism

    def build(self) -> PaneFarmTPU:
        self._check_windows()
        return PaneFarmTPU(self.fn, self.wlq, self.win_len, self.slide_len,
                           self.win_type, self.par1, self.par2,
                           self.plq_on_tpu, not self.plq_on_tpu,
                           self.batch_len, self.triggering_delay, self.name,
                           self.result_factory, self.value_of, self.ordered,
                           self.opt_level,
                           max_buffer_elems=self.max_buffer_elems,
                           inflight_depth=self.inflight_depth,
                           max_batch_delay_ms=self.max_batch_delay_ms,
                           emit_batches=self.emit_batches,
                           placement=self.placement,
                           adaptive_batch=self.adaptive_batch)


@_alias_camel
class WinMapReduceTPUBuilder(_WinBuilderBase, _TPUBuilderMixin):
    """builders_gpu.hpp:1482 analogue: exactly one of MAP/REDUCE on device."""

    _default_name = "win_mr_tpu"

    def __init__(self, map_stage, reduce_stage, map_on_tpu: bool = True):
        super().__init__(map_stage)
        self.reduce_stage = reduce_stage
        self.map_on_tpu = map_on_tpu
        self.par1 = 2
        self.par2 = 1
        self.batch_len = DEFAULT_BATCH_LEN
        self.value_of = None
        self.device_index = 0
        self.ordered = True

    def with_parallelism(self, map_par: int, reduce_par: int = 1):
        self.par1 = map_par
        self.par2 = reduce_par
        return self

    withParallelism = with_parallelism

    def build(self) -> WinMapReduceTPU:
        self._check_windows()
        self._check_placement_supported()
        return WinMapReduceTPU(self.fn, self.reduce_stage, self.win_len,
                               self.slide_len, self.win_type, self.par1,
                               self.par2, self.map_on_tpu, self.batch_len,
                               self.triggering_delay, self.name,
                               self.result_factory, self.value_of,
                               self.ordered,
                               max_buffer_elems=self.max_buffer_elems,
                               inflight_depth=self.inflight_depth,
                               max_batch_delay_ms=self.max_batch_delay_ms)


@_alias_camel
class WinSeqFFATTPUBuilder(_WinBuilderBase, _TPUBuilderMixin):
    """builders_gpu.hpp:232 analogue (lift + combine)."""

    _default_name = "win_seqffat_tpu"

    _BUILTIN_COMBINES = {"sum": (None, 0.0), "max": (None, float("-inf")),
                         "min": (None, float("inf"))}

    def __init__(self, lift, combine):
        super().__init__(lift)
        self.combine = combine
        self.batch_len = DEFAULT_BATCH_LEN
        self.device_index = 0
        # None = auto (docs/PLANNER.md "Resident state"): CB windows
        # default onto the RESIDENT lane (rebuild=False) -- per-key
        # forests stay in device memory across launches and only new
        # leaves ship; TB windows default to rebuild (the resident
        # ring's eviction proof needs per-key in-order timestamps,
        # which an arbitrary TB stream does not guarantee)
        self.rebuild = None

    def with_rebuild(self, rebuild: bool):
        """rebuild=True: the tree is rebuilt from the staged flat
        buffer every device launch.  rebuild=False: the per-key forest
        stays resident in device memory and is incrementally updated
        (the Win_SeqFFAT_GPU ``rebuild`` flag, win_seqffat_gpu.hpp:150) --
        the DEFAULT for CB windows.  CB windows ride the arrival-order
        leaf ring; TB windows need per-key in-order timestamps (ring
        eviction is keyed on the timestamp proof), so out-of-order TB
        streams must keep rebuild=True (the TB default; rebuild=False
        opts an in-order TB stream in)."""
        self.rebuild = rebuild
        return self

    withRebuild = with_rebuild

    def _resident_combine(self):
        if isinstance(self.combine, tuple) and len(self.combine) == 2:
            return self.combine
        if isinstance(self.combine, str) \
                and self.combine in self._BUILTIN_COMBINES:
            import torch
            from ..ops import minmax
            fn = {"sum": torch.add, "max": minmax.maximum,
                  "min": minmax.minimum}[self.combine]
            return fn, self._BUILTIN_COMBINES[self.combine][1]
        raise ValueError(
            "resident (rebuild=False) mode needs a (torch function, "
            "neutral) combine or one of sum/max/min")

    def build(self):
        self._check_windows()
        self._check_placement_supported()
        rebuild = self.rebuild
        if rebuild is None:
            # auto: CB engines default onto the resident lane when the
            # combine has a resident form; TB (ordering not guaranteed)
            # and exotic combines keep the rebuild path
            try:
                self._resident_combine()
                rebuild = self.win_type != WinType.CB
            except ValueError:
                rebuild = True
        if not rebuild:
            from ..operators.tpu.ffat_resident import WinSeqFFATResident
            fn, neutral = self._resident_combine()
            return WinSeqFFATResident(self.fn, fn, neutral, self.win_len,
                                      self.slide_len, self.win_type,
                                      self.name, self.result_factory)
        return WinSeqFFATTPU(self.fn, self.combine, self.win_len,
                             self.slide_len, self.win_type, self.batch_len,
                             self.triggering_delay, self.name,
                             self.result_factory,
                             max_buffer_elems=self.max_buffer_elems,
                             inflight_depth=self.inflight_depth,
                             max_batch_delay_ms=self.max_batch_delay_ms)


@_alias_camel
class KeyFFATTPUBuilder(_WinBuilderBase, _TPUBuilderMixin,
                        _KeyShardedMixin):
    """builders_gpu.hpp:1003 analogue (lift + combine, key-sharded)."""

    _default_name = "key_ffat_tpu"

    def __init__(self, lift, combine):
        super().__init__(lift)
        self.combine = combine
        self.batch_len = DEFAULT_BATCH_LEN
        self.device_index = 0
        self.coalesce = True

    def build(self) -> KeyFFATTPU:
        self._check_windows()
        self._check_placement_supported()
        return KeyFFATTPU(self.fn, self.combine, self.win_len,
                          self.slide_len, self.win_type, self.parallelism,
                          self.batch_len, self.triggering_delay, self.name,
                          self.result_factory,
                          max_buffer_elems=self.max_buffer_elems,
                          coalesce=self.coalesce,
                          inflight_depth=self.inflight_depth,
                          max_batch_delay_ms=self.max_batch_delay_ms)
