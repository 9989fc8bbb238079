"""Device-batched composite window operators (the port of the
reference's ``operators/tpu/farms_tpu.py``), so far the FFAT pair:

* WinSeqFFATTPU    <- win_seqffat_gpu.hpp (734): lift on the host,
                      FlatFAT aggregation on the device (the ``ffat``
                      kind of ops/window_compute)
* KeyFFATTPU       <- key_ffat_gpu.hpp (345)

An FFAT combine is a builtin name ('sum'/'max'/'min', served by the
builtin kinds) or a ``(torch_binary_fn, neutral)`` pair; on the card the
function must be one the FlatFAT query kernel compiles: ``torch.add``,
``torch.maximum`` or ``torch.minimum``.

KeyFarmTPU, WinFarmTPU, PaneFarmTPU and WinMapReduceTPU are not ported
yet (ROADMAP.md A8) and raise when constructed.
"""
from __future__ import annotations

from typing import Any, Callable

from ..._unported import unported
from ...core.basic import (OrderingMode, Pattern, RoutingMode,
                           WinOperatorConfig, WinType)
from ...core.tuples import BasicRecord
from ...runtime.emitters import StandardEmitter
from ...runtime.win_routing import KFEmitter
from ..base import Operator, StageSpec
from .win_seq_tpu import (DEFAULT_BATCH_LEN, DEFAULT_INFLIGHT_DEPTH,
                          DEFAULT_MAX_BATCH_DELAY_MS,
                          DEFAULT_MAX_BUFFER_ELEMS, WinSeqTPULogic)


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


def _unported_farm(name: str):
    def __init__(self, *args, **kwargs):
        raise unported(name, "farms")
    return type(name, (_TPUWinOp,), {"__init__": __init__,
                                     "__doc__": f"{name}: not ported yet."})


KeyFarmTPU = _unported_farm("KeyFarmTPU")
WinFarmTPU = _unported_farm("WinFarmTPU")
PaneFarmTPU = _unported_farm("PaneFarmTPU")
WinMapReduceTPU = _unported_farm("WinMapReduceTPU")


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
