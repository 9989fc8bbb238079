"""Win_Seq_TPU: the device-batched keyed window engine.

Re-design of reference ``wf/win_seq_gpu.hpp`` (769 LoC): where the
reference archives tuples per key, batches ``batch_len`` fired windows,
copies them to pinned buffers and launches a CUDA kernel per batch on a
private stream (svc :391-645), this engine:

* keeps each key's series in growing host buffers (consolidated into
  sorted numpy arrays at flush time -- the pinned-staging analogue);
* accumulates descriptors of fired windows (key, gwid, extent) until
  ``batch_len``;
* assembles one flat ragged buffer + [start, end) extents and launches
  the batch on the device via `WindowComputeEngine` (ops/window_compute;
  a ``sum`` launches the hand-written CUDA kernel ops/cuda/window_sum.cu);
* overlaps host batching with device execution through async dispatch
  on a per-engine CUDA stream, flushing the *previous* batch's results
  lazily -- the double-buffered ``waitAndFlush`` protocol
  (win_seq_gpu.hpp:267-297);
* on the resident lane (``resident=True``, or promoted by the planner)
  keeps per-key pane partials in a device forest across launches and
  ships only new partials (ops/window_compute.ResidentPaneCarry; one
  launch of the fused FlatFAT update+query kernel of
  ops/cuda/flatfat_query.cu writes them and answers the windows).

The device is explicit: ``device=`` (or the graph's
``RuntimeConfig.device``, bound by the planner at start) names the
torch device; CUDA is the default and its absence raises.

Window-id assignment (config/role arithmetic) is identical to the host
engine, so this operator drops into every composite farm exactly like
Win_Seq_GPU does in the reference (win_farm_gpu.hpp:82-86).
"""
from __future__ import annotations

import contextlib as _contextlib
import threading as _threading
import time as _time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ...core.basic import (OrderingMode, Pattern, Role, RoutingMode,
                           WinOperatorConfig, WinType)
from ...core.meta import default_hash
from ...core.tuples import BasicRecord, SynthChunk, TupleBatch
from ...core import win_assign as wa
from ...ops.window_compute import WindowComputeEngine
from ...runtime.emitters import StandardEmitter
from ...runtime.node import EOSMarker, NodeLogic
from ...telemetry.profiler import span, spanned
from ..base import Operator, StageSpec

DEFAULT_BATCH_LEN = 256
# host staging-buffer capacity (elements) before a forced flush
DEFAULT_MAX_BUFFER_ELEMS = 1 << 19
# device launches kept in flight before the oldest is flushed.  8 deep
# (was 4): over a high-latency transport the pipeline must hold enough
# programs that one RTT amortizes over several launches; the adaptive
# batch resize below keeps per-launch latency bounded regardless
DEFAULT_INFLIGHT_DEPTH = 8
# partial-batch launch trigger (latency bound), milliseconds
DEFAULT_MAX_BATCH_DELAY_MS = 10.0

PLACEMENTS = ("device", "host", "auto")


class AdaptiveBatcher:
    """x2 / /2 device-batch resize driven by observed launch latency
    against the measured transport RTT floor -- the adaptation loop of
    the reference's pinned-buffer management (win_seq_gpu.hpp:574-592),
    re-aimed at a transport where the launch floor, not buffer size,
    is the cost.

    * launch latency ~ the floor (<= ``grow_below`` x): the launch is
      transport-bound -- the batch is too small to amortize the round
      trip; after ``patience`` consecutive such launches the batch
      DOUBLES.
    * launch latency >> the floor (>= ``shrink_above`` x): compute or
      queueing dominates and per-window latency grows with the batch;
      after ``patience`` such launches the batch HALVES.
    * in between: the operating point is good; streaks reset.

    Deterministic on a given latency trace (unit-tested against
    scripted traces).  The engine reads ``batch_len`` between launches,
    so resizes take effect on the next batch assembly."""

    __slots__ = ("batch_len", "floor_ms", "lo", "hi", "grow_below",
                 "shrink_above", "patience", "_grow", "_shrink",
                 "resizes")

    def __init__(self, batch_len: int, floor_ms: float, lo: int = 64,
                 hi: int = 1 << 16, grow_below: float = 2.0,
                 shrink_above: float = 8.0, patience: int = 3):
        if floor_ms <= 0:
            raise ValueError("floor_ms must be > 0")
        # an explicitly configured batch_len outside the default band
        # widens the band rather than being silently clamped away
        self.batch_len = max(1, int(batch_len))
        self.floor_ms = floor_ms
        self.lo = min(lo, self.batch_len)
        self.hi = max(hi, self.batch_len)
        self.grow_below = grow_below
        self.shrink_above = shrink_above
        self.patience = patience
        self._grow = 0
        self._shrink = 0
        self.resizes: List = []  # (direction, new_len) decision log

    def observe(self, launch_ms: float) -> int:
        if launch_ms <= self.grow_below * self.floor_ms:
            self._grow += 1
            self._shrink = 0
            if self._grow >= self.patience and self.batch_len < self.hi:
                self.batch_len = min(self.hi, self.batch_len * 2)
                self.resizes.append(("x2", self.batch_len))
                self._grow = 0
        elif launch_ms >= self.shrink_above * self.floor_ms:
            self._shrink += 1
            self._grow = 0
            if self._shrink >= self.patience and self.batch_len > self.lo:
                self.batch_len = max(self.lo, self.batch_len // 2)
                self.resizes.append(("/2", self.batch_len))
                self._shrink = 0
        else:
            self._grow = 0
            self._shrink = 0
        return self.batch_len


def _key_groups(keys: np.ndarray):
    """Stable-group a key column: (order, keys_sorted, bounds) with
    ``order`` None when the column is already sorted (saves the
    re-index on the columnar hot path)."""
    if len(keys) > 1 and not np.all(keys[:-1] <= keys[1:]):
        order = np.argsort(keys, kind="stable")
        keys_s = keys[order]
    else:
        order, keys_s = None, keys
    edges = np.nonzero(np.diff(keys_s))[0] + 1
    bounds = np.concatenate([[0], edges, [len(keys_s)]])
    return order, keys_s, bounds


class _AsyncDispatcher:
    """Dedicated launch thread: the ingest thread stages numpy buffers
    and hands them off; this thread pays the host->device transfer
    latency, keeps ``inflight_depth`` programs in flight, and emits
    completed results.  The reference overlaps CUDA streams with host
    batching on ONE thread (win_seq_gpu.hpp:267-297); here the staging
    copies and the launch come off the ingest thread entirely.  The
    current CUDA device and stream are per thread in torch, so ``_run``
    sets the device itself and launches each batch on its engine's own
    stream."""

    __slots__ = ("logic", "work", "thread", "error", "aborting")

    def __init__(self, logic: "WinSeqTPULogic"):
        import queue as _q
        import threading as _t
        self.logic = logic
        self.work = _q.Queue(maxsize=max(1, logic.inflight_depth))
        self.error: Optional[BaseException] = None
        self.aborting = False
        self.thread = _t.Thread(target=self._run, daemon=True,
                                name="winseq-tpu-dispatch")
        self.thread.start()

    def submit(self, item) -> None:
        import queue as _q
        # bounded put re-checking for a dead/failed dispatcher: a plain
        # blocking put could hang forever if the thread errors out while
        # the queue is full (nothing would ever drain it)
        while True:
            if self.error is not None:
                raise RuntimeError("window dispatch thread failed") \
                    from self.error
            try:
                self.work.put(item, timeout=0.25)
                return
            except _q.Full:
                continue

    def drain(self) -> None:
        """EOS barrier: launch everything staged, flush every handle."""
        import queue as _q
        while True:  # the consumer drains even after an error, so the
            try:     # sentinel always fits eventually
                self.work.put(None, timeout=0.25)
                break
            except _q.Full:
                continue
        self.thread.join()
        if self.error is not None:
            raise RuntimeError("window dispatch thread failed") \
                from self.error

    def abort(self) -> None:
        """Node-error teardown: drop the backlog without launching it
        (no EOS barrier -- the downstream channel is closing)."""
        import queue as _q
        self.aborting = True
        try:
            self.work.put_nowait(None)
        except _q.Full:
            pass  # the run loop polls `aborting` on empty reads
        self.thread.join(timeout=30)

    def _run(self) -> None:
        from collections import deque
        import queue as _q
        logic = self.logic
        pending = deque()
        last_emit = None
        if logic.device is not None and logic.device.type == "cuda":
            torch.cuda.set_device(logic.device)
        while True:
            try:
                # fine-grained poll while batches are in flight: their
                # async D2H lands mid-stream and must be emitted then,
                # not at the next launch (latency would otherwise grow
                # with the launch interval)
                item = self.work.get(timeout=0.005 if pending else 0.25)
            except _q.Empty:
                if self.aborting:
                    return
                while (pending and self.error is None
                       and not self.aborting and pending[0][0].ready()):
                    try:
                        logic._finish(pending.popleft(), last_emit)
                    except BaseException as e:
                        self.error = e
                continue
            if item is None:
                break
            if self.aborting or self.error is not None:
                continue  # failed/aborted: drain the queue, launch nothing
            if type(item) is _Forward:
                # a watermark follows every result launched before it
                try:
                    while pending:
                        logic._finish(pending.popleft(), item.emit)
                    item.emit(item.wm)
                except BaseException as e:
                    self.error = e
                continue
            (engine, cols, starts, ends, gwids, descs, emit,
             nbytes_in) = item
            last_emit = emit
            try:
                t_sub = _time.perf_counter()
                # torch.profiler capture hook (telemetry/profiler.py):
                # a no-op unless WINDFLOW_TORCH_PROFILE=1
                with span("windflow/window_launch"), \
                        _launch_context(engine):
                    handle = engine.compute(cols, starts, ends, gwids)
                logic.launched_batches += 1
                pending.append((handle, descs, t_sub, len(pending) + 1,
                                nbytes_in))
                # flush at depth (backpressure) AND any batch whose
                # async D2H already landed -- otherwise results wait
                # for the pipeline to fill and latency grows with
                # inflight_depth instead of shrinking
                while (pending and not self.aborting
                       and (len(pending) >= logic.inflight_depth
                            or pending[0][0].ready())):
                    logic._finish(pending.popleft(), emit)
            except BaseException as e:  # surfaced on next submit / drain
                self.error = e
        while pending and self.error is None and not self.aborting:
            try:
                logic._finish(pending.popleft(), last_emit)
            except BaseException as e:
                self.error = e


class _Forward:
    """A watermark handed to the dispatcher: it leaves through ``emit``
    once every batch launched before it has been emitted."""

    __slots__ = ("wm", "emit")

    def __init__(self, wm, emit):
        self.wm = wm
        self.emit = emit


def _launch_context(engine):
    """The engine's device + stream context (device engines), a no-op
    for the host lane's numpy engine."""
    ctx = getattr(engine, "launch_context", None)
    return ctx() if ctx is not None else _contextlib.nullcontext()


class _TPUKeyState:
    __slots__ = ("sort_keys", "ts", "values", "pending_sort", "pending_ts",
                 "pending_val", "pending_chunks", "next_fire", "opened_max",
                 "max_id", "renumber_next", "emit_counter", "anchor",
                 "pane_synced", "min_new_id")

    def __init__(self, emit_counter_start=0):
        # resident-lane sync state (ops/window_compute.ResidentPaneCarry):
        # pane indices below ``pane_synced`` are final in the device
        # forest; ``min_new_id`` tracks the smallest id appended since
        # the last launch, so a launch ships only panes the new data
        # could have changed (None = everything dirty / nothing new)
        self.pane_synced = None
        self.min_new_id = None
        # consolidated sorted arrays
        self.sort_keys = np.empty(0, np.int64)
        self.ts = np.empty(0, np.int64)
        self.values = np.empty(0, np.float64)
        # unsorted pending appends (sorted at consolidation): scalar
        # lists for the record plane, array chunks for the batch plane
        self.pending_sort: List[int] = []
        self.pending_ts: List[int] = []
        self.pending_val: List[float] = []
        self.pending_chunks: List = []
        self.next_fire = 0        # next lwid to fire
        self.anchor = 0           # first window that can ever fire (set
                                  # from the first tuple, like the
                                  # native engine's anchor)
        self.opened_max = -1      # highest lwid opened by any tuple
        self.max_id = -1
        self.renumber_next = 0
        self.emit_counter = emit_counter_start


class WinSeqTPULogic(NodeLogic):
    # the runtime hands SynthChunk descriptors through un-materialized
    accepts_synth_chunks = True
    # on_watermark emits the watermark itself, behind the results it
    # fired (they may leave from the dispatcher thread): the runtime
    # must not forward it again
    forwards_watermarks = True
    # async dispatch calls emit from the dispatcher thread AFTER svc
    # returns: the runtime must not hand this logic a buffered emit
    # (set per instance in __init__; inline dispatch is synchronous)
    sync_emit = False

    def __init__(self, win_kind: Any, win_len: int, slide_len: int,
                 win_type: WinType, *, batch_len: int = DEFAULT_BATCH_LEN,
                 triggering_delay: int = 0, result_factory=BasicRecord,
                 config: WinOperatorConfig = None, role: Role = Role.SEQ,
                 map_indexes=(0, 1), parallelism: int = 1,
                 replica_index: int = 0, renumbering: bool = False,
                 value_of: Callable[[Any], float] = None,
                 closing_func: Callable = None, emit_batches: bool = False,
                 max_buffer_elems: int = DEFAULT_MAX_BUFFER_ELEMS,
                 inflight_depth: int = DEFAULT_INFLIGHT_DEPTH,
                 async_dispatch: bool = True,
                 max_batch_delay_ms: float = DEFAULT_MAX_BATCH_DELAY_MS,
                 placement: str = "device",
                 adaptive_batch: bool = False,
                 rtt_floor_ms: Optional[float] = None,
                 resident: Optional[bool] = None,
                 device=None):
        if win_len == 0 or slide_len == 0:
            raise ValueError("win_len and slide_len must be > 0")
        if placement not in PLACEMENTS:
            raise ValueError(
                f"placement must be one of {PLACEMENTS}, not {placement!r}")
        # placement plane (graph/planner.py; docs/PLANNER.md): 'device'
        # keeps the device lane (status quo), 'host' swaps in the numpy
        # host engine at construction, 'auto' defers to the cost-based
        # planner at PipeGraph.start
        self.placement = placement
        self.resolved_placement = placement if placement != "auto" else None
        self.adaptive_batch = adaptive_batch
        self.rtt_floor_ms = rtt_floor_ms
        self._adaptive: Optional[AdaptiveBatcher] = None
        # the device the device lane runs on (None: the graph's
        # RuntimeConfig.device, bound by the planner, else the card)
        self._device_req = device
        if placement == "host":
            from ...ops.host_compute import HostComputeEngine
            self.engine = HostComputeEngine(win_kind)  # builtin kinds only
        else:
            self.engine = WindowComputeEngine(win_kind, device=device)
        # direct-feed plane (ingest/feed.py): parallel feeder threads
        # call feed_columns concurrently; staging is single-writer
        self._feed_lock = _threading.Lock()
        self.win_len = win_len
        self.slide_len = slide_len
        self.win_type = win_type
        self.batch_len = max(1, batch_len)
        self.triggering_delay = triggering_delay
        self.result_factory = result_factory
        self.config = config or WinOperatorConfig()
        self.role = role
        self.map_indexes = map_indexes
        self.renumbering = renumbering
        self.value_of = value_of or (lambda t: t.value)
        self.closing_func = closing_func
        self.emit_batches = emit_batches
        self.keys: Dict[Any, _TPUKeyState] = {}
        # batch under assembly: descriptors (key, gwid, start_key, end_key)
        self.descriptors: List = []
        # in-flight batches, oldest first: (handle, descriptors, submit
        # time, depth at submit, bytes in).
        # Depth > 1 keeps several device programs + async D2H copies in
        # flight so one high-latency transport roundtrip amortizes over
        # many launches (deepens the reference's 2-deep waitAndFlush
        # pipeline, win_seq_gpu.hpp:267-297).
        from collections import deque
        self.pending = deque()
        self.inflight_depth = max(1, inflight_depth)
        self.async_dispatch = async_dispatch
        self.sync_emit = not async_dispatch
        self._dispatcher: Optional[_AsyncDispatcher] = None
        self.ignored_tuples = 0
        self.launched_batches = 0
        # launch also when this much unshipped data is buffered, even if
        # the window batch is not full -- bounds host memory and keeps
        # device transfers pipelined (the adaptive resize analogue,
        # win_seq_gpu.hpp:574-592)
        self.max_buffer_elems = max_buffer_elems
        self._buffered_since_launch = 0
        # time-based launch trigger: a partial batch launches whenever
        # windows are ready and at least this long has passed since the
        # previous launch -- the latency half of the reference's
        # adaptive batch resize (win_seq_gpu.hpp:574-592), bounding
        # result latency at (delay + transport RTT) instead of
        # (full-batch fill time + RTT)
        self.max_batch_delay_ms = max_batch_delay_ms
        self._last_launch_t = 0.0
        # telemetry plane (telemetry/; docs/OBSERVABILITY.md): the
        # trace context of the most recent traced input crosses the
        # async dispatcher -- captured at svc, stamped with a device
        # hop and re-attached to the next finished result batch.  Set
        # on the ingest thread, consumed on the dispatcher thread:
        # gauge-grade for sampled traces, like the depth gauges
        self._trace_ctx = None
        self._trace_name = "win_seq_tpu"
        # whole-partition device step (graph/device_step.py): while a
        # chunk is traversing the fused chain the step logic holds all
        # intra-chunk launch triggers and calls flush_chunk() once at
        # the chunk boundary, so a device segment pays ONE launch per
        # ingest chunk instead of one per trigger site.  eos_flush /
        # quiesce / idle_tick stay unguarded -- they run between
        # chunks, where the hold is always clear.
        self.chunk_hold = False
        # the C++ columnar engine covers the hot standalone cases
        # (native/window_engine.cpp): builtin kinds, identity window
        # assignment, default value column, role SEQ -- or role PLQ,
        # whose only difference under an identity config is that output
        # ids are per-key dense counters (plq_renumbered_id degenerates
        # to the emit counter), applied on the flushed batch
        self._native = None
        # resident lane (docs/PLANNER.md "Resident state"): per-key
        # pane partials stay device-resident across launches; a launch
        # ships only new/changed partials.  True forces it on (and
        # takes the Python staging path -- the native engine stages its
        # own pane buffers), False opts out, None lets the planner
        # promote eligible device-lane engines.
        self.resident = resident
        self._resident = None
        self._plq_counters: Dict[Any, int] = {}
        # non-integral record keys (the reference's templated key types)
        # are interned into a reserved negative int64 range for the
        # columnar/native stores and translated back on emission
        self._key_intern: Dict[Any, int] = {}
        self._key_extern: Dict[int, Any] = {}
        self._saw_nonint_key = False
        # a count reads no values: its batches need no value column
        self._reads_values = not (isinstance(win_kind, str)
                                  and win_kind == "count")
        self._zeros = np.zeros(0, np.float32)
        cfg = self.config
        if (isinstance(win_kind, str)
                and win_kind in ("sum", "count", "max", "min", "mean")
                and role in (Role.SEQ, Role.PLQ)
                and cfg.n_outer == 1 and cfg.n_inner == 1
                and cfg.id_outer == 0 and cfg.id_inner == 0
                and value_of is None and resident is not True):
            try:
                from ...runtime.native import (NativeWindowEngine,
                                               native_available)
                if native_available():
                    # renumbering = per-key arrival-order ids, which the
                    # engine implements natively (ids implicit, always
                    # on the dense lane)
                    self._native = NativeWindowEngine(
                        win_len, slide_len, win_type == WinType.TB,
                        triggering_delay, renumber=renumbering,
                        kind=win_kind)
            except Exception:
                self._native = None
        # the native fold's calls: spanned at svc_init when the
        # profiler switch is on (telemetry/profiler.py)
        if self._native is not None:
            self._ingest = self._native.ingest
            self._synth_ingest = self._native.synth_ingest
        if resident is True:
            self._enable_resident(required=True)

    # -- placement plane (graph/planner.py; docs/PLANNER.md) ---------------
    @property
    def device(self) -> Optional[torch.device]:
        """The device-lane engine's torch device (None: not bound yet,
        or the host lane)."""
        return getattr(self.engine, "device", None)

    def set_device(self, device) -> torch.device:
        """Bind the device-lane engines (main + helpers) to ``device``;
        raises when CUDA is asked for and absent."""
        dev = self.engine.bind(device)
        self._device_req = dev
        for cached in ("_count_eng", "_mean_eng"):
            eng = getattr(self, cached, None)
            if eng is not None:
                eng.bind(dev)
        if self._resident is not None and self._resident.device != dev:
            self._resident.bind(dev)
        return dev

    def apply_placement(self, placement: str,
                        rtt_floor_ms: Optional[float] = None) -> None:
        """Resolve this engine onto a lane.  Called by the planner at
        graph start (before any thread runs) for 'auto' engines, and
        for pinned ones to record the resolution + RTT floor.  Host
        resolution swaps the device engine for the numpy host engine
        and drops any cached helper engines so they rebuild on-lane."""
        from ...ops.host_compute import HostComputeEngine
        if placement not in ("device", "host"):
            raise ValueError(f"cannot resolve onto {placement!r}")
        self.resolved_placement = placement
        if rtt_floor_ms:
            self.rtt_floor_ms = rtt_floor_ms
        if placement == "host":
            # the host lane computes against the host staging store
            # directly: drop any resident device state (recomputable
            # from the retained series on a later flip back)
            self._resident = None
            for st in self.keys.values():
                st.pane_synced = None
                st.min_new_id = None
            if not isinstance(self.engine, HostComputeEngine):
                self.engine = HostComputeEngine(self.engine.kind)
                for cached in ("_count_eng", "_mean_eng"):
                    if hasattr(self, cached):
                        delattr(self, cached)
        elif isinstance(self.engine, HostComputeEngine):
            # a lane flip back to the device restores the device engine
            self.engine = WindowComputeEngine(self.engine.kind,
                                              device=self._device_req)
            for cached in ("_count_eng", "_mean_eng"):
                if hasattr(self, cached):
                    delattr(self, cached)

    def _make_engine(self, kind):
        """Helper-engine factory honouring the resolved lane (the
        count->sum and mean->pair engines must run where the main
        engine runs, on its device)."""
        if self.resolved_placement == "host":
            from ...ops.host_compute import HostComputeEngine
            return HostComputeEngine(kind)
        return WindowComputeEngine(kind, device=self.device)

    # -- resident lane (ops/window_compute.ResidentPaneCarry;
    # docs/PLANNER.md "Resident state & online re-planning") ---------------
    def resident_eligible(self) -> bool:
        """Shapes the resident pane carry serves: builtin monoid kind,
        pane length (gcd(win, slide)) long enough to pre-reduce, role
        SEQ on a device lane, Python staging (the native engine stages
        its own pane buffers).  Everything else keeps the rebuild
        path."""
        kind = getattr(self.engine, "kind", None)
        if not (isinstance(kind, str)
                and kind in ("sum", "count", "max", "min")):
            return False
        pane = int(np.gcd(self.win_len, self.slide_len))
        return (pane >= 16 and self.role == Role.SEQ
                and self._native is None
                and self.resolved_placement != "host")

    def _enable_resident(self, required: bool = False) -> bool:
        if self._resident is not None:
            return True
        if not self.resident_eligible():
            if required:
                raise ValueError(
                    "resident=True needs an eligible engine: builtin "
                    "sum/count/max/min kind, pane length (gcd(win, "
                    "slide)) >= 16, role SEQ and a device lane -- the "
                    "rebuild lane serves every other shape")
            return False
        from ...ops.window_compute import ResidentPaneCarry
        pane = int(np.gcd(self.win_len, self.slide_len))
        self._resident = ResidentPaneCarry(self.engine.kind,
                                           self.win_len // pane,
                                           device=self.device)
        for st in self.keys.values():
            st.pane_synced = None
        return True

    def maybe_enable_resident(self) -> bool:
        """Planner promotion hook (graph/planner.plan_graph): an
        undecided (resident=None) engine joins the resident lane when
        eligible; resident=False opts out, True forced it at
        construction."""
        if self.resident is False:
            return False
        return self._enable_resident()

    def _reset_resident(self) -> None:
        """Drop resident device state (restore / lane flip): the next
        launch re-ships live partials from the host retained series."""
        if self._resident is not None:
            self._resident.reset()
        for st in self.keys.values():
            st.pane_synced = None
            st.min_new_id = None

    def device_resident_bytes(self) -> int:
        """Gauge hook: bytes of window state resident in device memory
        (the ``Device_state_bytes_resident`` stats field)."""
        return (self._resident.state_bytes
                if self._resident is not None else 0)

    def svc_init(self) -> None:
        if self._native is not None:
            self._ingest = spanned("windflow/fold", self._native.ingest)
            self._synth_ingest = spanned("windflow/fold",
                                         self._native.synth_ingest)
        if self.stats is not None and self.stats.operator_name:
            self._trace_name = self.stats.operator_name
        # adaptive x2 / /2 batch resize (win_seq_gpu.hpp:574-592): only
        # meaningful against a launch floor, so the device lane measures
        # one (planner-provided, else probed once per process)
        if self.adaptive_batch and self._adaptive is None \
                and self.resolved_placement != "host":
            if not self.rtt_floor_ms:
                from ...graph.planner import rtt_floor_ms
                self.rtt_floor_ms = rtt_floor_ms()
            self._adaptive = AdaptiveBatcher(self.batch_len,
                                             self.rtt_floor_ms)

    # -- direct columnar feed (ingest/feed.py) -----------------------------
    def feed_columns(self, keys, ids, ts, vals, emit) -> None:
        """Thread-safe columnar ingest for parallel feeder threads:
        columns go straight into the staging store (the C++ engine when
        built) under the feed lock -- no channel hop, no per-tuple
        Python.  ``emit`` receives any results whose launch the ingest
        triggers (the async dispatcher keeps emitting after return)."""
        batch = TupleBatch({"key": np.asarray(keys, np.int64),
                            "id": np.asarray(ids, np.int64),
                            "ts": np.asarray(ts, np.int64),
                            "value": np.asarray(vals)})
        with self._feed_lock:
            self._svc_batch(batch, emit)

    def feed_eos(self, emit) -> None:
        """Drain hook for the direct-feed plane (pairs with
        ``feed_columns`` exactly like the record plane's feed_eos)."""
        with self._feed_lock:
            self.eos_flush(emit)

    # -- per-key helpers ---------------------------------------------------
    def _key_state(self, key) -> _TPUKeyState:
        st = self.keys.get(key)
        if st is None:
            start = self.map_indexes[0] if self.role == Role.MAP else 0
            st = self.keys[key] = _TPUKeyState(start)
        return st

    def _consolidate(self, st: _TPUKeyState) -> None:
        if not st.pending_sort and not st.pending_chunks:
            return
        chunks_sk = [c[0] for c in st.pending_chunks]
        chunks_ts = [c[1] for c in st.pending_chunks]
        chunks_v = [c[2] for c in st.pending_chunks]
        if st.pending_sort:
            chunks_sk.append(np.asarray(st.pending_sort, np.int64))
            chunks_ts.append(np.asarray(st.pending_ts, np.int64))
            chunks_v.append(np.asarray(st.pending_val, np.float64))
        st.pending_chunks.clear()
        sk = np.concatenate(chunks_sk)
        ts = np.concatenate(chunks_ts)
        vals = np.concatenate(chunks_v)
        order = np.argsort(sk, kind="stable")
        sk, ts, vals = sk[order], ts[order], vals[order]
        if len(st.sort_keys) and len(sk) and sk[0] < st.sort_keys[-1]:
            # out-of-order across consolidations (TB within delay): merge
            merged = np.concatenate([st.sort_keys, sk])
            order = np.argsort(merged, kind="stable")
            st.sort_keys = merged[order]
            st.ts = np.concatenate([st.ts, ts])[order]
            st.values = np.concatenate([st.values, vals])[order]
        else:
            st.sort_keys = np.concatenate([st.sort_keys, sk])
            st.ts = np.concatenate([st.ts, ts])
            st.values = np.concatenate([st.values, vals])
        st.pending_sort.clear()
        st.pending_ts.clear()
        st.pending_val.clear()

    def _evict(self, st: _TPUKeyState, initial_id: int) -> None:
        """Drop the prefix no window >= next_fire can reach (the archive
        purge, win_seq_gpu.hpp:612-614)."""
        keep_from = initial_id + st.next_fire * self.slide_len
        cut = np.searchsorted(st.sort_keys, keep_from, side="left")
        if cut:
            st.sort_keys = st.sort_keys[cut:]
            st.ts = st.ts[cut:]
            st.values = st.values[cut:]

    # -- batch plane -------------------------------------------------------
    def _finish(self, entry, emit) -> None:
        """Flush one in-flight batch: block on its handle, record the
        per-launch device time (submit -> result on host), feed the
        adaptive batch resize, emit."""
        handle, descs, t_sub, depth, nbytes_in = entry
        results = handle.block()
        now = _time.perf_counter()
        launch_ms = (now - t_sub) * 1e3
        if self.stats is not None:  # single-writer: dispatcher thread
            self.stats.bytes_from_device += results.nbytes
            self.stats.device_time_ms += launch_ms
        if self._adaptive is not None:
            # x2 / /2 against the RTT floor; the new length applies to
            # the next batch assembly (ingest thread reads batch_len).
            # The wall includes queueing behind the other in-flight
            # launches on a serialized transport, so it is normalized
            # by the depth at submit: otherwise a saturated pipeline at
            # depth 8 always reads >= shrink_above x the floor and the
            # controller can only shrink under exactly the load it is
            # meant to optimize
            before = self.batch_len
            self.batch_len = self._adaptive.observe(launch_ms / depth)
            if self.batch_len != before and self.flight is not None:
                self.flight.record("batch_resize",
                                   operator=self._trace_name,
                                   old_len=before,
                                   new_len=self.batch_len,
                                   launch_ms=round(launch_ms, 3))
        # trace crossing (telemetry/): the sampled context captured at
        # svc gets an engine hop (submit -> result-on-host) and rides
        # the result batch to the sink.  On the device lane the
        # "@device" suffix keys the diagnosis plane's hop-class split
        # (device transport/compute vs host service --
        # diagnosis/attribution.py); the host lane's launches are host
        # service time and stamp plain
        tr = self._trace_ctx
        if tr is not None:
            self._trace_ctx = None
            name = self._trace_name
            if self.resolved_placement != "host":
                # device-lane hops carry launch count + transfer bytes
                # as gauge-grade hop meta so a whole-partition step
                # (graph/device_step.py) stays attributable as ONE
                # launch per chunk in the diagnosis plane
                tr.hop(name + "@device", t_sub, now,
                       meta={"launches": 1,
                             "bytes_in": int(nbytes_in),
                             "bytes_out": int(results.nbytes)})
            else:
                tr.hop(name, t_sub, now)
        self._emit_results(results, descs, emit, trace=tr)

    def _submit(self, cols, starts, ends, gwids, descs, emit,
                engine=None) -> None:
        """Hand one staged batch to the device: via the dispatcher
        thread (default) or inline with the waitAndFlush protocol."""
        eng = engine or self.engine
        nbytes_in = (sum(int(np.asarray(c).nbytes) for c in cols.values())
                     + starts.nbytes + ends.nbytes + gwids.nbytes)
        if self.stats is not None:  # single-writer: ingest thread
            self.stats.num_launches += 1
            self.stats.bytes_to_device += nbytes_in
            self.stats.inputs_ignored = self.ignored_tuples
        if self.async_dispatch:
            if self._dispatcher is None:
                self._dispatcher = _AsyncDispatcher(self)
            self._dispatcher.submit(
                (eng, cols, starts, ends, gwids, descs, emit, nbytes_in))
        else:
            self._flush_pending(emit)  # waitAndFlush of the previous
            t_sub = _time.perf_counter()
            with span("windflow/window_launch"), _launch_context(eng):
                handle = eng.compute(cols, starts, ends, gwids)
            self.launched_batches += 1
            self.pending.append((handle, descs, t_sub,
                                 len(self.pending) + 1, nbytes_in))
        self._buffered_since_launch = 0
        self._last_launch_t = _time.perf_counter()

    def _flush_pending(self, emit, drain: bool = False) -> None:
        """Emit completed in-flight batches: the oldest when the
        pipeline is at depth (waitAndFlush), any whose async D2H has
        landed, or all when draining (inline-dispatch mode only)."""
        while self.pending and (drain
                                or len(self.pending) >= self.inflight_depth
                                or self.pending[0][0].ready()):
            self._finish(self.pending.popleft(), emit)

    def _drain_all(self, emit) -> None:
        if self._dispatcher is not None:
            self._dispatcher.drain()
            self._dispatcher = None
        self._flush_pending(emit, drain=True)

    def _plq_renumber(self, d_keys: np.ndarray) -> np.ndarray:
        """Dense per-key output ids for the native PLQ lane: windows of
        a key arrive in firing order, so each gets the key's running
        emit counter (win_seq.hpp:484 with an identity config)."""
        out = np.empty(len(d_keys), np.int64)
        order, keys_s, bounds = _key_groups(d_keys)
        for j in range(len(bounds) - 1):
            lo, hi = int(bounds[j]), int(bounds[j + 1])
            key = int(keys_s[lo])
            start = self._plq_counters.get(key, 0)
            ids = np.arange(start, start + (hi - lo))
            if order is None:
                out[lo:hi] = ids
            else:
                out[order[lo:hi]] = ids
            self._plq_counters[key] = start + (hi - lo)
        return out

    # interned ids live below _INTERN_CEIL, far outside any plausible
    # user key, so a result batch can be tested for them vectorized
    _INTERN_BASE = -(1 << 62)
    _INTERN_CEIL = -(1 << 61)

    def _intern_key(self, key) -> int:
        iid = self._key_intern.get(key)
        if iid is None:
            iid = self._INTERN_BASE + len(self._key_intern)
            self._key_intern[key] = iid
            self._key_extern[iid] = key
        return iid

    def _emit_results(self, results, descs, emit, trace=None) -> None:
        if trace is not None:
            # the captured trace context rides the first emission of
            # this finished batch to the sink (batch lanes attach to
            # the whole result batch, record lanes to the first record)
            def emit(item, _e=emit, _t=trace):
                nonlocal trace
                if trace is not None:
                    trace = None
                    try:
                        item.trace = _t
                    except AttributeError:
                        pass
                _e(item)
        if isinstance(descs, tuple) and descs[0] == "native":
            # native-engine batch: columnar descriptor arrays
            _, d_keys, d_gwids, d_rts = descs
            if self.role == Role.PLQ:
                d_gwids = self._plq_renumber(d_keys)
            has_interned = (bool(self._key_extern) and len(d_keys)
                            and bool((d_keys < self._INTERN_CEIL).any()))
            if self.emit_batches and not has_interned:
                emit(TupleBatch({"key": d_keys, "id": d_gwids,
                                 "ts": d_rts,
                                 "value": np.asarray(results, np.float64)}))
            else:
                # per-record (also when interned keys must be restored:
                # a TupleBatch key column cannot carry them)
                ext = self._key_extern
                for i in range(len(d_keys)):
                    out = self.result_factory()
                    out.value = float(results[i])
                    k = int(d_keys[i])
                    out.set_control_fields(ext.get(k, k), int(d_gwids[i]),
                                           int(d_rts[i]))
                    emit(out)
            return
        if (self.emit_batches and self.role == Role.SEQ
                and (not self._saw_nonint_key    # O(1) common case
                     or all(isinstance(d[0], (int, np.integer))
                            for d in descs))):
            # columnar emission: one result TupleBatch per device batch
            # (any non-integral key in the batch falls through to
            # record emission below -- int and string keys can mix)
            out = TupleBatch({
                "key": np.fromiter((d[0] for d in descs), np.int64,
                                   len(descs)),
                "id": np.fromiter((d[1] for d in descs), np.int64,
                                  len(descs)),
                "ts": np.fromiter((d[4] for d in descs), np.int64,
                                  len(descs)),
                "value": np.asarray(results, np.float64),
            })
            emit(out)
            return
        for (key, gwid, _s, _e, rts, kd_key), val in zip(descs, results):
            out = self.result_factory()
            out.value = float(val)
            out.set_control_fields(key, gwid, rts)
            st = self.keys[kd_key]
            if self.role == Role.MAP:
                out.set_control_fields(key, st.emit_counter, rts)
                st.emit_counter += self.map_indexes[1]
            elif self.role == Role.PLQ:
                new_id = wa.plq_renumbered_id(default_hash(key),
                                              st.emit_counter, self.config)
                out.set_control_fields(key, new_id, rts)
                st.emit_counter += 1
            emit(out)

    # builtin associative kinds whose pane partials the host can
    # pre-reduce before shipping (the Pane_Farm decomposition, applied
    # as a transport optimization: ship partials, not tuples)
    _PANE_KINDS = {"sum": "sum", "count": "sum", "max": "max", "min": "min"}

    def _pane_partials(self, st: _TPUKeyState, base_key: int, n_panes: int,
                       pane: int, kind: str):
        """Per-pane host pre-reduction over one key's retained series."""
        edges = base_key + np.arange(n_panes + 1, dtype=np.int64) * pane
        pos = np.searchsorted(st.sort_keys, edges)
        if kind == "count":
            return np.diff(pos).astype(np.float64)
        from ...runtime.native import pane_reduce
        red = pane_reduce(st.values, pos, kind)  # exact [pos[i], pos[i+1])
        if red is not None:
            return red
        if kind == "sum":
            cs = np.concatenate([[0.0], np.cumsum(st.values)])
            return cs[pos[1:]] - cs[pos[:-1]]
        neutral = -np.inf if kind == "max" else np.inf
        ufunc = np.maximum if kind == "max" else np.minimum
        # reduceat over the non-empty panes' start edges only: empty
        # panes collapse to equal edges so each segment ends exactly at
        # the next non-empty pane's start, and clipping the buffer at
        # pos[-1] keeps retained tuples beyond the batch's last window
        # edge out of the final segment (reduceat runs it to the end)
        vals = st.values[:int(pos[-1])]
        out = np.full(n_panes, neutral)
        nonempty = np.nonzero(np.diff(pos) > 0)[0]
        if len(nonempty):
            out[nonempty] = ufunc.reduceat(vals, pos[nonempty])
        return out

    def _launch(self, emit) -> None:
        if not self.descriptors:
            return
        descs = self.descriptors
        self.descriptors = []
        # group descriptors per key (preserving order)
        keys_involved: List = []
        per_key: Dict = {}
        for i, d in enumerate(descs):
            if d[5] not in per_key:
                per_key[d[5]] = []
                keys_involved.append(d[5])
            per_key[d[5]].append(i)
        pane = int(np.gcd(self.win_len, self.slide_len))
        kind = self.engine.kind
        use_panes = (isinstance(kind, str) and kind in self._PANE_KINDS
                     and pane >= 16)
        if use_panes and self._resident is not None:
            self._launch_resident(descs, per_key, keys_involved, pane,
                                  kind, emit)
            return
        starts = np.empty(len(descs), np.int64)
        ends = np.empty(len(descs), np.int64)
        gwids = np.fromiter((d[1] for d in descs), np.int64, len(descs))
        bufs_v = []
        off = 0
        for k in keys_involved:
            st = self.keys[k]
            self._consolidate(st)
            idxs = per_key[k]
            if use_panes:
                # window extents are pane-aligned (pane = gcd(win, slide)
                # divides both the slide stride and the window length)
                base_key = min(descs[i][2] for i in idxs)
                max_end = max(descs[i][3] for i in idxs)
                n_panes = (max_end - base_key) // pane
                bufs_v.append(self._pane_partials(st, base_key, n_panes,
                                                  pane, kind))
                for i in idxs:
                    starts[i] = off + (descs[i][2] - base_key) // pane
                    ends[i] = off + (descs[i][3] - base_key) // pane
                off += n_panes
            else:
                bufs_v.append(st.values)
                for i in idxs:
                    starts[i] = off + np.searchsorted(st.sort_keys,
                                                      descs[i][2], "left")
                    ends[i] = off + np.searchsorted(st.sort_keys,
                                                    descs[i][3], "left")
                off += len(st.values)
            for i in idxs:  # CB: result ts = last tuple in extent
                if descs[i][4] < 0:
                    hi = int(np.searchsorted(st.sort_keys, descs[i][3],
                                             "left"))
                    lo = int(np.searchsorted(st.sort_keys, descs[i][2],
                                             "left"))
                    d = descs[i]
                    descs[i] = (d[0], d[1], d[2], d[3],
                                int(st.ts[hi - 1]) if hi > lo else 0, d[5])
        flat_vals = (np.concatenate(bufs_v) if bufs_v
                     else np.empty(0, np.float64))
        eng = self.engine
        if use_panes and kind == "count":
            eng = self._count_engine()
        self._submit({"value": flat_vals}, starts, ends, gwids, descs,
                     emit, engine=eng)
        # the staged flat buffer is dispatcher-owned now: evict consumed
        # prefixes
        for k in keys_involved:
            st = self.keys[k]
            self._evict(st, wa.initial_id_of_key(default_hash(k), self.config,
                                                 self.role))

    def _launch_resident(self, descs, per_key, keys_involved, pane,
                         kind, emit) -> None:
        """Resident-lane launch (docs/PLANNER.md "Resident state"):
        ship only NEW/changed pane partials plus window extents and
        answer the batch as pane-range queries against the
        device-resident forest -- one fused scatter+query launch, so
        the window carry never re-ships.  A pane is final once below
        the fired frontier (the acceptance gate drops tuples behind
        it), so ``pane_synced``/``min_new_id`` bound the dirty range to
        O(new data) per launch."""
        carry = self._resident
        spans = {}
        for k in keys_involved:
            idxs = per_key[k]
            initial_id = wa.initial_id_of_key(default_hash(k),
                                              self.config, self.role)
            lo_p = (min(descs[i][2] for i in idxs) - initial_id) // pane
            hi_p = -(-(max(descs[i][3] for i in idxs) - initial_id)
                     // pane)
            spans[k] = (initial_id, lo_p, hi_p)
            carry.row_of(k)
            if carry.needs_grow(hi_p - lo_p):
                # the batch's pane span (or key count) outgrew the
                # forest: swap in a bigger EMPTY one and mark EVERY
                # key dirty -- live partials recompute from the
                # retained host series, which eviction keeps exactly
                # down to the oldest unfired window.  (Never migrate
                # by copying: launches still queued on the dispatcher
                # scatter into the OLD forest tensor.)
                carry.grow(hi_p - lo_p + 64)
                for st2 in self.keys.values():
                    st2.pane_synced = None
        starts = np.empty(len(descs), np.int64)
        ends = np.empty(len(descs), np.int64)
        q_rows = np.empty(len(descs), np.int64)
        gwids = np.fromiter((d[1] for d in descs), np.int64, len(descs))
        run_rows, run_starts, run_lens, bufs = [], [], [], []
        for k in keys_involved:
            st = self.keys[k]
            self._consolidate(st)
            initial_id, lo_p, n_end = spans[k]
            row = carry.rows[k]
            if st.pane_synced is None:
                dirty_lo = lo_p
            else:
                dirty_lo = st.pane_synced
                if st.min_new_id is not None:
                    dirty_lo = min(dirty_lo,
                                   (st.min_new_id - initial_id) // pane)
                # panes below this batch's oldest window start are
                # dead (never read again): skip them even if unsynced
                dirty_lo = max(dirty_lo, lo_p)
            dirty_lo = min(dirty_lo, n_end)
            if n_end > dirty_lo:
                part = self._pane_partials(st, initial_id + dirty_lo
                                           * pane, n_end - dirty_lo,
                                           pane, kind)
                bufs.append(np.asarray(part, np.float32))
                # one CONSECUTIVE run of panes per key: ship a
                # (row, start, len) descriptor, never positions
                run_rows.append(row)
                run_starts.append(dirty_lo)
                run_lens.append(n_end - dirty_lo)
            for i in per_key[k]:
                starts[i] = (descs[i][2] - initial_id) // pane
                ends[i] = -(-(descs[i][3] - initial_id) // pane)
                q_rows[i] = row
                if descs[i][4] < 0:  # CB: result ts = last in extent
                    hi = int(np.searchsorted(st.sort_keys, descs[i][3],
                                             "left"))
                    lo = int(np.searchsorted(st.sort_keys, descs[i][2],
                                             "left"))
                    d = descs[i]
                    descs[i] = (d[0], d[1], d[2], d[3],
                                int(st.ts[hi - 1]) if hi > lo else 0,
                                d[5])
            st.pane_synced = n_end
            st.min_new_id = None
        cols = {
            "value": (np.concatenate(bufs) if bufs
                      else np.empty(0, np.float32)),
            "run_rows": np.asarray(run_rows, np.int32),
            "run_starts": np.asarray(run_starts, np.int64),
            "run_lens": np.asarray(run_lens, np.int32),
            "q_rows": q_rows,
        }
        self._submit(cols, starts, ends, gwids, descs, emit,
                     engine=carry.launch_engine())
        if self.stats is not None:  # single-writer: ingest thread
            self.stats.device_state_bytes = carry.state_bytes
        for k in keys_involved:
            self._evict(self.keys[k], spans[k][0])

    def _count_engine(self):
        # count over panes = sum of per-pane counts
        if not hasattr(self, "_count_eng"):
            self._count_eng = self._make_engine("sum")
        return self._count_eng

    # -- descriptor generation (window assignment) -------------------------
    def _fire_ready(self, key, st: _TPUKeyState, id_: int, hashcode: int,
                    emit) -> None:
        cfg = self.config
        first_gwid = wa.first_gwid_of_key(hashcode, cfg)
        initial_id = wa.initial_id_of_key(hashcode, cfg, self.role)
        slack = self.triggering_delay if self.win_type == WinType.TB else 0
        while True:
            lwid = st.next_fire
            start = initial_id + lwid * self.slide_len
            end = start + self.win_len
            # a window fires once a tuple beyond its extent (+delay) is seen
            if st.max_id < end + slack or lwid > st.opened_max:
                break
            gwid = wa.gwid_of_lwid(first_gwid, lwid, cfg)
            rts = (gwid * self.slide_len + self.win_len - 1
                   if self.win_type == WinType.TB else -1)  # CB: at launch
            self.descriptors.append((key, gwid, start, end, rts, key))
            st.next_fire += 1
            if (len(self.descriptors) >= self.batch_len
                    and not self.chunk_hold):
                self._launch(emit)

    # -- columnar ingest (the zero-copy fast path: a whole TupleBatch is
    # partitioned by key and appended per key vectorized; the analogue of
    # the reference feeding batches straight from pinned staging) --------
    def _native_launch(self, emit, max_windows=None):
        """Stage ready windows from the C++ engine and launch one device
        batch over the pane-partial buffer."""
        out = self._native.flush(max_windows or max(self.batch_len, 4096))
        if out is None:
            return
        vals, starts, ends, d_keys, d_gwids, d_rts = out[:6]
        cols = {"value": vals}
        # count windows sum their per-pane counts; mean windows divide
        # pane-sum totals by pane-count totals (pair program); max/min
        # fold partials through the matching sparse-table engine
        if self.engine.kind == "count":
            eng = self._count_engine()
        elif self.engine.kind == "mean":
            cols["count"] = out[6]
            eng = self._mean_engine()
        else:
            eng = None
        self._submit(cols, starts, ends, d_gwids,
                     ("native", d_keys, d_gwids, d_rts), emit, engine=eng)

    def _mean_engine(self):
        if not hasattr(self, "_mean_eng"):
            self._mean_eng = self._make_engine("mean_panes")
        return self._mean_eng

    def _launch_due(self) -> bool:
        return ((_time.perf_counter() - self._last_launch_t) * 1e3
                >= self.max_batch_delay_ms)

    def _values(self, batch: TupleBatch) -> np.ndarray:
        """The batch's value column, or zeros where the kind reads
        none (a count)."""
        if self._reads_values:
            return batch["value"]
        n = len(batch)
        if len(self._zeros) < n:
            self._zeros = np.zeros(n, np.float32)
        return self._zeros[:n]

    def _svc_batch_native(self, batch: TupleBatch, emit):
        ids = batch.id if self.win_type == WinType.CB else batch.ts
        ready = self._ingest(batch.key, ids, batch.ts, self._values(batch))
        self._buffered_since_launch += len(batch)
        if (ready and not self.chunk_hold
                and (ready >= self.batch_len
                     or self._buffered_since_launch >= self.max_buffer_elems
                     or self._launch_due())):
            self._native_launch(emit)

    def _svc_batch(self, batch: TupleBatch, emit):
        if self._native is not None:
            self._svc_batch_native(batch, emit)
            return
        keys = batch.key
        ids = batch.id if self.win_type == WinType.CB else batch.ts
        vals = self._values(batch)
        tss = batch.ts
        order, keys_s, bounds = _key_groups(keys)
        if order is None:
            ids_s, vals_s, tss_s = ids, vals, tss
        else:
            ids_s, vals_s, tss_s = ids[order], vals[order], tss[order]
        uniq = keys_s[bounds[:-1]]
        cfg = self.config
        for j, key in enumerate(uniq):
            key = key.item()
            lo, hi = bounds[j], bounds[j + 1]
            st = self._key_state(key)
            hashcode = default_hash(key)
            initial_id = wa.initial_id_of_key(hashcode, cfg, self.role)
            k_ids = ids_s[lo:hi]
            if self.renumbering:
                k_ids = np.arange(st.renumber_next,
                                  st.renumber_next + (hi - lo))
                st.renumber_next += hi - lo
            if st.max_id < 0 and len(k_ids):
                # first data: anchor the fire frontier at the first
                # containing window (native-engine parity; an
                # epoch-scale first id must not fire ~id/slide empty
                # windows)
                rel = int(k_ids.min()) - initial_id
                if rel >= self.win_len:
                    st.anchor = (rel - self.win_len) // self.slide_len + 1
                    st.next_fire = st.anchor
            # acceptance: drop tuples behind the already-fired frontier
            min_boundary = (self.win_len + (st.next_fire - 1) * self.slide_len
                            if st.next_fire > st.anchor
                            else st.anchor * self.slide_len)
            keep = k_ids >= initial_id + min_boundary
            if self.win_len < self.slide_len:  # hopping: drop gap tuples
                n = (k_ids - initial_id) // self.slide_len
                off = k_ids - initial_id
                keep &= (off >= n * self.slide_len) & \
                    (off < n * self.slide_len + self.win_len)
            n_drop = int((~keep).sum())
            if n_drop and st.next_fire > st.anchor:
                self.ignored_tuples += n_drop
            k_ids = k_ids[keep]
            if len(k_ids) == 0:
                continue
            if self._resident is not None:
                mn = int(k_ids.min())
                if st.min_new_id is None or mn < st.min_new_id:
                    st.min_new_id = mn
            st.pending_chunks.append(
                (k_ids.astype(np.int64), tss_s[lo:hi][keep],
                 vals_s[lo:hi][keep].astype(np.float64)))
            self._buffered_since_launch += len(k_ids)
            st.max_id = max(st.max_id, int(k_ids.max()))
            last_w = wa.last_window_of(st.max_id, initial_id, self.win_len,
                                       self.slide_len)
            if last_w >= 0:
                st.opened_max = max(st.opened_max, last_w)
            self._fire_ready(key, st, st.max_id, hashcode, emit)
        if (self.descriptors and not self.chunk_hold
                and (self._buffered_since_launch >= self.max_buffer_elems
                     or self._launch_due())):
            self._launch(emit)

    def svc(self, item, channel_id, emit):
        if self.telemetry is not None:
            tr = getattr(item, "trace", None)
            if tr is not None:   # crosses the dispatcher (see _finish)
                self._trace_ctx = tr
        if isinstance(item, TupleBatch):
            self._svc_batch(item, emit)
            return
        if isinstance(item, SynthChunk):
            # declared synthetic stream: the native engine generates and
            # folds the chunk in one pass (no host column materializes)
            if self._native is not None:
                ready = self._synth_ingest(
                    item.start, item.n, item.n_keys, item.vmod,
                    item.vscale, item.voff)
                self._buffered_since_launch += item.n
                if (ready and not self.chunk_hold
                        and (ready >= self.batch_len
                             or self._buffered_since_launch
                             >= self.max_buffer_elems
                             or self._launch_due())):
                    self._native_launch(emit)
            else:
                self._svc_batch(item.materialize(), emit)
            return
        if self._native is not None and not isinstance(item, EOSMarker):
            # route records through the native engine as 1-row columns so
            # mixed record/batch streams share one state store
            key, tid, ts = item.get_control_fields()
            if not isinstance(key, (int, np.integer)):
                key = self._intern_key(key)
            self._svc_batch_native(TupleBatch({
                "key": np.array([key], np.int64),
                "id": np.array([tid], np.int64),
                "ts": np.array([ts], np.int64),
                "value": np.array([self.value_of(item)], np.float64),
            }), emit)
            return
        if self._native is not None:
            return  # EOS markers: the native engine fires on eos_flush
        is_marker = isinstance(item, EOSMarker)
        t = item.record if is_marker else item
        key, tid, ts = t.get_control_fields()
        if not isinstance(key, (int, np.integer)):
            self._saw_nonint_key = True
        hashcode = default_hash(key)
        st = self._key_state(key)
        if self.renumbering and not is_marker:
            tid = st.renumber_next
            st.renumber_next += 1
            t.set_control_fields(key, tid, ts)
        id_ = tid if self.win_type == WinType.CB else ts
        cfg = self.config
        initial_id = wa.initial_id_of_key(hashcode, cfg, self.role)
        if not is_marker:
            if st.max_id < 0:
                rel = id_ - initial_id
                if rel >= self.win_len:
                    st.anchor = (rel - self.win_len) // self.slide_len + 1
                    st.next_fire = st.anchor
            min_boundary = (self.win_len + (st.next_fire - 1) * self.slide_len
                            if st.next_fire > st.anchor
                            else st.anchor * self.slide_len)
            if id_ < initial_id + min_boundary:
                if st.next_fire > st.anchor:
                    self.ignored_tuples += 1
                return
            last_w = wa.last_window_of(id_, initial_id, self.win_len,
                                       self.slide_len)
            if last_w < 0:
                return  # hopping gap
            st.opened_max = max(st.opened_max, last_w)
            if self._resident is not None and (
                    st.min_new_id is None or id_ < st.min_new_id):
                st.min_new_id = id_
            st.pending_sort.append(id_)
            st.pending_ts.append(ts)
            st.pending_val.append(self.value_of(t))
        st.max_id = max(st.max_id, id_)
        self._fire_ready(key, st, id_, hashcode, emit)
        if (self.descriptors and self._launch_due()
                and not self.chunk_hold):
            self._launch(emit)

    def _fire_open(self, emit, until=None) -> None:
        """Python lane: fire every opened window of every key (whose
        end is at or below ``until``, when given), launching full
        batches as they fill and the rest at the end."""
        cfg = self.config
        for key, st in self.keys.items():
            hashcode = default_hash(key)
            first_gwid = wa.first_gwid_of_key(hashcode, cfg)
            initial_id = wa.initial_id_of_key(hashcode, cfg, self.role)
            while st.next_fire <= st.opened_max:
                lwid = st.next_fire
                start = initial_id + lwid * self.slide_len
                end = start + self.win_len
                if until is not None and end > until:
                    break
                gwid = wa.gwid_of_lwid(first_gwid, lwid, cfg)
                # CB: -1 sentinel -> _launch resolves the result ts to
                # the last tuple in the extent (same as the fired path)
                rts = (gwid * self.slide_len + self.win_len - 1
                       if self.win_type == WinType.TB else -1)
                self.descriptors.append((key, gwid, start, end, rts, key))
                st.next_fire += 1
                if len(self.descriptors) >= self.batch_len:
                    self._launch(emit)
        self._launch(emit)

    def eos_flush(self, emit):
        """Fire every opened window, then drain both batches (the
        reference computes leftovers on CPU at EOS,
        win_seq_gpu.hpp:648-710; we just launch a final batch)."""
        if self._native is not None:
            self._native.eos()
            while self._native.ready():
                self._native_launch(emit)
        else:
            self._fire_open(emit)
        self._drain_all(emit)

    def on_watermark(self, wm, emit) -> None:
        """Event-time firing (runtime/queues.Watermark): fire every
        window whose end is at or below the watermark, launch what
        fired, then forward the watermark behind those results.  The
        native engine fires in order of (window, key), fires nothing by
        a key's own tuples from its first watermark on, and frees the
        keys left with no window to fire.  The Python lane fires the
        due windows of every key and frees nothing."""
        with span("windflow/watermark"):
            if self._native is not None:
                ready = self._native.watermark(wm.ts)
                while ready:
                    self._native_launch(emit)
                    ready = self._native.ready()
                st = self.stats
                if st is not None:
                    c = self._native.counters()
                    st.watermarks = c["watermarks"]
                    st.windows_fired_watermark = \
                        c["windows_fired_watermark"]
                    st.keys_evicted = c["keys_evicted"]
                    st.keys_live = c["keys_live"]
            else:
                self._fire_open(emit, until=wm.ts)
        if self._dispatcher is not None:
            self._dispatcher.submit(_Forward(wm, emit))
        else:
            self._flush_pending(emit, drain=True)
            emit(wm)

    def idle_tick(self, emit) -> None:
        """Stalled-stream launch trigger (RtNode timed gets): windows
        that fired but sit staged/ready while no input arrives must
        still launch once the rate-limit allows -- otherwise a paused
        source withholds results until the next batch or EOS."""
        if self.pending:
            # inline-dispatch mode parks computed batches in `pending`
            # until the next launch; a stall must drain the ready ones
            self._flush_pending(emit)
        if not self._launch_due():
            return
        if self._native is not None:
            if self._native.ready():
                self._native_launch(emit)
        elif self.descriptors:
            self._launch(emit)

    def flush_chunk(self, emit) -> int:
        """Chunk-boundary launch for the whole-partition device step
        (graph/device_step.py): everything that fired while
        ``chunk_hold`` suppressed the intra-chunk triggers goes out as
        ONE launch.  Returns the number of launches issued (0 or 1) so
        the step logic can account launches-per-chunk."""
        if self._native is not None:
            ready = self._native.ready()
            if ready:
                self._native_launch(emit, max_windows=ready)
                return 1
            return 0
        if self.descriptors:
            self._launch(emit)
            return 1
        return 0

    def quiesce(self, emit) -> bool:
        """Live-checkpoint barrier hook (pipegraph.quiesce): drain every
        in-flight device batch, emitting its results, so ``state_dict``
        sees no pending work.  Returns True when anything was drained
        (the barrier loops until a drain pass emits nothing).  Called
        only while this node's thread is idle (sources paused, channels
        empty), so touching engine state is safe."""
        had = self._dispatcher is not None or bool(self.pending)
        self._drain_all(emit)
        return had

    # -- audit-plane hooks (audit/; docs/OBSERVABILITY.md): lock-free
    # gauge reads from the auditor thread against the live engine -----
    def audit_in_flight(self) -> dict:
        """Windows absorbed but not yet emitted: submitted device
        batches plus the batch under assembly -- the ``in_flight``
        term of the conservation ledger's device leg."""
        disp = self._dispatcher
        pend = len(self.pending) + (disp.depth() if disp is not None
                                    and hasattr(disp, "depth") else 0)
        return {"device_batches": pend,
                "staging": len(self.descriptors)}

    def keyed_state_census(self):
        """(key count, byte estimate) of the per-key window state.
        Python path: sampled _TPUKeyState arrays; native path: key
        count only (the engine owns the buffers)."""
        if self._native is not None:
            n = len(self._plq_counters) or len(self._key_intern)
            return (n, 0) if n else None
        keys = self.keys
        n = len(keys)
        if n == 0:
            return (0, 0)
        try:
            st = next(iter(keys.values()))
            per = (st.sort_keys.nbytes + st.ts.nbytes
                   + st.values.nbytes + 96)
        except (RuntimeError, StopIteration, AttributeError):
            per = 96  # resized under us: count-only estimate
        res = self.device_resident_bytes()
        if res:
            # resident-forest bytes surface as the census "device" tier
            # (metrics render them under
            # windflow_keyed_state_bytes{tier="device"})
            return (n, n * per, {"tiers": {"device": [n, int(res)]}})
        return (n, n * per)

    # -- checkpoint / resume (utils/checkpoint.py policy layer) --------
    def state_dict(self):
        """Pickle-friendly snapshot (quiescent contract: no device
        batches in flight).  Native-path state is the engine's versioned
        binary blob; Python-path state is the per-key store."""
        import copy
        st = {
            "descriptors": list(self.descriptors),
            "ignored_tuples": self.ignored_tuples,
            "launched_batches": self.launched_batches,
            "buffered": self._buffered_since_launch,
        }
        if self._native is not None:
            st["native"] = self._native.serialize()
            st["plq_counters"] = dict(self._plq_counters)
            if self._key_intern:
                st["key_intern"] = dict(self._key_intern)
        else:
            # deep copy: a live checkpoint resumes the stream after the
            # snapshot, and an aliased store would keep advancing
            st["keys"] = copy.deepcopy(self.keys)
        return st

    def load_state(self, state):
        self.descriptors = list(state.get("descriptors", []))
        self.ignored_tuples = state.get("ignored_tuples", 0)
        self.launched_batches = state.get("launched_batches", 0)
        self._buffered_since_launch = state.get("buffered", 0)
        if "native" in state:
            if self._native is None:
                raise RuntimeError(
                    "snapshot came from the native engine but this "
                    "replica runs the Python path")
            self._native.deserialize(state["native"])
            self._plq_counters = dict(state.get("plq_counters", {}))
            self._key_intern = dict(state.get("key_intern", {}))
            self._key_extern = {v: k for k, v in self._key_intern.items()}
        else:
            if self._native is not None:
                raise RuntimeError(
                    "snapshot came from the Python path but this "
                    "replica runs the native engine")
            import copy
            self.keys = copy.deepcopy(state["keys"])
            # re-derive the non-integral-key flag from the restored
            # store (every descriptor's key is in it): the columnar
            # emit shortcut keys off the flag, and a fresh replica
            # restoring string-keyed state would otherwise crash in
            # np.fromiter on the first launch
            self._saw_nonint_key = any(
                not isinstance(k, (int, np.integer)) for k in self.keys)
        # resident carry is NOT part of the snapshot (it is derivable
        # from the retained host series): drop it so the next launch
        # re-ships live partials -- restores stay lane-portable
        self._reset_resident()

    def svc_end(self):
        # error-path teardown: eos_flush already drained (and cleared)
        # the dispatcher on the normal path, so one still present here
        # means the node thread aborted -- stop launching its backlog
        if self._dispatcher is not None:
            self._dispatcher.abort()
            self._dispatcher = None
        if self.closing_func is not None:
            from ...core.context import RuntimeContext
            self.closing_func(RuntimeContext())


class WinSeqTPU(Operator):
    """Standalone device-batched window operator (builders_gpu.hpp:50
    analogue)."""

    def __init__(self, win_kind, win_len, slide_len, win_type,
                 batch_len=DEFAULT_BATCH_LEN, triggering_delay=0,
                 name="win_seq_tpu", result_factory=BasicRecord,
                 value_of=None, closing_func=None, emit_batches=False,
                 max_buffer_elems=DEFAULT_MAX_BUFFER_ELEMS,
                 inflight_depth=DEFAULT_INFLIGHT_DEPTH,
                 async_dispatch=True,
                 max_batch_delay_ms=DEFAULT_MAX_BATCH_DELAY_MS,
                 placement="device", adaptive_batch=False,
                 rtt_floor_ms=None, resident=None, device=None):
        super().__init__(name, 1, RoutingMode.FORWARD, Pattern.WIN_SEQ_TPU)
        self.win_type = win_type
        self.kwargs = dict(
            win_kind=win_kind, win_len=win_len, slide_len=slide_len,
            win_type=win_type, batch_len=batch_len,
            triggering_delay=triggering_delay, result_factory=result_factory,
            value_of=value_of, closing_func=closing_func,
            emit_batches=emit_batches, max_buffer_elems=max_buffer_elems,
            inflight_depth=inflight_depth, async_dispatch=async_dispatch,
            max_batch_delay_ms=max_batch_delay_ms, placement=placement,
            adaptive_batch=adaptive_batch, rtt_floor_ms=rtt_floor_ms,
            resident=resident, device=device)
        self._renumbering = False

    def enable_renumbering(self):
        self._renumbering = True

    def stages(self):
        logic = WinSeqTPULogic(renumbering=self._renumbering, **self.kwargs)
        return [StageSpec(
            self.name, [logic], StandardEmitter(), self.routing,
            ordering_mode=(OrderingMode.ID if self.win_type == WinType.CB
                           else OrderingMode.TS))]
