"""Batched window computation on the device: the torch/CUDA port of the
reference engine's jitted XLA programs.

* windows over each key live in one contiguous **flat buffer** (ragged
  concatenation of per-key series); window extents are [start, end)
  index pairs into it, packed as one int32 ``[2, B]`` array.
* **sums** (``sum``, and ``count``/``mean`` over pane partials through
  the sum engine) run the hand-written Hopper kernel
  ``ops/cuda/window_sum.cu`` on a CUDA device -- always, with no
  fallback -- and its plain version (the tile/scan pair) on the CPU.
* **max/min** use a sparse table (log-sweep of strided combines) + two
  gathers per window, in plain torch.
* **ffat** kinds ``("ffat", combine, neutral)`` build a FlatFAT tree
  over the flat buffer and answer every window in one launch of the
  hand-written fused build+query kernel (``flatfat_build_query``,
  ``ops/cuda/flatfat_query.cu``) on a CUDA device.
* the **resident lane** (:class:`ResidentPaneCarry`) keeps per-key pane
  partials in a device forest across launches; each launch writes the
  new partials, recomputes their root paths and answers the due windows
  in one launch of the fused FlatFAT kernel (``flatfat_update_query``).

All shapes are bucketed to powers of two with a 2048 floor, so the
buffers the caching allocators hand out come from a handful of sizes.
Dispatch is asynchronous: a launch runs on the caller's current CUDA
stream (the dispatcher thread sets the engine's own stream), copies its
result into a pinned host buffer without blocking and records an event;
``DeviceBatchHandle.block()`` waits on that event.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from .._unported import unported
from .cuda.flatfat_query import flatfat_build_query, require_kernel_op
from .cuda.window_sum import next_pow2, window_sums
from .device import resolve_device, stream_context
from .flatfat_torch import BatchedFlatFAT

BUILTIN_KINDS = ("sum", "count", "mean", "max", "min")

# pane-partial pair kinds: cols carry a second buffer alongside "value"
# (the native engine's MEAN staging ships per-pane sums + counts)
PAIR_KINDS = ("mean_panes",)

# opt-in escape hatch for transports that cannot take concurrent
# transfers (WINDFLOW_GLOBAL_DISPATCH_LOCK=1)
_GLOBAL_DISPATCH_LOCK = threading.Lock()


def _transfer_guard():
    """Serialization context for device transfers: the global lock when
    the escape hatch is on (D2H in block() must serialize against every
    engine's H2D, not just its own), else a no-op."""
    if os.environ.get("WINDFLOW_GLOBAL_DISPATCH_LOCK") == "1":
        return _GLOBAL_DISPATCH_LOCK
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# plain programs (the reference's XLA programs, in torch)
# ---------------------------------------------------------------------------

def _sparse_table(values: torch.Tensor, se: torch.Tensor, kind: str,
                  n_levels: int) -> torch.Tensor:
    """Range-min/max via log-sweep sparse table: level j holds the
    combine over [i, i + 2^j).  Result = combine(table[j][start],
    table[j][end - 2^j]) with j = floor(log2(len)) per window."""
    neutral = float("-inf") if kind == "max" else float("inf")
    comb = torch.maximum if kind == "max" else torch.minimum
    starts, ends = se[0].long(), se[1].long()
    T = values.shape[0]
    levels = [values]
    v = values
    for j in range(1, n_levels):
        shift = 1 << (j - 1)
        shifted = torch.cat([v[shift:], v.new_full((shift,), neutral)])
        v = comb(v, shifted)
        levels.append(v)
    table = torch.stack(levels)  # [L, T]
    length = torch.clamp(ends - starts, min=1)
    j = torch.floor(torch.log2(length.float())).long().clamp(0, n_levels - 1)
    hi = (ends - (1 << j)).clamp(0, T - 1)
    lo = starts.clamp(0, T - 1)
    out = comb(table[j, lo], table[j, hi])
    # padding rows ((0,0) extents) may hold +-inf; zero them so the
    # host-side result buffer stays finite
    return torch.where(ends > starts, out, torch.zeros_like(out))


class DeviceBatchHandle:
    """Async result of one batched window computation.

    On a CUDA device the result is copied into a pinned host buffer on
    the launching stream without blocking, and an event is recorded
    behind the copy: ``ready()`` queries the event, ``block()`` waits on
    it -- the cudaMemcpyAsync-D2H + waitAndFlush protocol of the
    reference (win_seq_gpu.hpp:267-297, :610).  On the CPU the result
    is already there."""

    __slots__ = ("_dev", "_host", "_event", "_n")

    def __init__(self, dev_out: torch.Tensor, n_valid: int):
        self._n = n_valid
        if dev_out.device.type == "cuda":
            # keep the device tensor referenced until the copy is known
            # to have landed (block), independent of allocator reuse
            self._dev = dev_out
            self._host = torch.empty(dev_out.shape, dtype=dev_out.dtype,
                                     pin_memory=True)
            self._host.copy_(dev_out, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev_out.device))
        else:
            self._dev = None
            self._host = dev_out
            self._event = None

    def ready(self) -> bool:
        """True when the result has landed on the host (block() will not
        stall)."""
        return self._event is None or self._event.query()

    def _landed(self) -> np.ndarray:
        """The whole host buffer, after the copy has landed."""
        with _transfer_guard():
            if self._event is not None:
                self._event.synchronize()
                self._dev = None
            return self._host.numpy()

    def block(self) -> np.ndarray:
        return self._landed()[: self._n]


class _ResidentPaneHandle(DeviceBatchHandle):
    """Async result of one fused resident-pane launch, as
    :class:`DeviceBatchHandle` (one result per window, nothing left to
    combine on the host).  The handle keeps the forest it launched
    against referenced, so a grow that swaps the forest out cannot free
    it under a queued update."""

    __slots__ = ("_forest",)

    def __init__(self, dev_out: torch.Tensor, forest: BatchedFlatFAT):
        super().__init__(dev_out, dev_out.shape[0])
        self._forest = forest


class _ResidentPaneLaunch:
    """One launch's engine view: pins the forest the staging was
    computed against, so a concurrent capacity grow (which swaps the
    carry's forest and re-ships everything dirty) can never retarget
    an already-staged launch."""

    __slots__ = ("carry", "forest")

    def __init__(self, carry: "ResidentPaneCarry", forest):
        self.carry = carry
        self.forest = forest

    def launch_context(self):
        return self.carry.launch_context()

    def compute(self, cols, starts, ends, gwids) -> _ResidentPaneHandle:
        with self.carry._lock:
            dev = self.forest.update_runs_query_launch(
                cols["run_rows"], cols["run_starts"], cols["run_lens"],
                np.asarray(cols["value"], np.float32),
                cols["q_rows"], starts, ends)
            return _ResidentPaneHandle(dev, self.forest)


class ResidentPaneCarry:
    """Device-resident pane-partial state for the WinSeqTPULogic
    resident lane (docs/PLANNER.md "Resident state").

    Where the rebuild lane re-ships the whole staged pane buffer
    (window carry included) on every launch, this keeps one per-key
    ring of pane partials resident in device memory as a
    :class:`~windflow_tpu_torch.ops.flatfat_torch.BatchedFlatFAT` forest
    (one tensor, updated in place on the carry's CUDA stream) and ships
    only NEW/changed partials per launch; windows are answered as
    pane-range queries in the same launch of the fused FlatFAT
    update+query kernel.  Keyed by pane index: ring position = absolute
    pane id mod capacity, alias-safe because the engine's fired frontier
    proves
    panes below the oldest unfired window dead before their slots are
    reused.

    ``device`` binds the carry as the window engine binds (None: bound
    by the owner, else the card on first use); the forest lives on the
    carry's own CUDA stream, on which every launch runs."""

    KINDS = ("sum", "count", "max", "min")

    def __init__(self, kind: str, panes_per_window: int,
                 initial_keys: int = 16, headroom: int = 1024,
                 device: Optional[Union[str, torch.device]] = None):
        if kind not in self.KINDS:
            raise ValueError(f"resident pane carry needs a builtin "
                             f"monoid kind, not {kind!r}")
        self.kind = kind
        self.combine = {"sum": torch.add, "count": torch.add,
                        "max": torch.maximum, "min": torch.minimum}[kind]
        self.neutral = (0.0 if kind in ("sum", "count")
                        else (-np.inf if kind == "max" else np.inf))
        self.panes_per_window = panes_per_window
        self.capacity = next_pow2(panes_per_window + headroom)
        self._initial_keys = max(2, initial_keys)
        self.rows: Dict[Any, int] = {}
        # serializes forest launches against forest swaps
        self._lock = threading.Lock()
        self.device: Optional[torch.device] = None
        self._stream = None
        self._forest: Optional[BatchedFlatFAT] = None
        if device is not None:
            self.bind(device)

    def bind(self, device: Union[str, torch.device]) -> torch.device:
        """Fix the carry's device and start an empty forest there."""
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        with self._lock:
            self._forest = self._new_forest(self._initial_keys)
        return self.device

    def _new_forest(self, n_keys: int) -> BatchedFlatFAT:
        return BatchedFlatFAT(self.combine, self.neutral, n_keys,
                              self.capacity, device=self.device,
                              stream=self._stream)

    @property
    def forest(self) -> BatchedFlatFAT:
        if self._forest is None:
            self.bind("cuda")
        return self._forest

    def launch_context(self):
        if self._forest is None:
            self.bind("cuda")
        return stream_context(self.device, self._stream)

    @property
    def state_bytes(self) -> int:
        return self._forest.state_bytes if self._forest is not None else 0

    def row_of(self, key) -> int:
        """Assign/look up the key's forest row.  Returns the row; when
        it does not fit the current forest the caller must call
        :meth:`grow` (which swaps in a bigger EMPTY forest) and mark
        every key dirty -- the forest is never migrated by copying,
        because launches already queued on the dispatcher still
        scatter into the OLD forest tensor and a snapshot copy would
        silently lose them."""
        row = self.rows.get(key)
        if row is None:
            row = self.rows[key] = len(self.rows)
        return row

    def needs_grow(self, span: int) -> bool:
        return span > self.capacity or len(self.rows) > self.forest.n_keys

    def grow(self, min_capacity: int) -> None:
        """Key-count or pane-span overflow: swap in a bigger EMPTY
        forest -- the caller must mark every key fully dirty so the
        next launch re-ships live partials (they are recomputable
        from the host retained series, which the engine's eviction
        keeps exactly down to the oldest unfired window).  Launches
        already in flight keep their pinned (old, complete) forest,
        so their queries stay correct."""
        if self._forest is None:
            self.bind("cuda")
        n = self.capacity
        while n < min_capacity:
            n <<= 1
        k = self._initial_keys
        while k < max(1, len(self.rows)):
            k <<= 1
        with self._lock:
            self.capacity = n
            self._forest = self._new_forest(k)

    def reset(self) -> None:
        """Drop all resident state (lane flip / state restore): the
        next launch recomputes live partials from the host store."""
        self.rows.clear()
        if self._forest is not None:
            with self._lock:
                self._forest = self._new_forest(self._initial_keys)

    def launch_engine(self) -> _ResidentPaneLaunch:
        return _ResidentPaneLaunch(self, self.forest)


class WindowComputeEngine:
    """Executes batches of window extents against a flat value buffer.

    ``kind`` is a builtin combine name (:data:`BUILTIN_KINDS`), a
    pane-pair kind (:data:`PAIR_KINDS`), or ``("ffat", combine,
    neutral)``: a FlatFAT tree over the flat buffer answers every window
    (the Win_SeqFFAT_GPU pipeline), with ``combine`` a binary torch
    function forming a monoid with ``neutral``; on the card it must be
    one the FlatFAT query kernel compiles (``torch.add``,
    ``torch.maximum``, ``torch.minimum``).  ``device`` is the torch
    device the engine launches on; ``None`` leaves the engine unbound
    until :meth:`bind` (the planner binds it to
    ``RuntimeConfig.device`` at graph start) and binds it to the CUDA
    device on first use otherwise."""

    def __init__(self, kind: Any = "sum", value_col: str = "value",
                 device: Optional[Union[str, torch.device]] = None):
        self.is_ffat = (isinstance(kind, tuple) and len(kind) == 3
                        and kind[0] == "ffat")
        if self.is_ffat:
            if not callable(kind[1]):
                raise ValueError(f"ffat combine must be a binary torch "
                                 f"function, not {kind[1]!r}")
            kind = ("ffat", kind[1], float(kind[2]))
        elif callable(kind):
            raise unported("custom window functions", "custom")
        elif kind not in BUILTIN_KINDS and kind not in PAIR_KINDS:
            raise ValueError(f"unknown window combine kind: {kind!r}")
        self.kind = kind
        self.value_col = value_col
        self.device: Optional[torch.device] = None
        self._stream = None
        if device is not None:
            self.bind(device)
        # one in-flight dispatch per ENGINE (farm replicas overlap
        # launches); the env var restores process-global serialization
        if os.environ.get("WINDFLOW_GLOBAL_DISPATCH_LOCK") == "1":
            self._lock = _GLOBAL_DISPATCH_LOCK
        else:
            self._lock = threading.Lock()

    def bind(self, device: Union[str, torch.device]) -> torch.device:
        """Fix the engine's device (raises when CUDA is asked for and
        absent, and for an ffat combine the card has no kernel for)."""
        dev = resolve_device(device)
        if self.is_ffat and dev.type == "cuda":
            require_kernel_op(self.kind[1])
        self.device = dev
        self._stream = None
        return self.device

    def launch_context(self):
        """Device + stream context a launch runs under: the engine's own
        CUDA stream, created on first use."""
        dev = self.device if self.device is not None else self.bind("cuda")
        if dev.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(device=dev)
        return stream_context(dev, self._stream)

    def compute(self, cols: Dict[str, np.ndarray], starts: np.ndarray,
                ends: np.ndarray, gwids: np.ndarray) -> DeviceBatchHandle:
        """Launch one batch on the current stream; returns an async
        handle."""
        with self._lock:
            return self._compute(cols, starts, ends, gwids)

    def _compute(self, cols: Dict[str, np.ndarray], starts: np.ndarray,
                 ends: np.ndarray, gwids: np.ndarray) -> DeviceBatchHandle:
        dev = self.device if self.device is not None else self.bind("cuda")
        B = len(starts)
        T = len(next(iter(cols.values())))
        # floor the shape buckets: padding a small launch to 2048 costs
        # ~16-32 KB of transfer and keeps the buffer sizes few
        T_pad = next_pow2(max(T, 2048))
        B_pad = next_pow2(max(B, 2048))
        # starts/ends ride in ONE packed int32 array: two buffers (values
        # + extents) per launch; padding rows are (0, 0) -> 0
        se = np.zeros((2, B_pad), dtype=np.int32)
        se[0, :B] = starts
        se[1, :B] = ends
        # the widest extent picks the window-sum kernel's form
        max_extent = int(np.max(se[1] - se[0], initial=0))

        pinned = dev.type == "cuda"

        def put(v, fill=0.0):
            # staged in pinned memory so the H2D copy is truly async: a
            # copy from pageable memory first waits for the stream, which
            # would serialize the launches kept in flight
            buf = torch.empty(T_pad, dtype=torch.float32,
                              pin_memory=pinned)
            host = buf.numpy()
            host[:T] = v
            host[T:] = fill
            return buf.to(dev, non_blocking=True)

        se_host = torch.from_numpy(se)
        se_dev = (se_host.pin_memory() if pinned else se_host).to(
            dev, non_blocking=True)
        kind = self.kind
        if self.is_ffat:
            # the twin of the reference's _ffat_program: the tree over the
            # flat buffer (padded with the neutral) and every window, in
            # one launch of the fused build+query kernel
            _, comb, neutral = kind
            out = flatfat_build_query(put(cols[self.value_col], neutral),
                                      se_dev, comb, neutral)
        elif kind == "sum":
            out = window_sums(put(cols[self.value_col]), se_dev, max_extent)
        elif kind == "count":
            out = (se_dev[1] - se_dev[0]).to(torch.float32)
        elif kind == "mean":
            n = (se_dev[1] - se_dev[0]).to(torch.float32)
            out = window_sums(put(cols[self.value_col]), se_dev,
                              max_extent) / torch.clamp(n, min=1.0)
        elif kind == "mean_panes":
            # a windowed mean is the sum of pane sums over the sum of
            # pane counts, NOT the mean of pane means
            s = window_sums(put(cols[self.value_col]), se_dev, max_extent)
            n = window_sums(put(cols["count"]), se_dev, max_extent)
            out = s / torch.clamp(n, min=1.0)
        else:  # max / min
            fill = float("-inf") if kind == "max" else float("inf")
            n_levels = max(1, int(np.log2(T_pad)) + 1)
            out = _sparse_table(put(cols[self.value_col], fill), se_dev,
                                kind, n_levels)
        return DeviceBatchHandle(out, B)
