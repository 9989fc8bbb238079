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
from .cuda.window_sum import next_pow2, window_sums

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


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The torch device a window engine runs on.  A CUDA device must
    exist: the port never quietly runs on the CPU unless asked to."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is "
                f"available (pass device='cpu' to run the plain versions "
                f"on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: "
                         f"'cuda' or 'cpu'")
    return dev


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

    def block(self) -> np.ndarray:
        with _transfer_guard():
            if self._event is not None:
                self._event.synchronize()
                self._dev = None
            return self._host.numpy()[: self._n]


class ResidentPaneCarry:
    """Device-resident pane-partial state of the resident lane: not
    ported yet."""

    def __init__(self, *args, **kwargs):
        raise unported("ResidentPaneCarry (the resident lane)", "resident")


class WindowComputeEngine:
    """Executes batches of window extents against a flat value buffer.

    ``kind`` is a builtin combine name (:data:`BUILTIN_KINDS`) or a
    pane-pair kind (:data:`PAIR_KINDS`).  ``device`` is the torch device
    the engine launches on; ``None`` leaves the engine unbound until
    :meth:`bind` (the planner binds it to ``RuntimeConfig.device`` at
    graph start) and binds it to the CUDA device on first use
    otherwise."""

    def __init__(self, kind: Any = "sum", value_col: str = "value",
                 device: Optional[Union[str, torch.device]] = None):
        if isinstance(kind, tuple) and len(kind) == 3 and kind[0] == "ffat":
            raise unported("the 'ffat' window kind", "ffat")
        if callable(kind):
            raise unported("custom window functions", "ffat")
        if kind not in BUILTIN_KINDS and kind not in PAIR_KINDS:
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
        absent)."""
        self.device = resolve_device(device)
        self._stream = None
        return self.device

    def launch_context(self):
        """Device + stream context a launch runs under: the engine's own
        CUDA stream, created on first use."""
        dev = self.device if self.device is not None else self.bind("cuda")
        if dev.type != "cuda":
            return contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=dev)
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(dev))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

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
        if kind == "sum":
            out = window_sums(put(cols[self.value_col]), se_dev)
        elif kind == "count":
            out = (se_dev[1] - se_dev[0]).to(torch.float32)
        elif kind == "mean":
            n = (se_dev[1] - se_dev[0]).to(torch.float32)
            out = window_sums(put(cols[self.value_col]), se_dev) \
                / torch.clamp(n, min=1.0)
        elif kind == "mean_panes":
            # a windowed mean is the sum of pane sums over the sum of
            # pane counts, NOT the mean of pane means
            s = window_sums(put(cols[self.value_col]), se_dev)
            n = window_sums(put(cols["count"]), se_dev)
            out = s / torch.clamp(n, min=1.0)
        else:  # max / min
            fill = float("-inf") if kind == "max" else float("inf")
            n_levels = max(1, int(np.log2(T_pad)) + 1)
            out = _sparse_table(put(cols[self.value_col], fill), se_dev,
                                kind, n_levels)
        return DeviceBatchHandle(out, B)
