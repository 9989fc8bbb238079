"""Batched window sum: the hand-written Hopper kernel and its plain twin.

``window_sums(values, se)`` computes ``out[b] = sum(values[se[0, b]:
se[1, b]])`` (empty extent -> 0) for a flat f32 buffer ``values [T]``
and the engine's packed int32 extents ``se [2, B]``.

* On a CUDA tensor it launches ``window_sum.cu`` (one warp per window;
  built with nvcc for ``sm_90a`` into ``windflow_tpu_torch/_build/`` on
  first use and bound through ctypes) on the current stream.  A build
  or launch failure raises: there is no fallback.
* On a CPU tensor it runs :func:`window_sums_plain`, the torch form of
  the reference engine's XLA pair ``_tile_sum_program`` /
  ``_scan_program`` (windflow_tpu/ops/window_compute.py:80,105).

The kernel replaces the Pallas TPU kernel
``windflow_tpu/ops/pallas/window_sum.py`` (``_build``'s kernel, entry
``window_sums_device``).  ``launch_count()`` counts kernel launches so a
run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import torch

from ...runtime.build import build_shared, nvcc_command

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "window_sum.cu")
_LIB_NAME = "libwf_window_sum.so"

# max window extent (already padded to a power of two) served by the
# gather-tile form; wider windows take the prefix scan
_TILE_MAX_W = 32

_lib = None
_lib_lock = threading.Lock()
_launches = 0
_count_lock = threading.Lock()


def next_pow2(n: int) -> int:
    p = 1
    while p < max(1, n):
        p <<= 1
    return p


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def tile_sum(values: torch.Tensor, se: torch.Tensor,
             w_pad: int) -> torch.Tensor:
    """Window sums via a masked [B, w_pad] gather-tile reduction.  Used
    instead of the prefix scan when every window spans few elements:
    the scan's c[end]-c[start] differencing carries the f32 rounding of
    the WHOLE buffer's magnitude into each window (catastrophic for
    small windows late in the buffer), while the tile sums only the
    window's own elements."""
    starts, ends = se[0].long(), se[1].long()
    idx = starts[:, None] + torch.arange(w_pad, device=values.device)
    mask = idx < ends[:, None]
    idx = idx.clamp(0, max(0, values.shape[0] - 1))
    return torch.where(mask, values[idx], 0.0).sum(dim=1)


def scan_sum(values: torch.Tensor, se: torch.Tensor) -> torch.Tensor:
    """Window sums by prefix-sum differencing: O(T + B) work."""
    c = torch.cat([values.new_zeros(1), torch.cumsum(values, 0)])
    return c[se[1].long()] - c[se[0].long()]


def max_extent(se: torch.Tensor) -> int:
    return int((se[1] - se[0]).max()) if se.shape[1] else 1


def window_sums_plain(values: torch.Tensor, se: torch.Tensor) -> torch.Tensor:
    """The tile/scan pair of the reference engine, switched at
    ``_TILE_MAX_W`` on the batch's widest extent."""
    w_pad = next_pow2(max(max_extent(se), 2))
    if w_pad <= _TILE_MAX_W:
        return tile_sum(values, se, w_pad)
    return scan_sum(values, se)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

def load_kernel() -> ctypes.CDLL:
    """Build (once per source change) and bind the CUDA kernel."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            path = build_shared(_LIB_NAME, nvcc_command(_SRC), [_SRC])
        except subprocess.CalledProcessError as e:
            raise RuntimeError(
                f"window_sum kernel build failed:\n{e.stderr}") from e
        lib = ctypes.CDLL(path)
        lib.wf_window_sum.restype = ctypes.c_int
        lib.wf_window_sum.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        _lib = lib
        return lib


def launch_count() -> int:
    return _launches


def reset_launch_count() -> None:
    global _launches
    with _count_lock:
        _launches = 0


def _check(values: torch.Tensor, se: torch.Tensor) -> None:
    if values.dtype != torch.float32 or values.dim() != 1:
        raise ValueError("values must be a 1-D float32 tensor")
    if se.dtype != torch.int32 or se.dim() != 2 or se.shape[0] != 2:
        raise ValueError("se must be an int32 [2, B] tensor")
    if values.device != se.device:
        raise ValueError("values and se must be on the same device")
    if not (values.is_contiguous() and se.is_contiguous()):
        raise ValueError("values and se must be contiguous")


def window_sums(values: torch.Tensor, se: torch.Tensor) -> torch.Tensor:
    """``out[b] = sum(values[se[0, b]:se[1, b]])`` as f32 [B]: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    global _launches
    _check(values, se)
    if values.device.type == "cpu":
        return window_sums_plain(values, se)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    lib = load_kernel()
    n_windows = se.shape[1]
    out = torch.empty(n_windows, dtype=torch.float32, device=values.device)
    if n_windows == 0:
        return out
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = lib.wf_window_sum(values.data_ptr(), values.shape[0],
                               se.data_ptr(), out.data_ptr(), n_windows,
                               stream)
    if rc != 0:
        raise RuntimeError(f"window_sum kernel launch failed: "
                           f"cudaError {rc}")
    with _count_lock:
        _launches += 1
    return out
