"""Peaks of one NVIDIA H100 SXM and the arithmetic the readers share.

The peaks are NVIDIA's data sheet figures at the card's full 700 W
(dense, no sparsity).  A card set below that limit runs slower: the
harness reports the limit beside every run.

The bound of a kernel is the least time the card could take for the
work the benchmark itself counts: every byte read once and written once
over the HBM rate, or every operation over the f32 rate, whichever is
larger.  Device busy time is the union of the device intervals (kernels
and copies) inside a window, so copies that overlap kernels count once.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_s(nbytes: float, ops: float = 0.0) -> float:
    """Least seconds for ``nbytes`` moved once and ``ops`` f32 ops."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def window_sum_bytes(n_windows: int, panes_per_window: int) -> int:
    """Bytes one window-sum launch needs for ``n_windows`` results: each
    window's pane partials read once (f32), its result written once
    (f32), and its [start, end) extent read once (two int32)."""
    return n_windows * ((panes_per_window + 1) * 4 + 8)


def merge(intervals: Iterable[Tuple[float, float]], lo: float,
          hi: float) -> List[Tuple[float, float]]:
    """The union of ``intervals`` clipped to [lo, hi], sorted."""
    clipped = sorted((max(a, lo), min(b, hi)) for a, b in intervals
                     if b > lo and a < hi)
    out: List[Tuple[float, float]] = []
    for a, b in clipped:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def busy_s(intervals: Sequence[Tuple[float, float]], lo: float,
           hi: float) -> float:
    """Seconds of [lo, hi] covered by at least one interval."""
    return sum(b - a for a, b in merge(intervals, lo, hi))


def gaps(intervals: Sequence[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The idle stretches of [lo, hi]: where no interval runs."""
    out, t = [], lo
    for a, b in merge(intervals, lo, hi):
        if a > t:
            out.append((t, a))
        t = b
    if hi > t:
        out.append((t, hi))
    return out
