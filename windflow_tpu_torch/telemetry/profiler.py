"""torch.profiler capture hook around device launches
(docs/OBSERVABILITY.md).

``launch_span(label)`` wraps every window-engine launch (the
dispatcher thread's ``engine.compute`` call).  By default it is a
no-op null context; setting ``WINDFLOW_TORCH_PROFILE=1`` turns it into
a ``torch.profiler.record_function`` range, so a capture taken with
``torch.profiler.profile(activities=[CPU, CUDA])`` shows each launch
as a named span that lines up with the per-launch ``Device_time_ms``
wall numbers in the stats JSON.

Resolution happens once per process, on first use, never at import.
"""
from __future__ import annotations

import os
from contextlib import nullcontext

_impl = None  # resolved on first launch_span call


def _resolve():
    if os.environ.get("WINDFLOW_TORCH_PROFILE", "0") == "0":
        return lambda label: nullcontext()
    from torch.profiler import record_function
    return record_function


def launch_span(label: str):
    """Context manager spanning one device launch."""
    global _impl
    if _impl is None:
        _impl = _resolve()
    return _impl(label)


def reset() -> None:
    """Re-read WINDFLOW_TORCH_PROFILE (tests)."""
    global _impl
    _impl = None
