"""torch.profiler spans inside the port (docs/TORCH_PROFILER.md).

One switch, ``WINDFLOW_TORCH_PROFILE=1``, turns every span into a
``torch.profiler.record_function`` range, so a capture taken with
``torch.profiler.profile(activities=[CPU, CUDA])`` shows the host work
on the same timeline as the card's kernels and copies.  The names say
what ran and on which thread:

* ``windflow/op/<operator>``: one operator's ``svc`` call on the
  thread that feeds it (a source's generation step, a fused segment, a
  chained operator, an unfused node).  Operators run inline downstream
  lie inside it, so its self time is its duration less its nested
  spans.
* ``windflow/emit/<operator>``: the same, for an operator fed from a
  window engine's dispatcher thread (downstream of an engine that
  emits asynchronously).
* ``windflow/fold``: the native engine's ingest of one chunk (the
  pane fold, ctypes marshalling included).
* ``windflow/window_launch``: one device launch on the dispatcher
  thread.
* ``windflow/watermark``: one watermark taken by a window engine: its
  firing by event time, the keys it frees and the launch of what
  fired.

Off (the default), no span is built: the fused chain's closures and
the per-chunk sites hold the plain calls, so the hot path makes no
extra call.  The switch is read once per process, on first use, never
at import; ``reset()`` reads it again (tests).
"""
from __future__ import annotations

import os
from contextlib import nullcontext

_on = None  # resolved on first use


def enabled() -> bool:
    """True when WINDFLOW_TORCH_PROFILE asks for spans."""
    global _on
    if _on is None:
        _on = os.environ.get("WINDFLOW_TORCH_PROFILE", "0") != "0"
    return _on


def span(label: str):
    """Context manager: a ``record_function`` range named ``label``
    when the switch is on, else a null context."""
    if not enabled():
        return nullcontext()
    from torch.profiler import record_function
    return record_function(label)


def spanned(label: str, fn):
    """``fn`` itself when the switch is off, else ``fn`` called inside
    a span named ``label``.  Resolve it once, where a call site is
    built, never per call."""
    if not enabled():
        return fn
    from torch.profiler import record_function

    def call(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    return call


def reset() -> None:
    """Re-read WINDFLOW_TORCH_PROFILE (tests)."""
    global _on
    _on = None
