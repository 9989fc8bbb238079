"""Graph-wide cancellation: the failure-containment primitive.

The reference has no failure layer at all (SURVEY.md §5): an ff_node
that throws takes its thread down and leaves every upstream producer
blocked on a full bounded queue.  windflow_tpu_torch's containment design is
a single **CancelToken** per PipeGraph holding every channel of the
wired graph.  When any replica dies (or a watchdog fires), the token
poisons every channel in both directions: blocked ``put()``s and
``get()``s wake immediately and raise :class:`GraphCancelled`, which
the runtime node treats as a clean shutdown signal rather than a
failure -- so ``wait_end`` always returns, carrying only the *real*
errors.
"""
from __future__ import annotations

import threading
from typing import Any, List, Optional


class GraphCancelled(BaseException):
    """Raised by channel put/get once the owning graph is cancelled.

    Deliberately a ``BaseException`` (like ``asyncio.CancelledError``):
    operator error policies and user ``except Exception`` blocks must
    not swallow the shutdown signal.
    """


class CancelToken:
    """One per PipeGraph: fans a cancellation out to every channel.

    Channels (anything with a ``poison()`` method) register at graph
    start.  ``cancel(reason)`` is idempotent -- the first reason wins,
    later calls are no-ops -- and poisons every registered channel so
    all blocked channel operations raise :class:`GraphCancelled`.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._channels: List[Any] = []
        self._event = threading.Event()
        self.reason: Optional[BaseException] = None
        self.origin: Optional[str] = None  # node name that triggered it

    def register(self, channel: Any) -> None:
        with self._lock:
            self._channels.append(channel)
            poisoned = self._event.is_set()
        if poisoned:  # late registration after a cancel: poison now
            channel.poison()

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def cancel(self, reason: Optional[BaseException] = None,
               origin: Optional[str] = None) -> bool:
        """Poison every channel; returns False if already cancelled."""
        with self._lock:
            if self._event.is_set():
                return False
            self.reason = reason
            self.origin = origin
            self._event.set()
            channels = list(self._channels)
        for ch in channels:
            ch.poison()
        return True
