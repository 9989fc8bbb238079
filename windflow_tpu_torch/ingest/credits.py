"""Credit-based backpressure for ingest sources.

A source replica may have ``budget`` tuples outstanding in its outlet
channels; every emitted item spends ``len(item)`` credits and every
item the downstream consumer dequeues returns them.  Exhausted credits
block (or, with an admission policy, shed) at the *ingest* boundary --
the transport stops reading, so for TCP the kernel's flow control
propagates backpressure to the peer instead of the process buffering
without bound.

The mechanism is two halves:

* :class:`CreditGate` -- the per-source-replica budget.  ``acquire``
  blocks until credits are available (cancel-aware: the graph
  CancelToken poisons gates so a cancelled graph unblocks a source
  stuck waiting for credits).  Spend times are kept FIFO so each
  ``release`` yields a queue-residency latency sample -- the feedback
  signal of the microbatch controller.
* :class:`CreditedChannel` -- a transparent proxy wrapped around the
  source's outlet channel at graph start (`wiring.py`).  Consumer
  ``get``s pass through and return the item's credits to the gate of
  the producer that sent it.
"""
from __future__ import annotations

import threading
import time as _time
from collections import deque
from typing import Any, Dict, Optional

from ..resilience.cancel import GraphCancelled


def credits_of(item: Any) -> int:
    """Credit cost of one channel item, in tuples."""
    try:
        return max(1, len(item))
    except TypeError:
        return 1


class CreditGate:
    """Per-source-replica credit budget (tuples outstanding downstream)."""

    def __init__(self, budget: int):
        if budget < 1:
            raise ValueError("credit budget must be >= 1")
        self.budget = budget
        self._lock = threading.Lock()
        self._avail = threading.Condition(self._lock)
        self.available = budget
        self.poisoned = False
        # FIFO of (spend_time, n): channel delivery is FIFO per
        # producer, so releases pop in spend order and the head's age is
        # the dequeued item's queue residency
        self._inflight: deque = deque()
        # -- observability (monitoring JSON / tests) -------------------
        self.peak_outstanding = 0
        self.credit_waits = 0          # acquires that had to block/shed
        self.wait_time_s = 0.0
        self._observer = None          # MicrobatchController.observe

    def bind_observer(self, observer) -> None:
        self._observer = observer

    def resize(self, budget: int) -> None:
        """Rebudget -- pre-start (wiring applies RuntimeConfig
        defaults) or LIVE (the serving plane's arbiter moves credits
        between running tenants, docs/SERVING.md).  Waiters are woken
        so an upward resize unblocks promptly, and ``acquire``
        re-reads the budget inside its wait loop so a downward resize
        can never wedge a blocked source against a need the new
        budget can no longer satisfy."""
        if budget < 1:
            raise ValueError("credit budget must be >= 1")
        with self._avail:
            self.available += budget - self.budget
            self.budget = budget
            self._avail.notify_all()

    def outstanding(self) -> int:
        with self._lock:
            return self.budget - self.available

    def try_acquire(self, n: int) -> bool:
        """Non-blocking acquire; full-budget grants are always allowed
        so a single over-budget batch cannot wedge the source."""
        with self._lock:
            if self.poisoned:
                raise GraphCancelled("credit gate poisoned")
            if self.available < min(n, self.budget):
                return False
            self._spend_locked(n)
            return True

    def acquire(self, n: int, timeout: Optional[float] = None) -> bool:
        """Block until ``n`` credits are available (or the full budget,
        when ``n`` exceeds it).  Returns False on timeout -- the
        admission layer's shed trigger.  Raises GraphCancelled once the
        owning graph is cancelled."""
        deadline = None if timeout is None else _time.monotonic() + timeout
        with self._avail:
            if self.available < min(n, self.budget):
                self.credit_waits += 1
                t0 = _time.monotonic()
                # re-read the budget each pass: a live resize may have
                # shrunk it below a captured `need`, which release()'s
                # budget clamp could then never satisfy (permanent
                # wedge of the blocked source)
                while self.available < min(n, self.budget):
                    if self.poisoned:
                        raise GraphCancelled("credit gate poisoned")
                    if deadline is None:
                        self._avail.wait(0.1)
                    else:
                        remaining = deadline - _time.monotonic()
                        if remaining <= 0:
                            self.wait_time_s += _time.monotonic() - t0
                            return False
                        self._avail.wait(min(remaining, 0.1))
                self.wait_time_s += _time.monotonic() - t0
            if self.poisoned:
                raise GraphCancelled("credit gate poisoned")
            self._spend_locked(n)
            return True

    def _spend_locked(self, n: int) -> None:
        self.available -= n
        out = self.budget - self.available
        if out > self.peak_outstanding:
            self.peak_outstanding = out
        self._inflight.append((_time.monotonic(), n))

    def release(self, n: int) -> None:
        """Return credits (consumer dequeued an item of ``n`` tuples)
        and feed the controller one queue-residency latency sample."""
        now = _time.monotonic()
        sample = None
        with self._avail:
            self.available = min(self.budget, self.available + n)
            left = n
            while left > 0 and self._inflight:
                t0, m = self._inflight[0]
                sample = now - t0
                if m <= left:
                    self._inflight.popleft()
                    left -= m
                else:
                    self._inflight[0] = (t0, m - left)
                    left = 0
            self._avail.notify_all()
        if sample is not None and self._observer is not None:
            self._observer(sample)

    def poison(self) -> None:
        """CancelToken hook: wake every blocked acquire."""
        with self._avail:
            self.poisoned = True
            self._avail.notify_all()


class CreditedChannel:
    """Transparent channel proxy returning credits on consumer gets.

    Wraps either the pure-Python ``Channel`` or the native C++ channel
    (same duck type: put/get/close/poison/qsize + counter attrs).  The
    producer-id -> gate map routes each dequeued item's credits back to
    the source replica that emitted it; producers without a gate (a
    non-ingest operator feeding the same consumer) pass through
    untouched.
    """

    __slots__ = ("inner", "gates")

    def __init__(self, inner, gates: Optional[Dict[int, CreditGate]] = None):
        self.inner = inner
        self.gates = gates or {}

    def bind_gate(self, producer_id: int, gate: CreditGate) -> None:
        self.gates[producer_id] = gate

    # -- forwarded surface (runtime/queues.Channel duck type) ----------
    def register_producer(self) -> int:
        return self.inner.register_producer()

    def put(self, producer_id: int, item: Any) -> None:
        # credits are spent HERE, per actual delivery, so the books
        # balance for every emitter shape: round-robin puts into one of
        # N channels (one spend, one release), multicast puts into all
        # N (N spends, N releases).  Spending at emit time instead
        # would over- or under-charge depending on the emitter.
        gate = self.gates.get(producer_id)
        if gate is not None:
            gate.acquire(credits_of(item))
        self.inner.put(producer_id, item)

    def put_many(self, producer_id: int, items) -> None:
        """Bulk put with EXACT credit accounting: each item's credits
        are acquired immediately before its own delivery (never summed
        up front -- a bulk acquire larger than the budget could wait on
        releases only the not-yet-delivered prefix can produce)."""
        gate = self.gates.get(producer_id)
        if gate is None:
            pm = getattr(self.inner, "put_many", None)
            if pm is not None:
                pm(producer_id, items)
            else:
                for item in items:
                    self.inner.put(producer_id, item)
            return
        for item in items:
            gate.acquire(credits_of(item))
            self.inner.put(producer_id, item)

    def close(self, producer_id: int) -> None:
        self.inner.close(producer_id)

    def get(self, timeout: Optional[float] = None):
        got = self.inner.get(timeout)
        if isinstance(got, tuple):
            pid, item = got
            gate = self.gates.get(pid)
            if gate is not None:
                gate.release(credits_of(item))
        return got

    def get_many(self, max_n: int = 128, timeout: Optional[float] = None):
        """Bulk get; every dequeued item returns its credits to its
        producer's gate, exactly as the per-item path does."""
        gm = getattr(self.inner, "get_many", None)
        if gm is None:
            got = self.get(timeout)
            return [got] if isinstance(got, tuple) else got
        got = gm(max_n, timeout)
        if isinstance(got, list):
            gates = self.gates
            for pid, item in got:
                gate = gates.get(pid)
                if gate is not None:
                    gate.release(credits_of(item))
        return got

    def poison(self) -> None:
        self.inner.poison()

    def qsize(self) -> int:
        return self.inner.qsize()

    @property
    def depth(self) -> int:
        return self.inner.depth

    @property
    def n_producers(self) -> int:
        return self.inner.n_producers

    @property
    def capacity(self):
        return getattr(self.inner, "capacity", None)

    @property
    def puts(self) -> int:
        return getattr(self.inner, "puts", 0)

    @property
    def gets(self) -> int:
        return getattr(self.inner, "gets", 0)

    @property
    def high_watermark(self) -> int:
        return getattr(self.inner, "high_watermark", 0)

    @property
    def poisoned(self) -> bool:
        return getattr(self.inner, "poisoned", False)
