"""Bounded channels of the host runtime plane.

The reference rides FastFlow's lock-free SPSC queues with raw pointers
(SURVEY.md §5 "Distributed communication backend"); windflow_tpu_torch's host
plane uses bounded MPSC channels with per-producer EOS accounting.  A
consumer node owns exactly one channel; each upstream replica is a
registered producer.  Backpressure = blocking bounded put (the analogue
of FF_BOUNDED_BUFFER).  When the native C++ runtime is built
(native/windflow_native.cpp), channels transparently use its ring
buffers.

Failure containment (resilience/): every channel supports ``poison()``
-- the graph-wide shutdown sentinel.  A poisoned channel wakes every
blocked ``put``/``get`` and makes them raise
:class:`~windflow_tpu_torch.resilience.GraphCancelled`, so a dead replica
can never strand its upstream producers on a full bounded buffer.
"""
from __future__ import annotations

import threading
import time as _time
import warnings
from collections import deque
from typing import Any, Optional

from ..core.basic import DEFAULT_QUEUE_CAPACITY
from ..resilience.cancel import GraphCancelled

_EOS_SENTINEL = object()


class EpochBarrier:
    """Aligned-epoch barrier marker (durability/; docs/RESILIENCE.md
    "Exactly-once epochs") -- the channel-plane control item of the
    Chandy-Lamport-style snapshot protocol (Carbone et al., Flink's
    aligned barriers).  Injected at source replicas by the epoch
    coordinator, broadcast to every outlet destination, and consumed by
    the per-node aligners (durability/barrier.py) -- it never reaches
    operator ``svc``.  Travels through both channel planes as an
    ordinary item, so per-edge delivery books stay balanced by
    construction.  ``final=True`` is the end-of-stream variant a node
    broadcasts before closing its outlets: it tells downstream aligners
    this producer will inject no further epochs."""

    __slots__ = ("epoch", "final")

    def __init__(self, epoch: int, final: bool = False):
        self.epoch = epoch
        self.final = final

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return ("EpochBarrier(final)" if self.final
                else f"EpochBarrier({self.epoch})")

class Watermark:
    """Event-time low-watermark control item (eventtime/;
    docs/EVENTTIME.md) -- the in-band trigger signal of the event-time
    relational plane (Akidau et al., the Dataflow model).  A
    ``Watermark(ts)`` is a promise from its producer that every FUTURE
    item on this stream has event-time ``>= ts``.  Emitted by
    watermarked sources (eventtime/watermarks.py), broadcast by every
    emitter to all destinations, merged per consumer as the min over
    its producers (runtime/node.py), and consumed by event-time logics
    (``on_watermark``) to fire windows, close sessions and evict join
    state.  Like :class:`EpochBarrier` it travels through both channel
    planes as an ordinary item, so per-edge delivery books stay
    balanced by construction; the graph-wide conservation identity
    subtracts the per-node ``watermarks_in/out`` counters
    (audit/ledger.py)."""

    __slots__ = ("ts",)

    def __init__(self, ts: float):
        self.ts = ts

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Watermark({self.ts})"


# returned by get(timeout=...) when the wait elapses: distinct from
# None (which means every producer closed)
CHANNEL_TIMEOUT = object()

# bounded spin before an empty get() blocks on the condition variable:
# each iteration yields the GIL, so a producer mid-put gets a chance to
# publish without this consumer paying a full cv sleep/wake round trip
GET_SPIN = 24

# default batch a bulk consumer pops per lock round trip
GET_MANY_MAX = 128


class Channel:
    """Bounded multi-producer single-consumer channel.

    Items are ``(producer_id, payload)``.  ``close(producer_id)`` enqueues
    an EOS token for that producer; ``get()`` returns ``None`` once every
    registered producer has closed (the FastFlow EOS-propagation analogue).
    ``poison()`` cancels the channel: blocked and future put/get raise
    GraphCancelled (close becomes a no-op -- the consumer is gone).
    """

    __slots__ = ("_items", "_lock", "_not_empty", "_not_full",
                 "n_producers", "_eos_seen", "capacity", "poisoned",
                 "puts", "gets", "high_watermark", "_all_closed")

    def __init__(self, capacity: int = DEFAULT_QUEUE_CAPACITY):
        self._items: deque = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self.n_producers = 0
        self._eos_seen = 0
        # 0 (or negative) = unbounded, matching queue.Queue(maxsize=0)
        # which this class replaced
        self.capacity = capacity if capacity > 0 else None
        self.poisoned = False
        # raw queue counters (TRACE_FASTFLOW analogue).  Since the
        # audit plane (audit/ledger.py) these are LOAD-BEARING: the
        # flow-conservation ledger compares ``puts`` against the
        # Outlet-layer delivery books and ``gets + depth`` against
        # ``puts`` at the wait_end closure check.  All three are
        # updated inside the channel's critical section, so they are
        # exact (not merely tracing-grade) on this plane; EOS tokens
        # are counted by neither.  ``high_watermark`` is exported as
        # the Queue_high_watermark gauge (PipeGraph.refresh_gauges).
        self.puts = 0
        self.gets = 0
        self.high_watermark = 0
        self._all_closed = False  # sticky once every producer closed

    def register_producer(self) -> int:
        with self._lock:
            pid = self.n_producers
            self.n_producers += 1
            return pid

    def put(self, producer_id: int, item: Any) -> None:
        with self._not_full:
            while self.capacity is not None \
                    and len(self._items) >= self.capacity \
                    and not self.poisoned:
                self._not_full.wait()
            if self.poisoned:
                raise GraphCancelled(f"channel poisoned (producer "
                                     f"{producer_id})")
            self._items.append((producer_id, item))
            self.puts += 1
            d = len(self._items)
            if d > self.high_watermark:
                self.high_watermark = d
            self._not_empty.notify()

    def put_many(self, producer_id: int, items) -> None:
        """Bulk put: one lock round trip per capacity window instead of
        one per item.  Equivalent to ``for it in items: put(pid, it)``
        including backpressure (never overfills the bound) and poison
        semantics (raises as soon as the channel is cancelled; items
        already appended stay appended, exactly like the loop)."""
        n = len(items)
        if n == 0:
            return
        i = 0
        with self._not_full:
            while i < n:
                while self.capacity is not None \
                        and len(self._items) >= self.capacity \
                        and not self.poisoned:
                    self._not_full.wait()
                if self.poisoned:
                    raise GraphCancelled(f"channel poisoned (producer "
                                         f"{producer_id})")
                room = (n - i if self.capacity is None
                        else self.capacity - len(self._items))
                take = min(room, n - i)
                append = self._items.append
                for j in range(i, i + take):
                    append((producer_id, items[j]))
                i += take
                self.puts += take
                d = len(self._items)
                if d > self.high_watermark:
                    self.high_watermark = d
                self._not_empty.notify()

    def close(self, producer_id: int) -> None:
        # EOS bypasses the capacity bound (like the native channel): a
        # producer must always be able to announce its end of stream
        with self._lock:
            if self.poisoned:
                return
            self._items.append((producer_id, _EOS_SENTINEL))
            self._not_empty.notify()

    def _spin(self) -> None:
        """Bounded spin before blocking: each sleep(0) yields the GIL so
        a producer mid-put can publish, saving the cv round trip on
        busy channels.  Purely an optimization -- falling through to
        the condition wait is always correct."""
        for _ in range(GET_SPIN):
            if self._items or self.poisoned:
                return
            _time.sleep(0)

    def get(self, timeout: Optional[float] = None):
        """Next (channel_id, item); None when all producers closed;
        CHANNEL_TIMEOUT when ``timeout`` seconds pass with nothing to
        deliver (idle-tick consumers).  Raises GraphCancelled once the
        channel is poisoned."""
        if timeout is None and not self._items and not self._all_closed:
            # spin only for indefinite gets: timed gets are idle-tick
            # pollers where the cv wait IS the intended pacing
            self._spin()
        with self._not_empty:
            deadline = (None if timeout is None
                        else _time.monotonic() + timeout)
            while True:
                while not self._items:
                    if self.poisoned:
                        raise GraphCancelled("channel poisoned")
                    if self._all_closed:
                        return None
                    if deadline is None:
                        self._not_empty.wait()
                    else:
                        remaining = deadline - _time.monotonic()
                        if remaining <= 0:
                            return CHANNEL_TIMEOUT
                        self._not_empty.wait(remaining)
                if self.poisoned:
                    raise GraphCancelled("channel poisoned")
                pid, item = self._items.popleft()
                self._not_full.notify()
                if item is _EOS_SENTINEL:
                    self._eos_seen += 1
                    if self._eos_seen >= self.n_producers:
                        self._all_closed = True
                        return None
                    continue
                self.gets += 1
                return pid, item

    def get_many(self, max_n: int = GET_MANY_MAX,
                 timeout: Optional[float] = None):
        """Pop up to ``max_n`` items under one lock round trip.

        Returns a non-empty list of ``(channel_id, item)`` pairs in
        arrival order, ``None`` once every producer has closed (sticky),
        or ``CHANNEL_TIMEOUT``.  Blocks until at least one item is
        available, like ``get``."""
        out = []
        if timeout is None and not self._items and not self._all_closed:
            self._spin()
        with self._not_empty:
            deadline = (None if timeout is None
                        else _time.monotonic() + timeout)
            while True:
                while not self._items:
                    if self.poisoned:
                        raise GraphCancelled("channel poisoned")
                    if self._all_closed:
                        return None
                    if deadline is None:
                        self._not_empty.wait()
                    else:
                        remaining = deadline - _time.monotonic()
                        if remaining <= 0:
                            return CHANNEL_TIMEOUT
                        self._not_empty.wait(remaining)
                if self.poisoned:
                    raise GraphCancelled("channel poisoned")
                popleft = self._items.popleft
                while self._items and len(out) < max_n:
                    pid, item = popleft()
                    if item is _EOS_SENTINEL:
                        self._eos_seen += 1
                        if self._eos_seen >= self.n_producers:
                            self._all_closed = True
                            break
                        continue
                    out.append((pid, item))
                self._not_full.notify_all()
                if out:
                    self.gets += len(out)
                    return out
                if self._all_closed:
                    return None
                # only partial EOS tokens were drained: wait for data

    def poison(self) -> None:
        """Graph-cancellation sentinel: wake and fail all blocked ends."""
        with self._lock:
            self.poisoned = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def qsize(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def depth(self) -> int:
        """Lock-free depth gauge: ``len`` of a deque is GIL-atomic, so
        monitoring/elastic samplers can read it without contending on
        the channel lock.  Gauge-grade (may lag a concurrent put/get by
        one item), like the puts/gets counters."""
        return len(self._items)


_native_warned = False


def _warn_native_unavailable(detail: str) -> None:
    """One warning per process: a broken native toolchain should be
    visible, not silently degrade every channel to pure Python."""
    global _native_warned
    if _native_warned:
        return
    _native_warned = True
    warnings.warn(
        f"windflow_tpu_torch native runtime unavailable ({detail}); falling "
        "back to pure-Python channels (set use_native_runtime=False or "
        "WINDFLOW_NATIVE=0 to silence)", RuntimeWarning, stacklevel=3)


def make_channel(config=None) -> "Channel":
    """Channel factory: prefers the native C++ channel when the runtime
    config allows it and the toolchain built it (runtime/native.py)."""
    cap = config.queue_capacity if config is not None else DEFAULT_QUEUE_CAPACITY
    if config is None or config.use_native_runtime:
        try:
            from .native import NativeChannel, native_available
            if native_available():
                return NativeChannel(cap)
            import os
            if os.environ.get("WINDFLOW_NATIVE", "1") != "0":
                # deliberate WINDFLOW_NATIVE=0 runs fall through
                # silently; only a genuinely broken toolchain warns
                _warn_native_unavailable("toolchain probe/build failed")
        except (OSError, RuntimeError) as e:
            # only environment errors are expected here; anything else
            # (a real bug in the binding layer) must propagate
            _warn_native_unavailable(repr(e))
    return Channel(cap)
