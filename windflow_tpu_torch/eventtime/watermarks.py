"""Watermark generation: the in-band event-time trigger.

A :class:`~windflow_tpu_torch.runtime.queues.Watermark` is an ordinary
channel item carrying a promise -- "every future tuple on this stream
has event-time >= ts".  The runtime transports it generically
(broadcast over every emitter, per-node min-merge across producers,
ledger-balanced like epoch barriers); this module is where watermarks
are BORN: :func:`watermarked` wraps any shipper-style source body so it
punctuates its own output with periodic watermarks derived from the
maximum event-time it has shipped, and seals the stream with
``Watermark(inf)`` at end-of-stream so every downstream merge drains.

``watermark_of(source)`` (audit/progress.py) reads the wrapper's
current promise for dashboards and tests.

``skew`` may be the string ``"auto"``: the out-of-order bound is then
LEARNED from the observed lateness of the stream itself (the same
bounded-EWMA shape as the K-slack collector's adaptive K,
runtime/ordering.py) instead of being promised up front.
"""
from __future__ import annotations

from typing import Any, Callable, Union

from ..core.tuples import TupleBatch
from ..runtime.queues import Watermark

__all__ = ["Watermark", "WatermarkedSource", "watermarked"]

# bounded-EWMA constants for skew="auto" (mirroring KSlackLogic's K
# adaptation): the learned bound relaxes instantly to any observed
# lateness above it (never promise what the stream already broke) and
# tightens slowly below it, so one well-ordered stretch does not erase
# the memory of a bursty one
_SKEW_ALPHA = 0.25


class _TsShipper:
    """Shipper proxy tracking the max event-time of pushed items, plus
    the worst observed lateness (how far a pushed ts trailed the
    running max) for the adaptive-skew estimator."""

    __slots__ = ("_inner", "max_ts", "pushed", "max_late")

    def __init__(self, inner, prev_max: float = float("-inf")):
        self._inner = inner
        self.max_ts = prev_max
        self.pushed = 0
        self.max_late = 0.0

    def push(self, item: Any) -> None:
        ts = None
        late = None
        if isinstance(item, TupleBatch):
            if len(item):
                ts = float(item.ts.max())
                # batch lateness: the oldest ts in the batch against
                # the newest seen so far (the columnar analogue of
                # KSlackLogic's per-batch ts.min() sample)
                late = max(self.max_ts, ts) - float(item.ts.min())
        else:
            try:
                ts = float(item.get_control_fields()[2])
            except (AttributeError, TypeError):
                pass  # ts-less control item
            if ts is not None:
                late = self.max_ts - ts
        if ts is not None and ts > self.max_ts:
            self.max_ts = ts
        if late is not None and late > self.max_late:
            self.max_late = late
        self.pushed += 1
        self._inner.push(item)

    def num_delivered(self) -> int:
        return self.pushed


class WatermarkedSource:
    """Source-body wrapper that punctuates its stream with watermarks.

    ``fn(shipper) -> bool`` is the wrapped shipper-style source body
    (SourceBuilder convention: push 0..N records, return False at end
    of stream).  Every ``every`` shipped tuples the wrapper emits
    ``Watermark(max_shipped_ts - skew)``; ``skew`` is the out-of-order
    bound the source promises (a tuple may trail the newest one by at
    most ``skew`` time units).  At end of stream it emits
    ``Watermark(inf)`` so downstream merges drain every open window.

    ``skew="auto"`` learns the bound instead: every generation step
    measures how far pushed tuples trailed the running max event-time,
    and the bound follows a bounded EWMA of that lateness -- jumping
    straight UP to any observed lateness above it (a promise already
    violated is worthless) and decaying DOWN slowly.  Each meaningful
    adjustment is recorded loudly as a ``skew_adapted`` flight event
    (telemetry/recorder.py) so an operator can see the source revising
    its disorder estimate.

    One instance drives ONE source replica -- the wrapper is stateful
    (shipped-count, max-ts, current promise), so watermarked sources
    run with parallelism 1 or one distinct instance per replica.

    Checkpoint contract (durability/): the wrapper's own counters ride
    ``state_dict`` next to the wrapped body's (when it has one), so an
    exactly-once restore resumes the watermark clock consistently with
    the replayed offset.
    """

    # PipeGraph.start binds the graph's flight recorder + node name to
    # any source body advertising _wants_flight (the builder call chain
    # never sees the graph)
    _wants_flight = True
    flight = None
    source_name = "watermarked"

    def __init__(self, fn: Callable, every: int = 64,
                 skew: Union[float, str] = 0.0):
        self.fn = fn
        self.every = int(every)
        self.auto_skew = skew == "auto"
        self.skew = 0.0 if self.auto_skew else float(skew)
        self._max_ts = float("-inf")
        self._since = 0
        self._wm = float("-inf")
        self._done = False

    @property
    def current_watermark(self) -> float:
        """The newest promise this source has emitted
        (``watermark_of`` reads this)."""
        return self._wm

    def _adapt_skew(self, observed: float) -> None:
        old = self.skew
        if observed > old:
            new = observed          # violated bound: jump to cover it
        else:
            new = old + _SKEW_ALPHA * (observed - old)  # decay slowly
        if new == old:
            return
        self.skew = new
        # loud only on meaningful moves: >=10% relative (or any jump
        # from zero), so the steady-state decay trickle stays quiet
        if self.flight is not None and (
                old == 0.0 or abs(new - old) >= 0.1 * old):
            self.flight.record("skew_adapted", source=self.source_name,
                               old=round(old, 6), new=round(new, 6),
                               observed=round(observed, 6))

    def __call__(self, shipper) -> bool:
        if self._done:
            return False
        proxy = _TsShipper(shipper, prev_max=self._max_ts)
        alive = self.fn(proxy)
        if proxy.max_ts > self._max_ts:
            self._max_ts = proxy.max_ts
        if self.auto_skew and proxy.pushed:
            self._adapt_skew(proxy.max_late)
        if not alive:
            self._done = True
            self._wm = float("inf")
            shipper.push(Watermark(float("inf")))
            return False
        self._since += proxy.pushed
        if self._since >= self.every and self._max_ts > float("-inf"):
            self._since = 0
            wm = self._max_ts - self.skew
            if wm > self._wm:
                self._wm = wm
                shipper.push(Watermark(wm))
        return True

    # -- checkpoint hooks: delegate to the wrapped body and stack the
    # watermark clock on top (durability/barrier.capture_states probes
    # the SOURCE LOGIC's state_dict, which closes over the callable;
    # SourceBuilder users get this through _WmSourceLogic in tests or
    # their own SourceLoopLogic subclass) -----------------------------
    def state_dict(self):
        inner = getattr(self.fn, "state_dict", None)
        return {
            "inner": inner() if inner is not None else None,
            "max_ts": self._max_ts, "since": self._since,
            "wm": self._wm, "done": self._done,
            "skew": self.skew, "auto_skew": self.auto_skew,
        }

    def load_state(self, st):
        if st.get("inner") is not None:
            self.fn.load_state(st["inner"])
        self._max_ts = st["max_ts"]
        self._since = st["since"]
        self._wm = st["wm"]
        self._done = st["done"]
        # pre-adaptive snapshots lack the skew keys: keep the
        # constructor's bound
        self.skew = st.get("skew", self.skew)
        self.auto_skew = st.get("auto_skew", self.auto_skew)


def watermarked(fn: Callable, every: int = 64,
                skew: Union[float, str] = 0.0) -> WatermarkedSource:
    """Wrap a shipper-style source body so it emits watermarks:
    ``SourceBuilder(watermarked(body, every=32)).build()`` --
    ``skew="auto"`` learns the out-of-order bound from observed
    lateness instead of promising a static one."""
    return WatermarkedSource(fn, every=every, skew=skew)
