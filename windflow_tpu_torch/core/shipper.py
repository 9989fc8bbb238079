"""Shipper: push interface for Source / FlatMap user logic.

Re-design of reference ``wf/shipper.hpp`` (push :85-103).  The reference
wraps ``ff_send_out``; here the shipper appends to the emitting node's
out-buffer (which the runtime flushes through the operator's emitter as
a micro-batch -- the TPU-first adaptation of per-tuple sends).
"""
from __future__ import annotations

from typing import Any, Callable


class Shipper:
    __slots__ = ("_sink", "delivered")

    def __init__(self, sink: Callable[[Any], None]):
        self._sink = sink
        self.delivered = 0

    def push(self, item: Any) -> None:
        self._sink(item)
        self.delivered += 1

    # reference exposes the count (shipper.hpp getNumDelivered)
    def num_delivered(self) -> int:
        return self.delivered
