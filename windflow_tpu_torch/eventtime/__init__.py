"""Event-time relational plane: watermark-triggered windows, session
windows and two-input stream joins (docs/EVENTTIME.md).

Built on the generic watermark transport in runtime/node.py (per-edge
broadcast, per-node min-merge across producers, ledger-balanced like
epoch barriers) and the keyed-state contract shared with
AccumulatorLogic, so every operator here composes with exactly-once
epochs (durability/), the tiered keyed store (state/) and runtime
rescale (elastic/) out of the box.
"""
from ..runtime.queues import Watermark
from .base import EventTimeLogic, iter_rows
from .frontend import StreamQuery, query
from .joins import (LEFT, RIGHT, IntervalJoin, IntervalJoinLogic, Sided,
                    WindowJoin, WindowJoinLogic, side_tagger, tag_side)
from .sessions import SessionWindow, SessionWindowLogic
from .watermarks import WatermarkedSource, watermarked
from .windows import EventTimeWindow, EventTimeWindowLogic

__all__ = [
    "Watermark", "WatermarkedSource", "watermarked",
    "EventTimeLogic", "iter_rows",
    "EventTimeWindow", "EventTimeWindowLogic",
    "SessionWindow", "SessionWindowLogic",
    "LEFT", "RIGHT", "Sided", "side_tagger", "tag_side",
    "IntervalJoin", "IntervalJoinLogic",
    "WindowJoin", "WindowJoinLogic",
    "StreamQuery", "query",
]
