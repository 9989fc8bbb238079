"""L0/L2 host runtime plane: channels, threaded nodes, emitters,
ordering collectors (the FastFlow substitute, SURVEY.md §5 last bullet)."""
from .queues import Channel
from .node import EOSMarker, NodeLogic, Outlet, RtNode, SourceLoopLogic
from .emitters import (Emitter, StandardEmitter, BroadcastEmitter,
                       SplittingEmitter, TreeEmitter)
from .ordering import OrderingLogic, KSlackLogic
from .win_routing import (WFEmitter, KFEmitter, WinMapEmitter,
                          WidOrderCollector)

__all__ = [
    "Channel", "EOSMarker", "NodeLogic", "Outlet", "RtNode",
    "SourceLoopLogic", "Emitter", "StandardEmitter", "BroadcastEmitter",
    "SplittingEmitter", "TreeEmitter", "OrderingLogic", "KSlackLogic",
    "WFEmitter", "KFEmitter", "WinMapEmitter", "WidOrderCollector",
]
