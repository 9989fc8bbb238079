"""L1 core abstractions (reference wf/ L1: SURVEY.md §2.1)."""
from .basic import (Mode, WinType, OptLevel, RoutingMode, Pattern, WinEvent,
                    OrderingMode, Role, WinOperatorConfig, RuntimeConfig,
                    DurabilityConfig, ElasticSpec,
                    DEFAULT_BATCH_SIZE_TB, current_time_usecs)
from .tuples import WFRecord, BasicRecord, TupleBatch, EOS
from .window import TriggererCB, TriggererTB, Window, classify_cb, classify_tb
from .archive import StreamArchive
from .flatfat import FlatFAT
from .iterable import Iterable
from .shipper import Shipper
from .context import RuntimeContext, LocalStorage
from .meta import arity, is_rich, with_context, default_hash
from .expr import Expr, F
from . import win_assign

__all__ = [
    "Mode", "WinType", "OptLevel", "RoutingMode", "Pattern", "WinEvent",
    "OrderingMode", "Role", "WinOperatorConfig", "RuntimeConfig",
    "DurabilityConfig",
    "ElasticSpec",
    "DEFAULT_BATCH_SIZE_TB", "current_time_usecs",
    "WFRecord", "BasicRecord", "TupleBatch", "EOS",
    "TriggererCB", "TriggererTB", "Window", "classify_cb", "classify_tb",
    "StreamArchive", "FlatFAT", "Iterable", "Shipper",
    "RuntimeContext", "LocalStorage",
    "arity", "is_rich", "with_context", "default_hash", "win_assign",
    "Expr", "F",
]
