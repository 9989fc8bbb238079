"""Deprecation shim: the wire codec moved to
:mod:`windflow_tpu_torch.distributed.wire`.

The ingest plane's framed-TCP protocol and the inter-worker shuffle
transport (docs/DISTRIBUTED.md) share one codec; it lives with the
distributed plane now.  This module keeps the historical import path
(``windflow_tpu_torch.ingest.codec``) working: the frozen legacy surface
(``encode_batch``/``decode_batch``/``StreamDecoder``/``MAGIC``)
re-exports silently -- existing callers must not start warning on a
pure code move -- while any NEW wire-layer name reached through this
path warns once per process, pointing the caller at the canonical
``windflow_tpu_torch.distributed.wire`` home.
"""
from __future__ import annotations

import warnings

from ..distributed.wire import (  # noqa: F401  (re-exported surface)
    MAGIC, StreamDecoder, decode_batch, encode_batch,
)

_warned = False


def _warn_moved() -> None:
    global _warned
    if not _warned:
        _warned = True
        warnings.warn(
            "windflow_tpu_torch.ingest.codec moved to "
            "windflow_tpu_torch.distributed.wire; update imports "
            "(the old path keeps working for now)",
            DeprecationWarning, stacklevel=3)


def __getattr__(name):  # anything beyond the frozen legacy surface
    from ..distributed import wire as _wire
    if hasattr(_wire, name):
        _warn_moved()
        return getattr(_wire, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
