"""Failure-containment exception types.

Defined here (below both the graph and runtime layers) so the
watchdog, the checkpoint/recovery runner and PipeGraph can all share
them without import cycles.  ``graph.pipegraph`` re-exports
``NodeFailureError`` at its historical location.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


class NodeFailureError(RuntimeError):
    """A replica thread died at runtime (vs. graph-validation errors,
    which raise plain RuntimeError/ValueError and are not recoverable
    by restarting -- utils/checkpoint.run_with_recovery retries only
    this type).

    ``errors`` carries every failed replica as ``(node_name, error)``
    pairs -- cancellation guarantees ``wait_end`` observes all of them,
    not just the first.
    """

    def __init__(self, message: str,
                 errors: Optional[Sequence[Tuple[str, BaseException]]] = None):
        super().__init__(message)
        self.errors: List[Tuple[str, BaseException]] = list(errors or [])

    @classmethod
    def from_pairs(cls, errors: Sequence[Tuple[str, BaseException]],
                   stuck: Sequence[str] = ()) -> "NodeFailureError":
        detail = "; ".join(f"{name}: {err!r}" for name, err in errors)
        msg = f"{len(errors)} node(s) failed: {detail}"
        if stuck:
            msg += ("; nodes still running after cancellation grace: "
                    + ", ".join(stuck))
        return cls(msg, errors)


class StallError(NodeFailureError):
    """The stall watchdog cancelled the graph: no channel made progress
    for the configured deadline.  Subclasses NodeFailureError so
    ``run_with_recovery`` treats a stalled run as retryable."""
