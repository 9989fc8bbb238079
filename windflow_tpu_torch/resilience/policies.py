"""Per-operator error policies and the graph dead-letter store.

Policy semantics (selected per operator from the builders via
``.with_error_policy(...)``; the default matches the reference, where
any svc exception kills the replica):

* ``'fail'``        -- the exception propagates, the replica dies and
                       the graph is cancelled (CancelToken).
* ``'skip'``        -- the offending tuple is dropped, a per-replica
                       failure counter increments, the replica lives.
* ``'dead_letter'`` -- like skip, but the tuple is quarantined (with
                       node name, error and traceback) into the
                       graph-level :class:`DeadLetterStore`, readable
                       after ``wait_end``.

Policies apply to per-tuple ``svc`` processing only; source generation
loops and EOS flushes always fail hard (there is no offending tuple to
quarantine).
"""
from __future__ import annotations

import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, List

POLICY_FAIL = "fail"
POLICY_SKIP = "skip"
POLICY_DEAD_LETTER = "dead_letter"
ERROR_POLICIES = (POLICY_FAIL, POLICY_SKIP, POLICY_DEAD_LETTER)


def validate_policy(policy: str) -> str:
    if policy not in ERROR_POLICIES:
        raise ValueError(
            f"unknown error policy {policy!r}; expected one of "
            f"{ERROR_POLICIES}")
    return policy


@dataclass
class DeadLetterEntry:
    """One quarantined tuple."""

    node: str                       # replica (RtNode) name
    item: Any                       # the offending tuple itself
    error: BaseException
    traceback: str                  # formatted traceback text
    time: float = field(default_factory=time.time)

    def __repr__(self) -> str:
        return (f"DeadLetterEntry(node={self.node!r}, "
                f"error={self.error!r}, item={self.item!r})")


class DeadLetterStore:
    """Graph-level quarantine of poisoned tuples (bounded, thread-safe).

    ``max_entries`` bounds memory: beyond it only the counters advance
    (the count is exact, the retained sample is the earliest entries).
    """

    def __init__(self, max_entries: int = 10_000):
        self._lock = threading.Lock()
        self._entries: List[DeadLetterEntry] = []
        self._count = 0
        self._by_node: Dict[str, int] = {}
        self.max_entries = max_entries

    def add(self, node: str, item: Any, error: BaseException,
            count: int = 1) -> None:
        """Quarantine one entry advancing the counters by ``count``
        tuples.  Bulk callers (ingest admission shedding) pass the shed
        total with a sample batch as ``item`` -- a columnar overload
        must not cost one store entry per tuple."""
        # format the traceback OF THE GIVEN ERROR, not whatever
        # exception happens to be ambient (format_exc would record
        # "NoneType: None" when called outside an except block)
        tb = "".join(traceback.format_exception(
            type(error), error, error.__traceback__))
        entry = DeadLetterEntry(node, item, error, tb)
        with self._lock:
            self._count += count
            self._by_node[node] = self._by_node.get(node, 0) + count
            if len(self._entries) < self.max_entries:
                self._entries.append(entry)

    @property
    def entries(self) -> List[DeadLetterEntry]:
        with self._lock:
            return list(self._entries)

    def count(self) -> int:
        with self._lock:
            return self._count

    def counts_by_node(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._by_node)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._by_node.clear()
            self._count = 0

    def __len__(self) -> int:
        return self.count()

    def __bool__(self) -> bool:
        return self.count() > 0
