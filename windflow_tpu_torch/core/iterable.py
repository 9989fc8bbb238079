"""Iterable: read-only random-access view of a window's content.

Re-design of reference ``wf/iterable.hpp`` (ctor :73, begin/end/size
:80-122, operator[]/at :131-176).  Handed to non-incremental window
functions; backed by a list slice view (archive storage) without copying.
"""
from __future__ import annotations

from typing import Any, Sequence


class Iterable:
    __slots__ = ("_items", "_lo", "_hi")

    def __init__(self, items: Sequence[Any], lo: int = 0, hi: int = None):
        self._items = items
        self._lo = lo
        self._hi = len(items) if hi is None else hi

    def __len__(self) -> int:
        return self._hi - self._lo

    def size(self) -> int:
        return len(self)

    def __iter__(self):
        for i in range(self._lo, self._hi):
            yield self._items[i]

    def __getitem__(self, i: int) -> Any:
        if i < 0 or i >= len(self):
            raise IndexError(i)  # bounds-checked like Iterable::at (:161-176)
        return self._items[self._lo + i]

    def at(self, i: int) -> Any:
        return self[i]
