"""StreamArchive: per-key ordered buffer with range queries and purge.

Re-design of reference ``wf/stream_archive.hpp`` (insert :60-71, purge
:74-80, getWinRange :106-127, getDistance :133-150).  The reference keeps
a ``std::deque`` ordered by a comparator and does insertion sort via
``lower_bound``; we do the same with ``bisect`` over a list keyed by a
sort key extracted once per record (cheaper than calling a comparator
O(log n) times per insert in Python).
"""
from __future__ import annotations

import bisect
from typing import Any, Callable, List, Tuple


class StreamArchive:
    """Ordered archive of records for one operator replica.

    ``sort_key(t)`` returns the ordering field -- tuple id for CB
    windows, timestamp for TB windows (matching the comparator choice in
    win_seq.hpp init).
    """

    __slots__ = ("sort_key", "_keys", "_items")

    def __init__(self, sort_key: Callable[[Any], int]):
        self.sort_key = sort_key
        self._keys: List[int] = []
        self._items: List[Any] = []

    def __len__(self) -> int:
        return len(self._items)

    def insert(self, t: Any) -> None:
        """Ordered insert (stream_archive.hpp:60-71). Ties keep arrival
        order (insert after equals, like upper-bound on equal keys keeps
        the reference's not-less-than placement stable for our purposes)."""
        k = self.sort_key(t)
        i = bisect.bisect_right(self._keys, k)
        self._keys.insert(i, k)
        self._items.insert(i, t)

    def purge(self, t: Any) -> int:
        """Drop every record strictly older than ``t``'s sort key
        (stream_archive.hpp:74-80).  Returns number purged."""
        k = self.sort_key(t)
        i = bisect.bisect_left(self._keys, k)
        del self._keys[:i]
        del self._items[:i]
        return i

    def purge_key(self, k: int) -> int:
        i = bisect.bisect_left(self._keys, k)
        del self._keys[:i]
        del self._items[:i]
        return i

    def win_range(self, t_s: Any, t_e: Any = None) -> Tuple[int, int]:
        """Index range [lo, hi) of records with sort key in
        [key(t_s), key(t_e)) -- the window extent query
        (stream_archive.hpp:106-127).  With ``t_e=None`` the range is
        open-ended (EOS flush, win_seq.hpp:539-543)."""
        lo = bisect.bisect_left(self._keys, self.sort_key(t_s))
        hi = len(self._keys) if t_e is None else bisect.bisect_left(
            self._keys, self.sort_key(t_e))
        return lo, hi

    def range_by_keys(self, k_lo: int, k_hi: int) -> Tuple[int, int]:
        """[lo, hi) covering sort keys in [k_lo, k_hi)."""
        return (bisect.bisect_left(self._keys, k_lo),
                bisect.bisect_left(self._keys, k_hi))

    def distance(self, t_s: Any, t_e: Any = None) -> int:
        lo, hi = self.win_range(t_s, t_e)
        return hi - lo

    def slice(self, lo: int, hi: int) -> List[Any]:
        return self._items[lo:hi]

    def items(self) -> List[Any]:
        return self._items

    def end(self) -> int:
        return len(self._items)
