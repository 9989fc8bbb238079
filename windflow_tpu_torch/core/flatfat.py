"""FlatFAT: flat fixed-size aggregator tree for incremental windows.

Re-design of reference ``wf/flatfat.hpp`` (prefix :81-105, suffix
:108-132, update :135-154, insert :210-294, remove :297-361, getResult
:364-390) -- the algorithm is Tangwongsan et al., "General Incremental
Sliding-Window Aggregation", VLDB 2015 (cited at flatfat.hpp:31-32).

A complete binary tree over a ring buffer of ``n`` leaves (n = power of
two): O(log n) amortized insert/evict, window result in O(log n),
supporting **non-commutative** combines by always folding leaves in
logical (oldest -> newest) order -- when the ring wraps, the result is
``suffix(front..end) ⊕ prefix(begin..back)``.

The host/CPU twin lives here; the device twin (trees in device memory,
level-wise updates and the FlatFAT query kernel, mirroring
flatfat_gpu.hpp's three kernels) is ops/flatfat_torch.py.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence


class FlatFAT:
    """Aggregator tree over values of an arbitrary type.

    Parameters
    ----------
    combine : (a, b) -> c            associative (not nec. commutative)
    empty   : () -> c                identity element factory
    n_leaves: ring capacity; rounded up to a power of two.
    """

    __slots__ = ("combine", "empty", "n", "tree", "front", "back", "count")

    def __init__(self, combine: Callable[[Any, Any], Any],
                 empty: Callable[[], Any], n_leaves: int):
        n = 1
        while n < max(2, n_leaves):
            n <<= 1
        self.combine = combine
        self.empty = empty
        self.n = n
        # heap layout: internal nodes [1, n), leaves [n, 2n)
        self.tree: List[Any] = [empty() for _ in range(2 * n)]
        self.front = 0   # ring index of the oldest element
        self.back = 0    # ring index one past the newest element
        self.count = 0

    # -- internals ---------------------------------------------------------
    def _update_paths(self, positions: Sequence[int]) -> None:
        """Recompute ancestors of the touched leaves level by level
        (the bulk-update strategy of flatfat.hpp:242-294: each level is
        refreshed once however many leaves changed under it)."""
        level = {(self.n + p) >> 1 for p in positions}
        while level:
            nxt = set()
            for node in level:
                self.tree[node] = self.combine(self.tree[2 * node],
                                               self.tree[2 * node + 1])
                if node > 1:
                    nxt.add(node >> 1)
            level = nxt

    def _range_query(self, lo: int, hi: int) -> Any:
        """Ordered fold of leaves [lo, hi] inclusive, O(log n), preserving
        left-to-right order for non-commutative combines (the role of
        prefix/suffix in flatfat.hpp:81-132)."""
        if lo > hi:
            return self.empty()
        left_parts: List[Any] = []
        right_parts: List[Any] = []
        lo += self.n
        hi += self.n + 1
        while lo < hi:
            if lo & 1:
                left_parts.append(self.tree[lo])
                lo += 1
            if hi & 1:
                hi -= 1
                right_parts.append(self.tree[hi])
            lo >>= 1
            hi >>= 1
        out: Optional[Any] = None
        for part in left_parts + right_parts[::-1]:
            out = part if out is None else self.combine(out, part)
        return out if out is not None else self.empty()

    # -- public API --------------------------------------------------------
    def __len__(self) -> int:
        return self.count

    @property
    def capacity(self) -> int:
        return self.n

    def insert(self, value: Any) -> None:
        self.insert_bulk([value])

    def insert_bulk(self, values: Sequence[Any]) -> None:
        """Append values at the back of the ring (flatfat.hpp:210-294)."""
        if self.count + len(values) > self.n:
            raise OverflowError("FlatFAT capacity exceeded")
        touched = []
        for v in values:
            self.tree[self.n + self.back] = v
            touched.append(self.back)
            self.back = (self.back + 1) % self.n
            self.count += 1
        self._update_paths(touched)

    def remove(self, k: int = 1) -> None:
        """Evict the k oldest values (flatfat.hpp:297-361)."""
        if k > self.count:
            raise IndexError("removing more than present")
        touched = []
        for _ in range(k):
            self.tree[self.n + self.front] = self.empty()
            touched.append(self.front)
            self.front = (self.front + 1) % self.n
            self.count -= 1
        self._update_paths(touched)

    def get_result(self) -> Any:
        """Fold of all live values in logical order (flatfat.hpp:364-390)."""
        if self.count == 0:
            return self.empty()
        back_incl = (self.back - 1) % self.n
        if self.front <= back_incl:
            return self._range_query(self.front, back_incl)
        # wrapped: suffix (front..n-1) then prefix (0..back_incl)
        return self.combine(self._range_query(self.front, self.n - 1),
                            self._range_query(0, back_incl))
