"""Device-resident FlatFAT in torch: the counterpart of the reference's
``windflow_tpu/ops/flatfat_jax.py``.

Trees are flat f32 arrays in heap layout (root at 1, leaves at
``[n, 2n)``, n a power of two).  The reference's jitted programs map to:

* ``_programs`` (:29-85) -> :func:`build_tree` / :func:`update_tree`
  (level sweeps of strided combines) and :func:`query_tree`, which runs
  the FlatFAT query kernel (``ops/cuda/flatfat_query.cu``; its plain
  version on the CPU);
* ``_batched_programs`` (:88-210) -> :func:`update_sparse` (scatter the
  new leaves, recompute only their root paths), :func:`expand_runs`, and
  the fused :func:`update_and_query` / :func:`update_runs_and_query`;
* :class:`BatchedFlatFAT` / :class:`FlatFATTorch`, the stateful
  wrappers.

The reference donated its forest to each jitted update and got a new
array back.  Here a forest is ONE tensor updated in place, on the
owner's CUDA stream: code that swaps in a new forest (a grow) must never
copy or reuse the old tensor while launches queued against it are in
flight.  In-place scatters with duplicate indices are unordered on CUDA,
so invalid lanes keep the reference's rule of writing heap slot 0 (never
read: the root lives at 1) with the value they read there.  Every read
of a forest from the host goes through the owner's stream.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from .cuda.flatfat_query import _levels, flatfat_query, torch_combine
from .device import resolve_device, stream_context


def _pow2_at_least(n: int, floor: int = 1) -> int:
    p = 1
    while p < max(floor, n):
        p <<= 1
    return p


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------

def build_tree(leaves: torch.Tensor, combine: Any,
               neutral: float) -> torch.Tensor:
    """The tree [2n] over ``leaves`` [n]: one strided combine per level."""
    comb = torch_combine(combine)
    n = leaves.shape[0]
    levels = _levels(n)
    tree = torch.full((2 * n,), neutral, dtype=torch.float32,
                      device=leaves.device)
    tree[n:] = leaves
    for j in range(levels - 1, -1, -1):  # level j holds 2^j nodes
        lo = 1 << j
        children = tree[2 * lo: 4 * lo]
        tree[lo: 2 * lo] = comb(children[0::2], children[1::2])
    return tree


def update_tree(tree: torch.Tensor, positions: torch.Tensor,
                values: torch.Tensor, valid: torch.Tensor,
                combine: Any) -> torch.Tensor:
    """Scatter new leaves into a single tree [2n] in place, then
    recompute every level (the reference's whole-level sweep)."""
    comb = torch_combine(combine)
    n = tree.shape[0] // 2
    levels = _levels(n)
    idx = torch.where(valid, positions.long() + n, 0)
    tree[idx] = torch.where(valid, values, tree[idx])
    for j in range(levels - 1, -1, -1):
        lo = 1 << j
        children = tree[2 * lo: 4 * lo]
        tree[lo: 2 * lo] = comb(children[0::2], children[1::2])
    return tree


def query_tree(tree: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
               combine: Any, neutral: float,
               rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fold leaves [start, end) per window (``rows`` picks each window's
    tree of a forest): the FlatFAT query kernel on CUDA."""
    return flatfat_query(tree, rows, starts.to(torch.int32).contiguous(),
                         ends.to(torch.int32).contiguous(), combine, neutral)


def update_sparse(tree: torch.Tensor, keys: torch.Tensor,
                  positions: torch.Tensor, values: torch.Tensor,
                  valid: torch.Tensor, combine: Any) -> torch.Tensor:
    """Scatter new leaves at (key, pos) of a forest [K, 2n] in place,
    then recompute ONLY the touched root paths: O(B log n) work.
    Duplicate parents get identical recomputed values, and invalid lanes
    write heap slot 0 of row 0 with its own value, so the unordered
    duplicate-index scatters of CUDA cannot clobber a real update."""
    comb = torch_combine(combine)
    two_n = tree.shape[-1]
    levels = _levels(two_n // 2)
    flat = tree.view(-1)
    row = torch.where(valid, keys.long(), 0) * two_n
    idx = torch.where(valid, positions.long() + two_n // 2, 0)
    lin = row + idx
    flat[lin] = torch.where(valid, values, flat[lin])
    for _ in range(levels):
        idx = idx >> 1
        child = row + 2 * idx
        node = row + idx
        flat[node] = torch.where(valid, comb(flat[child], flat[child + 1]),
                                 flat[node])
    return tree


def expand_runs(run_rows: torch.Tensor, run_starts: torch.Tensor,
                run_lens: torch.Tensor, n_values: int, n: int):
    """(keys, ring positions, valid) of ``n_values`` leaf slots from
    (row, start, len) run descriptors: run r covers the next ``len``
    values at consecutive ring positions from ``start``.  Expanded on
    the device, so a launch ships 12 bytes per run, not 8 per leaf."""
    lens = run_lens.long()
    cum = torch.cumsum(lens, 0)  # int64, as the searched values
    v = torch.arange(n_values, dtype=torch.int64, device=lens.device)
    r = torch.searchsorted(cum, v, right=True).clamp(max=lens.shape[0] - 1)
    base = cum[r] - lens[r]
    pos = (run_starts.long()[r] + (v - base)) % n
    return run_rows.long()[r], pos, v < cum[-1]


def update_and_query(tree, keys, positions, values, valid, q_rows,
                     q_starts, q_ends, combine, neutral) -> torch.Tensor:
    """The fused launch of the resident lane: scatter the new leaves,
    recompute their root paths, then answer every due window against
    the POST-update forest."""
    update_sparse(tree, keys, positions, values, valid, combine)
    return query_tree(tree, q_starts, q_ends, combine, neutral, rows=q_rows)


def update_runs_and_query(tree, run_rows, run_starts, run_lens, values,
                          q_rows, q_starts, q_ends, combine,
                          neutral) -> torch.Tensor:
    """Run-descriptor form of :func:`update_and_query`."""
    keys, pos, valid = expand_runs(run_rows, run_starts, run_lens,
                                   values.shape[0], tree.shape[-1] // 2)
    return update_and_query(tree, keys, pos, values, valid, q_rows,
                            q_starts, q_ends, combine, neutral)


# ---------------------------------------------------------------------------
# stateful wrappers
# ---------------------------------------------------------------------------

class _OnDevice:
    """Host arrays -> device tensors on the owner's device and stream
    (staged in pinned memory on CUDA, so the copies do not stall)."""

    def __init__(self, device, stream):
        self.device = resolve_device(device)
        self._stream = stream

    def _ctx(self):
        return stream_context(self.device, self._stream)

    def _put(self, host: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(host))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)


class BatchedFlatFAT(_OnDevice):
    """Device-resident per-key FlatFAT forest (the ``rebuild=false``
    incremental mode of Win_SeqFFAT_GPU).

    One [K, 2n] tensor holds every key's aggregator tree across batches;
    leaves form a circular buffer over each key's series (leaf position
    = id % n), so ``n_leaves`` must cover the window span.  Updates touch
    only the modified root paths; range queries that wrap the ring are
    answered in two ordered pieces combined on the host in time order,
    to keep non-commutative combines oldest -> newest.

    ``device`` defaults to the card; ``stream`` is the CUDA stream every
    launch and read of this forest runs on (None: the current one)."""

    def __init__(self, combine: Any, neutral: float, n_keys: int,
                 n_leaves: int, device: Union[str, torch.device] = "cuda",
                 stream: Optional["torch.cuda.Stream"] = None):
        super().__init__(device, stream)
        self.n = _pow2_at_least(n_leaves, 2)
        self.n_keys = n_keys
        self.neutral = float(neutral)
        self.combine = combine
        # leaves start as neutral; internal nodes of a neutral-filled
        # tree are neutral (monoid identity), so no build pass is needed
        with self._ctx():
            self.tree = torch.full((n_keys, 2 * self.n), self.neutral,
                                   dtype=torch.float32, device=self.device)

    @property
    def state_bytes(self) -> int:
        """Resident footprint of the forest in device memory (the
        ``Device_state_bytes_resident`` gauge)."""
        return self.tree.numel() * self.tree.element_size()

    def tree_numpy(self) -> np.ndarray:
        """The forest on the host, after every launch queued on its
        stream."""
        with self._ctx():
            return self.tree.cpu().numpy()

    def load_tree(self, tree) -> None:
        """Replace the forest's contents (a snapshot's [K, 2n] array)."""
        with self._ctx():
            t = torch.as_tensor(np.asarray(tree, np.float32))
            self.tree = t.to(self.device).contiguous()
        self.n_keys = self.tree.shape[0]

    def _leaves(self, keys, ids, values):
        """(keys, ring positions, values, valid) on the device, padded
        to a pow2 bucket of at least 512 lanes."""
        keys = np.asarray(keys)
        b = _pow2_at_least(len(keys), 512)
        k = np.zeros(b, np.int64)
        p = np.zeros(b, np.int64)
        v = np.full(b, self.neutral, np.float32)
        ok = np.zeros(b, bool)
        k[: len(keys)] = keys
        p[: len(keys)] = np.asarray(ids) % self.n
        v[: len(keys)] = values
        ok[: len(keys)] = True
        return self._put(k), self._put(p), self._put(v), self._put(ok)

    def update(self, keys, ids, values) -> None:
        """Insert values at ring positions ids % n for their keys."""
        with self._ctx():
            update_sparse(self.tree, *self._leaves(keys, ids, values),
                          self.combine)

    def _pack_queries(self, keys, starts, ends):
        """Pad query extents to a pow2 bucket with ring-wrap handling:
        a wrapping range [s, e) is answered as two ordered pieces
        ([s, n) then [0, e mod n)) so non-commutative combines keep
        oldest -> newest order.  A piece that is not asked for is
        empty (end = start), which the kernel answers with the neutral
        element.  Returns (k2, s2, e2, wraps, B)."""
        keys = np.asarray(keys, np.int64)
        starts = np.asarray(starts, np.int64)
        ends = np.asarray(ends, np.int64)
        if np.any(ends - starts > self.n):
            raise ValueError("window extent exceeds tree capacity")
        s = starts % self.n
        e_raw = ends % self.n
        wraps = (ends > starts) & (e_raw <= s)
        B = len(keys)
        b = _pow2_at_least(2 * B, 256)
        k2 = np.zeros(b, np.int32)
        s2 = np.zeros(b, np.int32)
        e2 = np.zeros(b, np.int32)
        # piece 1: [s, wrap ? n : e_raw)
        k2[:B] = keys
        s2[:B] = s
        e2[:B] = np.where(ends > starts, np.where(wraps, self.n, e_raw), s)
        # piece 2 (wrapping only): [0, e_raw)
        k2[B:2 * B] = keys
        e2[B:2 * B] = np.where(wraps, e_raw, 0)
        return k2, s2, e2, wraps, B

    def _combine_pieces(self, out: np.ndarray, wraps: np.ndarray,
                        B: int) -> np.ndarray:
        head, tail = out[:B], out[B:2 * B]
        if not wraps.any():
            return head
        combined = torch_combine(self.combine)(
            torch.from_numpy(head), torch.from_numpy(tail)).numpy()
        return np.where(wraps, combined, head)

    def _queries(self, q_keys, q_starts, q_ends):
        k2, s2, e2, wraps, B = self._pack_queries(q_keys, q_starts, q_ends)
        packed = self._put(np.concatenate([k2, s2, e2]))
        b = len(k2)
        return packed[:b], packed[b:2 * b], packed[2 * b:], wraps, B

    def update_query_launch(self, keys, ids, values, q_keys, q_starts,
                            q_ends):
        """Fused scatter + root-path recompute + range query, launched
        on the forest's stream without waiting.  Returns ``(dev_out,
        wraps, B)``: the device result (2B wrap pieces) plus what
        :meth:`finish_query` needs to resolve it on the host."""
        with self._ctx():
            qk, qs, qe, wraps, B = self._queries(q_keys, q_starts, q_ends)
            out = update_and_query(self.tree,
                                   *self._leaves(keys, ids, values), qk, qs,
                                   qe, self.combine, self.neutral)
        return out, wraps, B

    def update_runs_query_launch(self, rows, starts, lens, values,
                                 q_keys, q_starts, q_ends):
        """Run-descriptor form of :meth:`update_query_launch`: each
        (rows[i], starts[i], lens[i]) names a CONSECUTIVE run of new
        leaves for one key; positions expand on the device.  ``starts``
        may be absolute ids (reduced mod n on the host)."""
        rows = np.asarray(rows, np.int64)
        lens = np.asarray(lens, np.int64)
        total = int(lens.sum())
        R = len(rows)
        rb = _pow2_at_least(R, 8)
        runs = np.zeros(3 * rb, np.int32)
        runs[:R] = rows
        runs[rb:rb + R] = np.asarray(starts, np.int64) % self.n
        runs[2 * rb:2 * rb + R] = lens
        v = np.full(_pow2_at_least(total, 512), self.neutral, np.float32)
        v[:total] = values
        with self._ctx():
            qk, qs, qe, wraps, B = self._queries(q_keys, q_starts, q_ends)
            runs_d = self._put(runs)
            out = update_runs_and_query(
                self.tree, runs_d[:rb], runs_d[rb:2 * rb],
                runs_d[2 * rb:], self._put(v), qk, qs, qe, self.combine,
                self.neutral)
        return out, wraps, B

    def finish_query(self, dev_out: torch.Tensor, wraps,
                     B: int) -> np.ndarray:
        """One launch's query results on the host (ring-wrap pieces
        combined in time order), after the launch on the forest's
        stream."""
        with self._ctx():
            host = dev_out.cpu().numpy()
        return self._combine_pieces(host, wraps, B)

    def update_runs_query(self, rows, starts, lens, values, q_keys,
                          q_starts, q_ends) -> np.ndarray:
        """Blocking form of :meth:`update_runs_query_launch`."""
        dev, wraps, B = self.update_runs_query_launch(
            rows, starts, lens, values, q_keys, q_starts, q_ends)
        return self.finish_query(dev, wraps, B)

    def update_query(self, keys, ids, values, q_keys, q_starts,
                     q_ends) -> np.ndarray:
        """Blocking form of :meth:`update_query_launch`."""
        dev, wraps, B = self.update_query_launch(keys, ids, values,
                                                 q_keys, q_starts, q_ends)
        return self.finish_query(dev, wraps, B)

    def query(self, keys, starts, ends) -> np.ndarray:
        """Window results for extents [starts, ends) in id space (end -
        start <= n); wrapping ranges are combined as (tail, head) to
        keep time order."""
        with self._ctx():
            qk, qs, qe, wraps, B = self._queries(keys, starts, ends)
            out = query_tree(self.tree, qs, qe, self.combine, self.neutral,
                             rows=qk)
        return self.finish_query(out, wraps, B)


class FlatFATTorch(_OnDevice):
    """Stateful single-tree wrapper (the twin of ``FlatFATJax``).

    ``combine`` must form a monoid with identity ``neutral``; it need
    not be commutative -- fold order is preserved oldest->newest."""

    def __init__(self, combine: Callable, neutral: float, n_leaves: int,
                 device: Union[str, torch.device] = "cuda",
                 stream: Optional["torch.cuda.Stream"] = None):
        super().__init__(device, stream)
        self.n = _pow2_at_least(n_leaves, 2)
        self.neutral = float(neutral)
        self.combine = combine
        self.build(np.empty(0, np.float32))

    def build(self, leaves: np.ndarray) -> None:
        padded = np.full(self.n, self.neutral, np.float32)
        padded[: len(leaves)] = leaves
        with self._ctx():
            self.tree = build_tree(self._put(padded), self.combine,
                                   self.neutral)

    def update(self, positions: np.ndarray, values: np.ndarray) -> None:
        b = _pow2_at_least(len(positions))
        pos = np.zeros(b, np.int64)
        val = np.full(b, self.neutral, np.float32)
        ok = np.zeros(b, bool)
        pos[: len(positions)] = positions
        val[: len(values)] = values
        ok[: len(positions)] = True
        with self._ctx():
            update_tree(self.tree, self._put(pos), self._put(val),
                        self._put(ok), self.combine)

    def query_ranges(self, starts: np.ndarray,
                     ends: np.ndarray) -> np.ndarray:
        with self._ctx():
            out = query_tree(self.tree,
                             self._put(np.asarray(starts, np.int32)),
                             self._put(np.asarray(ends, np.int32)),
                             self.combine, self.neutral)
            return out.cpu().numpy()
