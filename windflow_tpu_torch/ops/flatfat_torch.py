"""Device-resident FlatFAT in torch: the counterpart of the reference's
``windflow_tpu/ops/flatfat_jax.py``.

Trees are flat f32 arrays in heap layout (root at 1, leaves at
``[n, 2n)``, n a power of two).  The reference's jitted programs map to:

* ``_programs`` (:29-85) -> ``build_tree`` / :func:`update_tree`
  (level sweeps of strided combines; ``build_tree`` lives beside the
  plain versions in ``ops/cuda/flatfat_query.py``) and
  :func:`query_tree`, which runs the FlatFAT query kernel
  (``ops/cuda/flatfat_query.cu``; its plain version on the CPU).  The
  engine's ffat kind builds and queries in one launch of the fused
  build+query kernel instead (``flatfat_build_query``);
* ``_batched_programs`` (:88-210) -> the fused FlatFAT update+query
  kernel (``flatfat_update_query``: new leaves, their root paths and
  every window in one launch), fed by :func:`pack_step`; its plain
  version is the reference's own composition in torch: ``expand_runs``
  and ``update_sparse`` (scatter the new leaves, recompute only their
  root paths), then the plain query over two pieces a wrapping window;
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

from .cuda.flatfat_query import (FusedInputs, _levels, build_tree,
                                 flatfat_query, flatfat_update_query,
                                 resolve_combine, torch_combine)
from .device import resolve_device, stream_context



def _pow2_at_least(n: int, floor: int = 1) -> int:
    p = 1
    while p < max(floor, n):
        p <<= 1
    return p


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------

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


def _by_row(group_row: np.ndarray, rows: np.ndarray):
    """(order, ptr): items sorted stably by their row's group, and the
    CSR offsets [G + 1] of each group's items."""
    if len(group_row) == 1:  # one row: the resident FFAT lane's step
        return slice(None), np.array([0, len(rows)])
    g = np.searchsorted(group_row, rows)
    ptr = np.zeros(len(group_row) + 1, np.int64)
    np.cumsum(np.bincount(g, minlength=len(group_row)), out=ptr[1:])
    return np.argsort(g, kind="stable"), ptr


def pack_step(n: int, n_rows: int, run_rows, run_starts, run_lens, values,
              q_rows, q_starts, q_ends, pinned: bool = False):
    """One fused step's inputs, row-grouped, in ONE int32 host buffer
    (pinned when asked): ``groups | runs | queries | values`` as
    :class:`FusedInputs` lays them out.  Run r covers ``run_lens[r]``
    consecutive leaves from ring position ``run_starts[r] mod n`` with
    the next values of ``values`` (runs take them in order); a row's
    runs apply in the order given.  Window w is ids
    ``[q_starts[w], q_ends[w])`` of row ``q_rows[w]``, shipped as
    (start mod n, length): a window of exactly n leaves stays whole.
    Returns ``(buffer, (G, R, Q, V))``."""
    run_rows = np.asarray(run_rows, np.int64).reshape(-1)
    lens = np.asarray(run_lens, np.int64).reshape(-1)
    q_rows = np.asarray(q_rows, np.int64).reshape(-1)
    q_starts = np.asarray(q_starts, np.int64).reshape(-1)
    q_lens = np.maximum(np.asarray(q_ends, np.int64).reshape(-1) - q_starts,
                        0)
    values = np.asarray(values, np.float32).reshape(-1)
    R, Q, V = len(run_rows), len(q_rows), len(values)
    if R and (lens.min() < 0 or lens.max() > n):
        raise ValueError(f"a run must hold 0..{n} leaves (a longer one "
                         f"would overwrite its own leaves)")
    if int(lens.sum()) != V:
        raise ValueError("run lengths must add up to the values")
    if Q and q_lens.max() > n:
        raise ValueError("window extent exceeds tree capacity")
    group_row = np.unique(np.concatenate([run_rows, q_rows]))
    G = len(group_row)
    if G and (group_row[0] < 0 or group_row[-1] >= n_rows):
        raise ValueError(f"forest row outside [0, {n_rows})")
    r_order, run_ptr = _by_row(group_row, run_rows)
    q_order, q_ptr = _by_row(group_row, q_rows)
    nbuf = 3 * G + 2 + 3 * R + 3 * Q + V
    t = torch.empty(nbuf, dtype=torch.int32, pin_memory=pinned)
    buf = t.numpy()
    buf[:G] = group_row
    buf[G:2 * G + 1] = run_ptr
    buf[2 * G + 1:3 * G + 2] = q_ptr
    o = 3 * G + 2
    runs = buf[o:o + 3 * R].reshape(3, R)
    runs[0] = np.asarray(run_starts, np.int64).reshape(-1)[r_order] % n
    runs[1] = lens[r_order]
    runs[2] = (np.cumsum(lens) - lens)[r_order]
    o += 3 * R
    queries = buf[o:o + 3 * Q].reshape(3, Q)
    queries[0] = q_starts[q_order] % n
    queries[1] = q_lens[q_order]
    queries[2] = np.arange(Q)[q_order]
    buf[o + 3 * Q:].view(np.float32)[:] = values
    return t, (G, R, Q, V)


def step_inputs(buf: torch.Tensor, sizes) -> FusedInputs:
    """The :class:`FusedInputs` views of a :func:`pack_step` buffer (on
    whatever device it now lies)."""
    G, R, Q, V = sizes
    a = 3 * G + 2
    b = a + 3 * R
    c = b + 3 * Q
    return FusedInputs(buf[:a], buf[a:b].view(3, R), buf[b:c].view(3, Q),
                       buf[c:].view(torch.float32))


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

    def _kernel_combine(self, combine: Any) -> Any:
        """The combine as the kernels take it: on the card resolved now
        (a user combine lowered and built, or ``ValueError``), so no
        launch builds or raises; on the CPU as given."""
        if self.device.type == "cuda":
            return resolve_combine(combine)
        return combine

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
    = id % n), so ``n_leaves`` must cover the window span.  Every update
    and query is one step of the fused kernel: new leaves, their root
    paths only, then the windows; a window that wraps the ring folds its
    two pieces in time order inside the kernel, to keep non-commutative
    combines oldest -> newest.

    ``device`` defaults to the card; ``stream`` is the CUDA stream every
    launch and read of this forest runs on (None: the current one)."""

    def __init__(self, combine: Any, neutral: float, n_keys: int,
                 n_leaves: int, device: Union[str, torch.device] = "cuda",
                 stream: Optional["torch.cuda.Stream"] = None):
        super().__init__(device, stream)
        self.n = _pow2_at_least(n_leaves, 2)
        self.n_keys = n_keys
        self.neutral = float(neutral)
        self.combine = self._kernel_combine(combine)
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
        """A copy of the forest on the host, after every launch queued
        on its stream (a CPU forest is copied too: a snapshot must not
        change as the forest steps on)."""
        with self._ctx():
            host = self.tree.cpu()
        return host.numpy().copy() if host is self.tree else host.numpy()

    def load_tree(self, tree) -> None:
        """Replace the forest's contents (a snapshot's [K, 2n] array)."""
        with self._ctx():
            t = torch.as_tensor(np.asarray(tree, np.float32))
            self.tree = t.to(self.device).contiguous()
        self.n_keys = self.tree.shape[0]

    def _step(self, run_rows, run_starts, run_lens, values, q_rows,
              q_starts, q_ends) -> torch.Tensor:
        """One fused step on the forest's stream, without waiting: the
        inputs packed on the host, ONE (pinned, async) copy to the
        device, one launch of the fused kernel (its plain version on the
        CPU).  Returns the device result, f32 [Q] in window order."""
        pinned = self.device.type == "cuda"
        buf, sizes = pack_step(self.n, self.tree.shape[0], run_rows,
                               run_starts, run_lens, values, q_rows,
                               q_starts, q_ends, pinned=pinned)
        with self._ctx():
            if pinned:
                buf = buf.to(self.device, non_blocking=True)
            return flatfat_update_query(self.tree, step_inputs(buf, sizes),
                                        self.combine, self.neutral)

    def update_runs_query_launch(self, rows, starts, lens, values,
                                 q_keys, q_starts, q_ends) -> torch.Tensor:
        """Fused scatter + root-path recompute + range query, launched
        on the forest's stream without waiting: each (rows[i],
        starts[i], lens[i]) names a CONSECUTIVE run of new leaves for
        one key (``starts`` may be absolute ids); windows are ids
        [q_starts, q_ends) of row q_keys, answered against the
        post-update forest.  Returns the device result f32 [B], which
        :meth:`finish_query` brings to the host."""
        return self._step(rows, starts, lens, values, q_keys, q_starts,
                          q_ends)

    def update_query_launch(self, keys, ids, values, q_keys, q_starts,
                            q_ends) -> torch.Tensor:
        """Position form of :meth:`update_runs_query_launch`: values at
        ring positions ids % n for their keys.  Neighbouring values of
        one key at consecutive positions go as one run (of at most n)."""
        keys = np.asarray(keys, np.int64).reshape(-1)
        pos = np.asarray(ids, np.int64).reshape(-1) % self.n
        brk = np.ones(len(keys), bool)
        brk[1:] = (keys[1:] != keys[:-1]) | (pos[1:] != (pos[:-1] + 1)
                                             % self.n)
        first = np.flatnonzero(brk)
        within = np.arange(len(keys)) - first[np.cumsum(brk) - 1]
        first = np.flatnonzero(brk | (within % self.n == 0))
        lens = np.diff(np.append(first, len(keys)))
        return self._step(keys[first], pos[first], lens, values, q_keys,
                          q_starts, q_ends)

    def finish_query(self, dev_out: torch.Tensor) -> np.ndarray:
        """One launch's window results on the host, after the launch on
        the forest's stream."""
        with self._ctx():
            return dev_out.cpu().numpy()

    def update_runs_query(self, rows, starts, lens, values, q_keys,
                          q_starts, q_ends) -> np.ndarray:
        """Blocking form of :meth:`update_runs_query_launch`."""
        return self.finish_query(self.update_runs_query_launch(
            rows, starts, lens, values, q_keys, q_starts, q_ends))

    def update_query(self, keys, ids, values, q_keys, q_starts,
                     q_ends) -> np.ndarray:
        """Blocking form of :meth:`update_query_launch`."""
        return self.finish_query(self.update_query_launch(
            keys, ids, values, q_keys, q_starts, q_ends))

    def update(self, keys, ids, values) -> None:
        """Insert values at ring positions ids % n for their keys."""
        self.update_query_launch(keys, ids, values, [], [], [])

    def query(self, keys, starts, ends) -> np.ndarray:
        """Window results for extents [starts, ends) in id space (end -
        start <= n): a step with no new leaves."""
        return self.update_runs_query([], [], [], [], keys, starts, ends)


class FlatFATTorch(_OnDevice):
    """Stateful single-tree wrapper (the twin of ``FlatFATJax``).

    ``combine`` must form a monoid with identity ``neutral``; it need
    not be commutative -- fold order is preserved oldest->newest.  On
    the card it is resolved at construction (:class:`BatchedFlatFAT`
    alike): a combine the kernels cannot compile raises there."""

    def __init__(self, combine: Callable, neutral: float, n_leaves: int,
                 device: Union[str, torch.device] = "cuda",
                 stream: Optional["torch.cuda.Stream"] = None):
        super().__init__(device, stream)
        self.n = _pow2_at_least(n_leaves, 2)
        self.neutral = float(neutral)
        self.combine = self._kernel_combine(combine)
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
