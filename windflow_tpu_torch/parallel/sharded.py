"""Sharded window aggregation over a ('key', 'win') mesh: the mesh
plane's engine.

The port of the reference's ``shard_map`` programs (windflow_tpu/
parallel/sharded.py), mapped onto the mesh of logical shards
(:mod:`.mesh`):

* **Key_Farm across shards** (:meth:`ShardedWindowEngine.compute_kf`):
  per-key series and window state are sharded over 'key'; every shard's
  windows are answered at once, with no traffic between shards.  On the
  card sums and means launch the window-sum kernel K1 and max/min/FFAT
  folds the fused FlatFAT build+query kernel K2r, once a call for all of
  the process's shards: the ``[S, T_pad]`` values flattened, the extents
  offset by ``s * T_pad``.
* **Win_MapReduce across shards** (:meth:`~ShardedWindowEngine.compute_wmr`):
  each window's tuples are striped over 'win'; every shard folds its
  stripe and the results are combined over 'win' (the reference's
  psum / pmax / pmin, or all_gather + :func:`pairwise_fold`).
* **Pane_Farm across shards** (:meth:`~ShardedWindowEngine.compute_pf_ring`):
  shards hold consecutive pane chunks; windows spanning chunks read
  their right neighbours' panes through ring hops.

Between the shards of one process a collective is a tensor op over the
stacked shard axis; across processes the key rows are computed where
they live and ``all_gather``ed (``torch.distributed``).  The WMR, ring
and fused-step programs are torch code on the mesh's device.

On the CPU (``device="cpu"``) sums and means take one f32 prefix scan a
row, as the reference's per-row cumsum; max/min/FFAT folds run K2r's
plain version.  On the card K1 sums each extent directly.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import minmax
from ..ops.cuda.flatfat_query import (BUILD_QUERY_MIN_LEAVES,
                                      flatfat_build_query, resolve_combine)
from ..ops.cuda.window_sum import next_pow2, window_sums


def pairwise_fold(x, combine, neutral):
    """Log-depth pairwise combine tree along the LAST axis (associative
    by the FFAT contract).  ``x`` is a numpy array (with a combine that
    takes numpy) or a torch tensor (with a torch combine): one
    implementation serves the host PLQ and the device programs."""
    is_torch = isinstance(x, torch.Tensor)
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            shape = tuple(x.shape[:-1]) + (1,)
            if is_torch:
                x = torch.cat([x, torch.full(shape, neutral, dtype=x.dtype,
                                             device=x.device)], dim=-1)
            else:
                x = np.concatenate([x, np.full(shape, neutral, x.dtype)],
                                   axis=-1)
        x = combine(x[..., 0::2], x[..., 1::2])
        if not is_torch:
            x = np.asarray(x)
    return x[..., 0]


def _resolve_kind(kind):
    """Normalize a mesh combine spec to (name, combine, neutral, lift).

    ``kind`` is a builtin name ('sum'/'count'/'mean'/'max'/'min') or an
    FFAT spec -- either the single-chip 3-tuple ('ffat', combine,
    neutral) that farms_tpu._ffat_kind produces (lift rides separately
    there) or the mesh 4-tuple ('ffat', lift, combine, neutral) with a
    columnar lift.  The combine is a binary torch function forming a
    monoid with the neutral (``ops/minmax.py``'s ``maximum`` and
    ``minimum`` for max and min: signed zeros in the reference's order);
    on the card it is compiled into K2r."""
    if isinstance(kind, tuple) and kind and kind[0] == "ffat":
        if len(kind) == 4:
            _, lift, combine, neutral = kind
        elif len(kind) == 3:
            lift, (_, combine, neutral) = None, kind
        else:
            raise ValueError(
                "FFAT mesh kind must be ('ffat', combine, neutral) or "
                "('ffat', lift, combine, neutral)")
        return "ffat", combine, float(neutral), lift
    if kind == "max":
        return "max", minmax.maximum, float("-inf"), None
    if kind == "min":
        return "min", minmax.minimum, float("inf"), None
    if kind in ("sum", "count", "mean"):
        return kind, None, 0.0, None
    raise ValueError(f"unknown mesh window kind: {kind!r}")


def _fold(x: torch.Tensor, kind: str, combine, neutral: float,
          dim: int) -> torch.Tensor:
    """Combine-fold along one axis: reductions for the builtins (max and
    min with signed zeros in the reference's order), the log-depth
    pairwise tree for an FFAT combine."""
    if kind in ("sum", "count"):
        return x.sum(dim)
    if kind == "max":
        return minmax.amax(x, dim)
    if kind == "min":
        return minmax.amin(x, dim)
    return pairwise_fold(x.movedim(dim, -1), combine, neutral)


def _offset_extents(starts: torch.Tensor, ends: torch.Tensor,
                    stride: int) -> torch.Tensor:
    """[S, B] per-shard extents as one packed int32 [2, S * B] into the
    flattened ``[S, stride]`` buffer (shard s at offset s * stride)."""
    off = torch.arange(starts.shape[0], dtype=torch.int64,
                       device=starts.device)[:, None] * stride
    return torch.stack([(starts.long() + off).reshape(-1),
                        (ends.long() + off).reshape(-1)]).to(
        torch.int32).contiguous()


def _row_scan_sums(v: torch.Tensor, starts: torch.Tensor,
                   ends: torch.Tensor) -> torch.Tensor:
    """[S, B] window sums of a CPU ``[S, T]`` buffer, one f32 prefix scan
    a row as the reference's ``kf_shard`` (a scan over every row laid
    end to end would carry the whole buffer's magnitude into each
    window).  ``end <= start``: an empty window, 0."""
    c = torch.cat([v.new_zeros(v.shape[0], 1), torch.cumsum(v, 1)], 1)
    s = starts.long()
    e = torch.maximum(ends.long(), s)
    return c.gather(1, e) - c.gather(1, s)


class ShardedWindowEngine:
    """Key-sharded window engine over a mesh (the distributed twin of
    WindowComputeEngine).  Its device is the mesh's.

    ``kind`` selects the combine (see :func:`_resolve_kind`): sums and
    means launch K1 over every shard's windows, counts are ``e - s``,
    max/min and FFAT combines build one FlatFAT over all shards and
    answer every extent with a range query in one K2r launch (the
    key_farm_gpu.hpp arbitrary-functor surface at mesh scale).  On the
    card an FFAT combine is resolved here: a user combine is lowered
    and compiled now, and one that cannot be lowered raises
    ``ValueError``."""

    def __init__(self, mesh, win_len: int, slide_len: int, kind="sum"):
        self.mesh = mesh
        self.win_len = win_len
        self.slide_len = slide_len
        self.kind, self.combine, self.neutral, self.lift = \
            _resolve_kind(kind)
        self.device = mesh.device
        self._tree_combine = self.combine
        if self.kind in ("max", "min", "ffat") \
                and self.device.type == "cuda":
            self._tree_combine = resolve_combine(self.combine)

    @property
    def n_key_shards(self) -> int:
        return self.mesh.shape["key"]

    @property
    def n_win_shards(self) -> int:
        return self.mesh.shape["win"]

    def _put(self, x, dtype) -> torch.Tensor:
        """This process's key rows of ``x`` on the mesh's device."""
        return self.mesh.local_rows(torch.as_tensor(x)).to(
            self.device, dtype).contiguous()

    def _gather(self, out: torch.Tensor) -> torch.Tensor:
        """The key-sharded result of every process, in key order."""
        if self.mesh.group is None:
            return out
        dist = torch.distributed
        parts = [torch.empty_like(out)
                 for _ in range(dist.get_world_size(self.mesh.group))]
        dist.all_gather(parts, out.contiguous(), group=self.mesh.group)
        return torch.cat(parts, 0)

    # -- Key_Farm across shards: the kernel path --------------------------
    def compute_kf(self, values, starts, ends) -> torch.Tensor:
        """Key-sharded window combines (the Key_Farm-across-shards path
        of operators.tpu.mesh_farm).  ``values`` is [K_shards, T],
        extents are [K_shards, B] index pairs into each shard's row
        (``end <= start``: an empty window, 0).  Returns f32
        [K_shards, B] on the mesh's device."""
        max_extent: Optional[int] = None
        if not isinstance(starts, torch.Tensor):
            # the widest extent picks K1's form; known on the host here
            max_extent = int(np.max(np.asarray(ends) - np.asarray(starts),
                                    initial=0))
        v = self._put(values, torch.float32)
        s = self._put(starts, torch.int32)
        e = self._put(ends, torch.int32)
        if self.kind == "count":
            out = (e - s).to(torch.float32)
        elif self.kind in ("sum", "mean"):
            S, T = v.shape
            if v.device.type == "cpu":
                out = _row_scan_sums(v, s, e)
            else:
                out = window_sums(v.reshape(-1), _offset_extents(s, e, T),
                                  max_extent).reshape(S, -1)
            if self.kind == "mean":
                out = out / torch.clamp(e - s, min=1)
        else:
            out = self._tree_fold(v, s, e)
        return self._gather(out)

    def _tree_fold(self, v: torch.Tensor, s: torch.Tensor,
                   e: torch.Tensor) -> torch.Tensor:
        """Every shard's windows folded by one K2r launch: the S rows
        laid end to end at a power-of-two stride in one tree of
        next_pow2(S) * stride leaves (at least BUILD_QUERY_MIN_LEAVES),
        the rest the neutral.  Each row's subtree is then exactly the
        per-row FlatFAT, so every extent folds the same nodes in the
        same order as a tree per row; empty extents give 0."""
        S, T = v.shape
        stride = next_pow2(T)
        n = max(BUILD_QUERY_MIN_LEAVES, next_pow2(S) * stride)
        leaves = torch.full((n,), self.neutral, dtype=torch.float32,
                            device=self.device)
        leaves[: S * stride].view(S, stride)[:, :T] = v
        out = flatfat_build_query(leaves, _offset_extents(s, e, stride),
                                  self._tree_combine, self.neutral)
        return out.reshape(S, -1)

    # -- Win_MapReduce across shards ---------------------------------------
    def compute_wmr(self, stripes) -> torch.Tensor:
        """Striped window combines over 'win' (the Win_MapReduce
        distribution, used by operators.tpu.wmr_mesh.WinMapReduceMesh).

        ``stripes``: [K_rows, W_shards, B, stripe_len] -- window b of
        row k holds its tuples round-robin striped over the 'win' axis
        (WinMap_Emitter's per-key round robin, wm_nodes.hpp:62), padded
        with the combine's neutral.  Each shard folds its stripe (the
        MAP stage); the REDUCE over 'win' is a sum over the shard axis,
        the reference's pmax / pmin (``ops/minmax.py``: shards folded in
        order, NaN passed over) for max and min, or the gathered
        partials folded by :func:`pairwise_fold` for an FFAT combine.
        Returns [K_rows, B]."""
        if self.kind == "mean":
            raise ValueError("WinMapReduceMesh does not support 'mean' "
                             "(stripe partials carry no count channel)")
        x = self._put(stripes, torch.float32)
        partial = _fold(x, self.kind, self.combine, self.neutral, -1)
        if self.kind in ("max", "min"):
            reduce = minmax.pmax if self.kind == "max" else minmax.pmin
            return self._gather(reduce(partial, 1))
        return self._gather(_fold(partial, self.kind, self.combine,
                                  self.neutral, 1))

    # -- Pane_Farm across shards: the ring ---------------------------------
    def compute_pf_ring(self, pane_values, pane_len: int) -> torch.Tensor:
        """Ring sequence-parallel pane combine.

        The pane timeline is sharded in consecutive chunks over 'win'
        (shard w holds panes [w*P_loc, (w+1)*P_loc)).  Sliding windows
        starting in a shard's chunk need at most ``wpp - 1`` panes from
        its right neighbours, fetched with ``hops`` one-step ring hops:
        the reference's ``ppermute`` with perm ``(i, (i - 1) % W)``, in
        which shard w *receives* shard w+1's block -- a roll by -1 along
        the shard axis.  Windows overrunning the global timeline end are
        masked to 0.

        pane_values: [K, W_shards * P_loc, pane_len].  Returns
        [K, W_shards * P_loc // spp] window results, windows in global
        time order."""
        wpp = max(1, self.win_len // pane_len)    # panes per window
        spp = max(1, self.slide_len // pane_len)  # panes per slide
        W = self.n_win_shards
        p_total = pane_values.shape[1]
        p_loc = p_total // W
        if p_loc % spp:
            raise ValueError(
                f"panes per shard ({p_loc}) must be a multiple of the "
                f"slide ({spp} panes) for the ring layout")
        hops = min(W - 1, -(-(wpp - 1) // p_loc))  # ceil, capped at ring
        n_loc_wins = p_loc // spp
        if self.kind == "mean":
            raise ValueError("PaneFarmMesh does not support 'mean' "
                             "(pane partials are not mean-decomposable "
                             "without a count channel)")
        x = self._put(pane_values, torch.float32)
        K = x.shape[0]
        partials = _fold(x.view(K, W, p_loc, x.shape[-1]), self.kind,
                         self.combine, self.neutral, -1)  # [K, W, P_loc]
        blocks, cur = [partials], partials
        for _ in range(hops):
            cur = torch.roll(cur, -1, dims=1)  # shard w gets w+1's block
            blocks.append(cur)
        ext = torch.cat(blocks, dim=-1)
        dev = self.device
        starts_l = torch.arange(n_loc_wins, device=dev) * spp
        # the clamp only protects windows masked below (for every valid
        # window g_start + wpp <= p_total implies the extent fits)
        idx = (starts_l[:, None] + torch.arange(wpp, device=dev)[None, :]
               ).clamp(max=ext.shape[-1] - 1)
        wins = _fold(ext[:, :, idx], self.kind, self.combine, self.neutral,
                     -1)                                  # [K, W, n_loc]
        g_start = torch.arange(W, device=dev)[:, None] * p_loc + starts_l
        ok = g_start + wpp <= p_total
        out = torch.where(ok, wins, torch.zeros((), device=dev))
        return self._gather(out.reshape(K, W * n_loc_wins))

    # -- the fused sharded step --------------------------------------------
    def step(self, values, starts, ends, stripe_values, pane_values):
        """One sharded streaming step (the reference's
        ``_sharded_programs`` step) as torch programs on the mesh's
        device:

        1. key-sharded sliding-window sums by cumsum differencing
           [K_shards, B] (KF path);
        2. stripe sums combined over 'win' [K_rows, 1, B2] (WMR path);
        3. pane partials gathered over 'win' into each row's timeline,
           then the sliding windows over it [K_rows, n_windows] (PF
           path)."""
        v = self._put(values, torch.float32)
        c = torch.cat([v.new_zeros(v.shape[0], 1), torch.cumsum(v, 1)], 1)
        kf = (torch.take_along_dim(c, self._put(ends, torch.int64), 1)
              - torch.take_along_dim(c, self._put(starts, torch.int64), 1))
        stripe = self._put(stripe_values, torch.float32)
        wmr = stripe.sum(-1).sum(1, keepdim=True)
        pane = self._put(pane_values, torch.float32)
        partials = pane.sum(-1).reshape(pane.shape[0], -1)  # [K, P_tot]
        pane_len = pane.shape[-1]
        wpp = max(1, self.win_len // pane_len)   # panes per window
        spp = max(1, self.slide_len // pane_len)  # panes per slide
        n_windows = max(1, (partials.shape[1] - wpp) // spp + 1)
        dev = self.device
        # clamped as the reference's gather clamps out-of-range indices
        idx = (torch.arange(n_windows, device=dev)[:, None] * spp
               + torch.arange(wpp, device=dev)[None, :]).clamp(
            max=partials.shape[1] - 1)
        pf = partials[:, idx].sum(-1)
        return self._gather(kf), self._gather(wmr), self._gather(pf)

    def example_inputs(self, T: int = 64, B: int = 8, keys_per_shard: int = 2,
                       stripe_w: int = 8, panes_per_shard: int = 4,
                       pane_len: int = 4):
        """Tiny inputs for compile checks and dry runs (the reference's
        draws from ``default_rng(0)``), on the mesh's device."""
        K = self.n_key_shards
        W = self.n_win_shards
        rng = np.random.default_rng(0)
        values = rng.normal(size=(K, T)).astype(np.float32)
        starts = np.tile(np.arange(B, dtype=np.int32) * 4, (K, 1))
        ends = starts + np.int32(self.win_len)
        stripe = rng.normal(
            size=(K * keys_per_shard, W, B, stripe_w)).astype(np.float32)
        pane = rng.normal(
            size=(K * keys_per_shard, W, panes_per_shard,
                  pane_len)).astype(np.float32)
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in (values, starts, ends, stripe, pane))
