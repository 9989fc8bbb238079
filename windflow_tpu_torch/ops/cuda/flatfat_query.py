"""Batched FlatFAT range query: the hand-written Hopper kernel and its
plain twin.

``flatfat_query(tree, rows, starts, ends, combine, neutral)`` folds, for
each window ``b``, the leaves ``[starts[b], ends[b])`` of the heap-layout
tree in row ``rows[b]`` of a forest ``tree [K, 2n]`` (f32, n a power of
two, root at 1, leaves at ``[n, 2n)``) and returns f32 ``[B]``; an extent
with ``end <= start`` gives ``neutral``.  A single tree is ``[2n]`` (or
``[1, 2n]``) with ``rows=None``.  The fold is the O(log n) bit-walk with
separate left and right accumulators, so a non-commutative ``combine``
keeps oldest -> newest order; ``combine`` and ``neutral`` form a monoid.

* On a CUDA tensor it launches ``flatfat_query.cu`` (one thread per
  window; built with nvcc for ``sm_90a`` into ``windflow_tpu_torch/
  _build/`` on first use and bound through ctypes) on the current
  stream.  The kernel's combine is compiled in.  ``torch.add``,
  ``torch.maximum`` and ``torch.minimum`` (and the builtin names
  ``sum``/``count``/``max``/``min``) are in the library built from the
  source as it stands; any other combine is lowered from its torch ops
  to C++ (:mod:`.combine_lower`) and compiled into a library of its own,
  ``_build/libwf_flatfat_query_<key>.so``, keyed by the lowered text.
  :func:`resolve_combine` does both and returns a :class:`KernelCombine`
  that every entry takes in place of the combine; it raises
  ``ValueError`` for a combine that cannot be lowered.  A build or
  launch failure raises: there is no fallback.
* On a CPU tensor it runs :func:`flatfat_query_plain`, the torch form of
  the reference's ``_query_body`` (windflow_tpu/ops/flatfat_jax.py:149),
  for any torch combine.

The kernel replaces the Pallas TPU kernel
``windflow_tpu/ops/pallas/flatfat_query.py`` (``_build``'s kernel, entry
``flatfat_query_ranges``).  ``launch_count()`` counts kernel launches so
a run can show that its main path went through the kernel.

``flatfat_update_query(forest, inputs, combine, neutral)`` is the
resident lanes' whole step in one launch of the second entry of the same
source: it writes runs of new leaves into a forest ``[K, 2n]`` in place,
recomputes their root paths and answers every window against the
post-update rows, returning f32 ``[Q]``.  ``inputs`` is a
:class:`FusedInputs` (row-grouped CSR; ``flatfat_torch.pack_step`` builds
it).  It replaces the reference's fused program
``_batched_programs.update_runs_and_query`` (windflow_tpu/ops/
flatfat_jax.py:188-207) and its Pallas query.  The same rules hold: the
kernel on a CUDA tensor, :func:`flatfat_update_query_plain`
on a CPU tensor, its own count in ``fused_launch_count()``.

``flatfat_build_query(leaves, se, combine, neutral)`` is the FFAT
rebuild lane's whole launch in one cooperative launch of the third entry:
it builds the tree over ``leaves [n]`` (n a power of two, at least 2048)
into a scratch array of this call, answers every window of the packed
int32 extents ``se [2, B]`` and returns f32 ``[B]``, 0 for a window with
``end <= start``.  It replaces the reference's jitted ``_ffat_program``
/ ``_ffat_pallas_program`` (windflow_tpu/ops/window_compute.py:224,
:282).  The kernel on a CUDA tensor (or ``unported``),
:func:`flatfat_build_query_plain` (:func:`build_tree`, the plain query,
the reference's ``where``) on a CPU tensor, its own count in
``build_query_launch_count()``.

Each count covers every combine; :func:`user_launch_counts` counts the
launches of user-combine libraries apart, per entry, so a run can show
that it went through a generated kernel.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from ...runtime.build import BUILD_DIR, build_shared, nvcc_command
from .combine_lower import combine_key, lower_combine

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "flatfat_query.cu")
_LIB_NAME = "libwf_flatfat_query.so"

_lib = None
_builtin_lock = threading.Lock()
_lib_lock = threading.Lock()  # the user-library tables
_launches = 0
_fused_launches = 0
_build_query_launches = 0
_count_lock = threading.Lock()
# entry -> launches of user-combine libraries
_ENTRIES = ("flatfat_query", "flatfat_update_query", "flatfat_build_query")
_user_launches = dict.fromkeys(_ENTRIES, 0)

# combine -> the op code of the library built from flatfat_query.cu as
# it stands; a user combine's library holds op code USER_OP only
_BUILTIN_OPS = {torch.add: 0, torch.maximum: 1, torch.minimum: 2,
                "sum": 0, "count": 0, "max": 1, "min": 2}
USER_OP = 3
_BUILTIN_FNS = {"sum": torch.add, "count": torch.add, "max": torch.maximum,
                "min": torch.minimum}

# lowered-body key -> its library; combine -> its KernelCombine
_user_libs: Dict[str, ctypes.CDLL] = {}
_user_lib_locks: Dict[str, threading.Lock] = {}
_resolved: Dict[Any, "KernelCombine"] = {}


class KernelCombine(NamedTuple):
    """A combine resolved for the card: its torch function (what the
    plain versions run), the library that holds its kernels and its op
    code there; ``user`` marks a generated library."""
    fn: Callable
    lib: ctypes.CDLL
    code: int
    user: bool


def builtin_op(combine: Any) -> Optional[int]:
    """The op code of a builtin combine (compiled into the library
    built from the source as it stands), or None."""
    try:
        return _BUILTIN_OPS.get(combine)
    except TypeError:  # unhashable callable
        return None


def resolve_combine(combine: Any) -> KernelCombine:
    """``combine`` resolved for the kernels: a builtin to the shared
    library's op code, any other torch callable lowered to C++ and
    compiled into its own library (built on first use, shared by equal
    combines).  Raises ``ValueError`` for a combine that cannot be
    lowered.  Bind-time work: the engines resolve once and launch with
    the result."""
    if isinstance(combine, KernelCombine):
        return combine
    try:
        hit = _resolved.get(combine)
    except TypeError:  # unhashable: resolved every time
        hit = None
    if hit is not None:
        return hit
    code = builtin_op(combine)
    if code is not None:
        k = KernelCombine(torch_combine(combine), load_kernel(), code, False)
    else:
        k = KernelCombine(combine, load_user_kernel(lower_combine(combine)),
                          USER_OP, True)
    try:
        _resolved[combine] = k
    except TypeError:
        pass
    return k


def torch_combine(combine: Any) -> Callable:
    """``combine`` as a binary torch function (builtin names resolved)."""
    if isinstance(combine, str):
        return _BUILTIN_FNS[combine]
    if isinstance(combine, KernelCombine):
        return combine.fn
    return combine


def _levels(n: int) -> int:
    levels = n.bit_length() - 1
    if n < 1 or 1 << levels != n:
        raise ValueError(f"FlatFAT capacity must be a power of two, not {n}")
    return levels


# ---------------------------------------------------------------------------
# plain version
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


def flatfat_query_plain(tree: torch.Tensor, rows: Optional[torch.Tensor],
                        starts: torch.Tensor, ends: torch.Tensor,
                        combine: Any, neutral: float) -> torch.Tensor:
    """The bit-walk for every window at once, in torch (any combine)."""
    comb = torch_combine(combine)
    forest = tree.reshape(-1, tree.shape[-1])
    n_rows, two_n = forest.shape
    n = two_n // 2
    levels = _levels(n)
    flat = forest.reshape(-1)
    dev = tree.device
    B = starts.shape[0]
    if rows is None:
        row = torch.zeros(B, dtype=torch.int64, device=dev)
    else:
        row = rows.long()
    bad_row = (row < 0) | (row >= n_rows)
    base = row.clamp(0, n_rows - 1) * two_n
    s = starts.long().clamp(0, n)
    e = ends.long().clamp(0, n)
    valid = e > s
    lo, hi = s + n, e + n
    left = torch.full((B,), neutral, dtype=torch.float32, device=dev)
    right = left.clone()
    for _ in range(levels + 1):
        take_l = (lo < hi) & ((lo & 1) == 1)
        lval = flat[base + lo.clamp(max=two_n - 1)]
        left = torch.where(take_l, comb(left, lval), left)
        lo = torch.where(take_l, lo + 1, lo)
        take_r = (lo < hi) & ((hi & 1) == 1)
        hi = torch.where(take_r, hi - 1, hi)
        rval = flat[base + hi.clamp(max=two_n - 1)]
        right = torch.where(take_r, comb(rval, right), right)
        lo = lo >> 1
        hi = hi >> 1
    out = torch.where(valid, comb(left, right),
                      torch.full_like(left, neutral))
    return torch.where(bad_row, torch.full_like(out, float("nan")), out)


def expand_runs(run_rows: torch.Tensor, run_starts: torch.Tensor,
                run_lens: torch.Tensor, n_values: int, n: int):
    """(keys, ring positions, valid) of ``n_values`` leaf slots from
    (row, start, len) run descriptors: run r covers the next ``len``
    values at consecutive ring positions from ``start``.  Expanded on
    the device, so a step ships 12 bytes per run, not 8 per leaf."""
    lens = run_lens.long()
    cum = torch.cumsum(lens, 0)  # int64, as the searched values
    v = torch.arange(n_values, dtype=torch.int64, device=lens.device)
    r = torch.searchsorted(cum, v, right=True).clamp(max=lens.shape[0] - 1)
    base = cum[r] - lens[r]
    pos = (run_starts.long()[r] + (v - base)) % n
    return run_rows.long()[r], pos, v < cum[-1]


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


class FusedInputs(NamedTuple):
    """One fused step's inputs, row-grouped, as the kernel reads them
    (int32 unless named; all on the forest's device, usually views of
    one staged buffer).

    ``groups`` [3G + 2]: the G forest rows the step touches, then
    ``run_ptr`` [G + 1] and ``q_ptr`` [G + 1], CSR offsets of each row's
    runs and windows.  ``runs`` [3, R]: ring start (mod n), length and
    offset into ``values`` of each run of new leaves, a row's runs in
    the order they apply.  ``queries`` [3, Q]: ring start (mod n),
    length and output index of each window.  ``values`` f32 [V]."""
    groups: torch.Tensor
    runs: torch.Tensor
    queries: torch.Tensor
    values: torch.Tensor

    @property
    def n_groups(self) -> int:
        return (self.groups.shape[0] - 2) // 3


def flatfat_update_query_plain(forest: torch.Tensor, inputs: FusedInputs,
                               combine: Any, neutral: float) -> torch.Tensor:
    """The fused step in torch, from the same packed inputs: the runs'
    leaves through :func:`expand_runs` and :func:`update_sparse`, then
    each window as two ordered pieces ([s, min(e, n)) and, past the
    ring's end, [0, e - n)) through :func:`flatfat_query_plain`,
    combined in time order."""
    comb = torch_combine(combine)
    n = forest.shape[-1] // 2
    G = inputs.n_groups
    dev = forest.device
    grp = inputs.groups.long()
    rows, run_ptr, q_ptr = grp[:G], grp[G:2 * G + 1], grp[2 * G + 1:]
    starts, lens, voffs = inputs.runs
    n_leaves = int(lens.sum())
    if n_leaves:
        run_rows = torch.repeat_interleave(rows, run_ptr.diff())
        keys, pos, valid = expand_runs(run_rows, starts, lens, n_leaves, n)
        # run r's i-th leaf takes values[voffs[r] + i]: the same expansion
        # over the value offsets
        vidx = expand_runs(run_rows, voffs, lens, n_leaves,
                           inputs.values.shape[0])[1]
        update_sparse(forest, keys, pos, inputs.values[vidx], valid, comb)
    q_starts, q_lens, q_out = inputs.queries.long()
    q_rows = torch.repeat_interleave(rows, q_ptr.diff()).to(torch.int32)
    e = q_starts + q_lens
    wraps = (q_lens > 0) & (e >= n)
    ends1 = torch.where(wraps, n, e)
    ends2 = torch.where(wraps, e - n, 0)
    pieces = flatfat_query_plain(
        forest, torch.cat([q_rows, q_rows]),
        torch.cat([q_starts, torch.zeros_like(q_starts)]).to(torch.int32),
        torch.cat([ends1, ends2]).to(torch.int32), comb, neutral)
    Q = q_starts.shape[0]
    head, tail = pieces[:Q], pieces[Q:]
    res = torch.where(wraps, comb(head, tail), head)
    out = torch.empty(Q, dtype=torch.float32, device=dev)
    out[q_out] = res
    return out


def flatfat_build_query_plain(leaves: torch.Tensor, se: torch.Tensor,
                              combine: Any, neutral: float) -> torch.Tensor:
    """The rebuild lane's launch in torch: :func:`build_tree` over the
    leaves, the plain query for every window, and 0 where ``end <=
    start``, as the reference's ``jnp.where(valid, out, 0)``."""
    tree = build_tree(leaves, combine, neutral)
    out = flatfat_query_plain(tree, None, se[0], se[1], combine, neutral)
    return torch.where(se[1] > se[0], out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

def _bind(path: str) -> ctypes.CDLL:
    """Load one library of flatfat_query.cu and type its three entries
    (its own handle, symbols local: every library exports the same
    names)."""
    lib = ctypes.CDLL(path)
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.wf_flatfat_query.restype = ctypes.c_int
    lib.wf_flatfat_query.argtypes = [
        ptr, i64, i64, i64, ptr, ptr, ptr, ptr, i64, ctypes.c_float, i64,
        ptr]
    lib.wf_flatfat_update_query.restype = ctypes.c_int
    lib.wf_flatfat_update_query.argtypes = [
        ptr, i64, i64, i64, ptr, i64, ptr, i64, ptr, i64, ptr, i64,
        ptr, ctypes.c_float, i64, ptr]
    lib.wf_flatfat_build_query.restype = ctypes.c_int
    lib.wf_flatfat_build_query.argtypes = [
        ptr, i64, ptr, i64, ptr, ptr, ctypes.c_float, i64, ptr]
    return lib


def _build(name: str, cmd, srcs) -> str:
    try:
        return build_shared(name, cmd, srcs)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"flatfat_query kernel build failed ({name}):\n{e.stderr}") \
            from e


def load_kernel() -> ctypes.CDLL:
    """Build (once per source change) and bind the library of the
    builtin combines."""
    global _lib
    with _builtin_lock:  # not _lib_lock: user builds go on meanwhile
        if _lib is None:
            _lib = _bind(_build(_LIB_NAME, nvcc_command(_SRC), [_SRC]))
        return _lib


def user_source(body: str) -> str:
    """The generated source of a user combine's library: its lowered
    body as ``WF_USER_COMBINE_BODY``, then flatfat_query.cu."""
    return ("// Generated by windflow_tpu_torch/ops/cuda/flatfat_query.py: "
            "the FlatFAT\n// kernels under one user FFAT combine "
            "(combine_lower.py).\n"
            f"#define WF_USER_COMBINE_BODY {body}\n"
            '#include "flatfat_query.cu"\n')


def load_user_kernel(body: str) -> ctypes.CDLL:
    """Build (once per lowered body and source change) and bind the
    library of one user combine: ``_build/libwf_flatfat_query_<key>.so``,
    compiled from a generated file that defines the body and includes
    flatfat_query.cu.  Threads and processes that ask for the same body
    at once build it once (a lock per key here, ``build_shared``'s file
    lock across processes)."""
    key = combine_key(body)
    with _lib_lock:
        lib = _user_libs.get(key)
        if lib is not None:
            return lib
        lock = _user_lib_locks.setdefault(key, threading.Lock())
    with lock:
        lib = _user_libs.get(key)
        if lib is not None:
            return lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        gen = os.path.join(BUILD_DIR, f"wf_flatfat_query_{key}.cu")
        text = user_source(body)
        try:
            with open(gen) as f:
                same = f.read() == text
        except OSError:
            same = False
        # rewritten only when it differs: its mtime is one of the
        # library's sources, so a needless write would force a rebuild
        if not same:
            tmp = f"{gen}.{os.getpid()}.{threading.get_ident()}.tmp"
            with open(tmp, "w") as f:
                f.write(text)
            os.replace(tmp, gen)
        cmd = nvcc_command(gen, include_dirs=[os.path.dirname(_SRC)])
        lib = _bind(_build(f"libwf_flatfat_query_{key}.so", cmd,
                           [_SRC, gen]))
        with _lib_lock:
            _user_libs[key] = lib
        return lib


def launch_count() -> int:
    return _launches


def reset_launch_count() -> None:
    global _launches
    with _count_lock:
        _launches = 0


def fused_launch_count() -> int:
    return _fused_launches


def reset_fused_launch_count() -> None:
    global _fused_launches
    with _count_lock:
        _fused_launches = 0


def build_query_launch_count() -> int:
    return _build_query_launches


def reset_build_query_launch_count() -> None:
    global _build_query_launches
    with _count_lock:
        _build_query_launches = 0


def user_launch_counts() -> Dict[str, int]:
    """Launches of user-combine libraries, per entry (``flatfat_query``,
    ``flatfat_update_query``, ``flatfat_build_query``); each is also in
    that entry's own count."""
    with _count_lock:
        return dict(_user_launches)


def reset_user_launch_counts() -> None:
    with _count_lock:
        for e in _ENTRIES:
            _user_launches[e] = 0


def _counted(entry: str, k: KernelCombine) -> None:
    global _launches, _fused_launches, _build_query_launches
    with _count_lock:
        if entry == "flatfat_query":
            _launches += 1
        elif entry == "flatfat_update_query":
            _fused_launches += 1
        else:
            _build_query_launches += 1
        if k.user:
            _user_launches[entry] += 1


def _check(tree: torch.Tensor, rows: Optional[torch.Tensor],
           starts: torch.Tensor, ends: torch.Tensor) -> None:
    if tree.dtype != torch.float32 or tree.dim() not in (1, 2):
        raise ValueError("tree must be a float32 [2n] or [K, 2n] tensor")
    if tree.shape[-1] % 2:
        raise ValueError("tree rows must hold 2n nodes")
    _levels(tree.shape[-1] // 2)
    idx = [starts, ends] + ([rows] if rows is not None else [])
    for t in idx:
        if t.dtype != torch.int32 or t.dim() != 1 \
                or t.shape[0] != starts.shape[0]:
            raise ValueError("rows, starts and ends must be int32 [B] "
                             "tensors of one length")
    if any(t.device != tree.device for t in idx):
        raise ValueError("tree and extents must be on the same device")
    if not all(t.is_contiguous() for t in [tree] + idx):
        raise ValueError("tree and extents must be contiguous")


def flatfat_query(tree: torch.Tensor, rows: Optional[torch.Tensor],
                  starts: torch.Tensor, ends: torch.Tensor, combine: Any,
                  neutral: float) -> torch.Tensor:
    """The per-window fold as f32 [B]: the CUDA kernel for a CUDA tensor
    (``combine`` resolved by :func:`resolve_combine`, or a
    :class:`KernelCombine` it returned), the plain version for a CPU
    tensor."""
    _check(tree, rows, starts, ends)
    if tree.device.type == "cpu":
        return flatfat_query_plain(tree, rows, starts, ends, combine,
                                   neutral)
    if tree.device.type != "cuda":
        raise ValueError(f"unsupported device {tree.device}")
    k = resolve_combine(combine)
    n_windows = starts.shape[0]
    out = torch.empty(n_windows, dtype=torch.float32, device=tree.device)
    if n_windows == 0:
        return out
    two_n = tree.shape[-1]
    n_rows = tree.numel() // two_n
    with torch.cuda.device(tree.device):
        stream = torch.cuda.current_stream(tree.device).cuda_stream
        rc = k.lib.wf_flatfat_query(
            tree.data_ptr(), two_n // 2, _levels(two_n // 2), n_rows,
            rows.data_ptr() if rows is not None else None,
            starts.data_ptr(), ends.data_ptr(), out.data_ptr(), n_windows,
            float(neutral), k.code, stream)
    if rc != 0:
        raise RuntimeError(f"flatfat_query kernel launch failed: "
                           f"cudaError {rc}")
    _counted("flatfat_query", k)
    return out


def _check_fused(forest: torch.Tensor, inputs: FusedInputs) -> None:
    if forest.dtype != torch.float32 or forest.dim() != 2 \
            or forest.shape[-1] % 2:
        raise ValueError("forest must be a float32 [K, 2n] tensor")
    _levels(forest.shape[-1] // 2)
    g, r, q, v = inputs
    if g.dim() != 1 or g.shape[0] % 3 != 2 or r.dim() != 2 \
            or r.shape[0] != 3 or q.dim() != 2 or q.shape[0] != 3:
        raise ValueError("groups must be int32 [3G + 2], runs and queries "
                         "int32 [3, R] and [3, Q]")
    if any(t.dtype != torch.int32 for t in (g, r, q)) or v.dim() != 1 \
            or v.dtype != torch.float32:
        raise ValueError("groups, runs and queries must be int32, values "
                         "float32 [V]")
    if any(t.device != forest.device for t in inputs):
        raise ValueError("forest and step inputs must be on one device")
    if not all(t.is_contiguous() for t in (forest,) + tuple(inputs)):
        raise ValueError("forest and step inputs must be contiguous")


def flatfat_update_query(forest: torch.Tensor, inputs: FusedInputs,
                         combine: Any, neutral: float) -> torch.Tensor:
    """One resident-lane step as f32 [Q]: the fused CUDA kernel for a
    CUDA forest (``combine`` resolved as :func:`flatfat_query` takes it),
    the plain version for a CPU one.  Updates ``forest`` in place."""
    _check_fused(forest, inputs)
    if forest.device.type == "cpu":
        return flatfat_update_query_plain(forest, inputs, combine, neutral)
    if forest.device.type != "cuda":
        raise ValueError(f"unsupported device {forest.device}")
    k = resolve_combine(combine)
    Q = inputs.queries.shape[1]
    out = torch.empty(Q, dtype=torch.float32, device=forest.device)
    G = inputs.n_groups
    if G == 0:
        return out
    two_n = forest.shape[-1]
    with torch.cuda.device(forest.device):
        stream = torch.cuda.current_stream(forest.device).cuda_stream
        rc = k.lib.wf_flatfat_update_query(
            forest.data_ptr(), two_n // 2, _levels(two_n // 2),
            forest.shape[0], inputs.groups.data_ptr(), G,
            inputs.runs.data_ptr(), inputs.runs.shape[1],
            inputs.queries.data_ptr(), Q, inputs.values.data_ptr(),
            inputs.values.shape[0], out.data_ptr(), float(neutral), k.code,
            stream)
    if rc != 0:
        raise RuntimeError(f"flatfat_update_query kernel launch failed: "
                           f"cudaError {rc}")
    _counted("flatfat_update_query", k)
    return out


# the fused build+query kernel's smallest tree: two tiles of 1024 leaves
BUILD_QUERY_MIN_LEAVES = 2048


def _check_build_query(leaves: torch.Tensor, se: torch.Tensor) -> None:
    if leaves.dtype != torch.float32 or leaves.dim() != 1:
        raise ValueError("leaves must be a 1-D float32 tensor")
    n = leaves.shape[0]
    _levels(n)
    if not BUILD_QUERY_MIN_LEAVES <= n <= 1 << 30:
        raise ValueError(f"leaves must number {BUILD_QUERY_MIN_LEAVES} .. "
                         f"2^30, not {n}")
    if se.dtype != torch.int32 or se.dim() != 2 or se.shape[0] != 2:
        raise ValueError("se must be an int32 [2, B] tensor")
    if leaves.device != se.device:
        raise ValueError("leaves and se must be on the same device")
    if not (leaves.is_contiguous() and se.is_contiguous()):
        raise ValueError("leaves and se must be contiguous")
    if leaves.data_ptr() % 16:
        raise ValueError("leaves must be 16-byte aligned")


def flatfat_build_query(leaves: torch.Tensor, se: torch.Tensor,
                        combine: Any, neutral: float) -> torch.Tensor:
    """The tree over ``leaves`` and the fold of every window of ``se``
    as f32 [B] (0 where ``end <= start``): one launch of the fused CUDA
    kernel for a CUDA tensor (``combine`` resolved as
    :func:`flatfat_query` takes it), the plain version for a CPU
    tensor."""
    _check_build_query(leaves, se)
    if leaves.device.type == "cpu":
        return flatfat_build_query_plain(leaves, se, combine, neutral)
    if leaves.device.type != "cuda":
        raise ValueError(f"unsupported device {leaves.device}")
    k = resolve_combine(combine)
    n_windows = se.shape[1]
    out = torch.empty(n_windows, dtype=torch.float32, device=leaves.device)
    if n_windows == 0:
        return out
    n = leaves.shape[0]
    with torch.cuda.device(leaves.device):
        # this launch's own tree: several launches of the lane are in
        # flight, each allocated on the stream it runs on
        nodes = torch.empty(n, dtype=torch.float32, device=leaves.device)
        stream = torch.cuda.current_stream(leaves.device).cuda_stream
        rc = k.lib.wf_flatfat_build_query(
            leaves.data_ptr(), n, se.data_ptr(), n_windows,
            nodes.data_ptr(), out.data_ptr(), float(neutral), k.code, stream)
    if rc != 0:
        raise RuntimeError(f"flatfat_build_query kernel launch failed: "
                           f"cudaError {rc}")
    _counted("flatfat_build_query", k)
    return out
