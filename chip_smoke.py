"""Chip smoke test of the PyTorch/CUDA port (windflow_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; the last line is printed only when
every phase passed):

1. device  -- the CUDA card's name, and its name and power limit as
   nvidia-smi reports them.
2. build   -- window_sum.cu (the window-sum kernel K1, two forms) and
   flatfat_query.cu (the FlatFAT query kernel K2, the fused FlatFAT
   update+query kernel and the fused build+query kernel of the rebuild
   lane), nvcc for sm_90a, and the native C++ engine (g++), built from
   the checkout's sources in parallel into windflow_tpu_torch/_build/.
3. kernel  -- K1, the window-sum kernel, in both forms (a thread per
   window, the engine's choice up to extents of 32; a warp per window
   with float4 loads above) against its plain torch version and a
   float64 numpy sum on the card, at the headline launch shape (pane
   partials, B = 4096, 2-pane extents), the pane-rebuild cell's launch
   (1,024 windows of 64 panes, padded to 2,048), a wide raw-tuple shape
   (extents up to 4096 over T = 2^21), 12,288 such extents laid end to
   end (~100 MB, each value read once, from HBM: the streaming rate)
   and edge cases (empty extents, extents ending at T, single elements):
   exact on integer data, rtol 1e-5 on random f32.  First the launch floor: the thread form's device
   time on one window.  Per shape: device time of the form the engine
   takes and of both forms (torch.profiler), its ratio to the floor, the
   bytes the function must move and their share of the card's HBM rate,
   the plain version's time and a sparse CSR mv's.
   kernel K2 -- the FlatFAT query kernel against its plain torch version
   for add, max, min and the non-commutative left_weighted test combine,
   at the rebuild lane's launch shape of bench config 15 (one tree of
   T_pad = 2^17 leaves, B = 4096 windows), the resident shape before the
   fused kernel (16 rows x 8192 leaves, ring-wrap pieces), a
   deployment-size forest (4096 rows x 8192 leaves = 256 MiB, 65,536
   queries up to 4096 leaves) and edges (empty extents, [0, n), n = 2,
   end = n): exact for max/min and for add on integer data, rtol 1e-5 on
   random f32.  Per shape: device time, the bound (extents, output and
   each tree node the queries need, read once), the plain version's time
   and, for add, a sparse CSR mv.
   kernel K2 rebuild -- the fused build+query kernel against its plain
   version (build_tree, the plain query, the where) and the chain the
   rebuild lane ran before it (build_tree's torch sweep, K2, the where),
   bitwise for the four combines on integer and random f32 leaves, at
   the rebuild lane's launch (2^17 leaves, 4096 windows), two tiles
   (2048 leaves) with edges (empty and reversed extents, [0, n), end =
   n) and two tiling rounds (2^22 leaves).  At the rebuild shape: device
   time, the launch floor (2048 leaves, one window), the pre-PR chain's
   device time, the bound (leaves and extents read, output written
   once), the plain version's time and a sparse CSR mv's.
   kernel K2 fused (run first, before any phase starts the profiler) --
   the fused update+query kernel against its plain
   version on the same packed inputs, results and forests after the
   step, for the four combines, at the resident FFAT lane's step (forest
   [16, 2 x 8192], one 1024-leaf run crossing the ring's end, 64 windows
   of 4096, half wrapping), the resident pane lane's step (the carry's
   forest [16, 2 x 2048], a 128-pane run for each of 8 keys, 1024
   windows), a deployment-size forest (4096 x 8192, one 64-leaf run a
   row, 16 windows a row) and edges (n = 16 and n = 2, two runs on one
   row, an empty run, a row with windows and no run, windows of 0 and n
   leaves): exact for max/min and for add on integer data, rtol 1e-5 on
   random f32.  Per main shape: device time, the bound (the staged
   inputs and the output once, each dirty node written once, each clean
   node the update or the walks read once), the plain version's time,
   and one whole step as a lane pays it (host staging to host result,
   perf_counter and CUDA events) against the chain of torch ops and the
   query kernel that ran before the fused kernel.
4. main    -- the headline graph, bench.py config 2 (64M events, 64
   keys, TB window 4096 / slide 2048, source batch 2^20, device batch
   4096, buffer 2^21, 8 in flight, 10 ms delay), through PipeGraph ->
   BatchSource -> WinSeqTPU -> Sink of the port, with the native lane
   active and the kernel launched on every batch; every window's
   (key, id, value) is held exactly against a closed-form numpy oracle
   of the synthetic law.  Prints tuples/s, windows, p50/p99 window
   latency.
5. profile -- the main path once more under torch.profiler: the
   device's busy and idle share and its top device ops.
6. main15  -- bench.py config 15_resident_state at its full size (8M
   events, 8 keys, CB window 4096 / slide 16, source batch 65,536)
   through PipeGraph -> BatchSource -> lane -> Sink of the port, for the
   FFAT rebuild lane (WinSeqTPU(("ffat", torch.add, 0.0)), batch 128,
   buffer 2^21, 8 in flight; the fused build+query kernel per launch)
   and the resident FFAT lane (WinSeqFFATResident; the fused
   update+query kernel per launch): every window equal between the
   lanes and to a closed-form float64 oracle, shipped bytes per launch
   rebuild/resident >= 10x, each lane's kernel launches equal to its
   launched batches and the other kernels not launched.  Prints
   tuples/s, window latency p50/p99 and the forest's resident bytes.
7. resident pane -- WinSeqTPU("sum", 4096, 64, CB) with value_of on the
   same stream, promoted by the planner onto the resident pane lane (the
   fused kernel per launch), against resident=False (K1 per launch):
   bitwise equal, equal to the oracle, launches checked as in main15.
   Phases 6 and 7 run twice back to back; each cell's two readings are
   printed side by side.
8. flatfat -- FlatFATTorch, the single tree a user builds, updates and
   queries (the one path left that launches the query-only K2): built
   over 2^17 leaves, queried, updated, queried, exact against float64
   sums, two K2 launches and nothing else.
9. profile15 -- both FFAT lanes once more at the full 8M events under
   torch.profiler: device busy and idle share and the top device ops;
   the rebuild lane's only kernel must be the fused build+query kernel.

Then one JSON line describing each kernel, the card line, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import json
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch

# bench.py config 2 (the headline)
N_EVENTS = 64_000_000
N_KEYS = 64
WIN = 4096
SLIDE = 2048
SOURCE_BATCH = 1_048_576
DEVICE_BATCH = 4096
MAX_BUFFER = 1 << 21
INFLIGHT = 8
DELAY_MS = 10.0
VMOD = 97

# published peaks of one H100 SXM (NVIDIA data sheet), at 700 W
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

RTOL_F32 = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def build_all() -> None:
    from windflow_tpu_torch.ops.cuda import flatfat_query, window_sum
    from windflow_tpu_torch.runtime import native

    results = {}

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            results[name] = (fn(), time.perf_counter() - t0)
        except BaseException as e:  # re-raised on the main thread
            results[name] = (e, time.perf_counter() - t0)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(n, f)) for n, f in
               (("window_sum.cu (nvcc)", window_sum.load_kernel),
                ("flatfat_query.cu (nvcc)", flatfat_query.load_kernel),
                ("native/*.cpp (g++)", native.get_lib))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, (res, secs) in results.items():
        if isinstance(res, BaseException):
            raise RuntimeError(f"build of {name} failed") from res
        if res is None:
            raise RuntimeError(f"build of {name} failed (toolchain "
                               f"unavailable or compile error)")
        log(f"[build] {name}: {secs:.1f} s")
    log(f"[build] total (parallel): {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 3. kernel against its plain version
# ---------------------------------------------------------------------------

def headline_extents(n_keys=N_KEYS, per_key=DEVICE_BATCH // N_KEYS):
    """The launch shape the headline's native lane produces: per key,
    ``per_key + 1`` pane partials and ``per_key`` windows of 2 panes
    sliding by one pane."""
    starts, ends = [], []
    off = 0
    for _ in range(n_keys):
        s = off + np.arange(per_key)
        starts.append(s)
        ends.append(s + WIN // SLIDE)
        off += per_key + 1
    return off, np.concatenate(starts), np.concatenate(ends)


def wide_extents(rng, T=1 << 21, B=4096, max_w=4096):
    lens = rng.integers(1, max_w + 1, B)
    starts = rng.integers(0, T - max_w, B)
    return T, starts, starts + lens


def disjoint_extents(rng, B=3 * 4096, max_w=4096):
    """The wide shape's extent lengths laid end to end, three times as
    many (~100 MB of values in a buffer of 2^25, twice the 50 MB L2):
    every value is read once and repeated calls cannot keep them in L2,
    so the kernel's rate here is its streaming rate from HBM (the wide
    shape's windows overlap and re-read from L2)."""
    lens = rng.integers(1, max_w + 1, B)
    ends = np.cumsum(lens)
    return 1 << 25, ends - lens, ends


def edge_extents(T=5000):
    starts = np.array([0, 7, 100, T - 1, T, T, 0, 4999, 128, 127])
    ends = np.array([0, 7, 101, T, T, T, T, 5000, 256, 129])
    return T, starts, ends


def pack(starts, ends, device):
    B = len(starts)
    se = np.zeros((2, B), np.int32)
    se[0], se[1] = starts, ends
    return torch.from_numpy(se).to(device)


def float64_sums(values: np.ndarray, starts, ends) -> np.ndarray:
    c = np.concatenate([[0.0], np.cumsum(values.astype(np.float64))])
    return c[ends] - c[starts]


def device_busy_ms(prof) -> float:
    """Device time of every kernel and copy a torch.profiler capture
    saw (CUPTI traces kernels launched outside torch too)."""
    return sum(getattr(e, "self_device_time_total", 0)
               for e in prof.key_averages()) / 1e3


def timed(fn, reps: int = 50, warmup: int = 5):
    """(device ms per call, wall ms per call) of ``fn`` on the card.

    Device time: torch.profiler's CUPTI record of the kernels and copies
    of ``reps`` calls, over ``reps`` -- what the card spends, without
    the host's launch overhead (None if the profiler saw no device
    activity).  Wall time: median of single calls bracketed by CUDA
    events, which includes the host's launch path while the card
    waits."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = device_busy_ms(prof)
    return (busy / reps if busy > 0 else None), float(np.median(times))


def fmt(t) -> str:
    dev, wall = t
    return (f"{dev:.5f}" if dev is not None else "not measured") + \
        f" ({wall:.4f})"


def work_of(T: int, starts, ends):
    """(bytes, adds) the function needs on these inputs: each value
    inside some extent read once, the extents read once, the sums
    written once; one add per element of each extent."""
    cover = np.zeros(T + 1, np.int64)
    np.add.at(cover, starts, 1)
    np.add.at(cover, ends, -1)
    touched = int((np.cumsum(cover[:T]) > 0).sum())
    B = len(starts)
    return 4 * touched + 8 * B + 4 * B, int((ends - starts).sum())


def bound_ms(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def csr_of(T: int, starts, ends, device):
    """The extents as a [B, T] 0/1 CSR matrix: the library yardstick
    computes the window sums as one sparse matrix-vector product."""
    lens = ends - starts
    crow = np.concatenate([[0], np.cumsum(lens)])
    cols = np.concatenate([np.arange(s, e) for s, e in zip(starts, ends)]
                          or [np.empty(0, np.int64)])
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.from_numpy(crow).to(device),
            torch.from_numpy(cols).to(device),
            torch.ones(len(cols), dtype=torch.float32, device=device),
            size=(len(starts), T), check_invariants=True)


def pane_extents():
    """The pane-rebuild cell's launch (config 15's stream through
    WinSeqTPU("sum", 4096, 64) with resident=False): a 65,536-event
    chunk gives each of the 8 keys 128 new pane partials after 63
    carried ones and fires 128 windows of 64 panes a key; the engine
    pads T = 1,528 and B = 1,024 to 2,048 (padding windows (0, 0))."""
    w = WIN15 // PANE_SLIDE
    per_key = PANE_NEW + w - 1
    s = (np.arange(KEYS15)[:, None] * per_key
         + np.arange(PANE_NEW)[None, :]).ravel()
    starts = np.zeros(2048, np.int64)
    ends = np.zeros(2048, np.int64)
    starts[:len(s)], ends[:len(s)] = s, s + w
    return 2048, starts, ends


# a hint that picks each form of the window-sum kernel (either form is
# right for any extent; the engine passes the batch's widest extent)
K1_FORM_HINTS = {"thread": 0, "warp": None}


def check_kernel(device, card: str) -> dict:
    from windflow_tpu_torch.ops.cuda import window_sum as ws
    rng = np.random.default_rng(0)
    shapes = {"headline": headline_extents(), "pane": pane_extents(),
              "wide": wide_extents(rng),
              "wide_disjoint": disjoint_extents(rng),
              "edges": edge_extents()}
    # the launch floor: the form the headline takes, on one window
    one = pack([0], [2], device)
    tiny = torch.ones(8, dtype=torch.float32, device=device)
    t_floor = timed(lambda: ws.window_sums(tiny, one, max_extent=2))
    floor_ms = t_floor[0] if t_floor[0] is not None else t_floor[1]
    log(f"[kernel] launch floor: the thread form on one window, device ms "
        f"per call (wall ms per call) {fmt(t_floor)} ({card})")
    entry = None
    worst_err = 0.0
    for name, (T, starts, ends) in shapes.items():
        se = pack(starts, ends, device)
        # the engine's hint: the batch's widest extent, known on the host
        hint = int((ends - starts).max())
        form = ws.form_for(hint)
        # integer data: every sum below 2^24, so kernel, plain version
        # and the float64 oracle must agree exactly -- bounded by the
        # widest extent where the plain version sums tiles, by the whole
        # buffer where it takes the prefix scan
        hi = max(2, (1 << 24) // (T if hint > 32 else hint))
        ints = rng.integers(0, hi, T).astype(np.float32)
        f32 = rng.random(T, dtype=np.float32)
        p = ws.window_sums_plain(torch.from_numpy(ints).to(device),
                                 se).cpu().numpy()
        ref = float64_sums(ints, starts, ends)
        if not np.array_equal(p, ref):
            raise AssertionError(f"[kernel] {name}: plain version not exact "
                                 f"on integers, err {np.abs(p - ref).max()}")
        ref32 = float64_sums(f32, starts, ends)
        # both forms: exact on integers, rtol 1e-5 on random f32
        for fname, fhint in K1_FORM_HINTS.items():
            vals = torch.from_numpy(ints).to(device)
            k = ws.window_sums(vals, se, max_extent=fhint).cpu().numpy()
            if not np.array_equal(k, ref):
                raise AssertionError(
                    f"[kernel] {name} {fname} form: integer data not "
                    f"exact: err {np.abs(k - ref).max()}")
            worst_err = max(worst_err, float(np.abs(k - p).max()))
            vals = torch.from_numpy(f32).to(device)
            k = ws.window_sums(vals, se, max_extent=fhint).cpu().numpy()
            np.testing.assert_allclose(
                k, ref32, rtol=RTOL_F32, atol=0,
                err_msg=f"[kernel] {name} {fname} form: random f32")
        vals = torch.from_numpy(f32).to(device)
        k = ws.window_sums(vals, se, max_extent=hint).cpu().numpy()
        p = ws.window_sums_plain(vals, se).cpu().numpy()
        f32_err = float(np.abs(k - p).max())
        if name == "headline":
            # the plain version takes the tile form here: the same two
            # adds as the kernel
            np.testing.assert_allclose(k, p, rtol=1e-6, atol=0,
                                       err_msg="[kernel] headline vs plain")
            worst_err = max(worst_err, f32_err)
        torch.cuda.synchronize()
        t_forms = {f: timed(lambda: ws.window_sums(vals, se, max_extent=h))
                   for f, h in K1_FORM_HINTS.items()}
        t_k = t_forms[form]
        t_p = timed(lambda: ws.window_sums_plain(vals, se), reps=20)
        csr = csr_of(T, starts, ends, device)
        t_l = timed(lambda: torch.mv(csr, vals), reps=20)
        # device time where the profiler saw it, else the call's wall
        ms, plain_ms, lib_ms = (d if d is not None else w
                                for d, w in (t_k, t_p, t_l))
        lib = torch.mv(csr, vals).cpu().numpy()
        np.testing.assert_allclose(lib, ref32, rtol=RTOL_F32, atol=0,
                                   err_msg=f"[kernel] {name}: library")
        nbytes, ops = work_of(T, starts, ends)
        bms, bound_by = bound_ms(nbytes, ops)
        share = nbytes / (ms * 1e-3) / HBM_BYTES_PER_S
        # what direct summation reads: every window its own extent
        read = 4 * int(np.maximum(ends - starts, 0).sum())
        log(f"[kernel] {name}: T={T} B={len(starts)} max_extent={hint} -> "
            f"{form} form; both forms exact on integers, rtol {RTOL_F32} on "
            f"f32; f32 |kernel-plain|max={f32_err:.3g}; device ms per call "
            f"(wall ms per call): kernel {fmt(t_k)} (thread form "
            f"{fmt(t_forms['thread'])}, warp form {fmt(t_forms['warp'])}), "
            f"{ms / floor_ms:.2f}x the launch floor; plain {fmt(t_p)}, "
            f"sparse mv {fmt(t_l)}; bound {bms:.4g} ms ({bound_by}), "
            f"{nbytes} B moved = {100 * share:.2f}% of HBM peak at the "
            f"kernel's device time; the windows' own extents are {read} B, "
            f"{read / (ms * 1e-3) / 1e12:.3f} TB/s ({card})")
        if name == "headline":
            entry = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": bound_by, "library_ms": lib_ms}
    entry["max_abs_err"] = worst_err
    return entry


# ---------------------------------------------------------------------------
# 4. main path
# ---------------------------------------------------------------------------

def oracle(n_events: int):
    """Closed form of the synthetic law under TB windows, float64:
    key k holds ts 0..M-1 (M = n/keys) with value (ts*keys + k) % 97;
    window w covers ts [w*slide, w*slide + win), and every window opened
    by a tuple fires (partial tail windows flush at EOS)."""
    assert n_events % N_KEYS == 0
    M = n_events // N_KEYS
    keys = np.arange(N_KEYS)
    t = np.arange(VMOD)
    # partial[k, r] = sum_{t < r} (t*keys + k) % 97; the law has period 97
    per = (t[None, :] * N_KEYS + keys[:, None]) % VMOD
    partial = np.concatenate([np.zeros((N_KEYS, 1), np.int64),
                              np.cumsum(per, axis=1)], axis=1)
    full = int(per[0].sum())

    def prefix(n):  # [keys, W] prefix sums at ts n
        return (n // VMOD) * full + np.take_along_axis(partial, n % VMOD,
                                                       axis=1)

    n_win = (M - 1) // SLIDE + 1
    w = np.arange(n_win)
    a = np.broadcast_to(w * SLIDE, (N_KEYS, n_win))
    b = np.broadcast_to(np.minimum(w * SLIDE + WIN, M), (N_KEYS, n_win))
    sums = prefix(b) - prefix(a)
    return (np.repeat(keys, n_win), np.tile(w, N_KEYS),
            sums.reshape(-1).astype(np.float64))


class LatencySink:
    """bench.py's window-latency sink: birth = emit stamp of the source
    chunk carrying the window's closing tuple, emission = arrival."""

    def __init__(self, stamps):
        self.stamps = stamps
        self.lock = threading.Lock()
        self.keys, self.ids, self.vals, self.lats = [], [], [], []

    def __call__(self, item):
        if item is None:
            return
        now = time.perf_counter()
        with self.lock:
            self.keys.append(np.asarray(item.key).copy())
            self.ids.append(np.asarray(item.id).copy())
            self.vals.append(np.asarray(item["value"]).copy())
            closing = (item.id * SLIDE + (WIN - 1)) * N_KEYS + item.key
            chunk = np.minimum(closing // SOURCE_BATCH, len(self.stamps) - 1)
            self.lats.extend((now - np.asarray(self.stamps)[chunk]).tolist())


def find_logic(graph, cls=None):
    from windflow_tpu_torch.operators.tpu.win_seq_tpu import WinSeqTPULogic
    from windflow_tpu_torch.runtime.node import FusedLogic
    cls = cls or WinSeqTPULogic
    found = []
    for node in graph._all_nodes():
        logics = ([s.logic for s in node.logic.segments]
                  if isinstance(node.logic, FusedLogic) else [node.logic])
        found += [lg for lg in logics if isinstance(lg, cls)]
    if len(found) != 1:
        raise AssertionError(f"expected one {cls.__name__}, found "
                             f"{len(found)}")
    return found[0]


def run_main(n_events: int, device: str):
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.core.tuples import SynthChunk
    from windflow_tpu_torch.operators.basic_ops import Sink
    from windflow_tpu_torch.operators.batch_ops import BatchSource
    from windflow_tpu_torch.operators.tpu.win_seq_tpu import WinSeqTPU

    stamps: list = []
    state = {"i": 0}

    def source(ctx):
        i = state["i"]
        if i >= n_events:
            return None
        state["i"] = i + SOURCE_BATCH
        stamps.append(time.perf_counter())
        return SynthChunk(i, min(SOURCE_BATCH, n_events - i), N_KEYS, VMOD,
                          1.0, 0.0)

    sink = LatencySink(stamps)
    g = wf.PipeGraph("chip_smoke", wf.Mode.DEFAULT,
                     config=wf.RuntimeConfig(device=device))
    op = WinSeqTPU("sum", WIN, SLIDE, wf.WinType.TB,
                   batch_len=DEVICE_BATCH, emit_batches=True,
                   max_buffer_elems=MAX_BUFFER, inflight_depth=INFLIGHT,
                   max_batch_delay_ms=DELAY_MS)
    g.add_source(BatchSource(source, 1)).add(op).add_sink(Sink(sink))
    t0 = time.perf_counter()
    g.run()
    secs = time.perf_counter() - t0
    return g, sink, secs


def check_main(g, sink, n_events: int) -> int:
    logic = find_logic(g)
    if logic._native is None:
        raise AssertionError("[main] the native lane was not active")
    keys = np.concatenate(sink.keys)
    ids = np.concatenate(sink.ids)
    vals = np.concatenate(sink.vals)
    # per key, windows are emitted in id order
    for k in range(N_KEYS):
        kid = ids[keys == k]
        if len(kid) > 1 and not np.all(np.diff(kid) > 0):
            raise AssertionError(f"[main] key {k}: ids out of order")
    ok, oi, ov = oracle(n_events)
    if len(keys) != len(ok):
        raise AssertionError(f"[main] {len(keys)} windows, oracle "
                             f"{len(ok)}")
    order = np.lexsort((ids, keys))
    if not (np.array_equal(keys[order], ok) and np.array_equal(ids[order], oi)
            and np.array_equal(vals[order], ov)):
        bad = np.nonzero(vals[order] != ov)[0]
        raise AssertionError(f"[main] windows differ from the oracle "
                             f"({len(bad)} values differ)")
    return len(keys)


def profile_main(card: str) -> None:
    """The main path once more under torch.profiler (CUDA activity
    only): the device's busy and idle share of the run's wall time and
    the device ops that fill the busy part."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        g, sink, secs = run_main(N_EVENTS, "cuda")
    check_main(g, sink, N_EVENTS)
    log(f"[profile] main path under the profiler: "
        f"{profile_summary(prof, secs, 6)} ({card})")


def profile_summary(prof, secs: float, n_top: int) -> str:
    """Wall, device busy and idle share, and the top device ops of one
    profiled run."""
    ops = sorted(((getattr(e, "self_device_time_total", 0) / 1e3, e.count,
                   e.key) for e in prof.key_averages()), reverse=True)
    busy = sum(ms for ms, _n, _k in ops)
    top = "; ".join(f"{k[:48]} x{n} {ms:.3f} ms" for ms, n, k in ops[:n_top]
                    if ms > 0)
    return (f"wall {secs:.3f} s, device busy {busy:.3f} ms = "
            f"{100 * busy / (secs * 1e3):.3f}% (idle "
            f"{100 - 100 * busy / (secs * 1e3):.3f}%); top device ops: {top}")


# ---------------------------------------------------------------------------
# 3b. the FlatFAT query kernel (K2) against its plain version
# ---------------------------------------------------------------------------

# bench.py config 15_resident_state (bench.py:1737-1832, run at :2559
# with N_EVENTS // 8)
N15 = 8_000_000
KEYS15 = 8
WIN15, SLIDE15 = 4096, 16
SOURCE15 = 65_536
BATCH15 = 128
# the rebuild lane's launch shape there: the whole-partition device step
# launches once per 65,536-event chunk, so a launch carries 4096 windows
# over the 8 keys' retained series (~98k values), padded to T_pad = 2^17
# and B_pad = 4096 ([main15] checks this against the run)
T_PAD15, B_PAD15 = 1 << 17, 4096
# the resident forest: 16 initial rows x pow2(4096 + 16 + 1024) leaves;
# a chunk of 1024 leaves fires 64 windows -> 256 padded query pieces
RES_K, RES_N, RES_CHUNK = 16, 8192, 1024
# the resident pane lane's slide (pane = gcd(4096, 64) = 64 >= 16)
PANE_SLIDE = 64
# the config-15 graphs' device (the CPU only to rehearse the phases
# without a card, at a small N15)
DEVICE15 = "cuda"


def k2_combines():
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq
    # name -> (combine, neutral, f32 ops per combine)
    return {"add": (torch.add, 0.0, 1), "max": (torch.maximum, -np.inf, 1),
            "min": (torch.minimum, np.inf, 1),
            "left_weighted": (fq._left_weighted, 0.0, 2)}


def forest_of(leaves: torch.Tensor, comb) -> torch.Tensor:
    """[K, 2n] heap forest over leaves [K, n], one combine per level."""
    K, n = leaves.shape
    tree = torch.zeros((K, 2 * n), dtype=torch.float32, device=leaves.device)
    tree[:, n:] = leaves
    lo = n // 2
    while lo >= 1:
        ch = tree[:, 2 * lo: 4 * lo]
        tree[:, lo: 2 * lo] = comb(ch[:, 0::2], ch[:, 1::2])
        lo //= 2
    return tree


def pieces(n: int, keys, starts, ends):
    """Windows [starts, ends) in id space as the query kernel took them
    before the fused kernel: padded to a pow2 bucket of at least 256, a
    wrapping window as two pieces ([s, n), then [0, e mod n)) combined
    on the host in time order.  Returns (k2, s2, e2, wraps, B)."""
    keys = np.asarray(keys, np.int64)
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    s = starts % n
    e_raw = ends % n
    wraps = (ends > starts) & (e_raw <= s)
    B = len(keys)
    b = 256
    while b < 2 * B:
        b <<= 1
    k2, s2, e2 = (np.zeros(b, np.int32) for _ in range(3))
    k2[:B] = keys
    s2[:B] = s
    e2[:B] = np.where(ends > starts, np.where(wraps, n, e_raw), s)
    k2[B:2 * B] = keys
    e2[B:2 * B] = np.where(wraps, e_raw, 0)
    return k2, s2, e2, wraps, B


def k2_shapes(rng):
    """name -> (K, n, rows or None, starts, ends) at the main paths'
    launch shapes, a deployment-size forest and edges."""
    shapes = {}
    # rebuild lane: one tree over the 8 keys' series, 512 windows each
    per_key = WIN15 + (B_PAD15 // KEYS15 - 1) * SLIDE15
    off = np.repeat(np.arange(KEYS15) * per_key, B_PAD15 // KEYS15)
    starts = off + np.tile(np.arange(B_PAD15 // KEYS15) * SLIDE15, KEYS15)
    shapes["rebuild"] = (1, T_PAD15, None, starts, starts + WIN15)
    # resident lane before the fused kernel: one chunk's 64 windows of
    # one key, ring-wrapping, as query pieces
    first = 5 * RES_N + 4000  # past several ring turns; half wrap
    qs = first + np.arange(RES_CHUNK // SLIDE15) * SLIDE15
    k2, s2, e2, wraps, _B = pieces(RES_N, np.full(len(qs), 3), qs,
                                   qs + WIN15)
    assert wraps.any()
    shapes["resident"] = (RES_K, RES_N, k2, s2, e2)
    # deployment-size forest: 4096 keys x 8192 leaves (256 MiB)
    B = 65_536
    s = rng.integers(0, RES_N, B)
    shapes["deploy"] = (4096, RES_N, rng.integers(0, 4096, B), s,
                        np.minimum(s + rng.integers(1, WIN15 + 1, B), RES_N))
    shapes["edges16"] = (1, 16, None, np.array([0, 3, 0, 15, 16, 7, 9]),
                         np.array([0, 3, 16, 16, 16, 16, 4]))
    shapes["edges2"] = (1, 2, None, np.array([0, 0, 1, 2, 1]),
                        np.array([2, 1, 2, 2, 1]))
    return shapes


def walk_nodes(n: int, rows, starts, ends):
    """(forest node ids, combines) of the bit-walks over [starts, ends)
    of rows (None: one tree): each node a walk takes, and one combine
    per node taken plus the final one of each non-empty extent."""
    two_n = 2 * n
    levels = n.bit_length() - 1
    r = np.zeros(len(starts), np.int64) if rows is None else \
        np.asarray(rows, np.int64)
    s = np.clip(np.asarray(starts, np.int64), 0, n)
    e = np.clip(np.asarray(ends, np.int64), 0, n)
    lo, hi, base = s + n, e + n, r * two_n
    nodes, combines = [], int((e > s).sum())
    for _ in range(levels + 1):
        tl = (lo < hi) & ((lo & 1) == 1)
        nodes.append((base + lo)[tl])
        lo = np.where(tl, lo + 1, lo)
        tr = (lo < hi) & ((hi & 1) == 1)
        hi = np.where(tr, hi - 1, hi)
        nodes.append((base + hi)[tr])
        combines += int(tl.sum() + tr.sum())
        lo, hi = lo >> 1, hi >> 1
    return np.concatenate(nodes), combines


def walk_work(n: int, rows, starts, ends, ops_per_combine: int):
    """(bytes, f32 ops) the queries need on these inputs: extents, row
    ids and outputs once, each distinct tree node the walks take read
    once; one combine per node taken plus the final one."""
    nodes, combines = walk_nodes(n, rows, starts, ends)
    B = len(starts)
    nbytes = 8 * B + (4 * B if rows is not None else 0) + 4 * B \
        + 4 * len(np.unique(nodes))
    return nbytes, combines * ops_per_combine


def range_csr(n_cols: int, n: int, rows, starts, ends, device):
    """The queries as a [B, K*n] 0/1 CSR matrix over the forest's leaves:
    the library yardstick sums them as one sparse matrix-vector product."""
    s = torch.as_tensor(np.asarray(starts, np.int64), device=device)
    e = torch.as_tensor(np.asarray(ends, np.int64), device=device)
    r = (torch.zeros_like(s) if rows is None else
         torch.as_tensor(np.asarray(rows, np.int64), device=device))
    lens = torch.clamp(e - s, min=0)
    crow = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
    nnz = int(crow[-1])
    cols = torch.repeat_interleave(r * n + s - crow[:-1], lens,
                                   output_size=nnz) \
        + torch.arange(nnz, device=device)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            crow, cols, torch.ones(nnz, dtype=torch.float32, device=device),
            size=(len(starts), n_cols))


def check_k2(device, card: str) -> dict:
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq
    rng = np.random.default_rng(1)
    out = {}
    worst_err = 0.0
    for name, (K, n, rows, starts, ends) in k2_shapes(rng).items():
        r_d = None if rows is None else torch.from_numpy(
            np.asarray(rows, np.int32)).to(device)
        s_d = torch.from_numpy(np.asarray(starts, np.int32)).to(device)
        e_d = torch.from_numpy(np.asarray(ends, np.int32)).to(device)
        ints = torch.from_numpy(
            rng.integers(0, 97, (K, n)).astype(np.float32)).to(device)
        f32 = torch.from_numpy(
            rng.random((K, n), dtype=np.float32)).to(device)
        times = []
        for cname, (comb, neutral, opc) in k2_combines().items():
            for integer in ((True, False) if cname == "add" else (False,)):
                tree = forest_of(ints if integer else f32, comb)
                k = fq.flatfat_query(tree, r_d, s_d, e_d, comb, neutral)
                p = fq.flatfat_query_plain(tree, r_d, s_d, e_d, comb,
                                           neutral)
                torch.cuda.synchronize()
                k, p = k.cpu().numpy(), p.cpu().numpy()
                if integer or cname in ("max", "min"):
                    if not np.array_equal(k, p):
                        raise AssertionError(
                            f"[kernel K2] {name} {cname}: not exact, err "
                            f"{np.nanmax(np.abs(k - p))}")
                else:
                    np.testing.assert_allclose(
                        k, p, rtol=RTOL_F32, atol=1e-6,
                        err_msg=f"[kernel K2] {name} {cname} f32")
                fin = np.isfinite(p)
                if not np.array_equal(fin, np.isfinite(k)):
                    raise AssertionError(f"[kernel K2] {name} {cname}: "
                                         f"non-finite results differ")
                if fin.any():
                    worst_err = max(worst_err, float(
                        np.abs(k[fin] - p[fin]).max()))
            t_k = timed(lambda: fq.flatfat_query(tree, r_d, s_d, e_d, comb,
                                                 neutral))
            times.append(f"{cname} {fmt(t_k)}")
            if cname == "add":
                add_tree, add_k = tree, t_k
        t_p = timed(lambda: fq.flatfat_query_plain(
            add_tree, r_d, s_d, e_d, torch.add, 0.0), reps=20)
        nbytes, ops = walk_work(n, rows, starts, ends, 1)
        bms, bound_by = bound_ms(nbytes, ops)
        ms, plain_ms = (d if d is not None else w for d, w in (add_k, t_p))
        lib_ms, lib_txt = None, "none"
        if name != "edges2":
            csr = range_csr(K * n, n, rows, starts, ends, device)
            leaves = add_tree[:, n:].reshape(-1).contiguous()
            lib = torch.mv(csr, leaves).cpu().numpy()
            ref = fq.flatfat_query(add_tree, r_d, s_d, e_d, torch.add,
                                   0.0).cpu().numpy()
            np.testing.assert_allclose(lib, ref, rtol=RTOL_F32, atol=1e-5,
                                       err_msg=f"[kernel K2] {name} mv")
            t_l = timed(lambda: torch.mv(csr, leaves), reps=20)
            lib_ms = t_l[0] if t_l[0] is not None else t_l[1]
            lib_txt = fmt(t_l)
            del csr
        log(f"[kernel K2] {name}: K={K} n={n} B={len(starts)} "
            f"max_extent={int(np.max(np.asarray(ends) - np.asarray(starts)))}"
            f"; exact on integers and max/min, rtol {RTOL_F32} on f32; "
            f"device ms per call (wall ms per call): kernel "
            f"{'; '.join(times)}; plain (add) {fmt(t_p)}; sparse mv (add) "
            f"{lib_txt}, range max/min: no library call; bound {bms:.4g} "
            f"ms ({bound_by}; {nbytes} B, {ops} combines) ({card})")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": bound_by, "library_ms": lib_ms}
        del ints, f32, tree, add_tree
        torch.cuda.empty_cache()
    out["max_abs_err"] = worst_err
    return out


# ---------------------------------------------------------------------------
# 3b'. the fused build+query kernel of the rebuild lane (K2r)
# ---------------------------------------------------------------------------

def k2r_shapes(rng):
    """name -> (n, starts, ends): the rebuild lane's launch (the query
    kernel's rebuild extents over one tree of T_PAD15 leaves), two tiles
    with the edges (empty and reversed extents, [0, n), end = n), and
    two tiling rounds (2^22 leaves: 4096 tile roots)."""
    rebuild = k2_shapes(rng)["rebuild"]
    shapes = {"rebuild": (T_PAD15, rebuild[3], rebuild[4])}
    for name, n in (("edges2048", 2048), ("rounds", 1 << 22)):
        starts = rng.integers(0, n, 4096)
        ends = np.minimum(starts + rng.integers(0, WIN15 + 1, 4096), n)
        edges = [(0, n), (n - 1, n), (5, 5), (9, 3), (1021, 1027), (n, n),
                 (0, 1), (n - 4096, n)]
        for i, (s, e) in enumerate(edges):
            starts[i], ends[i] = s, e
        shapes[name] = (n, starts, ends)
    return shapes


def legacy_rebuild(leaves, se, comb, neutral):
    """The rebuild lane's launch as it ran before the fused kernel: the
    17-level torch sweep of build_tree, the query kernel, the where."""
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq
    tree = fq.build_tree(leaves, comb, neutral)
    out = fq.flatfat_query(tree, None, se[0], se[1], comb, neutral)
    return torch.where(se[1] > se[0], out, torch.zeros_like(out))


def check_k2r(device, card: str) -> dict:
    """The fused build+query kernel against its plain version: bitwise
    for the four combines on integer and random f32 leaves, at every
    shape; timings at the rebuild lane's launch."""
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq
    rng = np.random.default_rng(3)
    for name, (n, starts, ends) in k2r_shapes(rng).items():
        se = pack(starts, ends, device)
        leaves = {"int": torch.from_numpy(rng.integers(0, 97, n).astype(
            np.float32)).to(device),
            "f32": torch.from_numpy(rng.random(n, dtype=np.float32)).to(
                device)}
        for cname, (comb, neutral, _opc) in k2_combines().items():
            for data, v in leaves.items():
                k = fq.flatfat_build_query(v, se, comb, neutral)
                p = fq.flatfat_build_query_plain(v, se, comb, neutral)
                legacy = legacy_rebuild(v, se, comb, neutral)
                torch.cuda.synchronize()
                k, p = k.cpu().numpy(), p.cpu().numpy()
                if not (np.array_equal(k, p) and np.array_equal(
                        k, legacy.cpu().numpy())):
                    raise AssertionError(
                        f"[kernel K2 rebuild] {name} {cname} {data}: not "
                        f"bitwise the plain version (err "
                        f"{np.nanmax(np.abs(k - p), initial=0)})")
        log(f"[kernel K2 rebuild] {name}: n={n} B={len(starts)} bitwise "
            f"equal to the plain version and the pre-PR chain for add, "
            f"max, min, left_weighted on integer and random f32 leaves")
        if name != "rebuild":
            del leaves
            continue
        v = leaves["int"]
        t_k = timed(lambda: fq.flatfat_build_query(v, se, torch.add, 0.0))
        t_chain = timed(lambda: legacy_rebuild(v, se, torch.add, 0.0))
        t_p = timed(lambda: fq.flatfat_build_query_plain(
            v, se, torch.add, 0.0), reps=20)
        csr = range_csr(n, n, None, starts, ends, device)
        lib = torch.mv(csr, v).cpu().numpy()
        np.testing.assert_array_equal(
            lib, fq.flatfat_build_query(v, se, torch.add, 0.0).cpu().numpy(),
            err_msg="[kernel K2 rebuild] sparse mv")
        t_l = timed(lambda: torch.mv(csr, v), reps=20)
        # the launch floor: the same kernel on its smallest tree, one window
        small = torch.ones(2048, dtype=torch.float32, device=device)
        one = pack([0], [2], device)
        t_floor = timed(lambda: fq.flatfat_build_query(small, one, torch.add,
                                                       0.0))
        # the least work: leaves and extents read, outputs written once;
        # n - 1 combines to build, and the walks' combines
        nbytes = 4 * n + 8 * len(starts) + 4 * len(starts)
        ops = n - 1 + walk_nodes(n, None, starts, ends)[1]
        bms, bound_by = bound_ms(nbytes, ops)
        ms, chain_ms, plain_ms, lib_ms, floor_ms = (
            d if d is not None else w
            for d, w in (t_k, t_chain, t_p, t_l, t_floor))
        log(f"[kernel K2 rebuild] {name}: device ms per call (wall ms per "
            f"call): kernel (add) {fmt(t_k)}, launch floor (n=2048, one "
            f"window) {fmt(t_floor)} = {ms / floor_ms:.2f}x it; pre-PR "
            f"chain (build_tree, query kernel, where) {fmt(t_chain)} = "
            f"{chain_ms / ms:.1f}x the kernel; plain (add) {fmt(t_p)}; sparse "
            f"mv (add) {fmt(t_l)}, max/min: no library call; bound "
            f"{bms:.4g} ms ({bound_by}; {nbytes} B, {ops} combines) ({card})")
        out = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
               "bound_by": bound_by, "library_ms": lib_ms,
               "max_abs_err": 0.0}
        del leaves, v, csr
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 3c. the fused FlatFAT update+query kernel against its plain version
# ---------------------------------------------------------------------------

# the resident pane lane's carry: pow2(64 panes a window + 1024 headroom)
# leaves, 16 initial rows; a 65,536-event chunk brings 128 new panes for
# each of the 8 keys and fires 128 windows of 64 panes per key
PANE_N, PANE_NEW = 2048, 128


def fused_shapes(rng):
    """name -> (K, n, runs (rows, starts, lens), windows (rows, starts,
    ends)) in id space, at the resident lanes' launch shapes, a
    deployment-size forest and edges."""
    shapes = {}
    # resident FFAT lane: one 1024-leaf chunk of key 3 crossing the
    # ring's end and the 64 windows of 4096 it closes (half wrap)
    s0 = 6 * RES_N - 512
    ends = s0 + SLIDE15 * np.arange(1, RES_CHUNK // SLIDE15 + 1)
    shapes["resident"] = (RES_K, RES_N, ([3], [s0], [RES_CHUNK]),
                          (np.full(len(ends), 3), ends - WIN15, ends))
    # resident pane lane: one run of 128 panes per key, 128 windows each
    p0 = rng.integers(4 * PANE_N, 8 * PANE_N, KEYS15)
    ends = (p0[:, None] + PANE_NEW - np.arange(PANE_NEW)[None, :]).ravel()
    shapes["pane"] = (16, PANE_N, (np.arange(KEYS15), p0,
                                   np.full(KEYS15, PANE_NEW)),
                      (np.repeat(np.arange(KEYS15), PANE_NEW),
                       ends - WIN15 // PANE_SLIDE, ends))
    # deployment forest: 4096 keys x 8192 leaves (256 MiB), one 64-leaf
    # run per row (some wrap), 16 windows per row of up to 4096 leaves
    K = 4096
    r0 = rng.integers(RES_N, 8 * RES_N, K)
    ends = (np.repeat(r0 + 64, 16) - rng.integers(0, 128, 16 * K))
    shapes["deploy"] = (K, RES_N, (np.arange(K), r0, np.full(K, 64)),
                        (np.repeat(np.arange(K), 16),
                         ends - rng.integers(1, WIN15 + 1, 16 * K), ends))
    # edges: two runs on one row crossing the ring's end, an empty run,
    # a row with windows and no run, windows of 0 and of n leaves
    shapes["edges16"] = (3, 16, ([0, 0, 1], [14, 18, 5], [4, 3, 0]),
                         ([0, 0, 0, 2, 2, 1, 0], [10, 0, 20, 5, 30, 7, 16],
                          [26, 16, 20, 9, 40, 8, 21]))
    shapes["edges2"] = (2, 2, ([1], [1], [2]),
                        ([0, 1, 1, 1, 1], [0, 1, 1, 0, 3], [2, 3, 2, 0, 4]))
    return shapes


def fused_work(n: int, runs, wins, sizes, ops_per_combine: int):
    """(bytes, f32 ops) one fused step needs on these inputs: the staged
    buffer (descriptors and values) read and the output written once;
    each dirty node (new leaves and their ancestors) written once; each
    clean node the step needs read once: the children of dirty nodes
    that no run made dirty, and the nodes the walks take outside the
    dirty ones.  One combine per dirty inner node, per node a walk takes
    and per wrapping window."""
    levels = n.bit_length() - 1
    rows, starts, lens = (np.asarray(a, np.int64) for a in runs)
    which = np.repeat(np.arange(len(lens)), lens)
    idx = n + (starts[which] + np.arange(len(which))
               - np.repeat(np.cumsum(lens) - lens, lens)) % n
    base = rows[which] * 2 * n
    dirty = [base + idx]
    for _ in range(levels):
        idx = idx >> 1
        dirty.append(base + idx)
    dirty = np.unique(np.concatenate(dirty))
    parents = dirty[dirty % (2 * n) < n]  # dirty inner nodes
    row_base = parents - parents % (2 * n)
    children = np.concatenate([2 * parents - row_base,
                               2 * parents - row_base + 1])
    inner = len(parents)
    q_rows, q_s, q_e = (np.asarray(a, np.int64) for a in wins)
    s, e = q_s % n, q_s % n + np.maximum(q_e - q_s, 0)
    wrap = (q_e > q_s) & (e >= n)
    nodes, combines = walk_nodes(
        n, np.concatenate([q_rows, q_rows[wrap]]),
        np.concatenate([s, np.zeros(int(wrap.sum()), np.int64)]),
        np.concatenate([np.minimum(e, n), (e - n)[wrap]]))
    clean = np.setdiff1d(np.concatenate([children, nodes]), dirty)
    G, R, Q, V = sizes
    nbytes = 4 * (3 * G + 2 + 3 * R + 3 * Q + V) + 4 * Q \
        + 4 * len(dirty) + 4 * len(clean)
    return nbytes, (inner + combines + int(wrap.sum())) * ops_per_combine


def legacy_step(tree, comb, neutral, runs, values, wins) -> np.ndarray:
    """One resident step as the lanes paid it before the fused kernel:
    host packing into five pinned copies, run expansion, the 13-level
    torch root-path sweep and the query kernel over two pieces a
    wrapping window (the plain version's expand_runs and update_sparse,
    then K2), a blocking copy back, the pieces combined on the host."""
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq
    n = tree.shape[-1] // 2

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(
            tree.device, non_blocking=True)

    rows, starts, lens = (np.asarray(a, np.int64) for a in runs)
    R, total = len(rows), int(lens.sum())
    rb = 8
    while rb < R:
        rb <<= 1
    rr = np.zeros(3 * rb, np.int32)
    rr[:R], rr[rb:rb + R], rr[2 * rb:2 * rb + R] = rows, starts % n, lens
    vb = 512
    while vb < total:
        vb <<= 1
    v = np.full(vb, neutral, np.float32)
    v[:total] = values
    k2, s2, e2, wraps, B = pieces(n, *wins)
    qd = put(np.concatenate([k2, s2, e2]))
    rd = put(rr)
    b = len(k2)
    keys, pos, valid = fq.expand_runs(rd[:rb], rd[rb:2 * rb], rd[2 * rb:],
                                      vb, n)
    fq.update_sparse(tree, keys, pos, put(v), valid, comb)
    out = fq.flatfat_query(tree, qd[:b], qd[b:2 * b], qd[2 * b:], comb,
                           neutral).cpu().numpy()
    head, tail = out[:B], out[B:2 * B]
    if not wraps.any():
        return head
    return np.where(wraps, comb(torch.from_numpy(head),
                                torch.from_numpy(tail)).numpy(), head)


def step_walls(step, reps: int):
    """(median ms by perf_counter, median ms by CUDA events) of one
    blocking step, host staging to host result."""
    for _ in range(3):
        step()
    walls, evs = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        step()
        b.record()
        walls.append((time.perf_counter() - t0) * 1e3)
        b.synchronize()
        evs.append(a.elapsed_time(b))
    return float(np.median(walls)), float(np.median(evs))


def check_fused(device, card: str) -> dict:
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq
    from windflow_tpu_torch.ops.flatfat_torch import (BatchedFlatFAT,
                                                      pack_step,
                                                      step_inputs)
    rng = np.random.default_rng(2)
    out = {}
    worst_err = 0.0
    for name, (K, n, runs, wins) in fused_shapes(rng).items():
        V = int(np.sum(runs[2]))
        data = {}
        for integer in (True, False):
            vals = (rng.integers(0, 97, V) if integer
                    else rng.random(V)).astype(np.float32)
            buf, sizes = pack_step(n, K, *runs, vals, *wins, pinned=True)
            leaves = (rng.integers(0, 97, (K, n)) if integer
                      else rng.random((K, n))).astype(np.float32)
            data[integer] = (vals, step_inputs(buf.to(device), sizes),
                             torch.from_numpy(leaves).to(device), sizes)
        for cname, (comb, neutral, _opc) in k2_combines().items():
            for integer in ((True, False) if cname == "add" else (False,)):
                _vals, inputs, leaves, _sizes = data[integer]
                fk = forest_of(leaves, comb)
                fp = fk.clone()
                k = fq.flatfat_update_query(fk, inputs, comb, neutral)
                p = fq.flatfat_update_query_plain(fp, inputs, comb, neutral)
                torch.cuda.synchronize()
                k, p = k.cpu().numpy(), p.cpu().numpy()
                tk, tp = fk.cpu().numpy(), fp.cpu().numpy()
                if integer or cname in ("max", "min"):
                    if not (np.array_equal(k, p) and np.array_equal(tk, tp)):
                        raise AssertionError(
                            f"[kernel K2 fused] {name} {cname}: not exact, "
                            f"err {np.nanmax(np.abs(k - p), initial=0)}, "
                            f"forest err {np.nanmax(np.abs(tk - tp))}")
                else:
                    np.testing.assert_allclose(
                        k, p, rtol=RTOL_F32, atol=1e-6,
                        err_msg=f"[kernel K2 fused] {name} {cname} f32")
                    np.testing.assert_allclose(
                        tk, tp, rtol=RTOL_F32, atol=1e-6,
                        err_msg=f"[kernel K2 fused] {name} {cname} forest")
                fin = np.isfinite(p)
                if not np.array_equal(fin, np.isfinite(k)):
                    raise AssertionError(f"[kernel K2 fused] {name} "
                                         f"{cname}: non-finite results "
                                         f"differ")
                if fin.any():
                    worst_err = max(worst_err, float(
                        np.abs(k[fin] - p[fin]).max()))
                del fk, fp
        if name.startswith("edges"):
            log(f"[kernel K2 fused] {name}: K={K} n={n} exact on integers "
                f"and max/min, rtol {RTOL_F32} on f32, forests equal")
            continue
        # timings: add on integer data, the forest updated in place by
        # every call (the same step again: idempotent).  First one whole
        # step as the lane pays it, and the chain that ran before the
        # fused kernel, then the profiled timings
        vals, inputs, leaves, sizes = data[True]
        fk = forest_of(leaves, torch.add)
        bf = BatchedFlatFAT(torch.add, 0.0, K, n, device=device)
        bf.tree = fk
        fused_res = bf.update_runs_query(*runs, vals, *wins)
        old_res = legacy_step(fk, torch.add, 0.0, runs, vals, wins)
        if not np.array_equal(fused_res, old_res):
            raise AssertionError(f"[kernel K2 fused] {name}: the fused step "
                                 f"and the pre-fused chain differ")
        reps = 20 if name == "deploy" else 100
        new_wall = step_walls(lambda: bf.update_runs_query(*runs, vals, *wins),
                              reps)
        old_wall = step_walls(lambda: legacy_step(fk, torch.add, 0.0, runs,
                                                  vals, wins), reps)
        t_k = timed(lambda: fq.flatfat_update_query(fk, inputs, torch.add,
                                                    0.0))
        t_p = timed(lambda: fq.flatfat_update_query_plain(
            fk, inputs, torch.add, 0.0), reps=10)
        nbytes, ops = fused_work(n, runs, wins, sizes, 1)
        bms, bound_by = bound_ms(nbytes, ops)
        ms, plain_ms = (d if d is not None else w for d, w in (t_k, t_p))
        log(f"[kernel K2 fused] {name}: K={K} n={n} runs={len(runs[0])} "
            f"windows={len(wins[0])}; exact on integers and max/min, rtol "
            f"{RTOL_F32} on f32, forests equal; device ms per call (wall ms "
            f"per call): kernel {fmt(t_k)}, plain (add) {fmt(t_p)}; bound {bms:.4g} "
            f"ms ({bound_by}; {nbytes} B, {ops} combines); one step host "
            f"staging to host result, median ms (perf_counter / CUDA "
            f"events): fused {new_wall[0]:.4f} / {new_wall[1]:.4f}, "
            f"pre-fused chain {old_wall[0]:.4f} / {old_wall[1]:.4f} "
            f"({old_wall[0] / new_wall[0]:.1f}x) ({card})")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": bound_by, "library_ms": None}
        del fk, bf, data, inputs
        torch.cuda.empty_cache()
    out["max_abs_err"] = worst_err
    return out


# ---------------------------------------------------------------------------
# 6. bench config 15 through both FFAT lanes
# ---------------------------------------------------------------------------

class RecordSink:
    """Per-record sink with bench.py's window latency (config 15): birth
    = emit stamp of the source chunk carrying the window's closing tuple
    (id w*slide + win - 1 of its key), emission = arrival."""

    def __init__(self, stamps, slide):
        self.stamps = stamps
        self.slide = slide
        self.lock = threading.Lock()
        self.rows = []

    def __call__(self, r):
        if r is None:
            return
        now = time.perf_counter()
        with self.lock:
            self.rows.append((r.key, r.id, r.value, now))

    def columns(self):
        a = np.array([(k, i) for k, i, _v, _t in self.rows], np.int64)
        keys, ids = (a[:, 0], a[:, 1]) if len(a) else (a, a)
        vals = np.array([v for _k, _i, v, _t in self.rows], np.float64)
        now = np.array([t for _k, _i, _v, t in self.rows])
        closing = (ids * self.slide + WIN15 - 1) * KEYS15 + keys
        chunk = np.minimum(closing // SOURCE15, len(self.stamps) - 1)
        lats = now - np.asarray(self.stamps)[chunk]
        return keys, ids, vals, lats


def run15(make_op, n_events: int, slide: int, before_run=None):
    """One config-15 graph on the card: BatchSource of the stream law
    (key = e % 8, id = ts = e // 8, value = e % 97) -> op -> Sink."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.core.tuples import TupleBatch
    from windflow_tpu_torch.operators.basic_ops import Sink
    from windflow_tpu_torch.operators.batch_ops import BatchSource

    stamps: list = []
    state = {"i": 0}

    def source():
        i = state["i"]
        if i >= n_events:
            return None
        state["i"] = i + SOURCE15
        stamps.append(time.perf_counter())
        idx = np.arange(i, min(i + SOURCE15, n_events))
        return TupleBatch({"key": idx % KEYS15, "id": idx // KEYS15,
                           "ts": idx // KEYS15,
                           "value": (idx % VMOD).astype(np.float64)})

    sink = RecordSink(stamps, slide)
    g = wf.PipeGraph("chip_smoke15", wf.Mode.DEFAULT,
                     config=wf.RuntimeConfig(device=DEVICE15))
    g.add_source(BatchSource(source)).add(make_op()).add_sink(Sink(sink))
    if before_run is not None:
        before_run(g)
    t0 = time.perf_counter()
    g.run()
    return g, sink, time.perf_counter() - t0


def oracle15(n_events: int, slide: int):
    """(keys, ids, sums) of every window of the config-15 law, float64:
    key k holds ids 0..M-1 with value (id*8 + k) % 97; CB window w covers
    ids [w*slide, w*slide + 4096) clipped at M, for every w*slide < M
    (partial tail windows flush at EOS)."""
    M = n_events // KEYS15
    n_win = (M - 1) // slide + 1
    w = np.arange(n_win)
    keys, ids, sums = [], [], []
    for k in range(KEYS15):
        c = np.concatenate([[0], np.cumsum((np.arange(M) * KEYS15 + k)
                                           % VMOD)])
        sums.append((c[np.minimum(w * slide + WIN15, M)]
                     - c[w * slide]).astype(np.float64))
        keys.append(np.full(n_win, k))
        ids.append(w)
    return np.concatenate(keys), np.concatenate(ids), np.concatenate(sums)


def sorted_windows(sink, tag: str):
    keys, ids, vals, lats = sink.columns()
    order = np.lexsort((ids, keys))
    keys, ids, vals = keys[order], ids[order], vals[order]
    if len(keys) > 1 and np.any((np.diff(keys) == 0) & (np.diff(ids) == 0)):
        raise AssertionError(f"[{tag}] duplicate windows")
    return keys, ids, vals, lats


def hold_to_oracle(got, want, tag: str) -> None:
    keys, ids, vals = got[:3]
    if len(keys) != len(want[0]) or not (
            np.array_equal(keys, want[0]) and np.array_equal(ids, want[1])
            and np.array_equal(vals, want[2])):
        n_bad = (int((vals != want[2]).sum())
                 if len(vals) == len(want[2]) else -1)
        raise AssertionError(f"[{tag}] {len(keys)} windows vs oracle "
                             f"{len(want[0])}; {n_bad} values differ")


def bytes_per_launch(logic) -> float:
    st = logic.stats
    if st is None or not st.num_launches:
        raise AssertionError("device byte accounting missing")
    return (st.bytes_to_device + st.bytes_from_device) / st.num_launches


def ffat_lane(lane: str):
    """Config 15's operator for one FFAT lane, as bench.py builds it."""
    from windflow_tpu_torch.operators.tpu.ffat_resident import \
        WinSeqFFATResident
    from windflow_tpu_torch.operators.tpu.win_seq_tpu import WinSeqTPU
    import windflow_tpu_torch as wf
    if lane == "rebuild":
        return WinSeqTPU(("ffat", torch.add, 0.0), WIN15, SLIDE15,
                         wf.WinType.CB, batch_len=BATCH15,
                         max_buffer_elems=MAX_BUFFER, inflight_depth=INFLIGHT)
    return WinSeqFFATResident(lambda t: t.value, torch.add, 0.0, WIN15,
                              SLIDE15, wf.WinType.CB)


# config 15's cells, each run once per round: cell -> one reading a round
READINGS15: dict = collections.defaultdict(list)


def check_launches(tag: str, logic, kernels: dict, expect: str) -> int:
    """The path's launches of the kernel named ``expect`` equal its
    launched batches, and every other kernel counted in ``kernels``
    (name -> launches in the run) stayed at 0."""
    want = logic.launched_batches
    if kernels[expect] <= 0 or kernels[expect] != want:
        raise AssertionError(f"[{tag}] {expect} launches {kernels[expect]} "
                             f"!= batches launched {want}")
    for name, count in kernels.items():
        if name != expect and count:
            raise AssertionError(f"[{tag}] {name} launched {count} times "
                                 f"on a path that runs {expect}")
    return want


def reset_counts() -> None:
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq
    from windflow_tpu_torch.ops.cuda import window_sum
    fq.reset_launch_count()
    fq.reset_fused_launch_count()
    fq.reset_build_query_launch_count()
    window_sum.reset_launch_count()


def read_counts() -> dict:
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq
    from windflow_tpu_torch.ops.cuda import window_sum
    return {"flatfat_query": fq.launch_count(),
            "flatfat_update_query": fq.fused_launch_count(),
            "flatfat_build_query": fq.build_query_launch_count(),
            "window_sum": window_sum.launch_count()}


def reading(cell: str, secs: float, got) -> str:
    p50, p99 = (float(np.percentile(got[3], q)) * 1e3 for q in (50, 99))
    READINGS15[cell].append((N15 / secs, p50, p99))
    return (f"{N15} events in {secs:.3f} s = {N15 / secs:.1f} tuples/s; "
            f"{len(got[0])} windows match the oracle exactly; window "
            f"latency p50 {p50:.3f} ms, p99 {p99:.3f} ms")


def main15(card: str) -> dict:
    """Config 15 through the FFAT rebuild lane (the fused build+query
    kernel per launch) and the resident FFAT lane (the fused
    update+query kernel per launch): returns each path's kernel
    launches."""
    from windflow_tpu_torch.operators.tpu.ffat_resident import \
        WinSeqFFATResidentLogic
    from windflow_tpu_torch.ops.cuda.window_sum import next_pow2

    want = oracle15(N15, SLIDE15)
    shapes = collections.Counter()

    def record_shapes(g):
        eng = find_logic(g).engine
        compute = eng.compute

        def recorded(cols, starts, ends, gwids):
            T = len(next(iter(cols.values())))
            # windows per launch shape
            shapes[(next_pow2(max(T, 2048)),
                    next_pow2(max(len(starts), 2048)))] += len(starts)
            return compute(cols, starts, ends, gwids)
        eng.compute = recorded

    lanes = {}
    for lane, cls, hook, kernel in (
            ("rebuild", None, record_shapes, "flatfat_build_query"),
            ("resident", WinSeqFFATResidentLogic, None,
             "flatfat_update_query")):
        reset_counts()
        g, sink, secs = run15(lambda: ffat_lane(lane), N15, SLIDE15, hook)
        counts = read_counts()
        logic = find_logic(g, cls)
        if logic.device is None or logic.device.type != DEVICE15:
            raise AssertionError(f"[main15] {lane} device {logic.device}")
        launches = check_launches(f"main15 {lane}", logic, counts, kernel)
        got = sorted_windows(sink, f"main15 {lane}")
        hold_to_oracle(got, want, f"main15 {lane}")
        lanes[lane] = {"bpl": bytes_per_launch(logic), "launches": launches,
                       "state": logic.device_resident_bytes()
                       if lane == "resident" else 0}
        log(f"[main15] {lane} lane: {reading(lane, secs, got)}; "
            f"{launches} {kernel} launches = {logic.launched_batches} "
            f"batches, other kernels 0; "
            f"{lanes[lane]['bpl']:.1f} bytes shipped per launch"
            + (f"; Device_state_bytes_resident {lanes[lane]['state']}"
               if lane == "resident" else
               f"; windows per launch shape (T_pad, B_pad): "
               f"{dict(shapes)}")
            + f" ({card})")
    if shapes.most_common(1)[0][0] != (T_PAD15, B_PAD15):
        raise AssertionError(f"[main15] rebuild launch shapes {shapes}: "
                             f"[kernel K2 rebuild] timed another shape")
    ratio = lanes["rebuild"]["bpl"] / lanes["resident"]["bpl"]
    if ratio < 10:
        raise AssertionError(f"[main15] bytes/launch ratio {ratio:.2f} < 10")
    log(f"[main15] both lanes equal window for window; shipped bytes per "
        f"launch rebuild/resident = {ratio:.1f}x")
    return {"flatfat_build_query": lanes["rebuild"]["launches"],
            "flatfat_update_query": lanes["resident"]["launches"]}


def resident_pane(card: str) -> int:
    """WinSeqTPU sum over panes of 64 on the config-15 stream: promoted
    onto the resident pane lane (the fused kernel per launch) by the
    planner, against resident=False (K1 per launch).  Returns the fused
    kernel's launches."""
    from windflow_tpu_torch.operators.tpu.win_seq_tpu import WinSeqTPU
    import windflow_tpu_torch as wf

    want = oracle15(N15, PANE_SLIDE)
    got = {}
    fused = 0
    for resident in (None, False):
        reset_counts()
        g, sink, secs = run15(lambda: WinSeqTPU(
            "sum", WIN15, PANE_SLIDE, wf.WinType.CB, placement="device",
            value_of=lambda t: t.value, resident=resident), N15, PANE_SLIDE)
        counts = read_counts()
        logic = find_logic(g)
        entry = g.placements[0]
        tag = "resident" if resident is None else "rebuild"
        if bool(entry.get("resident")) != (resident is None):
            raise AssertionError(f"[resident pane] {tag}: placement {entry}")
        kernel = "flatfat_update_query" if resident is None else "window_sum"
        launches = check_launches(f"resident pane {tag}", logic, counts,
                                  kernel)
        if resident is None:
            fused = launches
        got[tag] = sorted_windows(sink, f"resident pane {tag}")
        hold_to_oracle(got[tag], want, f"resident pane {tag}")
        log(f"[resident pane] {tag} lane: "
            f"{reading('pane ' + tag, secs, got[tag])}; {launches} "
            f"{kernel} launches = {logic.launched_batches} batches, other "
            f"kernels 0; {bytes_per_launch(logic):.1f} bytes per launch; "
            f"Device_state_bytes_resident {logic.device_resident_bytes()} "
            f"({card})")
    if not all(np.array_equal(a, b) for a, b in zip(got["resident"][:3],
                                                     got["rebuild"][:3])):
        raise AssertionError("[resident pane] lanes differ")
    log("[resident pane] resident and rebuild lanes bitwise equal")
    return fused


def profile15(card: str, lane: str, n_events: int) -> None:
    """One FFAT lane of config 15 once more under torch.profiler (CUDA
    activity only): device busy and idle share, top device ops.  The
    rebuild lane must show one kernel, the fused build+query kernel;
    the rest is copies."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        g, sink, secs = run15(lambda: ffat_lane(lane), n_events, SLIDE15)
    hold_to_oracle(sorted_windows(sink, "profile15"),
                   oracle15(n_events, SLIDE15), "profile15")
    extra = ""
    if lane == "rebuild":
        kernels = {e.key: e.count for e in prof.key_averages()
                   if getattr(e, "self_device_time_total", 0) > 0
                   and not e.key.startswith(("Memcpy", "Memset"))}
        if not kernels or any("flatfat_build_query_kernel" not in k
                              for k in kernels):
            raise AssertionError(f"[profile15] rebuild lane kernels "
                                 f"{kernels}: not one fused kernel")
        extra = (f"; kernels traced: {sum(kernels.values())} fused "
                 f"build+query for {find_logic(g).launched_batches} "
                 f"launched batches, no other kernel")
    log(f"[profile15] {lane} lane, {n_events} events, under the profiler: "
        f"{profile_summary(prof, secs, 8)}{extra} ({card})")


def drive_flatfat(card: str) -> int:
    """The single-tree FlatFAT a user builds, updates and queries
    (FlatFATTorch, the twin of the reference's FlatFATJax), the one
    path that launches the query-only kernel: a tree of T_PAD15 leaves,
    the rebuild lane's 4096 windows, then 1024 leaves updated and the
    windows again.  Every window against a float64 prefix sum; returns
    the query kernel's launches."""
    from windflow_tpu_torch.ops.flatfat_torch import FlatFATTorch
    rng = np.random.default_rng(4)
    leaves = rng.integers(0, 97, T_PAD15).astype(np.float32)
    starts, ends = k2_shapes(rng)["rebuild"][3:]
    ft = FlatFATTorch(torch.add, 0.0, T_PAD15, device=DEVICE15)
    reset_counts()
    ft.build(leaves)
    got = [ft.query_ranges(starts, ends)]
    want = [float64_sums(leaves, starts, ends)]
    pos = rng.choice(T_PAD15, 1024, replace=False)
    leaves[pos] = rng.integers(0, 97, 1024)
    ft.update(pos, leaves[pos])
    got.append(ft.query_ranges(starts, ends))
    want.append(float64_sums(leaves, starts, ends))
    torch.cuda.synchronize()
    counts = read_counts()
    if counts["flatfat_query"] != 2 or sum(counts.values()) != 2:
        raise AssertionError(f"[flatfat] launches {counts}: expected two "
                             f"query kernel launches and nothing else")
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("[flatfat] windows differ from the float64 sum")
    log(f"[flatfat] FlatFATTorch: build, {len(starts)} windows, 1024 leaves "
        f"updated, the windows again, exact against the float64 sum; "
        f"{counts['flatfat_query']} query kernel launches, other kernels 0 "
        f"({card})")
    return counts["flatfat_query"]


def kernel_entry(name, source, replaces, launches, err, t) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[device] torch: {name}; nvidia-smi: {card}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    device = torch.device("cuda", 0)

    build_all()
    # the fused kernel first: its step walls are host times, taken
    # before any phase has run the profiler in this process
    k2f = check_fused(device, card)
    k1 = check_kernel(device, card)
    k2 = check_k2(device, card)
    k2r = check_k2r(device, card)
    log(f"[smoke] kernels checked at {time.perf_counter() - t_start:.1f} s")

    reset_counts()
    g, sink, secs = run_main(N_EVENTS, "cuda")
    counts = read_counts()
    logic = find_logic(g)
    if logic.device is None or logic.device.type != "cuda":
        raise AssertionError(f"[main] engine device {logic.device}")
    launches = check_launches("main", logic, counts, "window_sum")
    windows = check_main(g, sink, N_EVENTS)
    p50, p99 = (float(np.percentile(sink.lats, q)) * 1e3 for q in (50, 99))
    log(f"[main] {N_EVENTS} events in {secs:.3f} s = "
        f"{N_EVENTS / secs:.1f} tuples/s; {windows} windows match the "
        f"oracle exactly; window latency p50 {p50:.3f} ms, p99 "
        f"{p99:.3f} ms; {launches} kernel launches = "
        f"{logic.launched_batches} batches ({card})")
    profile_main(card)

    # config 15's four cells twice back to back; each path driven with
    # every launch count set to 0 just before it and read just after
    for rnd in (1, 2):
        counts = main15(card)
        counts["flatfat_update_query"] += resident_pane(card)
        if rnd == 1:
            launches15 = counts
        log(f"[smoke] config 15 round {rnd} done at "
            f"{time.perf_counter() - t_start:.1f} s")
    for cell, rows in READINGS15.items():
        log(f"[main15 x2] {cell}: tuples/s "
            f"{' / '.join(f'{r[0]:.1f}' for r in rows)}; p50 ms "
            f"{' / '.join(f'{r[1]:.3f}' for r in rows)}; p99 ms "
            f"{' / '.join(f'{r[2]:.3f}' for r in rows)} ({card})")
    launches15["flatfat_query"] = drive_flatfat(card)
    profile15(card, "rebuild", N15)
    profile15(card, "resident", N15)
    log(f"[smoke] total {time.perf_counter() - t_start:.1f} s")

    src = "windflow_tpu_torch/ops/cuda/flatfat_query.cu"
    log(json.dumps({"kernels": [
        kernel_entry("window_sum", "windflow_tpu_torch/ops/cuda/window_sum.cu",
                     "windflow_tpu/ops/pallas/window_sum.py:62", launches,
                     k1["max_abs_err"], k1),
        kernel_entry("flatfat_query", src,
                     "windflow_tpu/ops/pallas/flatfat_query.py:91",
                     launches15["flatfat_query"], k2["max_abs_err"],
                     k2["rebuild"]),
        kernel_entry("flatfat_update_query", src,
                     "windflow_tpu/ops/pallas/flatfat_query.py:91",
                     launches15["flatfat_update_query"],
                     k2f["max_abs_err"], k2f["resident"]),
        kernel_entry("flatfat_build_query", src,
                     "windflow_tpu/ops/pallas/flatfat_query.py:91",
                     launches15["flatfat_build_query"], k2r["max_abs_err"],
                     k2r)]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
