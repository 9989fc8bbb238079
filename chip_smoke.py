"""Chip smoke test of the PyTorch/CUDA port (windflow_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; the last line is printed only when
every phase passed):

1. device  -- the CUDA card's name, and its name and power limit as
   nvidia-smi reports them.
2. build   -- the window-sum kernel (nvcc, sm_90a) and the native C++
   engine (g++), built from the checkout's sources in parallel into
   windflow_tpu_torch/_build/.
3. kernel  -- the window-sum kernel against its plain torch version and
   a float64 numpy sum on the card, at the headline launch shape (pane
   partials, B = 4096, 2-pane extents), a wide raw-tuple shape (extents
   up to 4096 over T = 2^21) and edge cases (empty extents, extents
   ending at T, single elements): exact on integer data, rtol 1e-5 on
   random f32.  Per shape: median kernel time (CUDA events), the bytes
   the function must move and their share of the card's HBM rate.
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

Then one JSON line describing each kernel, the card line, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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
    from windflow_tpu_torch.ops.cuda import window_sum
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


def check_kernel(device, card: str) -> dict:
    from windflow_tpu_torch.ops.cuda.window_sum import (window_sums,
                                                        window_sums_plain)
    rng = np.random.default_rng(0)
    shapes = {"headline": headline_extents(),
              "wide": wide_extents(rng),
              "edges": edge_extents()}
    entry = None
    worst_err = 0.0
    for name, (T, starts, ends) in shapes.items():
        se = pack(starts, ends, device)
        # integer data: every sum below 2^24, so kernel, plain version
        # and the float64 oracle must agree exactly -- bounded by the
        # widest extent where the plain version sums tiles, by the whole
        # buffer where it takes the prefix scan
        max_w = int((ends - starts).max())
        hi = max(2, (1 << 24) // (T if max_w > 32 else max_w))
        ints = rng.integers(0, hi, T).astype(np.float32)
        vals = torch.from_numpy(ints).to(device)
        k = window_sums(vals, se).cpu().numpy()
        p = window_sums_plain(vals, se).cpu().numpy()
        ref = float64_sums(ints, starts, ends)
        if not (np.array_equal(k, ref) and np.array_equal(p, ref)):
            raise AssertionError(
                f"[kernel] {name}: integer data not exact: kernel err "
                f"{np.abs(k - ref).max()}, plain err {np.abs(p - ref).max()}")
        worst_err = max(worst_err, float(np.abs(k - p).max()))
        # random f32 data against the float64 sum
        f32 = rng.random(T, dtype=np.float32)
        vals = torch.from_numpy(f32).to(device)
        k = window_sums(vals, se).cpu().numpy()
        ref = float64_sums(f32, starts, ends)
        np.testing.assert_allclose(k, ref, rtol=RTOL_F32, atol=0,
                                   err_msg=f"[kernel] {name}: random f32")
        p = window_sums_plain(vals, se).cpu().numpy()
        f32_err = float(np.abs(k - p).max())
        if name == "headline":
            # the plain version takes the tile form here: the same two
            # adds as the kernel
            np.testing.assert_allclose(k, p, rtol=1e-6, atol=0,
                                       err_msg="[kernel] headline vs plain")
            worst_err = max(worst_err, f32_err)
        torch.cuda.synchronize()
        t_k = timed(lambda: window_sums(vals, se))
        t_p = timed(lambda: window_sums_plain(vals, se), reps=20)
        csr = csr_of(T, starts, ends, device)
        t_l = timed(lambda: torch.mv(csr, vals), reps=20)
        # device time where the profiler saw it, else the call's wall
        ms, plain_ms, lib_ms = (d if d is not None else w
                                for d, w in (t_k, t_p, t_l))
        lib = torch.mv(csr, vals).cpu().numpy()
        np.testing.assert_allclose(lib, ref, rtol=RTOL_F32, atol=0,
                                   err_msg=f"[kernel] {name}: library")
        nbytes, ops = work_of(T, starts, ends)
        bms, bound_by = bound_ms(nbytes, ops)
        share = nbytes / (ms * 1e-3) / HBM_BYTES_PER_S
        log(f"[kernel] {name}: T={T} B={len(starts)} "
            f"max_extent={int((ends - starts).max())} exact on integers; "
            f"f32 |kernel-plain|max={f32_err:.3g}; device ms per call "
            f"(wall ms per call): kernel {fmt(t_k)}, plain {fmt(t_p)}, "
            f"sparse mv {fmt(t_l)}; bound {bms:.4g} ms ({bound_by}), "
            f"{nbytes} B moved = {100 * share:.2f}% of HBM peak at the "
            f"kernel's device time ({card})")
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


def find_logic(graph):
    from windflow_tpu_torch.operators.tpu.win_seq_tpu import WinSeqTPULogic
    from windflow_tpu_torch.runtime.node import FusedLogic
    found = []
    for node in graph._all_nodes():
        logics = ([s.logic for s in node.logic.segments]
                  if isinstance(node.logic, FusedLogic) else [node.logic])
        found += [lg for lg in logics if isinstance(lg, WinSeqTPULogic)]
    if len(found) != 1:
        raise AssertionError(f"expected one WinSeqTPU logic, found "
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
    ops = sorted(((getattr(e, "self_device_time_total", 0) / 1e3, e.count,
                   e.key) for e in prof.key_averages()), reverse=True)
    busy = sum(ms for ms, _n, _k in ops)
    top = "; ".join(f"{k[:48]} x{n} {ms:.3f} ms" for ms, n, k in ops[:6]
                    if ms > 0)
    log(f"[profile] main path under the profiler: wall {secs:.3f} s, "
        f"device busy {busy:.3f} ms = {100 * busy / (secs * 1e3):.3f}% "
        f"(idle {100 - 100 * busy / (secs * 1e3):.3f}%); top device ops: "
        f"{top} ({card})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from windflow_tpu_torch.ops.cuda import window_sum

    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[device] torch: {name}; nvidia-smi: {card}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    device = torch.device("cuda", 0)

    build_all()
    k1 = check_kernel(device, card)

    window_sum.reset_launch_count()
    g, sink, secs = run_main(N_EVENTS, "cuda")
    launches = window_sum.launch_count()
    logic = find_logic(g)
    if logic.device is None or logic.device.type != "cuda":
        raise AssertionError(f"[main] engine device {logic.device}")
    if launches <= 0 or launches != logic.launched_batches:
        raise AssertionError(
            f"[main] window_sum kernel launches {launches} != batches "
            f"launched {logic.launched_batches}")
    windows = check_main(g, sink, N_EVENTS)
    p50, p99 = (float(np.percentile(sink.lats, q)) * 1e3 for q in (50, 99))
    log(f"[main] {N_EVENTS} events in {secs:.3f} s = "
        f"{N_EVENTS / secs:.1f} tuples/s; {windows} windows match the "
        f"oracle exactly; window latency p50 {p50:.3f} ms, p99 "
        f"{p99:.3f} ms; {launches} kernel launches = "
        f"{logic.launched_batches} batches ({card})")
    profile_main(card)
    log(f"[smoke] total {time.perf_counter() - t_start:.1f} s")

    log(json.dumps({"kernels": [{
        "name": "window_sum",
        "route": "cuda",
        "source": "windflow_tpu_torch/ops/cuda/window_sum.cu",
        "replaces": "windflow_tpu/ops/pallas/window_sum.py:62",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
