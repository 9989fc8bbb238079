"""NEXMark Q5 (hot items) at the Nexmark suite's settings through the
port's keyed device windows, on the CPU at a small size: the generator's
law at event rate 10,000 events a second (windows of 100,000 events
sliding by 20,000, a watermark 40,000 behind; nine windows close in
300,000 events).

* the pipeline (``models.nexmark.build_q5_nexmark``) against the plain
  torch reference (``tests/nexmark_q5_reference.py``): the hot rows and
  the full count table, exactly, over seeds;
* keys that never recur: each window leaves the engine, and reaches the
  sink, before the source's next batch after the watermark passes it;
* eviction: the live keys are exactly those with a bid in an open pane,
  the evicted ones the rest;
* ``Watermark(inf)`` drains everything; ties at a maximum all come out;
* the engine's snapshot round-trips with keys evicted;
* without watermarks the engine fires by each key's own tuples, as
  before;
* the benchmark's NumPy copy of the reference and the torch copy agree,
  and both agree with the generator's own events;
* the hot-items step's snapshot, taken mid-close beside the engine's,
  restores into logics that emit what the uninterrupted pair emits;
* the benchmark's cell, through its harness on the CPU, is judged on
  every window's sums as well as its hot rows, and those sums catch a
  fault at a count off the window's maximum.
"""
import importlib.util
import json
import pickle
import shutil
from contextlib import nullcontext
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import nexmark_q5_reference as ref_torch
import windflow_tpu_torch as wf
from windflow_tpu_torch.core.basic import WinType
from windflow_tpu_torch.core.tuples import TupleBatch
from windflow_tpu_torch.models.nexmark import (BID, NexmarkGenerator,
                                               build_q5_nexmark)
from windflow_tpu_torch.operators.hot_items import _HotItemsLogic
from windflow_tpu_torch.operators.tpu.win_seq_tpu import WinSeqTPULogic
from windflow_tpu_torch.runtime.native import (NativeWindowEngine,
                                               native_available)
from windflow_tpu_torch.runtime.queues import Watermark

ROOT = Path(__file__).resolve().parents[1]
RATE = 10_000
N = 300_000
BATCH = 4_096
SEEDS = [7, 2 ** 31 + 11, 2 ** 33 + 5]

needs_native = pytest.mark.skipif(not native_available(),
                                  reason="no C++ toolchain for the engine")


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def _config() -> dict:
    cfg = json.loads((ROOT / "wfbench/configs/nexmark_q5.json").read_text())
    cfg["event_rate"] = RATE
    return cfg


CFG = _config()
WIN, SLIDE, LAG = (int(CFG[k] * RATE)
                   for k in ("window_s", "slide_s", "watermark_lag_s"))


def _generator(seed: int) -> NexmarkGenerator:
    return _load("wfbench/configs/nexmark_q5.py", "q5_cfg").make_stream(
        CFG, {}, seed)


def _sorted(t: dict) -> dict:
    """Rows in order of (window, key), as numpy int64."""
    key = np.asarray(t["key"], np.int64)
    wid = np.asarray(t["wid"], np.int64)
    val = np.asarray(t["value"]).astype(np.int64)
    o = np.lexsort((key, wid))
    return {"key": key[o], "wid": wid[o], "value": val[o]}


def _same(a: dict, b: dict) -> bool:
    a, b = _sorted(a), _sorted(b)
    return all(np.array_equal(a[k], b[k]) for k in a)


class _Source:
    """A finite closed-loop source over the generator; ``before(k)``
    runs before batch k is made."""

    def __init__(self, gen, n=N, before=None):
        self.gen, self.n, self.before = gen, n, before
        self.sent = 0
        self.calls = 0

    def __call__(self, ctx=None):
        if self.sent >= self.n:
            return None
        if self.before is not None:
            self.before(self.calls)
        k = min(BATCH, self.n - self.sent)
        b = TupleBatch(self.gen.columns(self.sent, k))
        self.sent += k
        self.calls += 1
        return b


class _Rows:
    """A sink (or recording stage) keeping every row it is given."""

    def __init__(self):
        self.lock = threading.Lock()
        self.parts = []

    def __call__(self, item):
        if item is None:
            return
        with self.lock:
            self.parts.append((np.asarray(item.key).copy(),
                               np.asarray(item.id).copy(),
                               np.asarray(item["value"]).copy()))

    def table(self) -> dict:
        with self.lock:
            parts = list(self.parts)
        if not parts:
            z = np.zeros(0, np.int64)
            return {"key": z, "wid": z, "value": z}
        return {k: np.concatenate([p[i] for p in parts])
                for i, k in enumerate(("key", "wid", "value"))}


def _pipeline(source, sink, record=None, device_batch=512):
    g = wf.PipeGraph("q5_nexmark", wf.Mode.DEFAULT,
                     config=wf.RuntimeConfig(device="cpu"))
    build_q5_nexmark(g, source, sink, win_len=WIN, slide_len=SLIDE,
                     watermark_lag=LAG, device_batch=device_batch,
                     inflight_depth=4, record=record)
    return g


@needs_native
@pytest.mark.parametrize("seed", SEEDS)
def test_q5_pipeline_equals_the_reference(seed):
    gen = _generator(seed)
    sink, counts = _Rows(), _Rows()
    g = _pipeline(_Source(gen), sink, record=counts)
    g.run()
    want_t = ref_torch.counts(CFG, {}, gen, N)
    want = ref_torch.windows(CFG, {}, gen, N)
    assert len(torch.unique(want_t["wid"])) == -(-N // SLIDE)
    assert _same(counts.table(), want_t)
    assert _same(sink.table(), want)
    # every window's rows arrive once, in one batch a window
    got = sink.table()
    assert len(got["key"]) == len(want["key"])
    stats = json.loads(g.stats.to_json())
    rec = [r for op in stats["Operators"] for r in op["Replicas"]
           if "Watermarks" in r]
    assert rec and rec[0]["Watermarks"] == -(-N // BATCH) + 1
    assert rec[0]["Windows_fired_watermark"] == len(want_t["key"])
    assert rec[0]["Keys_evicted"] == len(torch.unique(want_t["key"]))


@needs_native
def test_q5_windows_leave_before_the_next_batch():
    """Each window reaches the sink before the source makes its next
    batch after the watermark passed the window's end: the source waits
    for it (up to 20 s) and records whether it came."""
    gen = _generator(SEEDS[0])
    sink = _Rows()
    shipped = []        # last event index of each batch made
    missed = []

    def before(k):
        if k == 0:
            return
        wm = shipped[-1] - LAG
        due = [w for w in range(0, wm // SLIDE + 1)
               if w * SLIDE + WIN <= wm]
        t_end = time.perf_counter() + 20.0
        while time.perf_counter() < t_end:
            if set(due) <= set(sink.table()["wid"].tolist()):
                return
            time.sleep(0.002)
        missed.append((k, due))

    src = _Source(gen, before=before)
    real = src.__call__

    def call(ctx=None):
        b = real(ctx)
        if b is not None:
            shipped.append(int(b.ts[-1]))
        return b

    g = _pipeline(call, sink)
    g.run()
    assert not missed
    assert len(np.unique(sink.table()["wid"])) == -(-N // SLIDE)


def _engine_stream(seed, n=N):
    gen = _generator(seed)
    for a in range(0, n, BATCH):
        c = gen.columns(a, min(BATCH, n - a))
        bid = c["event_type"] == BID
        yield c["key"][bid], c["ts"][bid]


def _drain(eng, out):
    while eng.ready():
        r = eng.flush(1 << 20)
        out.append((r[3], r[4], r[0]))


@needs_native
def test_q5_engine_frees_the_keys_of_closed_panes():
    eng = NativeWindowEngine(WIN, SLIDE, True, 0, kind="count")
    seen_key, seen_ts = [], []
    closes = 0
    for keys, ts in _engine_stream(SEEDS[1]):
        eng.ingest(keys, ts, ts, np.zeros(len(keys)))
        seen_key.append(keys)
        seen_ts.append(ts)
        before = eng.counters()["windows_fired_watermark"]
        eng.watermark(float(ts[-1] - LAG))
        _drain(eng, [])
        c = eng.counters()
        closes += c["windows_fired_watermark"] > before
        wm_next = (int(ts[-1]) - LAG - WIN) // SLIDE + 1
        k = np.concatenate(seen_key)
        t = np.concatenate(seen_ts)
        last = np.full(k.max() + 1, -1, np.int64)
        np.maximum.at(last, k, t)
        alive = last[np.unique(k)] >= wm_next * SLIDE
        # live: the keys with a bid in a pane not yet closed
        assert c["keys_live"] == int(alive.sum())
        assert c["keys_evicted"] == int((~alive).sum())
    assert closes >= 6


@needs_native
def test_q5_watermark_inf_drains_everything():
    lg = WinSeqTPULogic("count", WIN, SLIDE, WinType.TB, batch_len=512,
                        emit_batches=True, async_dispatch=False,
                        device="cpu")
    hot = _HotItemsLogic(WIN, SLIDE)
    counts, rows = _Rows(), _Rows()

    def emit(x):
        if isinstance(x, Watermark):
            hot.on_watermark(x, rows)
        else:
            counts(x)
            hot.svc(x, 0, rows)

    gen = _generator(SEEDS[2])
    for a in range(0, N, BATCH):
        c = gen.columns(a, BATCH)
        lg.svc(TupleBatch(c).take(c["event_type"] == BID), 0, emit)
        lg.on_watermark(Watermark(a + BATCH - 1 - LAG), emit)
    lg.on_watermark(Watermark(float("inf")), emit)
    n = -(-N // BATCH) * BATCH
    assert lg._native.counters()["keys_live"] == 0
    assert _same(counts.table(), ref_torch.counts(CFG, {}, gen, n))
    assert _same(rows.table(), ref_torch.windows(CFG, {}, gen, n))
    n_counts, n_rows = len(counts.parts), len(rows.parts)
    lg.eos_flush(emit)
    hot.eos_flush(rows)
    assert (len(counts.parts), len(rows.parts)) == (n_counts, n_rows)


def test_q5_hot_items_keeps_every_tie():
    hot = _HotItemsLogic(10, 2)
    rows = _Rows()

    def batch(keys, wids, vals):
        return TupleBatch({"key": np.array(keys, np.int64),
                           "id": np.array(wids, np.int64),
                           "ts": np.zeros(len(keys), np.int64),
                           "value": np.array(vals, np.float64)})

    # window 3 first at 5 (keys 1, 2), then 7 (keys 4, 5, 6 across two
    # batches), then a 7 more; window 1 ties at 2 (out of order)
    hot.svc(batch([1, 2, 3, 9], [3, 3, 3, 1], [5, 5, 4, 2]), 0, rows)
    hot.svc(batch([4, 8, 5], [3, 1, 3], [7, 2, 7]), 0, rows)
    hot.svc(batch([6, 7], [3, 3], [7, 6]), 0, rows)
    hot.on_watermark(Watermark(11), rows)      # window 0 ends at 10
    assert rows.table()["key"].tolist() == []
    hot.on_watermark(Watermark(12), rows)      # window 1 ends at 12
    got = rows.table()
    assert sorted(got["key"].tolist()) == [8, 9]
    assert set(got["value"].tolist()) == {2.0}
    hot.eos_flush(rows)
    got = rows.table()
    w3 = got["wid"] == 3
    assert sorted(got["key"][w3].tolist()) == [4, 5, 6]
    assert set(got["value"][w3].tolist()) == {7.0}


@needs_native
def test_q5_engine_snapshot_round_trips_with_keys_evicted():
    stream = list(_engine_stream(SEEDS[0]))
    half = len(stream) // 2
    a = NativeWindowEngine(WIN, SLIDE, True, 0, kind="count")
    out_a = []
    for keys, ts in stream[:half]:
        a.ingest(keys, ts, ts, np.zeros(len(keys)))
        a.watermark(float(ts[-1] - LAG))
    # some fired windows left unstaged across the snapshot
    r = a.flush(1000)
    out_a.append((r[3], r[4], r[0]))
    assert a.counters()["keys_evicted"] > 0 and a.ready() > 0
    blob = a.serialize()
    b = NativeWindowEngine(WIN, SLIDE, True, 0, kind="count")
    b.deserialize(blob)
    assert b.serialize() == blob
    assert b.counters()["keys_live"] == a.counters()["keys_live"]
    out_b = list(out_a)
    for eng, out in ((a, out_a), (b, out_b)):
        _drain(eng, out)
        for keys, ts in stream[half:]:
            eng.ingest(keys, ts, ts, np.zeros(len(keys)))
            eng.watermark(float(ts[-1] - LAG))
            _drain(eng, out)
        eng.watermark(float("inf"))
        _drain(eng, out)
    for i in range(3):
        assert np.array_equal(np.concatenate([o[i] for o in out_a]),
                              np.concatenate([o[i] for o in out_b]))
    assert a.counters()["keys_live"] == b.counters()["keys_live"] == 0
    # a truncated watermark section is refused
    with pytest.raises(ValueError):
        b.deserialize(blob[:-8])


@needs_native
def test_q5_without_watermarks_fires_by_each_keys_tuples():
    """No watermark: a key's window fires once its own tuple passes the
    window's end, at ingest, and a key that never recurs fires only at
    the end of the stream (the pre-watermark engine's rule)."""
    eng = NativeWindowEngine(10, 2, True, 0, kind="count")
    keys = np.array([1, 1, 2], np.int64)
    ts = np.array([0, 10, 3], np.int64)
    assert eng.ingest(keys, ts, ts, np.zeros(3)) == 1
    r = eng.flush(10)
    assert (r[3].tolist(), r[4].tolist(), r[0].tolist()) == \
        ([1], [0], [1.0, 0.0, 0.0, 0.0, 0.0])
    assert eng.counters() == {"watermarks": 0, "windows_fired_watermark": 0,
                              "keys_evicted": 0, "keys_live": 2}
    eng.eos()
    r = eng.flush(100)
    assert sorted(zip(r[3].tolist(), r[4].tolist())) == \
        [(1, 1), (1, 2), (1, 3), (1, 4), (1, 5), (2, 0), (2, 1)]
    # the whole pipeline without watermarks: every window at the end
    gen = _generator(SEEDS[1])
    sink = _Rows()
    g = wf.PipeGraph("q5_plain", wf.Mode.DEFAULT,
                     config=wf.RuntimeConfig(device="cpu"))
    from windflow_tpu_torch.operators.basic_ops import Sink
    from windflow_tpu_torch.operators.batch_ops import (BatchFilter,
                                                        BatchSource)
    from windflow_tpu_torch.operators.hot_items import HotItems
    from windflow_tpu_torch.operators.tpu.farms_tpu import KeyFarmTPU
    g.add_source(BatchSource(_Source(gen))) \
        .chain(BatchFilter(lambda b: b["event_type"] == BID)) \
        .add(KeyFarmTPU("count", WIN, SLIDE, WinType.TB, batch_len=512,
                        emit_batches=True)) \
        .add(HotItems(WIN, SLIDE)).add_sink(Sink(sink))
    g.run()
    assert _same(sink.table(), ref_torch.windows(CFG, {}, gen, N))


@pytest.mark.parametrize("seed", SEEDS)
def test_q5_reference_copies_agree(seed):
    gen = _generator(seed)
    ref_np = _load("wfbench/reference/nexmark_q5.py", "q5_ref_np")
    n = 123_457
    t_np = ref_np.counts(CFG, {}, gen, n)
    t_torch = ref_torch.counts(CFG, {}, gen, n)
    assert _same(t_np, t_torch)
    sums = ref_torch.totals(t_torch)
    assert _same(ref_np.totals(t_np), sums)
    hot = ref_torch.windows(CFG, {}, gen, n)
    assert _same(ref_np.windows(CFG, {}, gen, n),
                 {k: torch.cat([hot[k], sums[k]]) for k in hot})
    # both against the generator's own bids, counted per (auction, window)
    c = gen.columns(0, n)
    bid = c["event_type"] == BID
    key, ts = c["key"][bid], c["ts"][bid]
    k = WIN // SLIDE
    pairs = [(a, w) for a, t in zip(key.tolist(), ts.tolist())
             for w in range(max(0, t // SLIDE - k + 1), t // SLIDE + 1)]
    u, cnt = np.unique(np.array(pairs, np.int64), axis=0,
                       return_counts=True)
    assert _same({"key": u[:, 0], "wid": u[:, 1], "value": cnt}, t_np)
    # the law's shape: 46 bids in 50 events, half of them hot
    assert abs(bid.mean() - 46 / 50) < 1e-3
    idx, auc = ref_torch.auctions(CFG, seed, 0, n)
    last = (idx // 50) * 3 + 2 + CFG["first_auction_id"]
    hot = auc == torch.div(last - CFG["first_auction_id"], 100,
                           rounding_mode="floor") * 100 \
        + CFG["first_auction_id"]
    assert abs(float(hot.float().mean()) - 0.5) < 0.01
    assert int((auc - last).max()) == CFG["auction_id_lead"]


@needs_native
def test_q5_hot_items_snapshot_round_trips_mid_close():
    """Snapshots of the window engine and of the hot-items step, taken
    when a close's counts have reached the step and the watermark that
    emits them has not, restore into fresh logics that emit what the
    uninterrupted pair emits."""
    def logics():
        return (WinSeqTPULogic("count", WIN, SLIDE, WinType.TB,
                               batch_len=512, emit_batches=True,
                               async_dispatch=False, device="cpu"),
                _HotItemsLogic(WIN, SLIDE))

    gen = _generator(SEEDS[1])
    n = -(-N // BATCH) * BATCH
    lg, hot = logics()
    before, after_a, after_b = _Rows(), _Rows(), _Rows()
    held = []

    def feed(lg, hot, rows, a):
        """Batch a into the engine; its counts go on to the step, its
        watermarks are held back."""
        def emit(x):
            if isinstance(x, Watermark):
                held.append(x)
            else:
                hot.svc(x, 0, rows)
        c = gen.columns(a, BATCH)
        lg.svc(TupleBatch(c).take(c["event_type"] == BID), 0, emit)
        lg.on_watermark(Watermark(a + BATCH - 1 - LAG), emit)

    def release(hot, rows):
        for wm in held:
            hot.on_watermark(wm, rows)
        held.clear()

    starts = list(range(0, n, BATCH))
    closes = 0
    for i, a in enumerate(starts):
        feed(lg, hot, before, a)
        closes += bool(hot.best)
        if closes == 2:
            break
        release(hot, before)
    assert hot.best and held          # mid-close
    snap = pickle.loads(pickle.dumps((lg.state_dict(), hot.state_dict())))
    lg2, hot2 = logics()
    lg2.load_state(snap[0])
    hot2.load_state(snap[1])
    wms = list(held)
    for lgx, hotx, rows in ((lg, hot, after_a), (lg2, hot2, after_b)):
        held[:] = wms
        release(hotx, rows)
        for a in starts[i + 1:]:
            feed(lgx, hotx, rows, a)
            release(hotx, rows)
        lgx.on_watermark(Watermark(float("inf")),
                         lambda x: hotx.on_watermark(x, rows)
                         if isinstance(x, Watermark)
                         else hotx.svc(x, 0, rows))
        assert not hotx.best
    assert len(after_a.parts) > 0
    assert _same(after_a.table(), after_b.table())
    whole = {k: np.concatenate([before.table()[k], after_b.table()[k]])
             for k in ("key", "wid", "value")}
    assert _same(whole, ref_torch.windows(CFG, {}, gen, n))


def _bench_modules():
    return (_load("wfbench/configs/nexmark_q5.py", "q5_cfg_bench"),
            _load("wfbench/reference/nexmark_q5.py", "q5_ref_bench"))


def _count_batches(table: dict, rows: int = 1000):
    for a in range(0, len(table["key"]), rows):
        key = np.asarray(table["key"][a:a + rows], np.int64)
        wid = np.asarray(table["wid"][a:a + rows], np.int64)
        yield TupleBatch({"key": key, "id": wid, "ts": wid * SLIDE,
                          "value": np.asarray(table["value"][a:a + rows],
                                              np.float32)})


@pytest.mark.parametrize("fault", [None, "drop", "shift", "swap",
                                   "double"])
def test_q5_window_sums_catch_a_fault_off_the_maximum(fault):
    """The benchmark's window sums, computed from the counts the engine
    emits, hold the whole count table to the reference: a count dropped,
    moved to another auction, swapped between two auctions or emitted
    twice fails the comparison even where every hot row is right."""
    from wfbench import harness
    cfg_mod, ref_np = _bench_modules()
    gen = _generator(SEEDS[0])
    n = 123_457
    table = ref_np.counts(CFG, {}, gen, n)
    want = ref_np.windows(CFG, {}, gen, n)
    hot = want["key"] >= 0
    # a window, and two of its auctions below its maximum whose counts
    # and hash weights differ
    w = int(table["wid"][len(table["wid"]) // 2])
    rows = np.flatnonzero(table["wid"] == w)
    top = table["value"][rows].max()
    low = rows[table["value"][rows] < top - 1]
    i = low[0]
    j = next(r for r in low if table["value"][r] != table["value"][i]
             and cfg_mod.weight(table["key"][r])
             != cfg_mod.weight(table["key"][i]))
    t = {k: v.copy() for k, v in table.items()}
    if fault == "drop":
        t = {k: np.delete(v, i) for k, v in t.items()}
    elif fault == "shift":
        t["value"][i] += 1
        t["value"][j] -= 1
    elif fault == "swap":
        t["value"][[i, j]] = t["value"][[j, i]]
    elif fault == "double":
        t = {k: np.insert(v, i, v[i]) for k, v in t.items()}
    out = harness.Sink(harness.make_span(False))
    totals = cfg_mod.WindowTotals(out, lambda label: nullcontext(),
                                  WIN, SLIDE)
    for b in _count_batches(t):
        totals.record(b)
    for v in np.unique(want["wid"][hot]):
        sel = hot & (want["wid"] == v)
        totals(TupleBatch({"key": want["key"][sel], "id": want["wid"][sel],
                           "ts": want["wid"][sel] * SLIDE + WIN - 1,
                           "value": want["value"][sel]}))
    checks = harness.compare(out.arrays(), want, 0.0)[0]
    assert harness.verdict(checks) == (fault is None), checks


@needs_native
def test_q5_cell_runs_correct_through_the_harness(tmp_path):
    """The cell, with its configuration at event rate 10,000 a second,
    through the benchmark's harness on the CPU: correct, its first
    window closed before the measured window, and every window judged
    by its three sums beside its hot rows."""
    from wfbench import harness
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "wfbench", tmp_path / "wfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    p = tmp_path / "wfbench" / "configs" / "nexmark_q5.json"
    d = json.loads(p.read_text())
    d["event_rate"] = RATE
    p.write_text(json.dumps(d))
    spec = harness.Spec("nexmark_q5.saturate", tmp_path)
    run, stream = harness.run_cell(spec, SEEDS[1], 1.0, False,
                                   device="cpu", warm_timeout_s=120.0)
    checks = harness.judge(run, stream)
    assert harness.verdict(checks), checks
    got = run.results
    wins = np.unique(got["wid"])
    assert len(wins) >= 6
    for key in (-1, -2, -3):
        assert np.array_equal(np.sort(got["wid"][got["key"] == key]), wins)
    n_hot = int((got["key"] >= 0).sum())
    assert run.attempted == n_hot + 3 * len(wins)
