"""The port's BatchFilter defers its row selection (core/tuples.py
``DeferredBatch``; operators/batch_ops.py): a logic on its own thread
gathers the columns it reads, and an outlet (runtime/node.py) gathers
every column before the output enters a channel.

Unit cases, over five masks (scattered, empty, all true, a contiguous
run, a single row) and four payload columns (int64, float64, S13,
S36): every column of the deferred selection equals ``TupleBatch.take``
of the same rows, dtype and bytes; ``len`` gathers nothing; a column
read gathers that column once; the whole-batch views (``cols``,
``with_cols``, ``concat``, ``records``, pickling) see every column;
take of a take is the eager composition; the trace context rides on;
what an outlet sends on is a plain batch; the filter's record counts
the bytes an eager take copies and the bytes gathered.

Pipeline cases, wired three ways (filter and map chained into the
source, added and fused by LEVEL2, added at LEVEL0 as their own
stages): the windows of ``BatchSource -> BatchFilter -> BatchMap ->
KeyFarmTPU`` and of the Yahoo model equal the reference's and the
oracle's; only the columns read are gathered where the filter's
consumer shares its thread, and every column where the output enters a
channel, as a plain batch.
"""
import importlib
import json
import pickle

import numpy as np
import pytest

import windflow_tpu_torch as wf
from windflow_tpu_torch.core.tuples import DeferredBatch, TupleBatch
from windflow_tpu_torch.monitoring.stats import StatsRecord
from windflow_tpu_torch.operators.basic_ops import Sink
from windflow_tpu_torch.operators.batch_ops import (BatchFilter, BatchMap,
                                                    BatchSource,
                                                    _BatchFilterLogic)
from windflow_tpu_torch.runtime.emitters import StandardEmitter
from windflow_tpu_torch.runtime.node import Outlet

from torch_graphs import PACKAGES, PORT, mod, tb_counts, yahoo_oracle

N = 64
MASKS = {
    "scattered": lambda n: np.arange(n) % 3 != 1,
    "empty": lambda n: np.zeros(n, bool),
    "all_true": lambda n: np.ones(n, bool),
    "contiguous": lambda n: (np.arange(n) >= 9) & (np.arange(n) < 40),
    "single": lambda n: np.arange(n) == 17,
}
# masks whose rows an eager take copies (the others are a slice view
# or nothing)
GATHERED = {"scattered", "single"}
DTYPES = ("int64", "float64", "S13", "S36")


def _batch(dtype: str, n: int = N) -> TupleBatch:
    rng = np.random.default_rng(7)
    ids = np.arange(n, dtype=np.int64)
    if dtype.startswith("S"):
        width = int(dtype[1:])
        pay = np.array([(b"%x" % v).rjust(width, b"0")
                        for v in rng.integers(0, 1 << 40, n)], dtype)
    elif dtype == "int64":
        pay = rng.integers(-1 << 40, 1 << 40, n)
    else:
        pay = rng.standard_normal(n)
    return TupleBatch({"key": ids * 7 % 5, "id": ids, "ts": ids + 100,
                       "payload": pay})


def _deferred(batch, mask, stats=None):
    return DeferredBatch(batch, np.nonzero(mask)[0], stats)


def _same_batch(got, want):
    assert list(got.cols) == list(want.cols)
    assert len(got) == len(want)
    for name, col in want.cols.items():
        assert got.cols[name].dtype == col.dtype, name
        assert got.cols[name].tobytes() == col.tobytes(), name


class _Channel:
    """The two puts an outlet makes, recorded."""

    def __init__(self):
        self.items = []

    def put(self, producer_id, item):
        self.items.append(item)

    def put_many(self, producer_id, items):
        self.items.extend(items)


def _filter_out(batch, mask, boundary, stats=None):
    """What a filter logic emits for ``batch`` under ``mask``, to the
    next logic on its thread (``thread``) or into a channel through an
    outlet's ``send`` or ``send_many``."""
    logic = _BatchFilterLogic(lambda b: mask)
    logic.stats = stats
    out = []
    logic.svc(batch, 0, out.append)
    if boundary == "thread":
        return out
    ch = _Channel()
    outlet = Outlet(StandardEmitter(), [(ch, 0)])
    if boundary == "send":
        for item in out:
            outlet.send(item)
    else:
        outlet.send_many(out)
    return ch.items


BOUNDARIES = ("thread", "send", "send_many")


cases = pytest.mark.parametrize("dtype", DTYPES)
masks = pytest.mark.parametrize("mask_name", list(MASKS))


@cases
@masks
def test_deferred_columns_equal_the_eager_take(mask_name, dtype):
    batch = _batch(dtype)
    mask = MASKS[mask_name](N)
    want = batch.take(mask)
    d = _deferred(batch, mask)
    for name, col in want.cols.items():
        got = d[name]
        assert got.dtype == col.dtype and got.shape == col.shape
        assert got.tobytes() == col.tobytes(), name
    for prop in ("key", "id", "ts"):
        assert getattr(d, prop).tobytes() == getattr(want, prop).tobytes()


@cases
@masks
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_filter_output_equals_the_eager_take(mask_name, dtype, boundary):
    """The filter keeps its decisions: nothing for an empty selection, a
    zero-copy slice for a contiguous run, a deferred selection for a
    scattered one, which reaches a channel as a plain batch."""
    batch = _batch(dtype)
    mask = MASKS[mask_name](N)
    out = _filter_out(batch, mask, boundary)
    want = batch.take(mask)
    if mask_name == "empty":
        assert out == []
        return
    (got,) = out
    _same_batch(got, want)
    if mask_name in GATHERED:
        assert type(got) is (DeferredBatch if boundary == "thread"
                             else TupleBatch)
    else:
        assert type(got) is TupleBatch
        assert np.shares_memory(got["payload"], batch["payload"])


@cases
@masks
def test_len_gathers_nothing(mask_name, dtype):
    st = StatsRecord()
    d = _deferred(_batch(dtype), MASKS[mask_name](N), st)
    assert len(d) == int(MASKS[mask_name](N).sum())
    assert d._cache == {}
    assert st.bytes_gathered == 0


@cases
@masks
def test_one_column_read_gathers_it_once(mask_name, dtype):
    st = StatsRecord()
    d = _deferred(_batch(dtype), MASKS[mask_name](N), st)
    first = d["payload"]
    assert d["payload"] is first
    assert list(d._cache) == ["payload"]
    assert st.bytes_gathered == first.nbytes
    d.ts
    d.ts
    assert list(d._cache) == ["payload", "ts"]
    assert st.bytes_gathered == first.nbytes + d.ts.nbytes


@cases
@masks
@pytest.mark.parametrize("view", ["cols", "with_cols", "concat",
                                  "records", "pickle"])
def test_whole_batch_views_see_every_column(view, mask_name, dtype):
    batch = _batch(dtype)
    mask = MASKS[mask_name](N)
    want = batch.take(mask)
    d = _deferred(batch, mask)
    if view == "cols":
        _same_batch(TupleBatch(d.cols), want)
        assert d.payload_names() == want.payload_names() == ["payload"]
    elif view == "with_cols":
        extra = np.arange(len(want))
        _same_batch(d.with_cols(extra=extra), want.with_cols(extra=extra))
    elif view == "concat":
        _same_batch(d.concat(d), want.concat(want))
        _same_batch(want.concat(d), want.concat(want))
    elif view == "records":
        class Rec(wf.BasicRecord):
            payload = None
        got = [(r.key, r.id, r.ts, r.payload) for r in d.records(Rec)]
        assert got == [(r.key, r.id, r.ts, r.payload)
                       for r in want.records(Rec)]
    else:
        back = pickle.loads(pickle.dumps(d))
        assert type(back) is TupleBatch
        _same_batch(back, want)
    assert set(d._cache) == set(batch.cols)


@cases
@masks
@pytest.mark.parametrize("second", ["mask", "indices", "slice"])
def test_take_of_take_is_the_eager_composition(second, mask_name, dtype):
    batch = _batch(dtype)
    mask = MASKS[mask_name](N)
    d = _deferred(batch, mask)
    eager = batch.take(mask)
    n = len(eager)
    sel = {"mask": np.arange(n) % 2 == 0,
           "indices": np.arange(n)[::-3],
           "slice": slice(1, max(n - 1, 1))}[second]
    got = d.take(sel)
    assert type(got) is DeferredBatch
    assert got._cache == {} and d._cache == {}
    _same_batch(got, eager.take(sel))


@cases
@masks
def test_trace_context_rides_on(mask_name, dtype):
    batch = _batch(dtype)
    ctx = ("trace", 7)
    batch.trace = ctx
    d = _deferred(batch, MASKS[mask_name](N))
    assert d.trace is ctx
    assert d.take(slice(0, 1)).trace is ctx
    assert d.materialize().trace is ctx
    assert d.with_cols(extra=np.zeros(len(d))).trace is ctx
    assert pickle.loads(pickle.dumps(d)).trace == ctx


@cases
@masks
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_filter_record_counts_selected_and_gathered(mask_name, dtype,
                                                    boundary):
    """Bytes selected: what the eager take copies.  Bytes gathered: all
    of it where the output enters a channel, the columns read where a
    logic on the filter's thread consumes it."""
    batch = _batch(dtype)
    mask = MASKS[mask_name](N)
    want = batch.take(mask)
    st = StatsRecord()
    out = _filter_out(batch, mask, boundary, st)
    eager_bytes = sum(c.nbytes for c in want.cols.values()) \
        if mask_name in GATHERED else 0
    assert st.bytes_selected == eager_bytes
    if boundary != "thread" or mask_name not in GATHERED:
        assert st.bytes_gathered == eager_bytes
        return
    assert st.bytes_gathered == 0
    (d,) = out
    read = d["payload"].nbytes + d.id.nbytes
    assert st.bytes_gathered == read
    rec = st.to_dict()
    assert rec["Bytes_selected"] == eager_bytes
    assert rec["Bytes_gathered"] == read


# ---------------------------------------------------------------------------
# pipelines: the port against the reference (torch_graphs.py)
# ---------------------------------------------------------------------------

WIRINGS = ("chained", "fused", "standalone")
BATCH = 4096
N_BATCHES = 10
N_ADS = 40
N_CAMPAIGNS = 7
WIN = SLIDE = 6000
EVENT_TYPES = np.array([b"view", b"click", b"purchase"], "S8")
# bytes a row of the source's batch, and the columns the map reads
ROW_BYTES = 8 * 3 + 36 + 36 + 13 + 8
READ_BYTES = 36 + 8 + 13


def _ads():
    return np.array([b"%036x" % (i * 7919 + 11) for i in range(N_ADS)],
                    "S36")


def _stream():
    """Every batch of the source, made once (seeded)."""
    rng = np.random.default_rng(11)
    ads = _ads()
    out = []
    for b in range(N_BATCHES):
        ids = np.arange(b * BATCH, (b + 1) * BATCH, dtype=np.int64)
        out.append({
            "key": np.zeros(BATCH, np.int64), "id": ids, "ts": ids,
            "ad_id": ads[rng.integers(0, N_ADS, BATCH)],
            "user_id": ads[rng.integers(0, N_ADS, BATCH)][::-1].copy(),
            "event_time": np.char.zfill(ids.astype("S13"), 13),
            "event_type": EVENT_TYPES[rng.integers(0, 3, BATCH)]})
    return out


def _oracle(stream):
    ads = _ads()
    camp = np.arange(N_ADS) % N_CAMPAIGNS
    keys, ts = [], []
    for cols in stream:
        view = cols["event_type"] == b"view"
        keys.append(camp[np.searchsorted(ads, cols["ad_id"][view])])
        ts.append(cols["event_time"][view].astype(np.int64))
    return tb_counts(np.concatenate(keys), np.concatenate(ts), WIN, SLIDE)


def _filter_graph(pkg, wiring, tmp_path, stream):
    """``BatchSource -> BatchFilter -> BatchMap -> KeyFarmTPU -> Sink``
    of package ``pkg``; returns (windows, graph)."""
    pwf = importlib.import_module(pkg)
    ops = mod(pkg, "operators.batch_ops")
    TB = mod(pkg, "core.tuples").TupleBatch
    farm = mod(pkg, "operators.tpu.farms_tpu").KeyFarmTPU
    order = np.argsort(_ads())
    ads = _ads()[order]
    camp = (np.arange(N_ADS) % N_CAMPAIGNS)[order]
    level = pwf.OptLevel.LEVEL0 if wiring == "standalone" \
        else pwf.OptLevel.LEVEL2
    cfg = dict(opt_level=level)
    if pkg == PORT:
        cfg.update(device="cpu", tracing=True, log_dir=str(tmp_path))
    g = pwf.PipeGraph(f"deferred_{wiring}", pwf.Mode.DEFAULT,
                      config=pwf.RuntimeConfig(**cfg))
    sent = {"n": 0}

    def source(ctx=None):
        i = sent["n"]
        if i >= len(stream):
            return None
        sent["n"] = i + 1
        return TB(dict(stream[i]))

    def views(batch):
        return batch["event_type"] == b"view"

    def join(batch):
        return TB({"key": camp[np.searchsorted(ads, batch["ad_id"])],
                   "id": batch.id,
                   "ts": batch["event_time"].astype(np.int64),
                   "value": np.ones(len(batch))})

    rows = {}

    def sink(b):
        if b is None:
            return
        for k, w, v in zip(np.asarray(b.key).tolist(),
                           np.asarray(b.id).tolist(),
                           np.asarray(b["value"]).tolist()):
            assert (k, w) not in rows, "a window arrived twice"
            rows[(k, w)] = v

    pipe = g.add_source(ops.BatchSource(source, name="src"))
    join_op = pipe.chain if wiring == "chained" else pipe.add
    join_op(ops.BatchFilter(views, name="views"))
    join_op(ops.BatchMap(join, name="join"))
    pipe.add(farm("count", WIN, SLIDE, pwf.WinType.TB, batch_len=64,
                  name="count", emit_batches=True))
    pipe.add_sink(mod(pkg, "operators.basic_ops").Sink(sink, name="sink"))
    g.run()
    return rows, g


def _filter_bytes(g):
    """(Bytes_selected, Bytes_gathered) of the one record holding them."""
    reps = [r for op in json.loads(g.stats.to_json())["Operators"]
            for r in op["Replicas"] if "Bytes_selected" in r]
    assert len(reps) == 1, reps
    return reps[0]["Bytes_selected"], reps[0]["Bytes_gathered"]


@pytest.mark.parametrize("wiring", WIRINGS)
def test_filter_graph_equals_the_reference(wiring, tmp_path):
    stream = _stream()
    want = _oracle(stream)
    ref, _ = _filter_graph(PACKAGES[0], wiring, tmp_path, stream)
    port, g = _filter_graph(PORT, wiring, tmp_path, stream)
    assert port == ref == want
    assert want
    kept = sum(int((c["event_type"] == b"view").sum()) for c in stream)
    selected, gathered = _filter_bytes(g)
    assert selected == kept * ROW_BYTES
    if wiring == "standalone":
        # the output enters a channel: gathered eagerly, every column
        assert gathered == selected
    else:
        # the map on the filter's thread reads ad_id, id and event_time
        assert gathered == kept * READ_BYTES


@pytest.mark.parametrize("opt", ["LEVEL0", "LEVEL2"])
def test_yahoo_model_equals_the_reference(opt, tmp_path):
    """The Yahoo model chains its filter and join; the join's
    ``with_cols`` reads every column of the selection."""
    n, batch, device_batch = 60_000, 4096, 512
    tables = []
    for pkg in PACKAGES:
        pwf = importlib.import_module(pkg)
        cfg = dict(opt_level=getattr(pwf.OptLevel, opt))
        if pkg == PORT:
            cfg.update(device="cpu", tracing=True, log_dir=str(tmp_path))
        g = pwf.PipeGraph(f"yahoo_{opt}", pwf.Mode.DEFAULT,
                          config=pwf.RuntimeConfig(**cfg))
        rows = []
        mod(pkg, "models.yahoo").build_pipeline(
            g, n, batch_size=batch, device_batch=device_batch,
            sink=lambda b: b is not None and rows.extend(zip(
                np.asarray(b.key).tolist(), np.asarray(b.id).tolist(),
                np.asarray(b["value"]).tolist())))
        g.run()
        tables.append({(k, w): v for k, w, v in rows})
    want = yahoo_oracle(PACKAGES[0], n, 1000, 100, 10_000, batch)
    assert tables[1] == tables[0] == want
    selected, gathered = _filter_bytes(g)
    assert selected == gathered > 0


@pytest.mark.parametrize("consumer", ["channel", "pass_through"])
def test_output_entering_a_channel_is_a_plain_batch(consumer, tmp_path):
    """At LEVEL0 the sink is its own thread.  The outlet materializes
    the selection before the channel, whether the filter is last in its
    chain or a map after it returns its input."""
    got = []
    g = wf.PipeGraph(f"plain_{consumer}", wf.Mode.DEFAULT,
                     config=wf.RuntimeConfig(
                         device="cpu", opt_level=wf.OptLevel.LEVEL0,
                         tracing=True, log_dir=str(tmp_path)))
    batches = [_batch("S36", 512) for _ in range(3)]

    def source(ctx=None):
        return batches.pop() if batches else None

    pipe = g.add_source(BatchSource(source, name="src"))
    pipe.chain(BatchFilter(lambda b: b.id % 3 != 1, name="f"))
    if consumer == "pass_through":
        pipe.chain(BatchMap(lambda b: b, name="same"))
    pipe.add_sink(Sink(lambda b: b is not None and got.append(b),
                       name="sink"))
    g.run()
    want = _batch("S36", 512).take(np.arange(512) % 3 != 1)
    assert len(got) == 3
    for b in got:
        assert type(b) is TupleBatch
        _same_batch(b, want)
    selected, gathered = _filter_bytes(g)
    assert gathered == selected == 3 * sum(c.nbytes
                                           for c in want.cols.values())
