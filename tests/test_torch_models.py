"""The application models of the port (windflow_tpu_torch/models/: the
five BASELINE configs, the Yahoo Streaming Benchmark and the NEXMark
queries) against the reference (windflow_tpu/models/), the same graph
built by each package's own builder on the same seeded streams.  The
port runs with ``RuntimeConfig(device="cpu")``; the reference as its
own tests run it (tests/test_models_configs.py, tests/test_fusion.py).

What must match, and how:

* window counts (Yahoo, Q5) and config 1's total: exact, in both
  packages and against a numpy oracle;
* Q7's maxima: exact -- each window equals float32 of the float64
  oracle's max, since rounding to f32 is monotone;
* sums of random values (configs 2-4): keys and window ids exact, each
  window within rtol 1e-5 of the reference and of a float64 oracle
  (f32 sums added in other orders);
* ``make_step``: the port's counts equal JAX's exactly (whole numbers
  below 2^24);
* the device step: step on and step off bitwise equal, both equal to
  the reference, at most 2 launches per ingest chunk;
* the NEXMark generators and oracles: equal exactly;
* the event-time queries (Q3, Q4, Q6, Q8): the port's results equal
  the reference's and the oracles exactly.

Sizes are the reference tests' own (at most 60,000 events a graph).
"""
import importlib
import threading

import numpy as np
import pytest
import torch

from torch_graphs import (PACKAGES, PORT, mod, q5_oracle, q7_oracle,
                          yahoo_oracle)

REF = PACKAGES[0]
RTOL_F32 = 1e-5


def _graph(pkg, name, **cfg):
    """A PipeGraph of package ``pkg``; the port's on the CPU."""
    wf = importlib.import_module(pkg)
    config = wf.RuntimeConfig(**cfg)
    if pkg == PORT:
        config.device = "cpu"
    return wf.PipeGraph(name, wf.Mode.DEFAULT, config=config)


class Rows:
    """A sink (and a stand-in for configs.ResultCollector) keeping every
    window as (key, id, value), plus the collector's count and total."""

    def __init__(self):
        self.lock = threading.Lock()
        self.rows = []
        self.count = 0
        self.total = 0.0

    def __call__(self, item):
        if item is None:
            return
        with self.lock:
            if hasattr(item, "cols"):
                vals = np.asarray(item["value"], np.float64)
                self.rows += zip(np.asarray(item.key).tolist(),
                                 np.asarray(item.id).tolist(),
                                 vals.tolist())
                self.count += len(vals)
                self.total += float(vals.sum())
            else:
                self.rows.append((item.key, item.id, item.value))
                self.count += 1
                if isinstance(item.value, float):
                    self.total += item.value

    def table(self):
        """{(key, id): value}; each window arrives once."""
        out = dict(((k, i), v) for k, i, v in self.rows)
        assert len(out) == len(self.rows), "a window arrived twice"
        return out


def _same_windows(got, want, rtol=0.0):
    assert sorted(got) == sorted(want)
    for kw, v in want.items():
        if rtol:
            assert abs(got[kw] - v) <= rtol * abs(v), (kw, got[kw], v)
        else:
            assert got[kw] == v, (kw, got[kw], v)


# ---------------------------------------------------------------------------
# oracles
# ---------------------------------------------------------------------------

def _batch_stream_sums(n_events, n_keys, win, slide):
    """{(key, w): float64 sum} of configs 2-4's stream (batch_stream:
    key = i % n_keys, ts = i // n_keys) under TB windows."""
    fn = mod(REF, "utils.synthetic").batch_stream(n_events, n_keys)
    vals = []
    while (b := fn(None)) is not None:
        vals.append(b["value"])
    vals = np.concatenate(vals)
    out = {}
    for k in range(n_keys):
        v = vals[k::n_keys]                      # ts 0, 1, ... of key k
        c = np.concatenate([[0.0], np.cumsum(v)])
        for w in range((len(v) - 1) // slide + 1):
            out[(k, w)] = float(c[min(w * slide + win, len(v))]
                                - c[w * slide])
    return out


# ---------------------------------------------------------------------------
# the configs: tests/test_models_configs.py
# ---------------------------------------------------------------------------

def _run_config(pkg, name, monkeypatch, **kw):
    configs = mod(pkg, "models.configs")
    monkeypatch.setattr(configs, "ResultCollector", Rows)
    g = _graph(pkg, "cfg")
    coll = getattr(configs, name)(g, **kw)
    g.run()
    return coll


def test_config1_cpu_multipipe(monkeypatch):
    kw = dict(n_events=2000, n_keys=4, win=50)
    ref, port = (_run_config(pkg, "config_cpu_multipipe", monkeypatch, **kw)
                 for pkg in PACKAGES)
    assert port.total == ref.total == 2 * 4 * sum(range(2000 // 4))
    _same_windows(port.table(), ref.table())


@pytest.mark.parametrize("name,kw", [
    ("config_win_seq_tpu",
     dict(n_events=20000, n_keys=8, win=256, slide=128, batch=64)),
    ("config_pane_farm_tpu",
     dict(n_events=20000, n_keys=8, win=256, slide=128, batch=64)),
    ("config_key_farm_tpu",
     dict(n_events=20000, n_keys=16, win=256, slide=128, batch=64,
          parallelism=2)),
])
def test_config_device_sums(name, kw, monkeypatch):
    """Configs 2-4 (the reference asserts a window came out): every
    window of the port against the reference's and a float64 oracle."""
    ref, port = (_run_config(pkg, name, monkeypatch, **kw)
                 for pkg in PACKAGES)
    want = _batch_stream_sums(kw["n_events"], kw["n_keys"], kw["win"],
                              kw["slide"])
    assert port.count == ref.count == len(want) > 0
    _same_windows(port.table(), ref.table(), RTOL_F32)
    _same_windows(port.table(), want, RTOL_F32)


def test_config5_yahoo(monkeypatch):
    kw = dict(n_events=50000, n_ads=100, n_campaigns=10, win_len=2000,
              slide_len=2000, batch_size=8192, device_batch=64)
    ref, port = (_run_config(pkg, "config_yahoo", monkeypatch, **kw)
                 for pkg in PACKAGES)
    want = yahoo_oracle(REF, 50000, 100, 10, 2000, 8192)
    _same_windows(port.table(), want)
    _same_windows(ref.table(), want)
    assert port.total == ref.total == sum(want.values())


# ---------------------------------------------------------------------------
# the Yahoo step: models/yahoo.make_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,args_kw", [
    ((10, 4, 256), dict(n_events=1024, n_ads=50, n_campaigns=10,
                        n_windows=4, win_len=256)),
    ((10, 4, 256), {}),                       # the default events
    ((100, 8, 1024), {}),
])
def test_yahoo_step_matches_jax(shape, args_kw):
    ref_y, port_y = (mod(pkg, "models.yahoo") for pkg in PACKAGES)
    n_campaigns, n_windows, win_len = shape
    if not args_kw:
        args_kw = dict(n_campaigns=n_campaigns, n_windows=n_windows,
                       win_len=win_len)
    args = ref_y.example_step_args(**args_kw)
    port_args = port_y.example_step_args(**args_kw)
    for a, b in zip(args, port_args):
        np.testing.assert_array_equal(a, b)
    want = np.asarray(ref_y.make_step(*shape)(*args))
    got = port_y.make_step(*shape, device="cpu")(*port_args)
    assert got.dtype == torch.float32 and got.shape == shape[:2]
    np.testing.assert_array_equal(got.numpy(), want)
    camp, ad, et, ts, counts = args
    assert got.sum().item() == (et == ref_y.VIEW).sum()
    assert not counts.any(), "the step wrote its input"
    # tensors on the CPU run there, whatever device the step was made for
    got_t = port_y.make_step(*shape)(*(torch.as_tensor(a) for a in args))
    np.testing.assert_array_equal(got_t.numpy(), want)


def test_yahoo_step_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    yahoo = mod(PORT, "models.yahoo")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        yahoo.make_step(10, 4, 256)(*yahoo.example_step_args(
            n_events=64, n_ads=50, n_campaigns=10, n_windows=4,
            win_len=256))


def test_models_graph_defaults_to_cuda():
    """A models graph with a default RuntimeConfig runs on the card and
    raises where there is none; the graph starts no thread before."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    wf = importlib.import_module(PORT)
    before = set(threading.enumerate())
    g = wf.PipeGraph("q5", wf.Mode.DEFAULT)
    mod(PORT, "models.nexmark").build_q5_hot_items(
        g, 4096, 1 << 10, 1 << 9, Rows(), n_auctions=8, batch_size=1024,
        device_batch=256)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        g.run()
    assert not [t for t in threading.enumerate()
                if t not in before and t.is_alive()]


# ---------------------------------------------------------------------------
# NEXMark: TestNexmark of tests/test_models_configs.py
# ---------------------------------------------------------------------------

def test_q1_q2_stateless():
    outs = {}
    for pkg in PACKAGES:
        nx = mod(pkg, "models.nexmark")
        pool = nx.synth_bids(10_000, n_auctions=50)
        tb = mod(pkg, "core.tuples").TupleBatch(
            {"key": pool["auction"], "id": pool["ts"], "ts": pool["ts"],
             "value": pool["price"]})
        mask = nx.make_q2_selection({3, 7, 11})(tb)
        outs[pkg] = (nx.q1_currency(tb)["value"], mask, pool)
    (v0, m0, p0), (v1, m1, p1) = outs[REF], outs[PORT]
    for c in p0:
        np.testing.assert_array_equal(p1[c], p0[c])
    np.testing.assert_array_equal(v1, v0)
    np.testing.assert_array_equal(v1, p0["price"] * 0.9)
    np.testing.assert_array_equal(m1, m0)
    assert m1.sum() == np.isin(p0["auction"], [3, 7, 11]).sum()


def test_bid_batches_match_reference():
    fns = [mod(pkg, "models.nexmark").bid_batches(40_000, 16_384, 40)
           for pkg in PACKAGES]
    while True:
        ref, port = (fn(None) for fn in fns)
        if ref is None:
            assert port is None
            break
        for c in ref.cols:
            np.testing.assert_array_equal(port[c], ref[c])


def test_q5_hot_items():
    N, NA, WINL, SL = 60_000, 40, 8192, 4096
    tables = []
    for pkg in PACKAGES:
        sink = Rows()
        g = _graph(pkg, "q5")
        mod(pkg, "models.nexmark").build_q5_hot_items(
            g, N, WINL, SL, sink, n_auctions=NA, batch_size=16_384,
            device_batch=512)
        g.run()
        tables.append(sink.table())
    want = q5_oracle(REF, N, NA, WINL, SL, 16_384)
    _same_windows(tables[0], want)
    _same_windows(tables[1], want)


def test_q7_highest_bid():
    N, WINL = 50_000, 10_000
    tables = []
    for pkg in PACKAGES:
        sink = Rows()
        g = _graph(pkg, "q7")
        mod(pkg, "models.nexmark").build_q7_highest_bid(
            g, N, WINL, sink, batch_size=16_384, device_batch=256)
        g.run()
        tables.append({i: v for (_k, i), v in sink.table().items()})
    want = q7_oracle(REF, N, WINL, 16_384)
    assert tables[1] == tables[0] == want


# ---------------------------------------------------------------------------
# the device step on the models' graphs: tests/test_fusion.py:509-551
# ---------------------------------------------------------------------------

def _build_app(pkg, query, g, sink):
    if query == "yahoo":
        mod(pkg, "models.yahoo").build_pipeline(
            g, 60_000, batch_size=4096, device_batch=512, sink=sink)
        return
    nx = mod(pkg, "models.nexmark")
    if query == "q5":
        nx.build_q5_hot_items(g, 60_000, 1 << 12, 1 << 11, sink,
                              batch_size=4096, device_batch=512)
    else:
        nx.build_q7_highest_bid(g, 60_000, 1 << 12, sink,
                                batch_size=4096, device_batch=512)


def _step_info(pkg, g):
    DeviceStepLogic = mod(pkg, "graph.device_step").DeviceStepLogic
    return {n.name: (n.logic.chunks_in, n.logic.chunk_launches)
            for n in g._all_nodes() if isinstance(n.logic, DeviceStepLogic)}


def _run_app(pkg, query, step, force_python):
    OptLevel = mod(pkg, "core.basic").OptLevel
    sink = Rows()
    g = _graph(pkg, f"step_{query}", opt_level=OptLevel.LEVEL2,
               device_step=step)
    _build_app(pkg, query, g, sink)
    if force_python:
        for _name, logic in mod(pkg, "graph.fuse").iter_logics(g):
            if hasattr(logic, "_native"):
                logic._native = None
    g.run()
    return sorted(sink.rows), _step_info(pkg, g)


@pytest.mark.parametrize("force_python", [False, True])
@pytest.mark.parametrize("query", ["q5", "q7", "yahoo"])
def test_device_step_bitwise(query, force_python):
    """The port's device-step graph equals the same graph without the
    step bitwise, and both equal the reference's step graph; at most 2
    launches per ingest chunk."""
    want, _ = _run_app(REF, query, True, force_python)
    results, infos = {}, {}
    for step in (False, True):
        results[step], infos[step] = _run_app(PORT, query, step,
                                              force_python)
    assert results[True] == results[False] == want
    assert want, "no windows emitted"
    assert infos[True] and not infos[False]
    ((_name, (chunks, launches)),) = infos[True].items()
    assert chunks > 0
    assert launches <= 2 * chunks, (chunks, launches)


# ---------------------------------------------------------------------------
# NEXMark generators, oracles and the event-time builders
# ---------------------------------------------------------------------------

def _streams(pkg):
    nx = mod(pkg, "models.nexmark")
    persons = nx.synth_persons(300, n_cities=6)
    auctions = nx.synth_auctions(400, n_sellers=300, n_categories=5)
    bids = nx.synth_bids(3000, n_auctions=400)
    bids["ts"] = bids["ts"] // 4        # bids over the auctions' time axis
    return nx, persons, auctions, bids


def test_nexmark_generators_and_oracles_match_reference():
    (rn, rp, ra, rb), (pn, pp, pa, pb) = (_streams(pkg) for pkg in PACKAGES)
    for r, p in ((rp, pp), (ra, pa), (rb, pb)):
        assert sorted(p) == sorted(r)
        for c in r:
            np.testing.assert_array_equal(p[c], r[c])
    q3 = pn.q3_oracle(pp, pa)
    assert q3 and q3 == rn.q3_oracle(rp, ra)
    assert pn.q3_oracle(pp, pa, cities=(2, 3, 4), category=1) == \
        rn.q3_oracle(rp, ra, cities=(2, 3, 4), category=1)
    for name in ("q4_oracle", "q6_oracle"):
        got = getattr(pn, name)(pa, pb, 64)
        assert got and got == getattr(rn, name)(ra, rb, 64)
    q8 = pn.q8_oracle(pp, pa, 30)
    assert q8 and q8 == rn.q8_oracle(rp, ra, 30)
    pairs = list(zip(pb["auction"][:500].tolist(), pb["price"][:500]))
    assert pn._closing_price_agg(pairs) == rn._closing_price_agg(pairs)
    assert (pn.q3_baseline, pn.q4_baseline, pn.q6_baseline,
            pn.q8_baseline) == (pn.q3_oracle, pn.q4_oracle, pn.q6_oracle,
                                pn.q8_oracle)


def _relational(pkg, q, par, win):
    """NEXMark Q3/Q4/Q6/Q8 through package ``pkg``'s own builder on the
    reference tests' generated streams, at ``par`` join (and window)
    replicas: the sorted sink rows and the graph."""
    nx = mod(pkg, "models.nexmark")
    persons = nx.synth_persons(60, n_cities=5)
    auctions = nx.synth_auctions(80, n_sellers=40, n_categories=4)
    bids = nx.synth_bids(400, n_auctions=80)
    lock = threading.Lock()
    rows = []

    def sink(rec):
        if rec is not None:
            with lock:
                rows.append((rec.key, int(rec.ts), rec.value))

    g = _graph(pkg, q)
    if q == "q3":
        nx.build_q3_local_items(g, persons, auctions, sink, cities=(0, 1),
                                category=2, parallelism=par)
    elif q == "q8":
        nx.build_q8_new_users(g, persons, auctions, win, sink,
                              parallelism=par)
    else:
        build = nx.build_q4_avg_price if q == "q4" else \
            nx.build_q6_avg_seller
        build(g, auctions, bids, win, sink, parallelism=par)
    g.run()
    if q == "q3":
        got = sorted((k, v[0], v[1]) for k, _ts, v in rows)
        want = nx.q3_oracle(persons, auctions, cities=(0, 1), category=2)
    elif q == "q8":
        got = sorted((k, ts, v[0], v[1]) for k, ts, v in rows)
        want = nx.q8_oracle(persons, auctions, win)
    else:
        got = {(k, ts): v for k, ts, v in rows}
        oracle = nx.q4_oracle if q == "q4" else nx.q6_oracle
        want = oracle(auctions, bids, win)
    return got, want, g


# one replica at the reference tests' windows is
# tests/test_torch_eventtime.py's TestNexmarkRelational; these run the
# joins and windows as replicas, at other windows
@pytest.mark.parametrize("q,par,win", [
    ("q3", 2, None), ("q3", 3, None), ("q4", 2, 64), ("q4", 3, 32),
    ("q6", 2, 64), ("q6", 3, 32), ("q8", 2, 30), ("q8", 3, 64)])
def test_eventtime_query_matches_reference(q, par, win):
    """The event-time NEXMark queries through each package's own
    builder (watermarked record sources, the interval and window joins,
    the re-key stage, the event-time window): the port's results equal
    the reference's and both packages' oracles exactly (Q4/Q6's
    averages are float64 on the host in both), and no on-time tuple is
    quarantined."""
    got, want, g = _relational(PORT, q, par, win)
    ref_got, ref_want, _ = _relational(REF, q, par, win)
    assert got and want == ref_want
    assert got == want == ref_got
    assert g.dead_letters.count() == 0


def test_record_source_matches_reference():
    """``_record_source``: the same records and watermarks, shipped step
    by step, in both packages (every 4 records, skew 1.5, sealed by
    Watermark(inf))."""
    keys, tss, vals = np.arange(10) % 3, np.arange(10) * 2, np.arange(10.0)
    shipped = {}
    for pkg in PACKAGES:
        Watermark = mod(pkg, "runtime.queues").Watermark
        src = mod(pkg, "models.nexmark")._record_source(keys, tss, vals,
                                                        every=4, skew=1.5)

        class Ship:
            items = []

            def push(self, item):
                self.items.append(item)

        ship = Ship()
        ship.items = []
        while src(ship):
            pass
        shipped[pkg] = [("wm", x.ts) if isinstance(x, Watermark) else
                        x.get_control_fields() + (x.value,)
                        for x in ship.items]
    assert shipped[PORT] == shipped[REF]
    assert shipped[PORT][-1] == ("wm", float("inf"))


def test_rekey_joined_matches_reference():
    """Q4/Q6's re-key stage (a FlatMap over joined records) through both
    packages: key = the attribute, value = (auction, price)."""
    joined = [(a, i, i // 2, (a % 5, float(10 * i)))
              for i, a in enumerate(range(100, 160))]
    def source(pkg):
        BasicRecord = mod(pkg, "core").BasicRecord
        rows = iter(joined)

        def fn(shipper):
            row = next(rows, None)
            if row is not None:
                shipper.push(BasicRecord(*row))
            return row is not None

        return fn

    out = {}
    for pkg in PACKAGES:
        wf = importlib.import_module(pkg)
        sink = Rows()
        g = _graph(pkg, "rekey")
        pipe = g.add_source(wf.SourceBuilder(source(pkg)).build())
        mod(pkg, "models.nexmark")._rekey_joined(pipe, "rekey")
        pipe.add_sink(wf.SinkBuilder(sink).build())
        g.run()
        out[pkg] = sorted(sink.rows)
    assert out[PORT] == out[REF] == sorted(
        (a % 5, i, (a, float(10 * i))) for a, i, _t, _v in joined)
