"""The port's event-time relational plane (windflow_tpu_torch/eventtime/)
held against the reference's (tests/test_eventtime.py): each graph goes
through both packages on the same events and is compared with the
reference's run and with the reference tests' numpy oracles.

* watermark-triggered tumbling and sliding windows (bitwise across
  arrival shuffles), allowed lateness, and the late path: the same
  windows, the same dead letters (item, reason, node), the same
  ``late_data`` flight events and ``Late_tuples`` gauges;
* session windows (merge on a bridge, close at the watermark, the late
  path), interval and window joins (oracles, eviction, the state
  gauge), the declarative frontend;
* watermark generation: the promise, the checkpoint, ``skew="auto"``
  and its ``skew_adapted`` flight event, ``watermark_of``;
* K-slack drops to dead letters; the OpenMetrics families;
* NEXMark Q1/Q2 (numpy) and Q3/Q4/Q6/Q8 against their oracles;
* a session window crashed under exactly-once epochs equals the
  reference's uninterrupted run, and a window join rescaled 1->3->1
  mid-stream equals the reference's fixed run, with the reference's
  rescale events.

The port runs with ``device="cpu"``; no graph here has a device engine.
The doctor's golden report over the event-time gauges (the schema-10
pair in tests/golden/) goes through both packages' doctor CLIs.
"""
import collections
import importlib
import json
import math
import os
import threading
import time

import numpy as np
import pytest

from torch_graphs import (COMMIT_WAIT_S, NO_CADENCE_S, PACKAGES, PORT,
                          _resolved, mod)

REF = PACKAGES[0]


def _wf(pkg):
    return importlib.import_module(pkg)


def _config(pkg, **kw):
    cfg = _wf(pkg).RuntimeConfig(**kw)
    if pkg == PORT:
        cfg.device = "cpu"
    return cfg


def _graph(pkg, name, **kw):
    wf = _wf(pkg)
    return wf.PipeGraph(name, wf.Mode.DEFAULT, config=_config(pkg, **kw))


# ---------------------------------------------------------------------------
# helpers (the reference tests' own)
# ---------------------------------------------------------------------------

def _sum(vals):
    tot = 0.0
    for v in vals:
        tot += v
    return tot


def _shipper_source(pkg, events, every=16, skew=0.0):
    BasicRecord = mod(pkg, "core").BasicRecord
    state = {"i": 0}

    def body(shipper):
        i = state["i"]
        if i >= len(events):
            return False
        k, tid, ts, v = events[i]
        shipper.push(BasicRecord(k, tid, ts, v))
        state["i"] = i + 1
        return True

    return mod(pkg, "eventtime").watermarked(body, every=every, skew=skew)


def _block_shuffle(events, block=32, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(0, len(events), block):
        chunk = list(events[i:i + block])
        rng.shuffle(chunk)
        out.extend(chunk)
    return out


def _window_oracle(events, agg, size, slide=None):
    slide = slide or size
    rows = collections.defaultdict(list)
    for k, tid, ts, v in events:
        n_hi = math.floor(ts / slide)
        n_lo = math.floor((ts - size) / slide) + 1
        for n in range(n_lo, n_hi + 1):
            rows[(k, n * slide)].append((ts, tid, v))
    return {kw: agg([r[2] for r in sorted(rs)])
            for kw, rs in rows.items()}


def _collect_windows(items):
    return {(r[0], r[2]): r[3] for r in items}


class _Acc:
    def __init__(self):
        self.items = []
        self._lock = threading.Lock()

    def __call__(self, rec):
        if rec is not None:
            with self._lock:
                self.items.append((rec.key, rec.id, rec.ts, rec.value))


def _linear(pkg, name, events, make_op, every=16, skew=0.0, **cfg):
    """source(events) -> make_op(eventtime module) -> sink, run."""
    wf = _wf(pkg)
    got = _Acc()
    g = _graph(pkg, name, **cfg)
    g.add_source(wf.SourceBuilder(
        _shipper_source(pkg, events, every, skew)).build()) \
        .add(make_op(mod(pkg, "eventtime"))) \
        .add_sink(mod(pkg, "operators.basic_ops").Sink(got))
    g.run()
    return got.items, g


def _both(run):
    """``run(pkg)`` through both packages: {pkg: result}."""
    return {pkg: run(pkg) for pkg in PACKAGES}


def _late_view(g):
    """What the late path left: dead letters (node, item, reason type),
    the late_data flight events, the Late_tuples gauge per operator and
    the ledger's dead-letter count."""
    rep = json.loads(g.stats.to_json())
    gauges = {o["Operator_name"]: sum(r.get("Late_tuples", 0)
                                      for r in o["Replicas"])
              for o in rep["Operators"]}
    flights = [(e["n"], e["ts"], e["watermark"])
               for e in g.flight.snapshot() if e["kind"] == "late_data"]
    letters = [(e.node, e.item, type(e.error).__name__)
               for e in g.dead_letters.entries]
    return (g.dead_letters.count(), letters, flights, gauges,
            rep["Conservation"]["Dead_letters"])


# ---------------------------------------------------------------------------
# watermark-triggered windows
# ---------------------------------------------------------------------------

def test_tumbling_window_bitwise_oracle_under_shuffle():
    events = [(i % 4, i, float(i), float((i * 7) % 13) + 0.25)
              for i in range(400)]
    oracle = _window_oracle(events, _sum, size=20.0)
    for seed in (1, 2):
        shuffled = _block_shuffle(events, block=32, seed=seed)
        runs = _both(lambda pkg: _linear(
            pkg, f"ev_win_{seed}", shuffled,
            lambda et: et.EventTimeWindow(_sum, size=20.0, parallelism=2),
            every=16, skew=64.0)[0])
        assert _collect_windows(runs[PORT]) == oracle
        assert sorted(runs[PORT]) == sorted(runs[REF])


def test_sliding_windows_fire_with_ids_and_ts():
    events = [(0, i, float(i), 1.0) for i in range(100)]
    oracle = _window_oracle(events, _sum, size=30.0, slide=10.0)
    runs = _both(lambda pkg: _linear(
        pkg, "ev_slide", events,
        lambda et: et.EventTimeWindow(_sum, size=30.0, slide=10.0),
        every=8)[0])
    assert _collect_windows(runs[PORT]) == oracle
    assert runs[PORT] == runs[REF]     # one replica: the order too
    for key, wid, ts, _v in runs[PORT]:
        assert key == 0 and wid == int(ts // 10.0)


def test_late_tuple_quarantined_loudly(tmp_path):
    events = [(0, i, float(i), 1.0) for i in range(100)]
    events.append((1, 100, 3.0, 99.0))   # far behind the watermark
    runs = _both(lambda pkg: _linear(
        pkg, "ev_late", events,
        lambda et: et.EventTimeWindow(_sum, size=10.0), every=8,
        tracing=True, log_dir=str(tmp_path / pkg)))
    (items, g), (ref_items, ref_g) = runs[PORT], runs[REF]
    assert _collect_windows(items) == \
        _window_oracle(events[:-1], _sum, size=10.0)
    assert sorted(items) == sorted(ref_items)
    view = _late_view(g)
    assert view == _late_view(ref_g)
    assert view[0] == 1 and view[4] == 1
    assert view[1] == [("pipe0/event_window.0", (1, 100, 3.0, 99.0),
                        "LateTupleDropped")]
    assert view[2][0][:2] == (1, 3.0)
    assert json.loads(g.stats.to_json())["Schema_version"] >= 10


def test_allowed_lateness_keeps_stragglers():
    events = [(0, i, float(i), 1.0) for i in range(40)] \
        + [(0, 40, 30.0, 5.0)]
    runs = _both(lambda pkg: _linear(
        pkg, "ev_grace", events,
        lambda et: et.EventTimeWindow(_sum, size=10.0, lateness=20.0),
        every=4))
    assert runs[PORT][1].dead_letters.count() == 0
    assert _collect_windows(runs[PORT][0]) == \
        _window_oracle(events, _sum, size=10.0)
    assert runs[PORT][0] == runs[REF][0]


# ---------------------------------------------------------------------------
# session windows
# ---------------------------------------------------------------------------

def test_session_windows_merge_on_bridge_and_close():
    events = [
        (0, 0, 0.0, 1.0), (0, 1, 1.0, 2.0), (0, 2, 2.0, 3.0),
        (0, 3, 10.0, 4.0), (0, 4, 11.0, 5.0),
        (0, 5, 6.0, 6.0),          # bridges [0, 2] and [10, 11]
        (1, 6, 0.0, 7.0),
        (0, 7, 30.0, 8.0),
    ]
    runs = _both(lambda pkg: _linear(
        pkg, "ev_sess", events,
        lambda et: et.SessionWindow(_sum, gap=5.0), every=100)[0])
    assert sorted(runs[PORT]) == sorted(runs[REF]) == sorted([
        (0, 6, 0.0, 21.0), (0, 1, 30.0, 8.0), (1, 1, 0.0, 7.0)])


def test_session_closes_at_watermark_not_before():
    K, B, L = 3, 20, 4
    events = sorted(((k, b * L + j, float(b * 20 + j), float(k + 1))
                     for b in range(B) for j in range(L) for k in range(K)),
                    key=lambda e: e[2])
    runs = _both(lambda pkg: _linear(
        pkg, "ev_sess_wm", events,
        lambda et: et.SessionWindow(_sum, gap=5.0, parallelism=2),
        every=8)[0])
    assert len(runs[PORT]) == K * B
    assert sorted(runs[PORT]) == sorted(runs[REF])
    for k, n, start, v in runs[PORT]:
        assert n == L and start % 20 == 0.0 and v == (k + 1) * L


def test_session_late_tuple_quarantined(tmp_path):
    events = [(0, i, float(i * 3), 1.0) for i in range(50)]
    events.append((1, 50, 0.0, 9.0))
    runs = _both(lambda pkg: _linear(
        pkg, "ev_sess_late", events,
        lambda et: et.SessionWindow(_sum, gap=4.0), every=8,
        tracing=True, log_dir=str(tmp_path / pkg)))
    (items, g), (ref_items, ref_g) = runs[PORT], runs[REF]
    assert sorted(items) == sorted(ref_items)
    view = _late_view(g)
    assert view == _late_view(ref_g)
    assert view[1] == [("pipe0/session_window.0", (1, 50, 0.0, 9.0),
                        "LateTupleDropped")]
    assert view[3]["pipe0/session_window"] == 1


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------

def _join(pkg, name, left, right, make_op, key_of=None, **cfg):
    wf = _wf(pkg)
    et = mod(pkg, "eventtime")
    kw = {} if key_of is None else {"key_of": key_of}
    got = _Acc()
    g = _graph(pkg, name, **cfg)
    p1 = g.add_source(wf.SourceBuilder(
        _shipper_source(pkg, left, every=8)).build())
    p1.chain(et.tag_side(et.LEFT, **kw))
    p2 = g.add_source(wf.SourceBuilder(
        _shipper_source(pkg, right, every=8)).build())
    p2.chain(et.tag_side(et.RIGHT, **kw))
    p1.merge(p2).add(make_op(et)).add_sink(
        mod(pkg, "operators.basic_ops").Sink(got))
    g.run()
    return got.items, g


def test_interval_join_matches_nested_loop_oracle():
    lo, hi = -4.0, 4.0
    left = [(i % 3, i, float(i), 100.0 + i) for i in range(60)]
    right = [(i % 3, i, float(i) + 0.5, 200.0 + i) for i in range(60)]
    oracle = sorted((k, lv, rv) for k, _t, lts, lv in left
                    for k2, _t2, rts, rv in right
                    if k2 == k and lo <= rts - lts <= hi)
    runs = _both(lambda pkg: _join(
        pkg, "ev_ijoin", left, right,
        lambda et: et.IntervalJoin(lo, hi, parallelism=2))[0])
    got = sorted((k, v[0], v[1]) for k, _i, _t, v in runs[PORT])
    assert got == oracle
    # an interval join's output id is the later side's tuple id, which
    # depends on how the two sources interleave: held without it
    assert _no_ids(runs[PORT]) == _no_ids(runs[REF])


def _no_ids(items):
    return sorted((k, ts, v) for k, _i, ts, v in items)


def _eviction_trace(pkg):
    et = mod(pkg, "eventtime")
    logic = et.IntervalJoinLogic(lower=-2.0, upper=2.0)
    logic.dead_letters = mod(pkg, "resilience").DeadLetterStore()
    out = []
    trace = []
    logic.svc(et.Sided(et.LEFT, 7, 0, 10.0, "l0"), 0, out.append)
    logic.svc(et.Sided(et.RIGHT, 7, 1, 11.0, "r0"), 0, out.append)
    trace.append([(r.key, r.value) for r in out])
    trace.append(sorted(logic.state[7]["L"]) if 7 in logic.state else None)
    logic.on_watermark(et.Watermark(20.0), out.append)
    trace.append(dict(logic.state))
    logic.svc(et.Sided(et.LEFT, 7, 2, 10.0, "late"), 0, out.append)
    trace.append((logic.dead_letters.count(),
                  type(logic.dead_letters.entries[0].error).__name__))
    full = et.IntervalJoinLogic(float("-inf"), float("inf"))
    full.svc(et.Sided(et.LEFT, 1, 0, 0.0, "l"), 0, out.append)
    full.on_watermark(et.Watermark(1e12), out.append)
    trace.append(1 in full.state)
    return trace


def test_interval_join_watermark_eviction_and_late_drop():
    got = _eviction_trace(PORT)
    assert got == _eviction_trace(REF)
    assert got[0] == [(7, ("l0", "r0"))] and got[1]
    assert got[2] == {} and got[3] == (1, "LateTupleDropped") and got[4]


def test_window_join_cross_product_oracle():
    size = 16.0
    left = [(i % 4, i, float(i), ("L", i)) for i in range(120)]
    right = [(i % 4, i, float(i), ("R", i)) for i in range(120)]
    oracle = sorted((k, n * 16.0, lv, rv) for k, _t, lts, lv in left
                    for k2, _t2, rts, rv in right
                    for n in [int(lts // size)]
                    if k2 == k and int(rts // size) == n)
    runs = _both(lambda pkg: _join(
        pkg, "ev_wjoin", left, right,
        lambda et: et.WindowJoin(size, parallelism=2))[0])
    got = sorted((k, ts, v[0], v[1]) for k, _i, ts, v in runs[PORT])
    assert got == oracle
    assert sorted(runs[PORT]) == sorted(runs[REF])


def test_join_state_gauge_exported(tmp_path):
    left = [(k, k, 0.0, float(k)) for k in range(6)]
    right = [(6 + k, k, 0.0, float(k)) for k in range(3)]
    gauges = {}
    for pkg in PACKAGES:
        items, g = _join(pkg, "ev_join_gauge", left, right,
                         lambda et: et.IntervalJoin(float("-inf"),
                                                    float("inf")),
                         tracing=True, log_dir=str(tmp_path / pkg))
        assert items == []
        rep = json.loads(g.stats.to_json())
        op = next(o for o in rep["Operators"]
                  if "interval_join" in o["Operator_name"])
        gauges[pkg] = sum(r.get("Join_state_keys", 0) for r in op["Replicas"])
    assert gauges[PORT] == gauges[REF] == 9


# ---------------------------------------------------------------------------
# declarative frontend
# ---------------------------------------------------------------------------

def test_stream_query_where_select_window():
    events = [(i % 2, i, float(i), float(i % 5)) for i in range(200)]
    kept = [(k, t, ts, v * 10.0) for k, t, ts, v in events if v > 1.0]

    def run(pkg):
        wf = _wf(pkg)
        got = _Acc()
        g = _graph(pkg, "ev_query")

        def scale(t):
            t.value *= 10.0

        wf.query(g.add_source(wf.SourceBuilder(
            _shipper_source(pkg, events, every=16, skew=8.0)).build())) \
            .where(lambda t: t.value > 1.0).select(scale) \
            .window(_sum, size=25.0).sink(got)
        g.run()
        return got.items

    runs = _both(run)
    assert _collect_windows(runs[PORT]) == \
        _window_oracle(kept, _sum, size=25.0)
    assert sorted(runs[PORT]) == sorted(runs[REF])


def test_stream_query_join_and_session():
    left = [(i % 2, i, float(i), 1.0 + i) for i in range(40)]
    right = [(i % 2, i, float(i), 100.0 + i) for i in range(40)]
    oracle = sorted((k, lv, rv) for k, _t, lts, lv in left
                    for k2, _t2, rts, rv in right
                    if k2 == k and -1.0 <= rts - lts <= 1.0)
    sess_events = [(0, i, float(i), 1.0) for i in range(5)] \
        + [(0, 9, 50.0, 2.0)]

    def run(pkg):
        wf = _wf(pkg)
        got = _Acc()
        g = _graph(pkg, "ev_query_join")
        ql = wf.query(g.add_source(wf.SourceBuilder(
            _shipper_source(pkg, left, every=8)).build()))
        qr = wf.query(g.add_source(wf.SourceBuilder(
            _shipper_source(pkg, right, every=8)).build()))
        ql.join(qr, lower=-1.0, upper=1.0).sink(got)
        g.run()
        with pytest.raises(ValueError, match="exactly one"):
            ql.join(qr)
        got2 = _Acc()
        g2 = _graph(pkg, "ev_query_sess")
        wf.query(g2.add_source(wf.SourceBuilder(
            _shipper_source(pkg, sess_events, every=100)).build())) \
            .session(_sum, gap=3.0).sink(got2)
        g2.run()
        return _no_ids(got.items), sorted(got2.items)

    runs = _both(run)
    assert runs[PORT] == runs[REF]
    assert sorted((k, v[0], v[1]) for k, _t, v in runs[PORT][0]) \
        == oracle
    assert runs[PORT][1] == [(0, 1, 50.0, 2.0), (0, 5, 0.0, 5.0)]


# ---------------------------------------------------------------------------
# watermark generation + observation
# ---------------------------------------------------------------------------

class _Ship:
    def __init__(self):
        self.items = []

    def push(self, item):
        self.items.append(item)


def _shipped(pkg, items):
    Watermark = mod(pkg, "eventtime").Watermark
    return [("wm", x.ts) if isinstance(x, Watermark)
            else tuple(x.get_control_fields()) + (x.value,) for x in items]


def _promise_trace(pkg):
    wf = _wf(pkg)
    et = mod(pkg, "eventtime")
    src = _shipper_source(pkg, [(0, i, float(i), 1.0) for i in range(10)],
                          every=4, skew=1.5)
    trace = [wf.watermark_of(src)]
    ship = _Ship()
    for _ in range(4):
        assert src(ship)
    trace.append(wf.watermark_of(src))
    st = src.state_dict()
    trace.append(st["inner"])
    clone = et.WatermarkedSource(lambda s: False, every=4, skew=1.5)
    clone.load_state(st)
    trace.append(clone.current_watermark)
    while src(ship):
        pass
    trace.append(wf.watermark_of(src))
    trace.append(_shipped(pkg, ship.items))
    return trace


def test_watermarked_source_promise_and_checkpoint():
    got = _promise_trace(PORT)
    assert got == _promise_trace(REF)
    assert got[:5] == [float("-inf"), 1.5, None, 1.5, float("inf")]
    assert got[5][-1] == ("wm", float("inf"))


def _auto_skew_trace(pkg):
    et = mod(pkg, "eventtime")
    events = [(0, i, float(i), 1.0) for i in range(8)] \
        + [(0, 8, 0.0, 1.0)] + [(0, 9, 9.0, 1.0)]
    src = _shipper_source(pkg, events, every=4, skew="auto")
    src.flight = mod(pkg, "telemetry").FlightRecorder(16)
    ship = _Ship()
    for _ in range(8):
        assert src(ship)
    trace = [src.skew]
    assert src(ship)
    trace.append(src.skew)
    trace.append([(e["old"], e["new"], e["observed"])
                  for e in src.flight.snapshot()
                  if e["kind"] == "skew_adapted"])
    src.fn = _shipper_source(
        pkg, [(0, i, float(i + 10), 1.0) for i in range(4)], every=64).fn
    skews = []
    for _ in range(4):
        src(ship)
        skews.append(src.skew)
    trace.append(skews)
    clone = et.WatermarkedSource(lambda s: False, skew="auto")
    clone.load_state(src.state_dict())
    trace.append((clone.skew, clone.auto_skew))
    trace.append(_shipped(pkg, ship.items))
    return trace


def test_watermarked_auto_skew_learns_from_lateness():
    got = _auto_skew_trace(PORT)
    assert got == _auto_skew_trace(REF)
    assert got[0] == 0.0 and got[1] == pytest.approx(7.0)
    assert got[2] and got[2][-1][1] == pytest.approx(7.0)
    skews = got[3]
    assert all(s < got[1] for s in skews) and skews[-1] > 0.0
    assert skews == sorted(skews, reverse=True)
    assert got[4] == (pytest.approx(skews[-1]), True)


def test_watermarked_auto_skew_flight_event_in_graph():
    events = [(0, i, float(i), 1.0) for i in range(32)]
    events[20] = (0, 20, 2.0, 1.0)

    def run(pkg):
        items, g = _linear(pkg, "ev_autoskew", events,
                           lambda et: et.EventTimeWindow(_sum, size=16.0),
                           every=8, skew="auto")
        evs = [(e["source"], e["old"], e["new"], e["observed"])
               for e in g.flight.snapshot() if e["kind"] == "skew_adapted"]
        return sorted(items), evs

    runs = _both(run)
    assert runs[PORT] == runs[REF]
    evs = runs[PORT][1]
    assert evs and evs[-1][2] > 0.0 and evs[-1][0].startswith("pipe0/")


def test_watermark_of_node_and_frontier_fallback():
    events = [(0, i, float(i), 1.0) for i in range(64)]

    def run(pkg):
        wf = _wf(pkg)
        items, g = _linear(pkg, "ev_wm_of", events,
                           lambda et: et.EventTimeWindow(
                               _sum, size=16.0, parallelism=2), every=8)
        consumers = [n for n in g._all_nodes() if n.channel is not None]
        sources = [n for n in g._all_nodes() if n.channel is None]
        assert consumers and sources
        return (sorted(items),
                sorted((n.name, wf.watermark_of(n)) for n in consumers),
                all(wf.watermark_of(n) > 0 for n in sources))

    runs = _both(run)
    assert runs[PORT] == runs[REF]
    assert all(wm == float("inf") for _n, wm in runs[PORT][1])
    assert runs[PORT][2]


# ---------------------------------------------------------------------------
# K-slack drop accounting
# ---------------------------------------------------------------------------

def _kslack_trace(pkg):
    ordering = mod(pkg, "runtime.ordering")
    TupleBatch = mod(pkg, "core.tuples").TupleBatch
    logic = ordering.KSlackLogic(mod(pkg, "core.basic").OrderingMode.TS)
    logic.dead_letters = mod(pkg, "resilience").DeadLetterStore()
    logic.flight = mod(pkg, "telemetry").FlightRecorder(16)
    logic.last_timestamp = 50
    out = []
    logic._emit_in_order([mod(pkg, "core").BasicRecord(3, 1, 10, 1.0)],
                         out.append)
    trace = [logic.dropped, len(out), logic.dead_letters.count(),
             logic.dead_letters.entries[0].node,
             type(logic.dead_letters.entries[0].error).__name__]
    tb = TupleBatch({"key": np.zeros(4, np.int64),
                     "id": np.arange(4, dtype=np.int64),
                     "ts": np.array([10, 20, 60, 70], np.int64),
                     "value": np.ones(4)})
    logic._emit_batch_in_order(tb, out.append)
    trace += [logic.dropped, logic.dead_letters.count(),
              len(logic.dead_letters.entries),
              [(e["n"], e["watermark"]) for e in logic.flight.snapshot()
               if e["kind"] == "late_data"]]
    return trace


def test_kslack_drops_quarantined_with_flight_event():
    got = _kslack_trace(PORT)
    assert got == _kslack_trace(REF)
    assert got[:5] == [1, 0, 1, "kslack", "LateTupleDropped"]
    assert got[5:8] == [3, 3, 2] and sum(n for n, _ in got[8]) == 3


# ---------------------------------------------------------------------------
# NEXMark: Q1/Q2 numpy, Q3/Q4/Q6/Q8 relational graphs vs oracles
# ---------------------------------------------------------------------------

def _people(pkg):
    nx = mod(pkg, "models.nexmark")
    return (nx.synth_persons(60, n_cities=5),
            nx.synth_auctions(80, n_sellers=40, n_categories=4),
            nx.synth_bids(400, n_auctions=80))


class TestNexmarkRelational:

    def test_q1_q2_numpy(self):
        got = {}
        for pkg in PACKAGES:
            nx = mod(pkg, "models.nexmark")
            TupleBatch = mod(pkg, "core.tuples").TupleBatch
            pool = nx.synth_bids(1000, n_auctions=20)
            tb = TupleBatch({"key": pool["auction"], "id": pool["ts"],
                             "ts": pool["ts"], "value": pool["price"]})
            got[pkg] = (np.asarray(nx.q1_currency(tb)["value"]),
                        np.asarray(nx.make_q2_selection({1, 2})(tb)))
            np.testing.assert_allclose(got[pkg][0],
                                       pool["price"] * nx.DOL_TO_EUR)
            assert got[pkg][1].sum() == np.isin(pool["auction"],
                                                [1, 2]).sum()
        for a, b in zip(got[PORT], got[REF]):
            np.testing.assert_array_equal(a, b)

    def test_q3_local_items(self):
        def run(pkg):
            nx = mod(pkg, "models.nexmark")
            persons, auctions, _ = _people(pkg)
            out = _Acc()
            g = _graph(pkg, "q3")
            nx.build_q3_local_items(g, persons, auctions, out,
                                    cities=(0, 1), category=2)
            g.run()
            got = sorted((k, v[0], v[1]) for k, _i, _t, v in out.items)
            assert got == nx.q3_oracle(persons, auctions, cities=(0, 1),
                                       category=2)
            return got

        runs = _both(run)
        assert runs[PORT] and runs[PORT] == runs[REF]

    @pytest.mark.parametrize("q", ["q4", "q6"])
    def test_q4_q6_avg_closing_price(self, q):
        def run(pkg):
            nx = mod(pkg, "models.nexmark")
            _, auctions, bids = _people(pkg)
            out = {}

            def sink(rec):
                if rec is not None:
                    out[(rec.key, int(rec.ts))] = rec.value

            g = _graph(pkg, q)
            build = (nx.build_q4_avg_price if q == "q4"
                     else nx.build_q6_avg_seller)
            oracle = nx.q4_oracle if q == "q4" else nx.q6_oracle
            build(g, auctions, bids, 40, sink)
            g.run()
            assert out == oracle(auctions, bids, 40)
            return out

        runs = _both(run)
        assert runs[PORT] and runs[PORT] == runs[REF]

    def test_q8_new_users(self):
        def run(pkg):
            nx = mod(pkg, "models.nexmark")
            persons, auctions, _ = _people(pkg)
            out = _Acc()
            g = _graph(pkg, "q8")
            nx.build_q8_new_users(g, persons, auctions, 50, out)
            g.run()
            got = sorted((k, int(ts), v[0], v[1])
                         for k, _i, ts, v in out.items)
            assert got == nx.q8_oracle(persons, auctions, 50)
            return got

        runs = _both(run)
        assert runs[PORT] and runs[PORT] == runs[REF]

    def test_baseline_twins_are_the_oracles(self):
        nx = mod(PORT, "models.nexmark")
        assert nx.q3_baseline is nx.q3_oracle
        assert nx.q4_baseline is nx.q4_oracle
        assert nx.q6_baseline is nx.q6_oracle
        assert nx.q8_baseline is nx.q8_oracle


# ---------------------------------------------------------------------------
# a session window crashed under exactly-once epochs
# ---------------------------------------------------------------------------

K_CHAOS, B_CHAOS, L_CHAOS = 6, 100, 4
# the source begins an epoch at each of these indices and waits for its
# commit, so the crash (a replica's 900th item, past index 1,200) lands
# after epoch 3's commit
CHAOS_EPOCHS_AT = (400, 800, 1200)


def _chaos_events():
    events = []
    i = 0
    for b in range(B_CHAOS):
        for j in range(L_CHAOS):
            for k in range(K_CHAOS):
                events.append((k, i, float(b * 10 + j),
                               float((b + k + j) % 7)))
                i += 1
    return events


def _session_oracle(events, gap):
    by_key = collections.defaultdict(list)
    for k, tid, ts, v in events:
        by_key[k].append((ts, tid, v))
    out = set()
    for k, rows in by_key.items():
        rows.sort()
        cur = [rows[0]]
        for r in rows[1:]:
            if r[0] - cur[-1][0] <= gap:
                cur.append(r)
            else:
                out.add((k, len(cur), cur[0][0], _sum([x[2] for x in cur])))
                cur = [r]
        out.add((k, len(cur), cur[0][0], _sum([x[2] for x in cur])))
    return out


def _wm_ckpt_source(pkg, events, epochs_at=(), every=16):
    """An offset-checkpointable watermarked record source (the reference
    test's ``_WmCkptLogic``: the watermark clock rides ``state_dict``
    beside the body's offset).  At each index in ``epochs_at`` it begins
    an epoch and waits for its commit."""
    BasicRecord = mod(pkg, "core").BasicRecord
    basic = mod(pkg, "core.basic")
    base = mod(pkg, "operators.base")
    node = mod(pkg, "runtime.node")
    et = mod(pkg, "eventtime")
    marks = frozenset(epochs_at)

    class Body:
        def __init__(self):
            self.i = 0

        def __call__(self, shipper):
            i = self.i
            if i >= len(events):
                return False
            k, tid, ts, v = events[i]
            shipper.push(BasicRecord(k, tid, ts, v))
            self.i = i + 1
            return True

        def state_dict(self):
            return {"i": self.i}

        def load_state(self, st):
            self.i = st["i"]

    class Logic(node.SourceLoopLogic):
        def __init__(self):
            self.wrapped = et.WatermarkedSource(Body(), every=every)
            self._began = -1
            self._wait = None
            super().__init__(self._step)

        def _step(self, emit):
            inj = self.epoch_injector
            i = self.wrapped.fn.i
            if self._wait is not None:
                epoch, deadline = self._wait
                if not _resolved(inj.coord, epoch) \
                        and time.monotonic() < deadline:
                    time.sleep(0.0005)
                    return True
                self._wait = None
            elif inj is not None and i in marks and self._began != i:
                self._began = i
                self._wait = (inj.coord.begin_epoch(),
                              time.monotonic() + COMMIT_WAIT_S)
                return True

            class Ship:
                def push(self, item):
                    emit(item)

            return self.wrapped(Ship())

        def state_dict(self):
            return self.wrapped.state_dict()

        def load_state(self, st):
            self.wrapped.load_state(st)

        def progress_frontier(self):
            return self.wrapped.fn.i

    class Source(base.Operator):
        def __init__(self):
            super().__init__("wm_source", 1, basic.RoutingMode.NONE,
                             basic.Pattern.SOURCE)

        def stages(self):
            return [base.StageSpec(self.name, [Logic()],
                                   mod(pkg, "runtime.emitters")
                                   .StandardEmitter(), self.routing)]

    return Source()


def test_chaos_session_crash_under_epochs_exactly_once(tmp_path):
    """A FaultPlan kills a session-window replica mid-stream under
    exactly-once epochs: after the restart the fired sessions equal the
    reference's uninterrupted run and the oracle -- none lost, none
    twice, nothing falsely late, the ledger balanced."""
    events = _chaos_events()
    et = mod(PORT, "eventtime")
    FaultPlan = mod(PORT, "resilience").FaultPlan
    DurabilityConfig = mod(PORT, "core").DurabilityConfig
    effects = []

    def sink(rec):
        if rec is not None:
            effects.append((rec.key, rec.id, rec.ts, rec.value))

    def factory(attempt):
        plan = (FaultPlan(seed=23).crash_replica("session_window",
                                                 at_tuple=900)
                if attempt == 0 else None)
        g = _graph(PORT, "ev_chaos", durability=DurabilityConfig(
            epoch_interval_s=NO_CADENCE_S, path=str(tmp_path / "epochs")),
            fault_plan=plan)
        g.add_source(_wm_ckpt_source(PORT, events, CHAOS_EPOCHS_AT)) \
            .add(et.SessionWindow(_sum, gap=2.0, parallelism=2)) \
            .add_sink(_wf(PORT).SinkBuilder(sink).with_exactly_once()
                      .build())
        return g

    g = mod(PORT, "durability").run_with_epochs(factory, max_restarts=2)
    assert g._epoch_restored == 3
    ref = _Acc()
    g_ref = _graph(REF, "ev_chaos_ref")
    g_ref.add_source(_wm_ckpt_source(REF, events)) \
        .add(mod(REF, "eventtime").SessionWindow(_sum, gap=2.0,
                                                 parallelism=2)) \
        .add_sink(mod(REF, "operators.basic_ops").Sink(ref))
    g_ref.run()
    n_sessions = K_CHAOS * B_CHAOS
    assert len(effects) == len(set(effects)) == n_sessions
    assert set(effects) == set(ref.items) \
        == _session_oracle(events, gap=2.0)
    assert g.dead_letters.count() == 0
    cons = json.loads(g.stats.to_json())["Conservation"]
    assert cons["Violations_total"] == 0, cons["Violations"]
    assert cons["Edges_balanced"], cons


# ---------------------------------------------------------------------------
# a window join rescaled mid-stream
# ---------------------------------------------------------------------------

def _paced_events_source(pkg, events, state, every=32, pace_every=64,
                         pace_s=0.002):
    BasicRecord = mod(pkg, "core").BasicRecord

    def body(shipper):
        i = state["i"]
        if i >= len(events):
            return False
        if pace_every and i % pace_every == 0:
            time.sleep(pace_s)
        k, tid, ts, v = events[i]
        shipper.push(BasicRecord(k, tid, ts, v))
        state["i"] = i + 1
        return True

    return mod(pkg, "eventtime").watermarked(body, every=every)


def _wait_progress(state, upto, deadline_s=30.0):
    deadline = time.monotonic() + deadline_s
    while state["i"] < upto:
        assert time.monotonic() < deadline, "source made no progress"
        time.sleep(0.002)


def _run_join_rescale(pkg, n, rescale_steps):
    wf = _wf(pkg)
    et = mod(pkg, "eventtime")
    left = [(i % 8, i, float(i), ("L", i)) for i in range(n)]
    right = [(i % 8, i, float(i), ("R", i)) for i in range(n)]
    got = _Acc()
    st_l, st_r = {"i": 0}, {"i": 0}
    g = _graph(pkg, "ev_rescale",
               elasticity=mod(pkg, "elastic").ElasticityConfig(
                   enabled=False))
    pace = dict(pace_every=64, pace_s=0.002) if rescale_steps \
        else dict(pace_every=0)
    p1 = g.add_source(wf.SourceBuilder(
        _paced_events_source(pkg, left, st_l, **pace)).build())
    p1.chain(et.tag_side(et.LEFT))
    p2 = g.add_source(wf.SourceBuilder(
        _paced_events_source(pkg, right, st_r, **pace)).build())
    p2.chain(et.tag_side(et.RIGHT))
    op = et.WindowJoin(16.0, name="wjoin")
    op.elasticity = mod(pkg, "core.basic").ElasticSpec(1, 4)
    p1.merge(p2).add(op).add_sink(mod(pkg, "operators.basic_ops").Sink(got))
    if not rescale_steps:
        g.run()
        return sorted(got.items), []
    g.start()
    events = []
    for j, n_new in enumerate(rescale_steps):
        _wait_progress(st_l, (j + 1) * n // (len(rescale_steps) + 1))
        ev = g.rescale("wjoin", n_new, trigger="scripted step")
        events.append((ev.operator, ev.old_parallelism,
                       ev.new_parallelism, ev.trigger))
    g.wait_end()
    return sorted(got.items), events


def test_join_rescale_conserves_buffered_state():
    """A WindowJoin scales 1->3->1 mid-stream in both packages: the
    keyed two-sided buffers repartition through the drain barrier, the
    joined output equals the reference's fixed-parallelism run (no pair
    lost or twice), and the rescale events are the reference's."""
    n = 4000
    fixed, _ = _run_join_rescale(REF, n, ())
    got, events = _run_join_rescale(PORT, n, (3, 1))
    ref_got, ref_events = _run_join_rescale(REF, n, (3, 1))
    assert got == fixed == ref_got
    assert events == ref_events == [
        ("pipe0+pipe1/wjoin", 1, 3, "scripted step"),
        ("pipe0+pipe1/wjoin", 3, 1, "scripted step")]


# ---------------------------------------------------------------------------
# export surfaces
# ---------------------------------------------------------------------------

def test_openmetrics_eventtime_families():
    apps = {1: {"active": True, "report": {
        "PipeGraph_name": "ev",
        "Operators": [
            {"Operator_name": "pipe0/session_window", "Parallelism": 2,
             "Replicas": [{"Late_tuples": 4, "Sessions_open": 3},
                          {"Late_tuples": 3, "Sessions_open": 2}]},
            {"Operator_name": "pipe0/interval_join", "Parallelism": 1,
             "Replicas": [{"Join_state_keys": 42}]},
            {"Operator_name": "pipe0/map", "Parallelism": 1,
             "Replicas": [{"Inputs_received": 5}]},
        ],
    }}}
    text = mod(PORT, "telemetry.metrics").render_openmetrics(apps)
    assert text == mod(REF, "telemetry.metrics").render_openmetrics(apps)
    assert ('windflow_late_tuples_total{app="1",graph="ev",'
            'operator="pipe0/session_window"} 7') in text
    assert ('windflow_sessions_open{app="1",graph="ev",'
            'operator="pipe0/session_window"} 5') in text
    assert ('windflow_join_state_keys{app="1",graph="ev",'
            'operator="pipe0/interval_join"} 42') in text
    for fam in ("windflow_late_tuples_total", "windflow_sessions_open",
                "windflow_join_state_keys"):
        assert f'{fam}{{app="1",graph="ev",operator="pipe0/map"}}' \
            not in text


def test_doctor_golden_v10_eventtime_gauges(capsys):
    """Schema-10 dump (event-time gauges + late_data flight events) ->
    the port's doctor --json: the reference's bytes and the committed
    golden report."""
    golden_dir = os.path.join(os.path.dirname(__file__), "golden")
    path = os.path.join(golden_dir, "doctor_stats_v10.json")
    outs = []
    for pkg in PACKAGES:
        rc = mod(pkg, "doctor").main([path, "--json"])
        outs.append(capsys.readouterr().out)
        assert rc == 0
    assert outs[1] == outs[0]
    rep = json.loads(outs[1])
    src = rep.pop("Source")
    assert src.endswith("doctor_stats_v10.json")
    with open(os.path.join(golden_dir, "doctor_report_v10.json")) as f:
        golden = json.load(f)
    assert rep == golden
    with open(path) as f:
        dump = json.load(f)
    assert dump["Schema_version"] == 10
    sess = next(o for o in dump["Operators"]
                if o["Operator_name"] == "pipe0/session_window")
    assert sum(r["Late_tuples"] for r in sess["Replicas"]) == 7
