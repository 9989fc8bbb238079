"""The port's mission-control plane (windflow_tpu_torch/slo/, the live
cluster view in distributed/observe.py and the doctor) held against the
reference's (tests/test_slo.py, every test but the 2-process run,
which tests/test_torch_distributed_procs.py twins).

* Pure functions -- burn rates, debounce, episodes, ``merge_slo``,
  ``merge_stats``, ``stitch_traces``, the wire table, the OpenMetrics
  families and the doctor over the golden dumps: the same gauge series
  and stats dicts go through both packages and the results must be
  equal, with no tolerance, and meet the reference test's assertions.
* Graph-driven twins -- ``with_slo``, the Slo block and its flight
  episodes, the live observer and pusher, the dashboard's
  ``/cluster``: the same graph runs in both packages (the port with
  ``device="cpu"``); both meet the reference test's assertions and
  their sinks receive the same records.  Timings are not compared.

Every server binds port 0 and is stopped in a ``finally``; every graph
writes its logs under the test's temporary directory.
"""
import json
import os
import time
import urllib.request
import warnings

import pytest

from torch_graphs import (PACKAGES, PORT, Collector, cpu_config, doctor,
                          mod, record_source)

REF = PACKAGES[0]
WAIT_S = 60
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _both(scenario, *args):
    """``scenario(pkg, *args)`` in both packages; the results equal."""
    want = scenario(REF, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


def quiet_run(g):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g.run()


# ---------------------------------------------------------------------------
# burn-rate math (hand-computed windows)
# ---------------------------------------------------------------------------

def _cfg(pkg, **kw):
    kw.setdefault("p99_ms", 5.0)
    kw.setdefault("target", 0.9)
    kw.setdefault("fast_window_s", 4.0)
    kw.setdefault("slow_window_s", 40.0)
    kw.setdefault("warmup_ticks", 0)
    return mod(pkg, "slo").SloConfig(**kw)


def _tracker(pkg, **kw):
    return mod(pkg, "slo").SloTracker(_cfg(pkg, **kw))


GOOD = {"e2e_p99_us": 1000.0}
BAD = {"e2e_p99_us": 50000.0}


def _hand_computed(pkg):
    tr = _tracker(pkg)
    t = 100.0
    for _ in range(6):
        assert tr.update(t, GOOD) is None
        t += 1.0
    tr.update(t, BAD)
    t += 1.0
    tr.update(t, BAD)
    t += 1.0
    fast = tr.burn_rate(t - 1.0, 4.0)
    slow = tr.burn_rate(t - 1.0, 40.0)
    burned = tr.budget_burned(t - 1.0)
    assert fast == pytest.approx((2 / 5) / 0.1)
    assert slow == pytest.approx((2 / 8) / 0.1)
    assert burned == pytest.approx(0.4375)
    return fast, slow, burned, tr.block()


def test_burn_rate_hand_computed_windows():
    _both(_hand_computed)


def _min_samples(pkg):
    tr = _tracker(pkg)
    tr.update(0.0, BAD)
    one = tr.burn_rate(0.0, 4.0)
    assert one == 0.0
    tr.update(1.0, BAD)
    two = tr.burn_rate(1.0, 4.0)
    assert two == pytest.approx(10.0)
    return one, two


def test_burn_rate_needs_min_samples():
    _both(_min_samples)


def _blip(pkg):
    tr = _tracker(pkg, fast_burn=5.0)
    t, evs = 0.0, []
    for _ in range(8):
        evs.append(tr.update(t, GOOD))
        t += 1.0
    evs.append(tr.update(t, BAD))
    t += 1.0
    evs.append(tr.update(t, GOOD))
    assert evs == [None] * 10
    assert not tr.breached and tr.breaches_total == 0
    return tr.block()


def test_breach_debounce_blip_does_not_open():
    _both(_blip)


def _episode(pkg):
    tr = _tracker(pkg, fast_burn=5.0)
    t, evs = 0.0, []
    for _ in range(6):
        tr.update(t, GOOD)
        t += 1.0
    for _ in range(4):
        ev = tr.update(t, BAD)
        if ev:
            evs.append(ev)
        t += 1.0
    assert [e["event"] for e in evs] == ["slo_breach"]
    assert evs[0]["violating"] == ["e2e_p99"]
    assert evs[0]["burn_fast"] >= 5.0
    assert tr.breached and tr.breaches_total == 1
    b = tr.block()
    assert b["Breached"] and b["Violating"] == ["e2e_p99"]
    assert b["Values"]["e2e_p99_ms"] == pytest.approx(50.0)
    ev = None
    for _ in range(10):
        ev = tr.update(t, GOOD)
        t += 1.0
        if ev:
            break
    assert ev and ev["event"] == "slo_recovered"
    assert not tr.breached and tr.breaches_total == 1
    return evs, b, ev, tr.block()


def test_breach_opens_then_recovers_with_events():
    _both(_episode)


def _throughput_and_lag(pkg):
    cfg = mod(pkg, "slo").SloConfig(min_throughput_rps=100.0,
                                    max_frontier_lag_s=1.0, target=0.9,
                                    warmup_ticks=0)
    tr = mod(pkg, "slo").SloTracker(cfg)
    ev = None
    for i in range(6):
        ev = tr.update(float(i), {"throughput_rps": 5.0,
                                  "frontier_lag_ms": 2500.0}) or ev
    assert ev and ev["event"] == "slo_breach"
    assert set(ev["violating"]) == {"throughput", "frontier_lag"}
    assert tr.block()["Values"]["throughput_rps"] == 5.0
    return ev, tr.block()


def test_objectives_throughput_and_frontier_lag():
    _both(_throughput_and_lag)


def _first_flow(pkg):
    slo = mod(pkg, "slo")
    cfg = slo.SloConfig(min_throughput_rps=100.0, target=0.9,
                        fast_window_s=4.0, slow_window_s=40.0,
                        warmup_ticks=0, fast_burn=5.0)
    tr = slo.SloTracker(cfg)
    t = 0.0
    for _ in range(8):
        assert tr.update(t, {"throughput_rps": 0.0}) is None
        t += 1.0
    assert not tr.breached and tr.bad_ticks == 0
    tr.update(t, {"throughput_rps": 500.0})
    t += 1.0
    ev = None
    for _ in range(6):
        ev = tr.update(t, {"throughput_rps": 0.0}) or ev
        t += 1.0
    assert ev and ev["event"] == "slo_breach"
    tr2 = slo.SloTracker(slo.SloConfig(
        min_throughput_rps=100.0, target=0.9, fast_window_s=4.0,
        slow_window_s=40.0, warmup_ticks=2, fast_burn=5.0))
    t, ev2 = 0.0, None
    tr2.update(t, {"throughput_rps": 500.0})
    t += 1.0
    for _ in range(8):
        ev2 = tr2.update(t, {"throughput_rps": 0.0}) or ev2
        t += 1.0
    assert ev2 and ev2["event"] == "slo_breach"
    return ev, tr.block(), ev2, tr2.block()


def test_throughput_objective_waits_for_first_flow():
    _both(_first_flow)


def _validation(pkg):
    SloConfig = mod(pkg, "slo").SloConfig
    msgs = []
    for kw in ({}, {"p99_ms": 1.0, "target": 1.5},
               {"p99_ms": 1.0, "window_scale": 0.0}):
        with pytest.raises(ValueError) as e:
            SloConfig(**kw)
        msgs.append(str(e.value))
    return msgs


def test_slo_config_validation():
    _both(_validation)


def _scaled(pkg):
    tr = _tracker(pkg, window_scale=0.5)
    assert tr.fast_s == pytest.approx(2.0)
    assert tr.slow_s == pytest.approx(20.0)
    return tr.fast_s, tr.slow_s


def test_window_scale_shrinks_stream_time_windows():
    _both(_scaled)


def _merge_slo(pkg):
    merge_slo = mod(pkg, "slo.plane").merge_slo
    a = {"Objectives": {"p99_ms": 5.0}, "Target": 0.99,
         "Ticks": 10, "Bad_ticks": 0, "Burn_rate_fast": 0.0,
         "Burn_rate_slow": 0.0, "Budget_burned": 0.0,
         "Breached": False, "Breaches_total": 0, "Violating": [],
         "Values": {"e2e_p99_ms": 1.0, "throughput_rps": 500.0}}
    b = dict(a, Burn_rate_fast=20.0, Burn_rate_slow=3.0,
             Budget_burned=0.42, Breached=True, Breaches_total=2,
             Violating=["e2e_p99"], Since=123.0,
             Values={"e2e_p99_ms": 9.0, "throughput_rps": 50.0})
    m = merge_slo([a, b])
    assert m["Breached"] and m["Breaches_total"] == 2
    assert m["Burn_rate_fast"] == 20.0
    assert m["Budget_burned"] == 0.42
    assert m["Violating"] == ["e2e_p99"]
    assert m["Workers"] == 2
    assert m["Values"]["e2e_p99_ms"] == 9.0
    assert m["Values"]["throughput_rps"] == 50.0
    assert merge_slo([]) is None
    return m


def test_merge_slo_worst_news_wins():
    _both(_merge_slo)


# ---------------------------------------------------------------------------
# plane wiring: stats block, flight episodes, verdict, gauges
# ---------------------------------------------------------------------------

def slo_graph(pkg, tmp_path, n=1500, sleep_s=0.0008):
    """The reference's graph: source -> deliberately slow KEYBY map ->
    sink, with a hopeless p99 budget."""
    wf = __import__(pkg)
    cfg = cpu_config(pkg, tracing=True, trace_sample=4,
                     log_dir=str(tmp_path / pkg),
                     diagnosis_interval_s=0.05, audit_interval_s=0.05)
    g = wf.PipeGraph("slo_graph", wf.Mode.DEFAULT, cfg)
    g.with_slo(p99_ms=0.01, target=0.9, fast_burn=5.0, warmup_ticks=1)

    def slow(t):
        time.sleep(sleep_s)
        return None

    rows = Collector()
    g.add_source(wf.SourceBuilder(record_source(pkg, n)).build()) \
        .add(wf.MapBuilder(slow).with_name("slowmap")
             .with_key_by().build()) \
        .add_sink(wf.SinkBuilder(rows).build())
    return g, rows


def _graph_twin(tmp_path, check, n=1500, sleep_s=0.0008):
    """``check(pkg, g)`` after a run of ``slo_graph`` in each package;
    both sinks receive the same records."""
    seen = {}
    for pkg in PACKAGES:
        g, rows = slo_graph(pkg, tmp_path, n=n, sleep_s=sleep_s)
        quiet_run(g)
        check(pkg, g)
        seen[pkg] = sorted(rows.results)
    assert len(seen[PORT]) == n
    assert seen[PORT] == seen[REF]


def _with_slo(pkg, tmp_path):
    wf = __import__(pkg)
    log_dir = str(tmp_path / pkg)
    g = wf.PipeGraph("s", config=cpu_config(pkg, log_dir=log_dir))
    assert g.with_slo(p99_ms=2.0) is g
    assert g.config.slo.p99_ms == 2.0
    assert type(g.config.slo).__module__ == f"{pkg}.slo.plane"
    g2 = wf.PipeGraph("s2", config=cpu_config(pkg, diagnosis=False,
                                              log_dir=log_dir))
    g2.with_slo(p99_ms=2.0)
    g2.add_source(wf.SourceBuilder(record_source(pkg, 4)).build()) \
        .add_sink(wf.SinkBuilder(lambda r: None).build())
    with pytest.raises(RuntimeError, match="diagnosis") as e:
        g2.start()
    return g.config.slo.objectives(), str(e.value)


def test_with_slo_sets_config_and_requires_diagnosis(tmp_path):
    _both(_with_slo, tmp_path)


def test_slo_block_flight_episode_and_verdict(tmp_path):
    def check(pkg, g):
        render_text = mod(pkg, "diagnosis").render_text
        rep = g.explain()
        slo = rep["Slo"]
        assert slo is not None
        assert slo["Breaches_total"] >= 1
        assert "e2e_p99" in slo["Violating"] or slo["Breached"]
        assert "SLO VIOLATED" in rep["Verdict"]
        assert "budget" in rep["Verdict"]
        kinds = [e["kind"] for e in g.flight.snapshot()]
        assert "slo_breach" in kinds
        stats = json.loads(g.stats.to_json())
        assert stats["Schema_version"] >= 6
        assert stats["Slo"]["Breaches_total"] >= 1
        assert "slo [" in render_text(rep)
        assert set(stats["Slo"]) == {
            "Objectives", "Target", "Windows", "Ticks", "Bad_ticks",
            "Burn_rate_fast", "Burn_rate_slow", "Budget_burned",
            "Breached", "Breaches_total", "Violating", "Values", "Since"}

    _graph_twin(tmp_path, check)


def test_pool_and_rss_history_gauges(tmp_path):
    def check(pkg, g):
        build_report = mod(pkg, "diagnosis").build_report
        stats = json.loads(g.stats.to_json())
        series = stats["History"]["Series"]
        for name in ("mem_kb", "pool_kb", "pool_buffers"):
            assert name in series and len(series[name]) >= 1
        assert series["mem_kb"][-1] > 0
        pool = stats["Pool"]
        assert pool is not None and pool["Bytes"] >= 0
        rep = build_report(stats)
        assert rep["History"]["Mem_kb"] == series["mem_kb"][-1]

    _graph_twin(tmp_path, check, n=800)


def test_flight_events_carry_monotone_seq(tmp_path):
    def check(pkg, g):
        seqs = [e["seq"] for e in g.flight.snapshot()]
        assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)

    _graph_twin(tmp_path, check, n=400)


def test_diagnosis_reads_the_card_floor_only_for_device_hops(tmp_path,
                                                            monkeypatch):
    """Port-only: the attribution's transport floor (the planner's RTT
    probe) is read only once a trace carries a device hop.  A traced
    record graph with the diagnosis plane on never probes the card, so
    a record-only fleet worker opens no CUDA context; a trace with an
    ``@device`` hop reads the floor once and splits that hop into
    device transport and compute."""
    calls = []
    monkeypatch.setattr(mod(PORT, "graph.planner"), "rtt_floor_ms",
                        lambda: calls.append(1) or 1.0)
    g, rows = slo_graph(PORT, tmp_path, n=400)
    quiet_run(g)
    assert len(rows.results) == 400
    assert g.explain()["Attribution"]["Traces"] > 0 and calls == []

    plane = g.diagnosis
    t0 = time.perf_counter() - 10.0  # long settled
    for _ in range(2):
        ctx = mod(PORT, "telemetry.trace").TraceContext("src", t0)
        ctx.hop("pipe0/win.0@device", t0 + 0.001, t0 + 0.003)
        g.stats.trace_records.append((ctx, t0 + 0.004))
    plane._drain_traces()
    assert calls == [1]
    last = plane.attribution._rows[-1]["classes"]
    assert last["device_transport"] == pytest.approx(1.0)
    assert last["device_compute"] == pytest.approx(1.0)


def _metrics(pkg):
    render_openmetrics = mod(pkg, "telemetry").render_openmetrics
    apps = {1: {"active": True, "report": {
        "PipeGraph_name": "g",
        "Slo": {"Breached": True, "Breaches_total": 2,
                "Burn_rate_fast": 14.4, "Burn_rate_slow": 1.2,
                "Budget_burned": 0.42},
        "Pool": {"Buffers": 7, "Bytes": 4096},
        "Operators": []}}}
    text = render_openmetrics(apps)
    assert 'windflow_slo_breached{app="1",graph="g"} 1' in text
    assert 'windflow_slo_burn_rate{app="1",graph="g",window="fast"}' \
        ' 14.4' in text
    assert 'windflow_slo_burn_rate{app="1",graph="g",window="slow"}' \
        ' 1.2' in text
    assert 'windflow_slo_budget_burned{app="1",graph="g"} 0.42' in text
    assert 'windflow_slo_breaches_total{app="1",graph="g"} 2' in text
    assert 'windflow_pool_bytes{app="1",graph="g"} 4096' in text
    assert 'windflow_pool_buffers{app="1",graph="g"} 7' in text
    assert text.endswith("# EOF\n")
    return text


def test_metrics_families_slo_and_pool():
    _both(_metrics)


# ---------------------------------------------------------------------------
# merged-view folds: flight dedup, trace stitching, the wire table
# ---------------------------------------------------------------------------

def _observe(pkg):
    return mod(pkg, "distributed.observe")


def _flight_dedup(pkg):
    merge_stats = _observe(pkg).merge_stats
    ev = {"t": 1.0, "seq": 7, "kind": "slo_breach"}
    w0 = {"PipeGraph_name": "g", "Worker": 0,
          "Flight": [ev, dict(ev), {"t": 2.0, "seq": 8, "kind": "x"}]}
    w1 = {"PipeGraph_name": "g", "Worker": 1, "Flight": [dict(ev)]}
    merged = merge_stats([w0, w1])
    breaches = [e for e in merged["Flight"] if e["kind"] == "slo_breach"]
    assert len(breaches) == 2
    assert len(merged["Flight"]) == 3
    legacy = {"PipeGraph_name": "g", "Worker": 2,
              "Flight": [{"t": 1.0, "kind": "y"},
                         {"t": 1.0, "kind": "y"}]}
    merged_legacy = merge_stats([legacy])
    assert len(merged_legacy["Flight"]) == 2
    return merged, merged_legacy


def test_merge_dedups_flight_by_worker_seq():
    _both(_flight_dedup)


def _stitch(pkg):
    stitch_traces = _observe(pkg).stitch_traces
    attribution = mod(pkg, "diagnosis.attribution")
    closed = {"id": "src#1", "src": "src", "e2e_ms": 10.0, "worker": 1,
              "hops": [["pipe0/map", 4.0, 9.0],
                       ["pipe0/map@wire", 2.0, 4.0]]}
    partial = {"id": "src#1", "src": "src", "e2e_ms": 2.0,
               "partial": True, "worker": 0,
               "hops": [["pipe0/srcseg", 0.0, 2.0]]}
    lone_partial = {"id": "src#2", "src": "src", "e2e_ms": 1.0,
                    "partial": True, "worker": 0, "hops": []}
    no_id = {"src": "src", "e2e_ms": 3.0, "hops": []}
    out = stitch_traces([closed, partial, lone_partial, no_id])
    by_id = {r.get("id"): r for r in out}
    st = by_id["src#1"]
    assert st["stitched"] and st["workers"] == [0, 1]
    assert not st.get("partial")
    assert [h[0] for h in st["hops"]] == [
        "pipe0/srcseg", "pipe0/map@wire", "pipe0/map"]
    assert by_id["src#2"]["partial"]
    assert no_id in out
    assert attribution.trace_breakdown(by_id["src#2"]) is None
    acc = attribution.AttributionAccumulator()
    for r in out:
        acc.add(attribution.trace_breakdown(r))
    blk = acc.block()
    assert blk["Share_sum"] == pytest.approx(1.0, abs=0.01)
    ops = {r["operator"]: r for r in blk["Operators"]}
    assert ops["pipe0/srcseg"]["classes"]["service"] > 0
    return out, blk


def test_stitch_traces_joins_by_id():
    _both(_stitch)


def _wire_folds(pkg):
    merge_stats = _observe(pkg).merge_stats
    wire_table = _observe(pkg).wire_table
    check_wire_conservation = _observe(pkg).check_wire_conservation
    w0 = {"PipeGraph_name": "g", "Worker": 0,
          "Wire": {"Worker": 0, "out": [
              {"edge": "pipe0/fold.0", "tuples": 9000, "frames": 9,
               "unacked": 5, "unacked_tuples": 5000}], "in": []}}
    w1 = {"PipeGraph_name": "g", "Worker": 1,
          "Wire": {"Worker": 1, "out": [], "in": [
              {"edge": "pipe0/fold.0", "tuples": 4000, "frames": 4,
               "gaps": 0}]}}
    out = [wire_table([w0, w1]), check_wire_conservation([w0, w1])]
    live = merge_stats([w0, w1], live=True)
    (row,) = live["Wire"]["Edges"]
    assert row["settling"] and not row["balanced"]
    assert row["in_flight"] == 5000 and row["missing_tuples"] == 0
    assert not any(v["kind"] == "lost_wire_delivery"
                   for v in live["Conservation"]["Violations"])
    assert live["Conservation"]["Edges_balanced"]
    out.append(live)
    w0["Wire"]["out"][0]["unacked_tuples"] = 1000
    (row,) = merge_stats([w0, w1], live=True)["Wire"]["Edges"]
    assert not row["settling"] and row["missing_tuples"] == 4000
    out.append(row)
    w0["Wire"]["out"][0]["unacked_tuples"] = 5000
    merged = merge_stats([w0, w1])
    assert not merged["Conservation"]["Edges_balanced"]
    assert any(v["kind"] == "lost_wire_delivery" and v["count"] == 5000
               for v in merged["Conservation"]["Violations"])
    out.append(merged)
    w1["Wire"]["in"][0]["tuples"] = 9500
    merged = merge_stats([w0, w1])
    (row,) = merged["Wire"]["Edges"]
    assert not row["settling"] and row["extra_tuples"] == 500
    assert any(v["kind"] == "lost_wire_delivery" and v["count"] == 500
               for v in merged["Conservation"]["Violations"])
    out.append(merged)
    return out


def test_wire_live_vs_offline_fold_semantics():
    _both(_wire_folds)


def _slo_pool_fold(pkg):
    merge_stats = _observe(pkg).merge_stats
    build_report = mod(pkg, "diagnosis").build_report
    w0 = {"PipeGraph_name": "g", "Worker": 0,
          "Slo": {"Breached": False, "Breaches_total": 0,
                  "Burn_rate_fast": 0.0, "Burn_rate_slow": 0.0,
                  "Budget_burned": 0.0, "Objectives": {"p99_ms": 1.0},
                  "Ticks": 5, "Bad_ticks": 0},
          "Pool": {"Buffers": 2, "Bytes": 100}}
    w1 = {"PipeGraph_name": "g", "Worker": 1,
          "Slo": {"Breached": True, "Breaches_total": 1,
                  "Burn_rate_fast": 10.0, "Burn_rate_slow": 2.0,
                  "Budget_burned": 0.2, "Objectives": {"p99_ms": 1.0},
                  "Ticks": 5, "Bad_ticks": 4,
                  "Violating": ["e2e_p99"]},
          "Pool": {"Buffers": 3, "Bytes": 200}}
    merged = merge_stats([w0, w1])
    assert merged["Slo"]["Breached"]
    assert merged["Slo"]["Burn_rate_fast"] == 10.0
    assert merged["Pool"] == {"Buffers": 5, "Bytes": 300}
    rep = build_report(merged)
    assert "SLO VIOLATED" in rep["Verdict"]
    return merged, rep


def test_merge_stats_folds_slo_and_pool():
    _both(_slo_pool_fold)


# ---------------------------------------------------------------------------
# live cluster view: observer + pusher (single process), /cluster
# ---------------------------------------------------------------------------

def _get_json(url, timeout=5):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def _observer_live(pkg, tmp_path):
    obs_mod = _observe(pkg)
    obs = obs_mod.ClusterObserver()
    obs.start()
    obs.serve_http()
    g, rows = slo_graph(pkg, tmp_path, n=2500, sleep_s=0.001)
    pusher = None
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            g.start()
        pusher = obs_mod.attach_pusher(g, obs.host, obs.port, 0.1)
        url = obs.http_url + "/cluster"
        deadline = time.monotonic() + WAIT_S
        seen_breach = mid_run = False
        while time.monotonic() < deadline and not seen_breach:
            time.sleep(0.15)
            doc = _get_json(url)
            merged = doc.get("merged") or {}
            if any(e.get("kind") == "slo_breach"
                   for e in merged.get("Flight") or ()):
                seen_breach = True
                mid_run = not g._ended
                assert "SLO VIOLATED" in doc["report"]["Verdict"]
        assert seen_breach, "no slo_breach reached the observer"
        assert mid_run, "breach only observed after the run ended"
        g.wait_end()
        pusher.stop()
        assert pusher.pushes >= 2 and pusher.errors == 0
        deadline = time.monotonic() + 10.0
        while obs.pushes < pusher.pushes \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert obs.pushes == pusher.pushes
        final = obs.merged()
        assert final["Slo"]["Breaches_total"] >= 1
        return sorted(rows.results), sorted(final["Slo"])
    finally:
        if pusher is not None:
            pusher.stop()
        if not g._ended:
            g.cancel()
            try:
                g.wait_end()
            except Exception:
                pass
        obs.stop()


def test_observer_pusher_live_single_process(tmp_path):
    rows, _keys = _both(_observer_live, tmp_path)
    assert len(rows) == 2500


def _observer_dedup(pkg):
    obs = _observe(pkg).ClusterObserver()
    obs.start()
    try:
        stats = {"PipeGraph_name": "g", "Worker": 0,
                 "Flight": [{"t": 1.0, "seq": 1, "kind": "a"},
                            {"t": 2.0, "seq": 2, "kind": "b"}]}
        obs.ingest({"pid": 42, "stats": dict(
            stats, Flight=list(stats["Flight"]))})
        obs.ingest({"pid": 42, "stats": {
            "PipeGraph_name": "g", "Worker": 0,
            "Flight": [{"t": 2.0, "seq": 2, "kind": "b"},
                       {"t": 3.0, "seq": 3, "kind": "c"}]}})
        merged = obs.merged()
        assert [e["kind"] for e in merged["Flight"]] == ["a", "b", "c"]
        obs.ingest({"pid": 43, "stats": {
            "PipeGraph_name": "g", "Worker": 0,
            "Flight": [{"t": 4.0, "seq": 1, "kind": "d"}]}})
        merged2 = obs.merged()
        assert [e["kind"] for e in merged2["Flight"]] \
            == ["a", "b", "c", "d"]
        return merged, merged2
    finally:
        obs.stop()


def test_observer_dedups_resent_flight_tails():
    _both(_observer_dedup)


def _dashboard_cluster(pkg):
    dashboard = mod(pkg, "monitoring.dashboard")
    dash = dashboard.DashboardServer(port=0)
    dash.start()
    httpd = None
    try:
        with dash.lock:
            for aid, w in ((1, 0), (2, 1)):
                dash.apps[aid] = {"diagram": "", "active": True,
                                  "reports_received": 1,
                                  "report": {"PipeGraph_name": "g",
                                             "Worker": w,
                                             "Operators": []}}
        httpd = dashboard.serve_http(dash, port=0)
        port = httpd.server_address[1]
        doc = _get_json(f"http://127.0.0.1:{port}/cluster")
        merged = doc["merged"]
        assert {w["Worker"] for w in merged["Merged_workers"]} == {0, 1}
        assert doc["report"] is not None
        return doc
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        dash.stop()


def test_dashboard_cluster_endpoint():
    _both(_dashboard_cluster)


def _watch_once(pkg):
    obs = _observe(pkg).ClusterObserver()
    obs.start()
    obs.serve_http()
    try:
        obs.ingest({"pid": 1, "stats": {
            "PipeGraph_name": "g", "Worker": 0,
            "Slo": {"Breached": True, "Breaches_total": 1,
                    "Burn_rate_fast": 10.0, "Burn_rate_slow": 2.0,
                    "Budget_burned": 0.42,
                    "Objectives": {"p99_ms": 1.0},
                    "Violating": ["e2e_p99"],
                    "Values": {"e2e_p99_ms": 9.0}},
            "Operators": [], "Flight": []}})
        rc, out, _err = doctor(pkg, ["--watch", obs.http_url, "--once"])
        assert rc == 0
        assert "SLO VIOLATED" in out and "42% burned" in out
        assert "live cluster view" in out
        rc, js, _err = doctor(pkg, ["--watch", obs.http_url, "--once",
                                     "--json"])
        doc = json.loads(js)
        assert rc == 0 and doc["Slo"]["Breached"]
        url = obs.http_url + "/cluster"
        text = out.replace(url, "<url>")
        doc["Source"] = doc["Source"].replace(url, "<url>")
    finally:
        obs.stop()
    rc, _out, err = doctor(pkg, ["--watch", "http://127.0.0.1:9",
                                  "--once"])
    assert rc == 2
    return text, doc, err.split(":")[0]


def test_doctor_watch_once_against_observer():
    _both(_watch_once)


# ---------------------------------------------------------------------------
# golden-file contract: the doctor --json schema, both directions
# ---------------------------------------------------------------------------

REPORT_KEYS = {
    "Graph", "Schema_version", "Verdict", "Bottleneck", "Attribution",
    "Anomalies", "Anomalies_total", "Slo", "Scheduler",
    "Scheduler_events", "Conservation",
    "Durability", "Hot_keys", "State_tiers", "History", "Failures",
    "Arbitrations",
    "Replacements", "Replica_restarts", "Recovery_fallbacks",
    "State_pressure", "Disk_full", "Flight_tail",
}


def _doctor_json(pkg, path):
    rc, out, _err = doctor(pkg, [path, "--json"])
    assert rc == 0
    return json.loads(out)


def _golden(pkg, version):
    rep = _doctor_json(pkg, os.path.join(
        GOLDEN_DIR, f"doctor_stats_v{version}.json"))
    src = rep.pop("Source")
    assert src.endswith(f"doctor_stats_v{version}.json")
    with open(os.path.join(GOLDEN_DIR,
                           f"doctor_report_v{version}.json")) as f:
        assert rep == json.load(f)
    assert set(rep) == REPORT_KEYS
    return rep


def test_doctor_golden_old_dump_renders_identically():
    rep = _both(_golden, 5)
    assert rep["Slo"] is None


def test_doctor_golden_new_dump_with_slo():
    rep = _both(_golden, 6)
    assert "SLO VIOLATED" in rep["Verdict"]


def _stripped(pkg, tmp_path):
    with open(os.path.join(GOLDEN_DIR, "doctor_stats_v6.json")) as f:
        full = json.load(f)
    reps = []
    for block in ("Slo", "Pool", "Diagnosis", "History",
                  "Conservation", "Topology", "Durability", "Flight"):
        stripped = {k: v for k, v in full.items() if k != block}
        p = tmp_path / f"no_{block}.json"
        p.write_text(json.dumps(stripped))
        rep = _doctor_json(pkg, str(p))
        assert set(rep) - {"Source"} == REPORT_KEYS
        if block == "Slo":
            assert rep["Slo"] is None
            assert "SLO VIOLATED" not in rep["Verdict"]
        reps.append(rep)
    return reps


def test_doctor_tolerates_block_removal_from_new_dump(tmp_path):
    _both(_stripped, tmp_path)


@pytest.mark.parametrize("version", [5, 6, 10, 11])
@pytest.mark.parametrize("as_json", [False, True], ids=["text", "json"])
def test_doctor_output_byte_equal_over_goldens(version, as_json):
    """The port's doctor prints exactly the reference's bytes over every
    golden dump, as text and as JSON."""
    argv = [os.path.join(GOLDEN_DIR, f"doctor_stats_v{version}.json")]
    if as_json:
        argv.append("--json")
    rc, out, err = _both(doctor, argv)
    assert rc == 0 and out and not err


def _merge_dumps(pkg, tmp_path):
    """``--merge`` over two per-worker dumps (goldens v6 and v11 as
    workers 0 and 1)."""
    paths = []
    for w, version in enumerate((6, 11)):
        with open(os.path.join(GOLDEN_DIR,
                               f"doctor_stats_v{version}.json")) as f:
            stats = json.load(f)
        stats["Worker"] = w
        p = tmp_path / f"w{w}.json"
        p.write_text(json.dumps(stats))
        paths.append(str(p))
    out = []
    for extra in ([], ["--json"]):
        rc, text, err = doctor(pkg, ["--merge"] + paths + extra)
        assert rc == 0 and not err
        out.append(text)
    rep = json.loads(out[1])
    assert rep["Source"].startswith("merged:")
    assert "SLO VIOLATED" in rep["Verdict"]
    return out


def test_doctor_merge_folds_worker_dumps(tmp_path):
    _both(_merge_dumps, tmp_path)


def test_doctor_runs_as_a_module(tmp_path):
    """``python -m windflow_tpu_torch.doctor`` as a user runs it: the
    same text as the reference's module over a golden dump, and exit
    code 2 on a directory with no dump."""
    import subprocess
    import sys
    path = os.path.join(GOLDEN_DIR, "doctor_stats_v6.json")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    outs = []
    for pkg in PACKAGES:
        p = subprocess.run([sys.executable, "-m", f"{pkg}.doctor", path],
                           cwd=repo, env=env, capture_output=True,
                           text=True, timeout=120)
        assert p.returncode == 0, p.stderr
        outs.append(p.stdout)
    assert outs[1] == outs[0] and "SLO VIOLATED" in outs[1]
    p = subprocess.run([sys.executable, "-m", f"{PORT}.doctor",
                        str(tmp_path / "empty")], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and "doctor:" in p.stderr
