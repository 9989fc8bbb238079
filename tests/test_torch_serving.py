"""The port's serving plane (windflow_tpu_torch/serving/) held against
the reference's: one twin of each case of tests/test_serving.py.

Each twin runs the reference test's scenario through ``windflow_tpu``
and through ``windflow_tpu_torch`` (tenant graphs on the CPU,
``RuntimeConfig(device="cpu")``) with the same inputs, meets the
reference test's assertions in both, and holds what both decided equal:
tenant states, credit books, arbitration plans and ledgers, flight
events, the ``describe_*`` strings, the doctor's blocks and the sinks'
records.  The noisy-neighbour run is load-sensitive in the reference
(ROADMAP.md C3): its twin holds the two packages to the same decisions,
never to a timing, and every wait has a deadline.  Every ``Server`` is
closed in a ``finally``; every graph writes its logs under the test's
temporary directory.

Added for the port: a tenant whose graph asks for the CUDA card on a
box without one ends FAILED with the error on its handle, and a
dashboard opened and closed back to back raises in no thread.
"""
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from torch_dist_builds import device_engines
from torch_graphs import (PACKAGES, PORT, burn_10ms, burner_source,
                          close_server, cpu_config, mod, open_server,
                          quiet_cfg, record_source,
                          recovered_after_a_decision, wait_for)

REF = PACKAGES[0]
WAIT_S = 120


def _both(scenario, *args):
    """``scenario(pkg, *args)`` in both packages; the results equal."""
    want = scenario(REF, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# helpers (the reference test's, per package)
# ---------------------------------------------------------------------------



def simple_build(pkg, n=2000, sink_list=None, pace_s=0.0, endless=False):
    wf = __import__(pkg)

    def build(g):
        sink = (lambda r: sink_list.append((r.key, r.id))) \
            if sink_list is not None else (lambda r: None)
        g.add_source(wf.SourceBuilder(
            record_source(pkg, n, pace_s, endless)).build()) \
            .add(wf.MapBuilder(lambda t: None).with_name("m").build()) \
            .add_sink(wf.SinkBuilder(
                lambda r: r is not None and sink(r)).build())
    return build




def make_trace(pkg, n, n_keys=4):
    TupleBatch = mod(pkg, "core.tuples").TupleBatch
    ar = np.arange(n, dtype=np.int64)
    return TupleBatch({"key": ar % n_keys, "id": ar // n_keys,
                       "ts": ar // n_keys,
                       "value": np.ones(n, np.float64)})


def serving(pkg):
    return mod(pkg, "serving")






def arbitrations(h):
    return [{k: e[k] for k in ("victim", "donor", "action")}
            for e in h.graph.flight.snapshot()
            if e["kind"] == "arbitration"]


# ---------------------------------------------------------------------------
# spec validation + admission control
# ---------------------------------------------------------------------------

def _spec_validation(pkg):
    TenantSpec = serving(pkg).TenantSpec
    refused = []
    for kw in (dict(credits=0), dict(weight=0.0),
               dict(credits=100, min_credits=200), dict(pool_buffers=0),
               dict(devices=-1)):
        with pytest.raises(ValueError) as ei:
            TenantSpec(**kw)
        refused.append(str(ei.value))
    blk = TenantSpec(priority=3, weight=2.0, devices=1).block()
    assert blk["Priority"] == 3 and blk["Weight"] == 2.0
    return refused, blk


def test_tenant_spec_validation():
    _both(_spec_validation)


def _admission(pkg, tmp_path):
    S = serving(pkg)
    srv = open_server(pkg)
    try:
        cfg = quiet_cfg(pkg, tmp_path)
        h = srv.submit("a", simple_build(pkg, 500),
                       S.TenantSpec(credits=40_000), config=cfg)
        granted = [srv.granted]
        with pytest.raises(S.AdmissionError, match="global cap") as e1:
            srv.submit("b", simple_build(pkg, 500),
                       S.TenantSpec(credits=40_000), config=cfg)
        with pytest.raises(ValueError, match="already submitted") as e2:
            srv.submit("a", simple_build(pkg, 500), config=cfg)
        states = [h.wait(WAIT_S)]
        granted.append(srv.granted)
        srv.evict("a")
        h2 = srv.submit("a", simple_build(pkg, 300),
                        S.TenantSpec(credits=40_000), config=cfg)
        states.append(h2.wait(WAIT_S))
        granted.append(srv.granted)
    finally:
        close_server(srv)
    assert granted == [40_000, 0, 0]
    assert states == ["COMPLETED", "COMPLETED"]
    return granted, states, str(e1.value), str(e2.value)


def test_admission_over_cap_rejected_and_capacity_released(tmp_path):
    _both(_admission, tmp_path)


def _failed_build(pkg, tmp_path):
    S = serving(pkg)
    srv = open_server(pkg)
    try:
        def bad_build(g):
            raise RuntimeError("boom at build time")

        with pytest.raises(RuntimeError, match="boom") as ei:
            srv.submit("bad", bad_build, S.TenantSpec(credits=1024),
                       config=quiet_cfg(pkg, tmp_path))
        assert srv.granted == 0
        assert srv.get("bad") is None
    finally:
        close_server(srv)
    return str(ei.value), srv.granted


def test_failed_build_releases_reservation(tmp_path):
    _both(_failed_build, tmp_path)


# ---------------------------------------------------------------------------
# lifecycle: run to completion, stop mid-run, crash isolation
# ---------------------------------------------------------------------------

def _submit_runs(pkg, tmp_path):
    S = serving(pkg)
    srv = open_server(pkg)
    got = []
    try:
        h = srv.submit("alpha", simple_build(pkg, 2000, got),
                       S.TenantSpec(credits=1024, priority=2, weight=1.5),
                       config=quiet_cfg(pkg, tmp_path))
        assert h.wait(WAIT_S) == "COMPLETED"
        stats = json.loads(h.graph.stats.to_json(0, 0))
        cons = stats["Conservation"]
        assert cons["Edges_balanced"] and not cons["Violations_total"]
        row = srv.stats()["Tenants"][0]
    finally:
        close_server(srv)
    assert len(got) >= 2000
    t = stats["Tenant"]
    assert t["Name"] == "alpha" and t["State"] == "COMPLETED"
    assert t["Priority"] == 2 and t["Credits"] == 1024
    return sorted(got), t, {k: row[k] for k in row if k != "Slo"}


def test_submit_runs_and_publishes_tenant_block(tmp_path):
    _both(_submit_runs, tmp_path)


def _stop_midrun(pkg, tmp_path):
    S = serving(pkg)
    srv = open_server(pkg)
    try:
        h = srv.submit("endless",
                       simple_build(pkg, 0, endless=True, pace_s=0.0005),
                       S.TenantSpec(credits=1024),
                       config=quiet_cfg(pkg, tmp_path))
        time.sleep(0.5)
        running = h.state
        stopped = srv.evict("endless").state
        pool = h.graph.buffer_pool
        drained = pool is None or pool.stats()["buffers"] == 0
        out = (running, stopped, h.error, srv.granted, drained)
    finally:
        close_server(srv)
    assert out == ("RUNNING", "STOPPED", None, 0, True)
    return out


def test_stop_midrun_reclaims_and_reports_stopped(tmp_path):
    _both(_stop_midrun, tmp_path)


def _crash_isolated(pkg, tmp_path):
    wf = __import__(pkg)
    S = serving(pkg)
    FaultPlan = mod(pkg, "resilience").FaultPlan
    srv = open_server(pkg)
    got = []
    try:
        fp = FaultPlan(seed=7).crash_replica("m.0", at_tuple=50)
        h_bad = srv.submit("crashy", simple_build(pkg, 5000),
                           S.TenantSpec(credits=512),
                           config=quiet_cfg(pkg, tmp_path, fault_plan=fp))
        h_ok = srv.submit("steady", simple_build(pkg, 3000, got),
                          S.TenantSpec(credits=512),
                          config=quiet_cfg(pkg, tmp_path))
        states = (h_bad.wait(WAIT_S), h_ok.wait(WAIT_S))
        assert isinstance(h_bad.error, wf.NodeFailureError)
        stats = json.loads(h_ok.graph.stats.to_json(0, 0))
        assert stats["Conservation"]["Edges_balanced"]
    finally:
        close_server(srv)
    assert states == ("FAILED", "COMPLETED")
    assert len(got) >= 3000
    return states, sorted(got)


def test_crash_isolated_as_failed_handle(tmp_path):
    _both(_crash_isolated, tmp_path)


# ---------------------------------------------------------------------------
# acceptance: >= 8-graph soak, one tenant killed mid-run
# ---------------------------------------------------------------------------

def _soak(pkg, tmp_path):
    S = serving(pkg)
    FaultPlan = mod(pkg, "resilience").FaultPlan
    N_TENANTS, N_RECORDS = 8, 1500
    sinks = {i: [] for i in range(N_TENANTS)}
    srv = open_server(pkg)
    try:
        handles = {}
        for i in range(N_TENANTS):
            cfg = quiet_cfg(pkg, tmp_path)
            if i == 3:
                cfg.fault_plan = FaultPlan(seed=i).crash_replica(
                    "m.0", at_tuple=200)
            handles[i] = srv.submit(
                f"tenant-{i}", simple_build(pkg, N_RECORDS, sinks[i]),
                S.TenantSpec(credits=1024, priority=i % 3), config=cfg)
        states = {i: h.wait(WAIT_S) for i, h in handles.items()}
        names = set()
        for i, h in handles.items():
            stats = json.loads(h.graph.stats.to_json(0, 0))
            names.add(stats["PipeGraph_name"])
            if i == 3:
                continue
            cons = stats["Conservation"]
            assert cons["Edges_balanced"], (i, cons)
            assert not cons["Violations_total"], (i, cons)
            assert stats["Tenant"]["Name"] == f"tenant-{i}"
        for i in range(N_TENANTS):
            srv.evict(f"tenant-{i}")
    finally:
        close_server(srv)
    assert states == {i: "FAILED" if i == 3 else "COMPLETED"
                      for i in range(N_TENANTS)}
    assert len(names) == N_TENANTS
    delivered = {i: sorted(sinks[i]) for i in sinks if i != 3}
    assert all(len(v) >= N_RECORDS for v in delivered.values())
    return states, sorted(names), delivered


def test_soak_eight_tenants_one_crash(tmp_path):
    _both(_soak, tmp_path)


# ---------------------------------------------------------------------------
# lifecycle-leak census across repeated cycles
# ---------------------------------------------------------------------------

def _census_settled(pkg, base, deadline_s=20.0):
    process_census = serving(pkg).process_census
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        cen = process_census()
        if cen["threads"] <= base["threads"] \
                and (base["fds"] < 0 or cen["fds"] <= base["fds"]):
            return cen
        time.sleep(0.2)
    return process_census()


def _census(pkg, tmp_path):
    wf = __import__(pkg)
    S = serving(pkg)
    FaultPlan = mod(pkg, "resilience").FaultPlan

    def build(g):
        g.add_source(wf.SourceBuilder(record_source(pkg, 1500)).build()) \
            .add(wf.MapBuilder(lambda t: None).with_name("m")
                 .with_key_by().with_parallelism(2)
                 .with_elasticity(1, 4).build()) \
            .add_sink(wf.SinkBuilder(lambda r: None).build())

    states = []
    srv = open_server(pkg)
    try:
        srv.submit("warm", build, S.TenantSpec(credits=512),
                   config=quiet_cfg(pkg, tmp_path)).wait(WAIT_S)
        srv.evict("warm")
        base = _census_settled(pkg, S.process_census())
        for cycle in range(2):
            h = srv.submit("el", build, S.TenantSpec(credits=512),
                           config=cpu_config(
                               pkg, log_dir=str(tmp_path / pkg)))
            states.append(h.wait(WAIT_S))
            srv.evict("el")
            fp = FaultPlan(seed=cycle).crash_replica("m.0", at_tuple=100)
            h = srv.submit("crash", build, S.TenantSpec(credits=512),
                           config=quiet_cfg(pkg, tmp_path, fault_plan=fp))
            states.append(h.wait(WAIT_S))
            srv.evict("crash")
            h = srv.submit(
                "run", simple_build(pkg, 0, endless=True, pace_s=0.0005),
                S.TenantSpec(credits=512), config=quiet_cfg(pkg, tmp_path))
            time.sleep(0.4)
            states.append(srv.evict("run").state)
        cen = _census_settled(pkg, base)
        extra = [n for n in cen["names"] if n not in base["names"]]
        assert cen["threads"] <= base["threads"], (base, cen, extra)
        if base["fds"] >= 0:
            assert cen["fds"] <= base["fds"], (base, cen)
    finally:
        close_server(srv)
    assert states == ["COMPLETED", "FAILED", "STOPPED"] * 2
    return states


def test_census_no_thread_or_fd_leak_across_cycles(tmp_path):
    _both(_census, tmp_path)


# ---------------------------------------------------------------------------
# arbiter policy (pure planner): one parametrised twin per reference case
# ---------------------------------------------------------------------------

def _view(pkg, name, **kw):
    kw.setdefault("credits", 4096)
    kw.setdefault("min_credits", 256)
    return serving(pkg).TenantView(name=name, **kw)


def _cfg(pkg, **kw):
    kw.setdefault("breach_ticks", 2)
    kw.setdefault("cooldown_s", 5.0)
    return serving(pkg).ArbiterConfig(**kw)


def _plan_noop(pkg):
    plan = serving(pkg).plan_arbitration
    cfg = _cfg(pkg)
    out = [plan([_view(pkg, "a", breached=False),
                 _view(pkg, "b", breached=False)], cfg, {}, {}, 0.0),
           plan([_view(pkg, "a", breached=True)], cfg, {"a": 5}, {}, 0.0),
           plan([_view(pkg, "a", breached=True),
                 _view(pkg, "b", breached=True)], cfg,
                {"a": 5, "b": 5}, {}, 0.0)]
    assert out == [None, None, None]
    return out


def _plan_hysteresis(pkg):
    plan = serving(pkg).plan_arbitration
    cfg = _cfg(pkg)
    views = [_view(pkg, "a", breached=True), _view(pkg, "b", breached=False)]
    out = [plan(views, cfg, {"a": 1}, {}, 0.0),
           plan(views, cfg, {"a": 2}, {}, 0.0),
           plan(views, cfg, {"a": 2}, {"b": 10.0}, 5.0),
           plan(views, cfg, {"a": 2}, {"b": 10.0}, 11.0)]
    assert out[0] is None and out[2] is None
    assert out[1]["victim"] == "a" and out[1]["donor"] == "b"
    assert out[3]
    return out


def _plan_ordering(pkg):
    plan = serving(pkg).plan_arbitration
    cfg = _cfg(pkg)
    views = [
        _view(pkg, "low-vic", breached=True, priority=1),
        _view(pkg, "high-vic", breached=True, priority=5),
        _view(pkg, "heavy-donor", breached=False, priority=0, weight=4.0),
        _view(pkg, "light-donor", breached=False, priority=0, weight=1.0),
        _view(pkg, "vip-donor", breached=False, priority=9),
    ]
    d = plan(views, cfg, {v.name: 9 for v in views}, {}, 0.0)
    assert d["victim"] == "high-vic" and d["donor"] == "light-donor"
    views2 = [_view(pkg, "vic", breached=True, priority=1),
              _view(pkg, "vip", breached=False, priority=2)]
    d2 = plan(views2, cfg, {"vic": 9, "vip": 0}, {}, 0.0)
    assert d2 is None
    return d, d2


def _plan_actions(pkg):
    S = serving(pkg)
    sp = mod(pkg, "serving.arbiter")._spare_credits
    cfg = _cfg(pkg)
    views = [
        _view(pkg, "vic", breached=True, violating=("throughput",),
              values={"throughput_rps": 3.0}, burn_fast=10.0),
        _view(pkg, "don", breached=False, credits=4096, min_credits=256,
              elastic=[("pipe0/burn", 4, 1, 8)]),
    ]
    d = S.plan_arbitration(views, cfg, {"vic": 2, "don": 0}, {}, 0.0)
    kinds = {a["type"]: a for a in d["actions"]}
    assert kinds["rescale"]["old"] == 4 and kinds["rescale"]["new"] == 2
    assert kinds["credits"]["moved"] == (4096 - 256) // 2
    assert d["evidence"]["violating"] == ["throughput"]
    steps = (sp(_view(pkg, "don2", breached=False, credits=260,
                      min_credits=256), 0.5),
             sp(_view(pkg, "don3", credits=256, min_credits=256), 0.5))
    assert 1 <= steps[0] <= 4 and steps[1] == 0
    views[1] = _view(pkg, "don", breached=False, credits=256,
                     min_credits=256, elastic=[("pipe0/burn", 1, 1, 8)])
    d2 = S.plan_arbitration(views, cfg, {"vic": 2, "don": 0}, {}, 0.0)
    assert d2 is None
    return d, steps, d2


def _plan_restitution(pkg):
    S = serving(pkg)
    cfg = S.ArbiterConfig(clear_ticks=3)
    don = [S.Donation(victim="vic", donor="don", operator="op",
                      old_parallelism=4, new_parallelism=2),
           S.Donation(victim="vic", donor="don", credits_moved=512)]
    views = [_view(pkg, "vic", breached=False), _view(pkg, "don")]
    picks = [S.plan_restitution(views, cfg, don, {"vic": 2}),
             S.plan_restitution(views, cfg, don, {"vic": 3}),
             S.plan_restitution([_view(pkg, "don")], cfg, don, {})]
    views[0] = _view(pkg, "vic", breached=True)
    picks.append(S.plan_restitution(views, cfg, don, {"vic": 0}))
    idx = [None if p is None else next(i for i, d in enumerate(don)
                                       if d is p) for p in picks]
    assert idx == [None, 1, 1, None]
    return idx, [vars(d) for d in don]


def _forget(pkg):
    S = serving(pkg)
    arb = S.CrossTenantArbiter.__new__(S.CrossTenantArbiter)
    arb._state_lock = threading.Lock()
    arb._breach_runs, arb._clear_runs, arb._cooldowns = {}, {}, {}
    arb.donations = [
        S.Donation(victim="v", donor="reused", credits_moved=100),
        S.Donation(victim="reused", donor="other", credits_moved=200),
    ]
    arb._breach_runs["reused"] = 5
    arb.forget("reused")
    assert len(arb.donations) == 1
    assert arb.donations[0].victim == "reused"
    assert arb.donations[0].victim_departed
    assert "reused" not in arb._breach_runs
    views = [_view(pkg, "reused", breached=True), _view(pkg, "other")]
    d = S.plan_restitution(views, S.ArbiterConfig(), arb.donations, {})
    assert d is arb.donations[0]
    return [vars(x) for x in arb.donations], dict(arb._breach_runs)


def _describe(pkg):
    arb = mod(pkg, "serving.arbiter")
    s1 = arb.describe_actions(
        [{"type": "rescale", "operator": "pipe0/acc", "old": 4, "new": 2},
         {"type": "credits", "moved": 2048}], "tenant-b", "tenant-a")
    assert "scaled pipe0/acc@tenant-b 4→2" in s1
    assert "granted 2048 credits to tenant-a" in s1
    s2 = arb.describe_actions([{"type": "rescale", "operator": "op",
                                "old": 1, "new": 4}], "d", "v",
                              restore=True)
    assert "restored" in s2
    # the port's strings for the other actions, and the evidence phrase
    s3 = arb.describe_actions(
        [{"type": "credits", "moved": 7},
         {"type": "device", "operator": "n/win", "chip": "cuda:0",
          "to": "host"}], "d", "v", restore=True)
    s4 = arb.describe_evidence(
        {"violating": ["e2e_p99", "throughput", "frontier_lag", "x"],
         "values": {"e2e_p99_ms": 42.0, "throughput_rps": 3.5,
                    "frontier_lag_ms": 120.0},
         "budget_burned": 0.45})
    return s1, s2, s3, s4, arb.describe_evidence({})


PLAN_CASES = {
    "test_plan_no_victim_or_no_donor_is_noop": _plan_noop,
    "test_plan_respects_breach_hysteresis_and_cooldown": _plan_hysteresis,
    "test_plan_priority_and_weight_ordering": _plan_ordering,
    "test_plan_actions_halve_parallelism_and_move_spare_credits":
        _plan_actions,
    "test_plan_restitution_after_clear_or_departure": _plan_restitution,
    "test_forget_scrubs_donation_ledger_on_name_reuse": _forget,
    "test_describe_actions_strings": _describe,
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_arbiter_policy_twins(case):
    """The reference's pure arbiter cases: the same plans, ledgers and
    strings in both packages."""
    _both(PLAN_CASES[case])


# ---------------------------------------------------------------------------
# restitution against live graphs
# ---------------------------------------------------------------------------

def elastic_build(pkg, par):
    wf = __import__(pkg)

    def build(g):
        g.add_source(wf.SourceBuilder(
            record_source(pkg, 0, pace_s=0.001, endless=True)).build()) \
            .add(wf.MapBuilder(lambda t: None).with_name("m")
                 .with_key_by().with_parallelism(par)
                 .with_elasticity(1, 4).build()) \
            .add_sink(wf.SinkBuilder(lambda r: None).build())
    return build


def _stacked(pkg, tmp_path):
    S = serving(pkg)
    srv = open_server(pkg)
    try:
        h = srv.submit("don", elastic_build(pkg, 4),
                       S.TenantSpec(credits=1024),
                       config=quiet_cfg(pkg, tmp_path))
        try:
            op = next(iter(h.graph.elastic))

            def par():
                return next(iter(h.graph.elastic.values())).parallelism

            h.graph.rescale(op, 2)
            h.graph.rescale(op, 1)
            d1 = S.Donation(victim="x", donor="don", operator=op,
                            old_parallelism=4, new_parallelism=2,
                            victim_departed=True)
            d2 = S.Donation(victim="y", donor="don", operator=op,
                            old_parallelism=2, new_parallelism=1,
                            victim_departed=True)
            steps = [(srv.apply_restitution(d1), d1.operator == op, par())]
            steps.append((srv.apply_restitution(d2), d2.operator, par()))
            steps.append((srv.apply_restitution(d1), d1.operator, par()))
        finally:
            h.graph.cancel()
            h.wait(WAIT_S)
    finally:
        close_server(srv)
    assert steps == [(False, True, 1), (True, None, 2), (True, None, 4)]
    return op, steps, arbitrations(h)


def test_stacked_rescale_donations_unwind_lifo(tmp_path):
    _both(_stacked, tmp_path)


def ingest_build(pkg, n):
    wf = __import__(pkg)

    def build(g):
        src = wf.SourceBuilder.from_replay(make_trace(pkg, n), speedup=None,
                                           chunk=256).build()
        g.add_source(src).add_sink(wf.SinkBuilder(lambda b: None).build())
    return build


def _credit_moves(pkg, tmp_path):
    S = serving(pkg)
    srv = open_server(pkg)
    try:
        h_a = srv.submit("ing-a", ingest_build(pkg, 20_000),
                         S.TenantSpec(credits=4096),
                         config=quiet_cfg(pkg, tmp_path))
        h_b = srv.submit("ing-b", ingest_build(pkg, 20_000),
                         S.TenantSpec(credits=4096),
                         config=quiet_cfg(pkg, tmp_path))
        assert len(h_a._ingest) == 1 and len(h_b._ingest) == 1
        budgets = [h_a._ingest[0].gate.budget]
        decision = {"victim": "ing-a", "donor": "ing-b",
                    "actions": [{"type": "credits", "moved": 2048}],
                    "evidence": {"violating": ["throughput"]}}
        assert srv.apply_arbitration(decision)
        books = [(h_a.credits, h_b.credits)]
        budgets += [h_b._ingest[0].gate.budget, h_a._ingest[0].gate.budget]
        evs = [arbitrations(h) for h in (h_a, h_b)]
        for e in evs:
            assert e and e[0]["victim"] == "ing-a" \
                and e[0]["donor"] == "ing-b"
            assert "granted 2048 credits" in e[0]["action"]
        assert srv.apply_restitution(
            S.Donation(victim="ing-a", donor="ing-b", credits_moved=2048))
        books.append((h_a.credits, h_b.credits))
        states = (h_a.wait(WAIT_S), h_b.wait(WAIT_S))
        dead = h_a.graph.dead_letters.count()
        late = (srv._transfer_credits(h_b, h_a, 100),
                srv.apply_arbitration(
                    {"victim": "ing-a", "donor": "ing-b",
                     "actions": [{"type": "credits", "moved": 100}],
                     "evidence": {}}))
    finally:
        close_server(srv)
    assert budgets == [4096, 2048, 4096 + 2048]
    assert books == [(4096 + 2048, 2048), (4096, 4096)]
    assert states == ("COMPLETED", "COMPLETED") and dead == 0
    assert late == (0, False)
    return budgets, books, evs, states, late, decision


def test_credit_moves_resize_live_gates(tmp_path):
    _both(_credit_moves, tmp_path)


def _gate_resize(pkg):
    CreditGate = mod(pkg, "ingest").CreditGate
    gate = CreditGate(4096)
    assert gate.acquire(4096)
    got = threading.Event()
    t = threading.Thread(target=lambda: (gate.acquire(1024), got.set()),
                         daemon=True)
    t.start()
    time.sleep(0.2)
    early = got.is_set()
    gate.resize(256)
    gate.release(4096)
    woke = got.wait(5.0)
    gate2 = CreditGate(64)
    assert gate2.acquire(64)
    got2 = threading.Event()
    t2 = threading.Thread(
        target=lambda: (gate2.acquire(128), got2.set()), daemon=True)
    t2.start()
    time.sleep(0.1)
    gate2.resize(512)
    woke2 = got2.wait(5.0)
    t.join(5.0)
    t2.join(5.0)
    assert (early, woke, woke2) == (False, True, True), \
        "blocked acquire wedged against old budget"
    return early, woke, woke2, gate.budget, gate2.budget


def test_live_gate_resize_never_wedges_blocked_acquire():
    _both(_gate_resize)


def _victim_left(pkg, tmp_path):
    S = serving(pkg)
    srv = open_server(pkg)
    try:
        h_b = srv.submit("donor", ingest_build(pkg, 50_000),
                         S.TenantSpec(credits=2048),
                         config=quiet_cfg(pkg, tmp_path))
        granted0 = srv.granted
        assert srv.apply_restitution(
            S.Donation(victim="long-gone", donor="donor",
                       credits_moved=512))
        out = (h_b.credits, srv.granted - granted0, arbitrations(h_b),
               h_b.arbitrations, h_b.wait(WAIT_S))
    finally:
        close_server(srv)
    assert out[:2] == (2048 + 512, 512)
    assert out[2] and out[2][-1]["victim"] == "long-gone"
    assert "returned 512 credits" in out[2][-1]["action"]
    assert out[3:] == (1, "COMPLETED")
    return out


def test_restitution_after_victim_left_still_recorded(tmp_path):
    _both(_victim_left, tmp_path)


def _partial(pkg, tmp_path):
    S = serving(pkg)
    srv = open_server(pkg, capacity=4096)
    try:
        h = srv.submit("don", ingest_build(pkg, 50_000),
                       S.TenantSpec(credits=2048),
                       config=quiet_cfg(pkg, tmp_path))
        d = S.Donation(victim="gone", donor="don", credits_moved=4096)
        applied = srv.apply_restitution(d)
        out = (applied, h.credits, d.credits_moved, srv.granted,
               h.wait(WAIT_S))
    finally:
        close_server(srv)
    assert out == (True, 4096, 2048, 4096, "COMPLETED")
    return out


def test_partial_restitution_keeps_remainder_ledgered(tmp_path):
    _both(_partial, tmp_path)


def _failed_restitution(pkg, tmp_path):
    S = serving(pkg)
    srv = open_server(pkg)
    try:
        arb = S.CrossTenantArbiter(srv, S.ArbiterConfig(clear_ticks=1))
        h = srv.submit("don", elastic_build(pkg, 2),
                       S.TenantSpec(credits=1024),
                       config=quiet_cfg(pkg, tmp_path))
        op = next(iter(h.graph.elastic))
        arb.donations.append(S.Donation(victim="gone", donor="don",
                                        operator=op, old_parallelism=8,
                                        new_parallelism=2,
                                        victim_departed=True))
        arb.tick(now=0.0)
        ledger = [len(arb.donations)]
        arb.donations.append(S.Donation(victim="gone", donor="don",
                                        operator="no/such_op",
                                        old_parallelism=4,
                                        new_parallelism=2,
                                        victim_departed=True))
        arb.tick(now=1.0)
        ledger += [len(arb.donations), arb.donations[0].old_parallelism]
        h.graph.cancel()
        h.wait(WAIT_S)
        arb.tick(now=2.0)
        ledger.append(len(arb.donations))
    finally:
        close_server(srv)
    assert ledger == [1, 1, 8, 0], "failed restore dropped the ledger"
    return ledger


def test_failed_restitution_stays_ledgered(tmp_path):
    _both(_failed_restitution, tmp_path)


# ---------------------------------------------------------------------------
# acceptance: scripted noisy neighbour, arbiter restores the SLO
# ---------------------------------------------------------------------------









def _noisy_neighbor(pkg, tmp_path):
    wf = __import__(pkg)
    S = serving(pkg)
    render_text = mod(pkg, "diagnosis").render_text
    stop = threading.Event()
    srv = open_server(pkg, arbiter=S.ArbiterConfig(
        interval_s=0.25, breach_ticks=2, cooldown_s=1.0,
        clear_ticks=10 ** 6))
    try:
        vcfg = quiet_cfg(pkg, tmp_path, diagnosis_interval_s=0.2,
                         audit_interval_s=0.1)
        bcfg = quiet_cfg(pkg, tmp_path, queue_capacity=32)

        def build_victim(g):
            g.add_source(wf.SourceBuilder(
                record_source(pkg, 10 ** 6, pace_s=0.001)).build()) \
                .add(wf.MapBuilder(lambda t: None)
                     .with_name("vmap").build()) \
                .add_sink(wf.SinkBuilder(lambda r: None).build())

        def build_noisy(g):
            g.add_source(wf.SourceBuilder(burner_source(pkg, stop))
                         .build()) \
                .add(wf.MapBuilder(burn_10ms).with_name("burn")
                     .with_key_by().with_parallelism(4)
                     .with_elasticity(1, 4).build()) \
                .add_sink(wf.SinkBuilder(lambda r: None).build())

        hv = srv.submit(
            "tenant-a", build_victim,
            S.TenantSpec(credits=1024, priority=5,
                         slo=dict(min_throughput_rps=60.0, target=0.9,
                                  fast_window_s=3.0, slow_window_s=30.0,
                                  warmup_ticks=1, fast_burn=2.0)),
            config=vcfg)
        hb = srv.submit("tenant-b", build_noisy,
                        S.TenantSpec(credits=4096, priority=0),
                        config=bcfg)
        wait_for(lambda: hv.graph.diagnosis.slo is not None
                 and hv.graph.diagnosis.slo.breached,
                 "the victim breached under contention")
        wait_for(lambda: recovered_after_a_decision(srv, hv),
                 "the victim's SLO recovered after an arbitration")
        decisions = list(srv.arbiter.decisions)
        assert decisions, "arbiter never actuated"
        assert all(h.parallelism < 4 for h in hb.graph.elastic.values())
        for h in (hv, hb):
            evs = [e for e in h.graph.flight.snapshot()
                   if e["kind"] == "arbitration"]
            assert evs
            for e in evs:
                assert (e["victim"], e["donor"]) == ("tenant-a",
                                                     "tenant-b")
                assert e["action"] and "violating" in e["evidence"]
        txt = render_text(srv.explain("tenant-a"))
        assert "arbitrations (cross-tenant):" in txt
        assert "tenant-b -> tenant-a" in txt
        assert "scaled" in txt or "granted" in txt
        rows = {r["Name"]: r for r in srv.stats()["Tenants"]}
        assert rows["tenant-a"]["Arbitrations"] >= 1
        assert rows["tenant-b"]["Arbitrations"] >= 1
    finally:
        stop.set()
        close_server(srv)
    # what the arbiter decided first, not when: the same victim, donor
    # and ladder rung in both packages
    first = decisions[0]
    return (first["victim"], first["donor"],
            [a["type"] for a in first["actions"]],
            sorted(first["evidence"]))


def test_noisy_neighbor_arbiter_restores_victim_slo(tmp_path):
    _both(_noisy_neighbor, tmp_path)


# ---------------------------------------------------------------------------
# observability: dashboard index/tenants endpoints, /metrics families,
# doctor Arbitrations block
# ---------------------------------------------------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.read().decode()


def _dashboard(pkg, tmp_path):
    S = serving(pkg)
    srv = open_server(pkg, http_port=0)
    try:
        base = f"http://127.0.0.1:{srv.httpd.server_address[1]}"
        h = srv.submit("web-tenant",
                       simple_build(pkg, 0, endless=True, pace_s=0.0005),
                       S.TenantSpec(credits=2048, priority=1),
                       config=quiet_cfg(pkg, tmp_path))

        def rows():
            idx = json.loads(_get(base + "/index"))
            return [v for v in idx.values()
                    if (v.get("tenant") or {}).get("Name") == "web-tenant"]

        wait_for(rows, "the tenant's first monitor report")
        row = rows()[0]
        assert row["graph"] == "web-tenant" and row["active"]
        assert set(row["links"]) == {"apps", "explain", "flight",
                                     "metrics"}
        aid = row["links"]["apps"].split("=")[-1]
        filtered = json.loads(_get(base + f"/apps?app={aid}"))
        assert list(filtered) == [aid]
        tens = json.loads(_get(base + "/tenants"))
        assert tens["apps"][aid]["Name"] == "web-tenant"
        assert tens["server"]["Tenants"][0]["Name"] == "web-tenant"
        assert tens["server"]["Capacity"] == 1 << 16
        metrics = _get(base + "/metrics")
        families = sorted({ln.split("{")[0] for ln in metrics.splitlines()
                           if ln.startswith("windflow_tenant_")})
        for fam in ('windflow_tenant_up{', 'tenant="web-tenant"',
                    "windflow_tenant_credits",
                    "windflow_tenant_arbitrations_total"):
            assert fam in metrics
        try:  # strict parser, when available (as in test_audit)
            from prometheus_client.openmetrics import parser
            list(parser.text_string_to_metric_families(metrics))
        except ImportError:
            pass
        state = h.state
    finally:
        close_server(srv)
    assert state == "RUNNING"
    return sorted(row["links"]), tens["apps"][aid], families


def test_dashboard_index_tenants_and_metrics(tmp_path):
    _both(_dashboard, tmp_path)


def _report_arbitrations(pkg):
    D = mod(pkg, "diagnosis")
    flight = [
        {"t": 1.0, "seq": 0, "kind": "arbitration",
         "victim": "tenant-a", "donor": "tenant-b",
         "action": "scaled acc@tenant-b 4→2, granted 2k credits to "
                   "tenant-a",
         "detail": "p99 42 ms over budget, 42% budget burned",
         "evidence": {"violating": ["e2e_p99"]}},
        {"t": 2.0, "seq": 1, "kind": "shed", "node": "x"},
    ]
    rep = D.build_report({"PipeGraph_name": "g"}, flight)
    assert len(rep["Arbitrations"]) == 1
    a = rep["Arbitrations"][0]
    assert a["victim"] == "tenant-a" and a["donor"] == "tenant-b"
    txt = D.render_text(rep)
    assert "arbitrations (cross-tenant):" in txt
    assert "tenant-b -> tenant-a: scaled acc@tenant-b 4→2" in txt
    assert "p99 42 ms over budget" in txt
    rep2 = D.build_report({"PipeGraph_name": "g"}, [])
    assert rep2["Arbitrations"] == []
    txt2 = D.render_text(rep2)
    assert "arbitrations" not in txt2
    return rep["Arbitrations"], txt, txt2


def test_report_arbitrations_block_and_rendering():
    _both(_report_arbitrations)


# ---------------------------------------------------------------------------
# the port's own: no CUDA fallback, the dashboard's start/stop race
# ---------------------------------------------------------------------------

def test_tenant_asking_for_the_card_without_one_ends_failed(tmp_path):
    """A tenant graph with a device lane and the default device (the
    CUDA card) on a box without one: ``submit`` returns a FAILED handle
    with the error on it and its reservation back under the cap; the
    lane never ran on the CPU; a CPU tenant beside it completes."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA card")
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.operators.tpu.win_seq_tpu import WinSeqTPU
    S = serving(PORT)

    from windflow_tpu_torch.operators.basic_ops import Sink
    from windflow_tpu_torch.operators.batch_ops import BatchSource

    def build(g):
        batches = [make_trace(PORT, 256)]
        g.add_source(BatchSource(
            lambda ctx: batches.pop() if batches else None)) \
            .add(WinSeqTPU("sum", 8, 4, wf.WinType.TB, emit_batches=True)) \
            .add_sink(Sink(lambda item: None))

    srv = open_server(PORT, devices=1)
    try:
        cfg = quiet_cfg(PORT, tmp_path)
        cfg.device = "cuda"
        h = srv.submit("card", build, S.TenantSpec(credits=1024),
                       config=cfg)
        assert h.state == "FAILED" and h.done()
        assert "no CUDA device" in str(h.error)
        assert srv.granted == 0 and srv.get("card") is h
        assert not srv.devices.tenant_rows("card")
        row = srv.stats()["Tenants"][0]
        assert row["State"] == "FAILED" and "no CUDA device" in row["Error"]
        ends = [e for e in srv.flight.snapshot() if e["kind"] == "tenant_end"]
        assert ends and ends[-1]["state"] == "FAILED"
        (logic,) = device_engines(h.graph)
        assert logic.launched_batches == 0 and logic.device is None
        h_cpu = srv.submit("cpu", build, S.TenantSpec(credits=1024),
                           config=quiet_cfg(PORT, tmp_path))
        assert h_cpu.wait(WAIT_S) == "COMPLETED"
        assert srv.evict("card").state == "FAILED"
    finally:
        close_server(srv)


def test_dashboard_open_close_back_to_back_raises_in_no_thread():
    """A ``DashboardServer`` stopped right after (or before) its thread
    starts: the accept loop ends quietly on the closed socket."""
    dmod = mod(PORT, "monitoring.dashboard")
    seen = []
    old = threading.excepthook
    threading.excepthook = lambda args: seen.append(args.exc_value)
    try:
        for _ in range(20):
            dash = dmod.DashboardServer(port=0)
            dash.start()
            dash.stop()
            assert not dash.is_alive()
        # the close lands before the thread's first line
        dash = dmod.DashboardServer(port=0)
        dash.stop()
        dash.start()
        dash.join(5.0)
        assert not dash.is_alive()
    finally:
        threading.excepthook = old
    assert not seen, seen
