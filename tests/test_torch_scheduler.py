"""The port's global scheduler (windflow_tpu_torch/scheduler/) and the
planner's device leases held against the reference's: one twin of each
case of tests/test_scheduler.py.

Each twin runs the reference test's scenario through ``windflow_tpu``
and through ``windflow_tpu_torch`` (graphs on the CPU,
``RuntimeConfig(device="cpu")``) with the same inputs, meets the
reference test's assertions in both, and holds what both decided equal:
placements, fair-share grants, lease rows and blocks, arbitration plans,
merged stats, OpenMetrics families, the doctor's goldens, window results
(keys and ids exactly, f32 values within rtol 1e-5).  The one field that
differs by design is the lease's chip: the reference's registry leases
``"tpu:0"``, the port's the device the lane is bound to (``"cpu"``
here), or the CUDA card ``"cuda:0"`` for a lease taken without one;
twins either pass ``chip=`` the same to both or check the port's name
and compare the rest.  The contended-chip run is load-sensitive in the
reference (ROADMAP.md C3): its twin holds both packages to the same
decisions and windows, never to a timing, and every wait has a deadline.

The fleet twins spawn real worker processes: the reference's load their
builds from tests/test_scheduler.py, the port's from
tests/torch_sched_builds.py, which imports only the port.  Every
``Server`` and ``FleetServer`` is closed in a ``finally``.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

import torch_sched_builds as port_builds
from torch_graphs import (PACKAGES, PORT, burn_10ms, burner_source,
                          close_server, cpu_config, mod, open_server,
                          quiet_cfg, record_source,
                          recovered_after_a_decision, wait_for)

REF = PACKAGES[0]
WAIT_S = 120
N_KEYS = 8
WIN, SLIDE = 64, 32
RTOL_F32 = 1e-5


def _both(scenario, *args):
    """``scenario(pkg, *args)`` in both packages; the results equal."""
    want = scenario(REF, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


def sched(pkg):
    return mod(pkg, "scheduler")


def serving(pkg):
    return mod(pkg, "serving")








def unchipped(rows):
    """Lease rows (or a block, or a grant) without the chip's name."""
    if isinstance(rows, list):
        return [unchipped(r) for r in rows]
    if isinstance(rows, dict):
        return {k: unchipped(v) for k, v in rows.items()
                if k not in ("Chip", "chip")}
    return rows


def hold_windows(got: dict, want: dict) -> None:
    """(key, id) -> value maps: the same windows, values within rtol."""
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose([got[k] for k in sorted(want)],
                               [want[k] for k in sorted(want)],
                               rtol=RTOL_F32)


# ---------------------------------------------------------------------------
# helpers (the reference test's, per package)
# ---------------------------------------------------------------------------

def batch_source(pkg, n, sb=2048, pace_s=0.0, stop_evt=None, vmod=97):
    TupleBatch = mod(pkg, "core.tuples").TupleBatch
    state = {"i": 0}

    def fn(ctx):
        if stop_evt is not None and stop_evt.is_set():
            return None
        i = state["i"]
        if n is not None and i >= n:
            return None
        if pace_s:
            time.sleep(pace_s)
        m = sb if n is None else min(sb, n - i)
        idx = np.arange(i, i + m)
        ids = idx // N_KEYS
        state["i"] = i + m
        return TupleBatch({"key": idx % N_KEYS, "id": ids, "ts": ids,
                           "value": (idx % vmod).astype(np.float64)})

    return fn


def window_sink():
    """(rows, sink): every window received, duplicates kept."""
    rows = []
    lock = threading.Lock()

    def sink(item):
        if item is None:
            return
        with lock:
            for j in range(len(item)):
                rows.append((int(item.key[j]), int(item.id[j]),
                             float(item["value"][j])))

    return rows, sink


def as_dict(rows):
    out = {(k, i): v for k, i, v in rows}
    assert len(out) == len(rows), "a window arrived twice"
    return out




def device_window_pipe(pkg, g, n, sink, pace_s=0.0, stop_evt=None):
    """One device-pinned window lane (the card's lease holder)."""
    wf = __import__(pkg)
    WinSeqTPU = mod(pkg, "operators.tpu.win_seq_tpu").WinSeqTPU
    op = WinSeqTPU("sum", WIN, SLIDE, wf.WinType.TB, batch_len=128,
                   emit_batches=True, placement="device")
    g.add_source(mod(pkg, "operators.batch_ops").BatchSource(
        batch_source(pkg, n, pace_s=pace_s, stop_evt=stop_evt))) \
        .add(op).add_sink(mod(pkg, "operators.basic_ops").Sink(sink))






# ---------------------------------------------------------------------------
# placement policy (pure)
# ---------------------------------------------------------------------------

def _caps(pkg, n=2, credits=1000, lanes=1):
    return [sched(pkg).WorkerCaps(w, credits, lanes) for w in range(n)]


def _spreads_by_load(pkg):
    S = sched(pkg)
    out = S.plan_placement([S.PlacementRequest(f"t{i}", credits=250)
                            for i in range(4)], _caps(pkg))
    by_worker = {}
    for name, wid in out.items():
        by_worker.setdefault(wid, []).append(name)
    assert set(by_worker) == {0, 1}
    assert all(len(v) == 2 for v in by_worker.values()), out
    return out


def _priority_first(pkg):
    S = sched(pkg)
    caps = _caps(pkg, 2, credits=100)
    reqs = [S.PlacementRequest("low-a", credits=80, priority=0),
            S.PlacementRequest("low-b", credits=80, priority=0),
            S.PlacementRequest("vip", credits=80, priority=9)]
    with pytest.raises(S.SchedulerError) as ei:
        S.plan_placement(reqs, caps)
    err = ei.value
    assert err.tenant in ("low-a", "low-b")
    assert "no worker can host tenant" in str(err) and err.hint
    out = S.plan_placement(reqs[1:], caps)
    assert set(out) == {"low-b", "vip"} and out["low-b"] != out["vip"]
    return str(err), err.tenant, err.hint, out


def _existing_and_dead(pkg):
    S = sched(pkg)
    caps = _caps(pkg, 2, credits=1000)
    placed = [S.Placement("old", worker=0, credits=900)]
    out = [S.plan_placement([S.PlacementRequest("new", credits=500)],
                            caps, placed=placed)]
    with pytest.raises(S.SchedulerError) as e1:
        S.plan_placement([S.PlacementRequest("new", credits=500)], caps,
                         placed=placed, live={0: True, 1: False})
    out.append(S.plan_placement([S.PlacementRequest("new", credits=50)],
                                caps, placed=placed,
                                live={0: True, 1: False}))
    with pytest.raises(S.SchedulerError, match="no live workers") as e2:
        S.plan_placement([S.PlacementRequest("new", credits=1)], caps,
                         live={0: False, 1: False})
    assert out == [{"new": 1}, {"new": 0}]
    return out, str(e1.value), str(e2.value)


def _spreads_devices(pkg):
    S = sched(pkg)
    caps = _caps(pkg, 2, credits=1000, lanes=1)
    out = S.plan_placement([S.PlacementRequest("d1", credits=100, devices=1),
                            S.PlacementRequest("d2", credits=100, devices=1)],
                           caps)
    assert out["d1"] != out["d2"]
    placed = [S.Placement("d1", out["d1"], 100, devices=1),
              S.Placement("d2", out["d2"], 100, devices=1)]
    out3 = S.plan_placement([S.PlacementRequest("d3", credits=100,
                                                devices=1)],
                            caps, placed=placed)
    assert out3["d3"] in (0, 1)
    req = S.request_for("d4", serving(pkg).TenantSpec(
        credits=300, devices=2, priority=4, weight=0.5))
    import dataclasses
    return out, out3, dataclasses.asdict(req)


POLICY_CASES = {
    "test_plan_placement_spreads_by_normalized_load": _spreads_by_load,
    "test_plan_placement_priority_first_then_reservation": _priority_first,
    "test_plan_placement_respects_existing_and_dead_workers":
        _existing_and_dead,
    "test_plan_placement_spreads_device_demand": _spreads_devices,
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_placement_policy_twins(case):
    """The reference's pure placement cases: the same placements and
    refusals in both packages."""
    _both(POLICY_CASES[case])


# ---------------------------------------------------------------------------
# fair-share executor leases
# ---------------------------------------------------------------------------

def _solo(pkg):
    reg = sched(pkg).FairShareRegistry(burst=64)
    ls = reg.lease("only", weight=1.0)
    waits = [ls.acquire(1000) for _ in range(50)]
    assert waits == [0.0] * 50 and ls.wait_s == 0.0
    blk = reg.block()
    assert blk["Sched_wait_s"] == 0.0
    assert blk["Leases"][0]["Consumed"] == 50_000
    return blk


def _converges(pkg):
    reg = sched(pkg).FairShareRegistry(burst=256)
    heavy = reg.lease("heavy", weight=2.0)
    light = reg.lease("light", weight=1.0)
    stop = threading.Event()

    def spin(ls):
        while not stop.is_set():
            ls.acquire(64)

    threads = [threading.Thread(target=spin, args=(ls,))
               for ls in (heavy, light)]
    for t in threads:
        t.start()
    time.sleep(0.8)
    stop.set()
    heavy.poison()
    light.poison()
    for t in threads:
        t.join(10.0)
        assert not t.is_alive()
    ratio = heavy.consumed / max(1, light.consumed)
    assert 1.4 <= ratio <= 2.8, \
        f"weighted share diverged: {heavy.consumed}/{light.consumed}"
    blk = reg.block()
    assert blk["Sched_wait_s"] > 0.0, "contention never gated anyone"
    return sorted(r["Tenant"] for r in blk["Leases"]), blk["Burst"]


def _ages_out(pkg):
    reg = sched(pkg).FairShareRegistry(burst=64, active_window_s=0.2)
    a = reg.lease("a")
    b = reg.lease("b")
    b.acquire(10)
    t0 = time.monotonic()
    waited = a.acquire(10_000)
    took = time.monotonic() - t0
    assert waited > 0.0 and took < 5.0
    return a.consumed, b.consumed


def _release_unblocks(pkg):
    reg = sched(pkg).FairShareRegistry(burst=64)
    a = reg.lease("a")
    b = reg.lease("b")
    b.acquire(10)
    done = threading.Event()
    t = threading.Thread(target=lambda: (a.acquire(100_000), done.set()))
    t.start()
    time.sleep(0.1)
    engaged = not done.is_set()
    reg.release("b")
    woke = done.wait(5.0)
    t.join(5.0)
    assert (engaged, woke) == (True, True)
    assert a.wait_s > 0.0
    return engaged, woke, a.consumed, [r["Tenant"]
                                       for r in reg.block()["Leases"]]


def _late_joiner(pkg):
    reg = sched(pkg).FairShareRegistry(burst=64)
    a = reg.lease("a")
    a.acquire(9000)
    late = reg.lease("late", weight=2.0)
    assert late.consumed == 18_000
    assert a.acquire(64) < 1.0
    return late.consumed, a.consumed, late.block()


FAIR_CASES = {
    "test_fair_share_solo_never_waits": _solo,
    "test_fair_share_weighted_contention_converges": _converges,
    "test_fair_share_idle_lease_ages_out_of_floor": _ages_out,
    "test_fair_share_release_and_poison_unblock_waiters": _release_unblocks,
    "test_fair_share_late_joiner_seeded_at_floor": _late_joiner,
}


@pytest.mark.parametrize("case", sorted(FAIR_CASES))
def test_fair_share_twins(case):
    """The reference's fair-share cases: the same grants and books in
    both packages (waits are timed, so only their sign is held)."""
    _both(FAIR_CASES[case])


# ---------------------------------------------------------------------------
# device-lane leases
# ---------------------------------------------------------------------------

def _device_leases(pkg):
    reg = sched(pkg).DeviceLeaseRegistry(lanes=1, chip="cuda:0")
    g1 = reg.acquire("alpha", "pipe0/win", priority=2)
    assert g1 == {"chip": "cuda:0", "holders": 1, "contended": False}
    g2 = reg.acquire("beta", "pipe1/win", resident=True)
    assert g2["contended"] and g2["holders"] == 2
    assert reg.contended() and reg.holders() == 2
    rows = reg.rows()
    assert all(r["Contended"] for r in rows)
    assert {r["Tenant"]: r["Resident"] for r in rows} \
        == {"alpha": False, "beta": True}
    assert [r["Operator"] for r in reg.tenant_rows("alpha")] \
        == ["pipe0/win"]
    blk = reg.block()
    assert blk["Chip"] == "cuda:0" and blk["Lanes"] == 1
    assert blk["Holders"] == 2 and blk["Contended"]
    released = [reg.release("alpha", "no/such"),
                reg.release("alpha", "pipe0/win"), reg.contended()]
    reg.acquire("beta", "pipe2/win")
    released += [reg.release("beta"), reg.holders()]
    assert released == [0, 1, False, 2, 0]
    return g1, g2, rows, blk, released


def test_device_leases_grant_and_record_contention():
    _both(_device_leases)
    # the port's registry leases the CUDA card by default, and a lease
    # on another device names that device in its grant and its row
    reg = sched(PORT).DeviceLeaseRegistry()
    assert reg.chip == "cuda:0" and reg.block()["Chip"] == "cuda:0"
    assert reg.acquire("t", "op", chip="cuda:1")["chip"] == "cuda:1"
    assert [r["Chip"] for r in reg.rows()] == ["cuda:1"]


# ---------------------------------------------------------------------------
# arbiter device rung (pure planner)
# ---------------------------------------------------------------------------

def _lease_row(tenant, op, contended=True, resident=False):
    return {"Tenant": tenant, "Operator": op, "Chip": "cuda:0",
            "Contended": contended, "Resident": resident}


def _victim_view(pkg, **kw):
    kw.setdefault("name", "vic")
    kw.setdefault("priority", 5)
    kw.setdefault("breached", True)
    kw.setdefault("violating", ("throughput",))
    kw.setdefault("device_ops", [_lease_row("vic", "v/win")])
    return serving(pkg).TenantView(**kw)


def _donor_view(pkg, **kw):
    kw.setdefault("name", "noisy")
    kw.setdefault("priority", 0)
    kw.setdefault("breached", False)
    kw.setdefault("credits", 4096)
    kw.setdefault("device_ops", [_lease_row("noisy", "n/win")])
    return serving(pkg).TenantView(**kw)


def _demotes(pkg):
    S = serving(pkg)
    d = S.plan_arbitration([_victim_view(pkg), _donor_view(pkg)],
                           S.ArbiterConfig(breach_ticks=2),
                           breach_runs={"vic": 2}, cooldowns={}, now=0.0)
    assert d is not None and d["victim"] == "vic"
    assert d["actions"] == [{"type": "device", "operator": "n/win",
                             "chip": "cuda:0", "to": "host"}]
    assert d["evidence"]["chip"] == "cuda:0"
    assert d["evidence"]["contended"] is True
    return d


def _skips(pkg):
    S = serving(pkg)
    cfg = S.ArbiterConfig(breach_ticks=2)
    donor = _donor_view(pkg, device_ops=[
        _lease_row("noisy", "n/win", resident=True)])
    d1 = S.plan_arbitration([_victim_view(pkg), donor], cfg,
                            breach_runs={"vic": 2}, cooldowns={}, now=0.0)
    assert d1 is not None
    assert all(a["type"] != "device" for a in d1["actions"])
    vic = _victim_view(pkg, device_ops=[
        _lease_row("vic", "v/win", contended=False)])
    d2 = S.plan_arbitration([vic, _donor_view(pkg)], cfg,
                            breach_runs={"vic": 2}, cooldowns={}, now=0.0)
    assert d2 is not None
    assert all(a["type"] != "device" for a in d2["actions"])
    d3 = S.plan_arbitration([_victim_view(pkg, priority=0),
                             _donor_view(pkg, priority=5)], cfg,
                            breach_runs={"vic": 2}, cooldowns={}, now=0.0)
    assert d3 is None
    return d1, d2, d3


@pytest.mark.parametrize("case", [
    "test_arbiter_device_rung_demotes_contended_neighbor",
    "test_arbiter_device_rung_skips_resident_and_uncontended"])
def test_arbiter_device_rung_twins(case):
    _both(_demotes if "demotes" in case else _skips)


# ---------------------------------------------------------------------------
# planner integration: device lanes acquire worker leases
# ---------------------------------------------------------------------------

def _planner_lease(pkg):
    wf = __import__(pkg)
    reg = sched(pkg).DeviceLeaseRegistry(lanes=1)
    reg.acquire("hog", "other/win")
    rows, sink = window_sink()
    g = wf.PipeGraph("lease_probe", wf.Mode.DEFAULT, cpu_config(pkg))
    g.device_leases = reg
    g.tenant_name = "t1"
    g.tenant_priority = 3
    device_window_pipe(pkg, g, 4096, sink)
    g.run()
    t1 = reg.tenant_rows("t1")
    assert len(t1) == 1 and t1[0]["Priority"] == 3
    assert t1[0]["Resident"] is False and t1[0]["Contended"] is True
    leased = [p for p in g.placements if p.get("lease")]
    assert leased and leased[0]["lease"]["contended"]
    assert rows, "window results lost through the leased lane"
    chips = {r["Tenant"]: r["Chip"] for r in reg.rows()}
    placements = [{k: v for k, v in p.items() if k != "device"}
                  for p in g.placements]
    return unchipped(reg.rows()), unchipped(placements), as_dict(rows), \
        chips


def test_planner_acquires_device_lease():
    ref_rows, ref_pl, ref_win, ref_chips = _planner_lease(REF)
    rows, pl, win, chips = _planner_lease(PORT)
    assert (rows, pl) == (ref_rows, ref_pl)
    hold_windows(win, ref_win)
    # the reference leases its one chip; the port records the lane's
    # bound device ("cpu" here) and the registry's card for a lease
    # taken without one
    assert ref_chips == {"hog": "tpu:0", "t1": "tpu:0"}
    assert chips == {"hog": "cuda:0", "t1": "cpu"}


def test_planner_leases_only_device_lanes_and_marks_resident():
    """Port-only rows of the hook: a lane resolved to the host holds
    no lease, a resident FFAT lane's lease is marked resident, and the
    grant rides the placement entry, on the lane's device."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.operators.basic_ops import Sink
    from windflow_tpu_torch.operators.batch_ops import BatchSource
    from windflow_tpu_torch.operators.tpu.win_seq_tpu import WinSeqTPU
    reg = sched(PORT).DeviceLeaseRegistry(lanes=2)
    g = wf.PipeGraph("lease_mix", wf.Mode.DEFAULT, cpu_config(PORT))
    g.device_leases, g.tenant_name, g.tenant_priority = reg, "mix", 1
    for placement in ("host", "device"):
        g.add_source(BatchSource(batch_source(PORT, 4096))) \
            .add(WinSeqTPU("sum", WIN, SLIDE, wf.WinType.TB,
                           batch_len=128, emit_batches=True,
                           placement=placement)) \
            .add_sink(Sink(lambda item: None))
    g.add_source(BatchSource(batch_source(PORT, 4096))) \
        .add(wf.WinSeqFFATResident(lambda t: t.value, __import__(
            "torch").add, 0.0, WIN, SLIDE, device="cpu")) \
        .add_sink(Sink(lambda item: None))
    g.run()
    by_op = {p["operator"]: p for p in g.placements}
    rows = {r["Operator"]: r for r in reg.rows()}
    host_ops = [op for op, p in by_op.items() if p["placement"] == "host"]
    assert host_ops and not any("lease" in by_op[op] for op in host_ops)
    assert set(rows) == {op for op, p in by_op.items()
                         if p["placement"] == "device"}
    assert len(rows) == 2
    resident = [op for op, p in by_op.items() if p.get("reason", "")
                .startswith("resident ffat")]
    assert len(resident) == 1 and rows[resident[0]]["Resident"] is True
    for op, r in rows.items():
        assert r["Chip"] == "cpu" and r["Priority"] == 1
        assert by_op[op]["lease"] == {"chip": "cpu",
                                      "holders": by_op[op]["lease"]
                                      ["holders"], "contended": False}
        assert by_op[op]["device"] == "cpu"


# ---------------------------------------------------------------------------
# chaos: contended chip, arbiter demotes the low-priority neighbour
# ---------------------------------------------------------------------------





N_CHAOS = 40_000


def gap_free(rows) -> bool:
    """Every key's window ids 0..max, each once."""
    ids = {}
    for k, i, _v in rows:
        ids.setdefault(k, []).append(i)
    return all(sorted(v) == list(range(len(v))) for v in ids.values())


def _contended(pkg, tmp_path):
    wf = __import__(pkg)
    S = serving(pkg)
    ref_rows, ref_sink = window_sink()
    gs = wf.PipeGraph("chaos_solo", wf.Mode.DEFAULT, cpu_config(pkg))
    device_window_pipe(pkg, gs, N_CHAOS, ref_sink)
    gs.run()
    solo = as_dict(ref_rows)
    assert solo

    stop = threading.Event()
    vrows, vsink = window_sink()
    nrows, nsink = window_sink()
    srv = open_server(pkg, devices=1, arbiter=S.ArbiterConfig(
        interval_s=0.25, breach_ticks=2, cooldown_s=1.0,
        clear_ticks=10 ** 6))
    try:
        def build_victim(g):
            g.add_source(wf.SourceBuilder(
                record_source(pkg, 10 ** 6, pace_s=0.001)).build()) \
                .add(wf.MapBuilder(lambda t: None)
                     .with_name("vmap").build()) \
                .add_sink(wf.SinkBuilder(lambda r: None).build())
            device_window_pipe(pkg, g, N_CHAOS, vsink)

        def build_noisy(g):
            g.add_source(wf.SourceBuilder(burner_source(pkg, stop))
                         .build()) \
                .add(wf.MapBuilder(burn_10ms).with_name("burn")
                     .with_key_by().with_parallelism(4)
                     .with_elasticity(1, 4).build()) \
                .add_sink(wf.SinkBuilder(lambda r: None).build())
            device_window_pipe(pkg, g, None, nsink, pace_s=0.005,
                               stop_evt=stop)

        hv = srv.submit(
            "vic", build_victim,
            S.TenantSpec(credits=1024, priority=5,
                         slo=dict(min_throughput_rps=60.0, target=0.9,
                                  fast_window_s=3.0, slow_window_s=30.0,
                                  warmup_ticks=1, fast_burn=2.0)),
            config=quiet_cfg(pkg, tmp_path, diagnosis_interval_s=0.2,
                             audit_interval_s=0.1))
        hn = srv.submit("noisy", build_noisy,
                        S.TenantSpec(credits=4096, priority=0),
                        config=quiet_cfg(pkg, tmp_path, queue_capacity=32))
        assert srv.devices.contended(), \
            "two device lanes on one chip must contend"
        leases = unchipped(srv.devices.rows())
        lease_chips = {r["Chip"] for r in srv.devices.rows()}
        wait_for(lambda: hv.graph.diagnosis.slo is not None
                 and hv.graph.diagnosis.slo.breached,
                 "the victim breached under contention")
        wait_for(lambda: recovered_after_a_decision(srv, hv),
                 "the victim's SLO recovered after an arbitration")
        decisions = list(srv.arbiter.decisions)
        assert decisions, "arbiter never actuated"
        dev_acts = [a for d in decisions for a in d["actions"]
                    if a["type"] == "device"]
        assert dev_acts and dev_acts[0].get("applied")
        assert dev_acts[0]["to"] == "host"
        first = decisions[0]
        assert any(a["type"] == "device" for a in first["actions"])
        assert (first["donor"], first["victim"]) == ("noisy", "vic")
        assert first["evidence"]["contended"] is True
        repl = [e for e in hn.graph.flight.snapshot()
                if e["kind"] == "replacement"]
        assert any("arbiter:device->host for vic"
                   in (e.get("trigger") or "") for e in repl), repl
        assert not srv.devices.tenant_rows("noisy")
        assert not srv.devices.contended()
        assert srv.devices.tenant_rows("vic"), "the victim keeps its lane"
        for h in (hv, hn):
            evs = [e for e in h.graph.flight.snapshot()
                   if e["kind"] == "arbitration"]
            assert any("demoted" in (e.get("action") or "")
                       for e in evs), evs
        wait_for(lambda: len(vrows) >= len(solo),
                 "the victim's windows arrived")
        blk = srv.scheduler_block()
        assert blk["Devices"]["Holders"] == 1
        assert blk["Devices"]["Contended"] is False
        chip = blk["Devices"]["Chip"]
    finally:
        stop.set()
        close_server(srv)
    victim = as_dict(vrows)
    assert victim == solo, \
        (f"victim results diverged under contention: {len(victim)} vs "
         f"{len(solo)} windows")
    # the neighbour's windows across the flip: one gap-free sequence per
    # key, none twice
    assert nrows and gap_free(nrows)
    dev = first["actions"][0]
    return {"decision": (first["victim"], first["donor"],
                         [a["type"] for a in first["actions"]],
                         dev["operator"], dev["to"],
                         sorted(first["evidence"])),
            "leases": leases,
            "replacement": sorted({(e["operator"], e["old"], e["new"],
                                    e["trigger"]) for e in repl}),
            "chip": chip, "lease_chips": lease_chips, "victim": victim}


def test_contended_chip_arbiter_demotes_neighbor_slo_recovers(tmp_path):
    want = _contended(REF, tmp_path)
    got = _contended(PORT, tmp_path)
    for key in ("decision", "leases", "replacement"):
        assert got[key] == want[key], key
    assert (want["chip"], got["chip"]) == ("tpu:0", "cuda:0")
    # the port's rows name the device each lane is bound to
    assert (want["lease_chips"], got["lease_chips"]) == ({"tpu:0"}, {"cpu"})
    hold_windows(got["victim"], want["victim"])


# ---------------------------------------------------------------------------
# FleetServer: placement, crash isolation, structured rejection
# ---------------------------------------------------------------------------

def _fleet_refs(pkg):
    if pkg == PORT:
        return port_builds.fleet_build, port_builds.fleet_cfg
    import test_scheduler
    return test_scheduler.fleet_build, test_scheduler.fleet_cfg


def _fleet_8(pkg):
    S = sched(pkg)
    TenantSpec = serving(pkg).TenantSpec
    build, cfg = _fleet_refs(pkg)
    names = [f"t{i}" for i in range(8)]
    fleet = S.FleetServer(workers=2, capacity=100_000,
                          push_interval_s=0.2)
    try:
        for name in names:
            row = fleet.submit(name, build, TenantSpec(credits=8000),
                               config_fn=cfg)
            assert row["State"] == "PLACED"
        st = fleet.stats()
        by_worker = {}
        for row in st["Placements"]:
            by_worker.setdefault(row["Worker"], []).append(row["Tenant"])
        assert set(by_worker) == {0, 1}, by_worker
        assert all(len(v) == 4 for v in by_worker.values()), by_worker
        assert len([e for e in st["Flight"]
                    if e["kind"] == "sched_place"]) == 8
        with pytest.raises(S.SchedulerError) as ei:
            fleet.submit("whale", build, TenantSpec(credits=90_000),
                         config_fn=cfg)
        assert ei.value.tenant == "whale" and ei.value.hint
        rej = [e for e in fleet.flight.snapshot()
               if e["kind"] == "sched_rejected"]
        assert rej and rej[-1]["tenant"] == "whale"
        victims, survivors = sorted(by_worker[0]), sorted(by_worker[1])
        time.sleep(1.0)
        fleet.kill_worker(0)
        for name in names:
            row = fleet.wait(name, timeout=WAIT_S)
            assert row["State"] == "COMPLETED", (name, row)
            cons = row.get("Conservation")
            if cons:
                assert cons["Edges_balanced"], (name, cons)
        st = fleet.stats()
        rows = {r["Tenant"]: r for r in st["Placements"]}
        for name in victims:
            assert (rows[name]["Worker"], rows[name]["Attempts"]) == (1, 2)
        for name in survivors:
            assert (rows[name]["Worker"], rows[name]["Attempts"]) == (1, 1)
        deaths = [e for e in st["Flight"] if e["kind"] == "worker_death"]
        assert len(deaths) == 1 and deaths[0]["worker"] == 0
        assert sorted(deaths[0]["tenants"]) == victims
        replaced = [e for e in st["Flight"] if e["kind"] == "sched_replace"]
        assert sorted(e["tenant"] for e in replaced) == victims
        assert all(e["from_worker"] == 0 and e["worker"] == 1
                   for e in replaced)
        merged = {}

        def sched_folded():
            merged.update(fleet.cluster() or {})
            return bool(merged.get("Scheduler"))

        wait_for(sched_folded, "worker Scheduler blocks reached the "
                 "observer", timeout=15)
        blk = merged["Scheduler"]
        assert any(b.get("Fair_share") for b in blk["Workers"])
        assert {p["Tenant"] for p in blk["Placements"]} <= set(names)
    finally:
        fleet.close()
    return (by_worker, victims,
            sorted((r["Tenant"], r["Worker"], r["Attempts"], r["State"])
                   for r in st["Placements"]),
            sorted(e["kind"] for e in st["Flight"]), str(ei.value))


def test_fleet_places_8_tenants_and_survives_worker_death():
    _both(_fleet_8)


def _fleet_solo(pkg, tmp_path):
    wf = __import__(pkg)
    S = serving(pkg)

    def build(g):  # the reference's fleet_build, over 400 records
        g.add_source(wf.SourceBuilder(
            record_source(pkg, 400, pace_s=0.003)).build()) \
            .add(wf.MapBuilder(lambda t: None).with_name("m").build()) \
            .add_sink(wf.SinkBuilder(lambda r: None).build())

    srv = open_server(pkg, arbiter=False, fair_share=True, worker_id=0)
    try:
        h = srv.submit("solo", build, S.TenantSpec(credits=8000),
                       config=quiet_cfg(pkg, tmp_path))
        state = h.wait(WAIT_S)
        blk = srv.scheduler_block()
    finally:
        close_server(srv)
    assert state == "COMPLETED"
    assert blk["Fair_share"] is True and blk["Sched_wait_s"] == 0.0, blk
    return state, {k: v for k, v in blk.items() if k != "Leases"}, \
        [{k: r[k] for k in ("Tenant", "Weight", "Sched_wait_s")}
         for r in blk["Leases"]]


def test_fleet_single_tenant_completes_unthrottled(tmp_path):
    _both(_fleet_solo, tmp_path)


def test_fleet_device_tenants_spread_and_a_card_request_fails(tmp_path):
    """Port-only: two ``TenantSpec(devices=1)`` window lanes go to
    different workers, each worker's windows equal the reference
    scheduler tests' closed form and its exit probe shows its engine,
    no ``jax``, no kernel launch and no CUDA context (the lanes run on
    the CPU here); a tenant whose config asks for the CUDA card where
    there is none ends FAILED, its row carrying the error and the tail
    of its worker's log -- it never runs on the CPU."""
    import torch
    S = sched(PORT)
    TenantSpec = serving(PORT).TenantSpec
    out_dir, probe_dir = tmp_path / "out", tmp_path / "probe"
    out_dir.mkdir()
    probe_dir.mkdir()
    env = {"WFT_SCHED_N": "8192", "WFT_SCHED_OUT": str(out_dir),
           "WFT_DEVICE": "cpu", "WFT_PROBE_DIR": str(probe_dir)}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        fleet = S.FleetServer(workers=2, capacity=100_000,
                              push_interval_s=0.2)
        try:
            placed = {name: fleet.submit(
                name, port_builds.device_build,
                TenantSpec(credits=4096, devices=1),
                config_fn=port_builds.device_cfg)["Worker"]
                for name in ("dev-a", "dev-b")}
            assert sorted(placed.values()) == [0, 1], placed
            rows = {name: fleet.wait(name, timeout=WAIT_S)
                    for name in placed}
            if not torch.cuda.is_available():
                fleet.submit("card", port_builds.device_build,
                             TenantSpec(credits=4096),
                             config_fn=port_builds.cuda_cfg)
                bad = fleet.wait("card", timeout=WAIT_S)
                assert bad["State"] == "FAILED", bad
                assert "no CUDA device" in bad["Error"]
                assert "no CUDA device" in bad["Log_tail"]
                assert "failed to start" in bad["Log_tail"]
        finally:
            fleet.close()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    want_rows, want_sink = port_builds.window_rows_sink()
    ref_rows, ref_sink = window_sink()
    gs = __import__(REF).PipeGraph("solo", __import__(REF).Mode.DEFAULT)
    device_window_pipe(REF, gs, 8192, ref_sink)
    gs.run()
    want = as_dict(ref_rows)
    for name, row in rows.items():
        assert row["State"] == "COMPLETED", row
        assert row["Conservation"]["Edges_balanced"]
        with open(out_dir / f"{name}.json") as f:
            got = {(k, i): v for k, i, v in json.load(f)}
        hold_windows(got, want)
    probes = port_builds.read_probes(str(probe_dir))
    # one probe a worker, each naming the one tenant placed there
    assert sorted(placed[e["tenant"]] for p in probes
                  for e in p["engines"]) == [0, 1], probes
    for probe in probes:
        assert not probe["jax"] and not probe["reference"]
        assert not probe["cuda"] and not any(probe["counts"].values())
        assert len(probe["engines"]) == 1
        assert all(e["device"] == "cpu" and e["batches"] > 0
                   for e in probe["engines"])


# ---------------------------------------------------------------------------
# distributed wiring: elastic graphs rejected with a structured error
# ---------------------------------------------------------------------------

def _dist_elastic(pkg, tmp_path):
    wf = __import__(pkg)
    runtime = mod(pkg, "distributed.runtime")
    p0, p1 = runtime.free_ports(2)
    cfg = quiet_cfg(pkg, tmp_path)
    cfg.distributed = runtime.DistributedSpec(
        0, 2, [("127.0.0.1", p0), ("127.0.0.1", p1)])
    g = wf.PipeGraph("dist_elastic", wf.Mode.DEFAULT, cfg)
    g.add_source(wf.SourceBuilder(record_source(pkg, 100)).build()) \
        .add(wf.MapBuilder(lambda t: None).with_name("m")
             .with_key_by().with_parallelism(2)
             .with_elasticity(1, 4).build()) \
        .add_sink(wf.SinkBuilder(lambda r: None).build())
    try:
        with pytest.raises(sched(pkg).SchedulerError) as ei:
            g.start()
    finally:
        try:
            g.cancel()
        except Exception:
            pass
    err = ei.value
    assert err.operators and "FleetServer" in err.hint
    evs = [e for e in g.flight.snapshot() if e["kind"] == "sched_rejected"]
    assert len(evs) == 1 and evs[0]["operators"] == err.operators
    assert evs[0]["path"] == "scheduler.FleetServer"
    return str(err), err.operators, err.hint, \
        {k: v for k, v in evs[0].items() if k not in ("t", "seq")}


def test_distributed_elastic_rejected_with_sched_event(tmp_path):
    _both(_dist_elastic, tmp_path)


# ---------------------------------------------------------------------------
# observability: merged stats, /metrics families, doctor
# ---------------------------------------------------------------------------

def _worker_stats(wid, wait_s, tenants):
    return {
        "Worker": wid,
        "PipeGraph_name": "fleet",
        "Scheduler": {
            "Worker": wid, "Capacity": 1 << 20,
            "Granted": sum(c for _, c in tenants),
            "Fair_share": True,
            "Placements": [{"Tenant": t, "Worker": wid,
                            "State": "RUNNING", "Credits": c,
                            "Priority": 0, "Weight": 1.0,
                            "Devices": 0} for t, c in tenants],
            "Sched_wait_s": wait_s,
        },
    }


def _merge(pkg):
    merge_stats = mod(pkg, "distributed.observe").merge_stats
    merged = merge_stats([
        _worker_stats(0, 0.25, [("alpha", 1024), ("beta", 2048)]),
        _worker_stats(1, 0.5, [("gamma", 4096)]),
    ])
    blk = merged["Scheduler"]
    assert [b["Worker"] for b in blk["Workers"]] == [0, 1]
    assert blk["Sched_wait_s"] == 0.75
    assert [(p["Tenant"], p["Worker"]) for p in blk["Placements"]] \
        == [("alpha", 0), ("beta", 0), ("gamma", 1)]
    bare = merge_stats([{"Worker": 0, "PipeGraph_name": "g"}])
    assert bare["Scheduler"] is None
    return blk


def test_merge_stats_folds_scheduler_blocks():
    _both(_merge)


def _openmetrics(pkg):
    render = mod(pkg, "telemetry.metrics").render_openmetrics
    apps = {1: {"active": True, "report": {
        "PipeGraph_name": "fleet",
        "Operators": [
            {"Operator_name": "pipe0/m", "Parallelism": 2,
             "Replicas": [{"Sched_wait_s": 0.2}, {"Sched_wait_s": 0.11}]},
            {"Operator_name": "pipe0/sink", "Parallelism": 1,
             "Replicas": [{"Outputs_sent": 5}]},
        ],
        "Scheduler": {
            "Worker": 0,
            "Placements": [{"Tenant": "alpha", "Worker": 0,
                            "State": "RUNNING"},
                           {"Tenant": "beta", "Worker": 0,
                            "State": "RUNNING"}],
            "Devices": {"Chip": "cuda:0", "Lanes": 1, "Holders": 2,
                        "Contended": True,
                        "Leases": [{"Tenant": "alpha",
                                    "Operator": "pipe0/w"},
                                   {"Tenant": "alpha",
                                    "Operator": "pipe1/w"},
                                   {"Tenant": "beta",
                                    "Operator": "pipe2/w"}]},
        },
    }}}
    text = render(apps)
    for line in (
            'windflow_sched_wait_seconds_total{app="1",graph="fleet",'
            'operator="pipe0/m"} 0.31',
            'windflow_tenant_worker{app="1",graph="fleet",'
            'tenant="alpha",worker="0"} 1',
            'windflow_tenant_worker{app="1",graph="fleet",'
            'tenant="beta",worker="0"} 1',
            'windflow_device_lease{app="1",graph="fleet",'
            'tenant="alpha"} 2',
            'windflow_device_lease{app="1",graph="fleet",'
            'tenant="beta"} 1'):
        assert line in text
    assert ('windflow_sched_wait_seconds_total{app="1",graph="fleet",'
            'operator="pipe0/sink"}') not in text
    bare = render({1: {"active": True, "report": {
        "PipeGraph_name": "g",
        "Operators": [{"Operator_name": "pipe0/m",
                       "Replicas": [{"Inputs_received": 1}]}]}}})
    for fam in ("windflow_sched_wait_seconds_total{",
                "windflow_tenant_worker{", "windflow_device_lease{"):
        assert fam not in bare
    try:
        from prometheus_client.openmetrics import parser
        list(parser.text_string_to_metric_families(text))
    except ImportError:
        pass
    fams = ("windflow_sched_wait", "windflow_tenant_worker",
            "windflow_device_lease")
    return [ln for ln in text.splitlines() if ln.startswith(fams)
            or any(f in ln for f in fams)]


def test_openmetrics_scheduler_families():
    _both(_openmetrics)


GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _golden_v11(pkg):
    import contextlib
    import io
    path = os.path.join(GOLDEN_DIR, "doctor_stats_v11.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod(pkg, "doctor").main([path, "--json"])
    assert rc == 0
    rep = json.loads(buf.getvalue())
    assert rep.pop("Source").endswith("doctor_stats_v11.json")
    with open(os.path.join(GOLDEN_DIR, "doctor_report_v11.json")) as f:
        assert rep == json.load(f)
    with open(path) as f:
        dump = json.load(f)
    assert dump["Schema_version"] == 11
    assert dump["Scheduler"]["Devices"]["Contended"] is True
    return rep


def test_doctor_golden_v11_scheduler():
    _both(_golden_v11)


def _doctor_surface(pkg):
    D = mod(pkg, "diagnosis")
    with open(os.path.join(GOLDEN_DIR, "doctor_stats_v11.json")) as f:
        stats = json.load(f)
    rep = D.build_report(stats)
    blk = rep["Scheduler"]
    assert blk["Worker"] == 0 and blk["Fair_share"] is True
    assert blk["Device_contended"] is True and blk["Device_holders"] == 2
    assert {e["kind"] for e in rep["Scheduler_events"]} \
        >= {"sched_place", "worker_death", "sched_replace",
            "sched_rejected"}
    assert "worker 1 DIED" in rep["Verdict"] and "REJECTED" in rep["Verdict"]
    txt = D.render_text(rep)
    for part in ("scheduler: worker=0", "CONTENDED", "worker_death",
                 "hint:"):
        assert part in txt
    return blk, rep["Scheduler_events"], rep["Verdict"], txt


def test_doctor_report_and_text_surface_scheduler():
    _both(_doctor_surface)
