"""The port's placement planner (windflow_tpu_torch/graph/planner.py)
held side by side with the reference's: twins of the CPU cases of
tests/test_planner.py.

The port's ``plan_graph`` differs from the reference's in its CUDA
round-trip probe, its bind of each device lane to
``RuntimeConfig.device`` and the ``ChainedLogic`` bind; its device
leases follow the bind.  Each twin takes both packages, the same graph
and the same pinned measured inputs (``WINDFLOW_RTT_FLOOR_MS``,
``WINDFLOW_HOST_RATE_TPS``, ``WINDFLOW_DEVICE_COMPUTE_MS``) and holds
every placement decision equal -- the port's entries carry one key more,
the lane's ``device`` -- and the lease rows equal except the chip's
name (the reference leases ``"tpu:0"``, the port the device the lane
is bound to, ``"cpu"`` here, and the CUDA card ``"cuda:0"`` for a lease
taken without a device).  Windows are held equal in keys and ids, f32
values within rtol 1e-5.
"""
import json
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_graphs import PACKAGES, PORT, cpu_config, mod

REF = PACKAGES[0]
N_KEYS = 8
WIN, SLIDE = 64, 32
N_EVENTS = 40_000
RTOL_F32 = 1e-5
ADD = {"windflow_tpu": jnp.add, "windflow_tpu_torch": torch.add}


def _both(scenario, *args):
    want = scenario(REF, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


def planner(pkg):
    return mod(pkg, "graph.planner")


def _dev(pkg):
    return {"device": "cpu"} if pkg == PORT else {}


# ---------------------------------------------------------------------------
# the cost model and the strategy table (pure)
# ---------------------------------------------------------------------------

def _deterministic(pkg):
    P = planner(pkg)
    inp = P.PlacementInputs(rtt_floor_ms=70.0, host_rate_tps=50e6,
                            tuples_per_launch=4096 * 2048,
                            bytes_per_launch=20_000,
                            device_compute_ms=0.5)
    d1, d2 = P.decide_placement(inp), P.decide_placement(inp)
    assert d1 == d2 and d1["placement"] in ("device", "host")
    return d1


def _monotone_rtt(pkg):
    P = planner(pkg)
    base = dict(host_rate_tps=50e6, tuples_per_launch=4096 * 2048,
                bytes_per_launch=20_000)
    fast = P.decide_placement(P.PlacementInputs(rtt_floor_ms=0.1, **base))
    slow = P.decide_placement(P.PlacementInputs(rtt_floor_ms=10_000.0,
                                                **base))
    assert (fast["placement"], slow["placement"]) == ("device", "host")
    return fast, slow


def _monotone_host_rate(pkg):
    P = planner(pkg)
    base = dict(rtt_floor_ms=10.0, tuples_per_launch=4096 * 64,
                bytes_per_launch=20_000)
    weak = P.decide_placement(P.PlacementInputs(host_rate_tps=1e3, **base))
    strong = P.decide_placement(P.PlacementInputs(host_rate_tps=1e12,
                                                  **base))
    assert (weak["placement"], strong["placement"]) == ("device", "host")
    return weak, strong


def _small_launches(pkg):
    P = planner(pkg)
    d = P.decide_placement(P.PlacementInputs(
        rtt_floor_ms=70.0, host_rate_tps=60e6,
        tuples_per_launch=256 * 16, bytes_per_launch=4_000))
    assert d["placement"] == "host"
    return d


def _launch_profile(pkg):
    wf = __import__(pkg)
    logic = mod(pkg, "operators.tpu.win_seq_tpu").WinSeqTPULogic
    a = logic("sum", 4096, 2048, wf.WinType.TB, batch_len=4096, **_dev(pkg))
    b = logic("sum", 4096, 2048, wf.WinType.TB, batch_len=64, **_dev(pkg))
    (ta, ba), (tb, bb) = (planner(pkg).launch_profile(x) for x in (a, b))
    assert ta == 4096 * 2048 and tb == 64 * 2048
    return (ta, ba), (tb, bb)


def _strategy_table(pkg):
    select = planner(pkg).select_strategy
    got = [select("sum", 4096, 2048, 64),
           select("count", 1 << 18, 1 << 17, 1000),
           select("max", 1024, 1, 1),
           select(lambda *a: 0.0, 100, 7, 64),
           select(lambda *a: 0.0, 1 << 17, 7, 1),
           select(lambda *a: 0.0, 100, 7, 1)]
    assert got == ["pane_farm", "pane_farm", "ffat", "key_farm",
                   "win_farm", "win_seq"]
    with pytest.raises(ValueError):
        select("sum", 0, 1)
    return got


def _window_operator(pkg):
    wf = __import__(pkg)
    farms = mod(pkg, "operators.tpu.farms_tpu")
    P = planner(pkg)
    op = P.plan_window_operator("sum", 4096, 2048, wf.WinType.TB,
                                key_cardinality=64)
    assert isinstance(op, farms.PaneFarmTPU)
    op2 = P.plan_window_operator(lambda *a: 0.0, 100, 7, wf.WinType.TB,
                                 key_cardinality=64, parallelism=3)
    assert isinstance(op2, farms.KeyFarmTPU) and op2.parallelism == 3
    return type(op).__name__, type(op2).__name__, op2.parallelism


COST_CASES = {
    "test_decision_deterministic": _deterministic,
    "test_decision_monotone_in_rtt": _monotone_rtt,
    "test_decision_monotone_in_host_rate": _monotone_host_rate,
    "test_small_launches_behind_long_rtt_go_host": _small_launches,
    "test_launch_profile_scales_with_params": _launch_profile,
    "test_strategy_table": _strategy_table,
    "test_plan_window_operator_builds_selected": _window_operator,
}


@pytest.mark.parametrize("case", sorted(COST_CASES))
def test_cost_model_twins(case):
    _both(COST_CASES[case])


# ---------------------------------------------------------------------------
# plan_graph: placements, leases, stats JSON and windows, side by side
# ---------------------------------------------------------------------------

def batch_source(pkg, n, sb=4096, vmod=97):
    TupleBatch = mod(pkg, "core.tuples").TupleBatch
    state = {"i": 0}

    def fn(ctx):
        i = state["i"]
        if i >= n:
            return None
        m = min(sb, n - i)
        idx = np.arange(i, i + m)
        ids = idx // N_KEYS
        state["i"] = i + m
        return TupleBatch({"key": idx % N_KEYS, "id": ids, "ts": ids,
                           "value": (idx % vmod).astype(np.float64)})

    return fn


def window_sink(pkg):
    TupleBatch = mod(pkg, "core.tuples").TupleBatch
    res = {}
    lock = threading.Lock()

    def sink(item):
        if item is None:
            return
        with lock:
            if isinstance(item, TupleBatch):
                for j in range(len(item)):
                    res[(int(item.key[j]), int(item.id[j]))] = \
                        float(item["value"][j])
            else:
                res[(int(item.key), int(item.id))] = float(item.value)

    return res, sink


def _win_seq(pkg, placement):
    wf = __import__(pkg)
    return mod(pkg, "operators.tpu.win_seq_tpu").WinSeqTPU(
        "sum", WIN, SLIDE, wf.WinType.TB, batch_len=128, emit_batches=True,
        placement=placement)


def _key_farm(pkg, placement):
    wf = __import__(pkg)
    return wf.KeyFarmTPUBuilder("sum").with_tb_windows(WIN, SLIDE) \
        .with_batch(128).with_batch_output() \
        .with_placement(placement).build()


def _resident_ffat(pkg, _placement):
    wf = __import__(pkg)
    return mod(pkg, "operators.tpu.ffat_resident").WinSeqFFATResident(
        lambda t: t.value, ADD[pkg], 0.0, WIN, SLIDE, wf.WinType.TB,
        **_dev(pkg))


# name -> (operator factory, placement, pinned measured inputs, the lane
# the planner must choose)
GRAPH_CASES = {
    "pinned device": (_win_seq, "device", {}, "device"),
    "pinned host": (_win_seq, "host", {}, "host"),
    "auto to host": (_win_seq, "auto",
                     {"WINDFLOW_RTT_FLOOR_MS": "1000",
                      "WINDFLOW_HOST_RATE_TPS": "1e12"}, "host"),
    "auto to device": (_win_seq, "auto",
                       {"WINDFLOW_RTT_FLOOR_MS": "0.01",
                        "WINDFLOW_HOST_RATE_TPS": "1"}, "device"),
    "key farm auto": (_key_farm, "auto",
                      {"WINDFLOW_RTT_FLOOR_MS": "1000",
                       "WINDFLOW_HOST_RATE_TPS": "1e12"}, "host"),
    "resident ffat": (_resident_ffat, None, {}, "device"),
}


def _plan_graph(pkg, case):
    wf = __import__(pkg)
    make_op, placement, _env, lane = GRAPH_CASES[case]
    reg = mod(pkg, "scheduler").DeviceLeaseRegistry(lanes=1)
    reg.acquire("hog", "other/win")
    res, sink = window_sink(pkg)
    g = wf.PipeGraph(f"plan_{placement}", wf.Mode.DEFAULT, cpu_config(pkg))
    g.device_leases, g.tenant_name, g.tenant_priority = reg, "t1", 2
    g.add_source(mod(pkg, "operators.batch_ops").BatchSource(
        batch_source(pkg, N_EVENTS))).add(make_op(pkg, placement)) \
        .add_sink(mod(pkg, "operators.basic_ops").Sink(sink))
    g.run()
    assert [p["placement"] for p in g.placements] == [lane]
    rows = reg.tenant_rows("t1")
    assert len(rows) == (lane == "device")
    chips = {r["Tenant"]: r["Chip"] for r in reg.rows()}
    decisions = []
    for p in g.placements:
        p = {k: v for k, v in p.items() if k != "device"}
        if "lease" in p:
            p["lease"] = {k: v for k, v in p["lease"].items()
                          if k != "chip"}
        decisions.append(p)
    stats = json.loads(g.stats.to_json())["Placements"]
    assert [s["placement"] for s in stats] == [lane]
    return decisions, [{k: v for k, v in r.items() if k != "Chip"}
                       for r in reg.rows()], res, chips


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_plan_graph_twins(case, monkeypatch):
    # one pinned set of measured inputs for both packages
    monkeypatch.setenv("WINDFLOW_RTT_FLOOR_MS", "1.0")
    monkeypatch.setenv("WINDFLOW_HOST_RATE_TPS", "5e7")
    monkeypatch.setenv("WINDFLOW_DEVICE_COMPUTE_MS", "0.5")
    for var, value in GRAPH_CASES[case][2].items():
        monkeypatch.setenv(var, value)
    ref_dec, ref_rows, ref_win, ref_chips = _plan_graph(REF, case)
    dec, rows, win, chips = _plan_graph(PORT, case)
    assert dec == ref_dec
    assert rows == ref_rows
    # the reference leases its one chip; the port records a lane's
    # bound device ("cpu" here), the registry's card for "hog"
    t1 = {"t1": "cpu"} if GRAPH_CASES[case][3] == "device" else {}
    assert ref_chips == {"hog": "tpu:0", **dict.fromkeys(t1, "tpu:0")}
    assert chips == {"hog": "cuda:0", **t1}
    assert sorted(win) == sorted(ref_win) and win
    np.testing.assert_allclose([win[k] for k in sorted(ref_win)],
                               [ref_win[k] for k in sorted(ref_win)],
                               rtol=RTOL_F32)
