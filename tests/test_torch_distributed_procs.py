"""The port's distributed runtime across real worker processes, held
against the reference's: the two-process runs of
tests/test_distributed.py (TestTwoProcess), the two-process live
detection of tests/test_slo.py, NEXMark Q5 on the device lane with the
window-sum kernel's plain version in worker 1, and the no-fallback
rule across the process boundary.

The reference's runs load their builds from tests/test_distributed.py,
the port's from tests/torch_dist_builds.py, which imports only the
port: every port worker reports ``jax`` absent from ``sys.modules``.
Rows, wire books and conservation flags are compared exactly; what
depends on thread timing (latencies, frame counts of the record plane
under a drop) is held to the reference test's own assertions.  Every
run gets a ``timeout_s`` and its workers are reaped by
``run_distributed`` before it returns or raises.
"""
import collections
import json
import os
import threading
import time
import urllib.request

import pytest

import test_distributed as ref_builds
import torch_dist_builds as port_builds

Q5_N = 60_000
RUN_TIMEOUT_S = 120.0


def _run(pkg, build, tmp_path, tag, **kw):
    import importlib
    run_distributed = importlib.import_module(
        f"{pkg}.distributed.runtime").run_distributed
    kw.setdefault("timeout_s", RUN_TIMEOUT_S)
    return run_distributed(build, n_workers=2, graph_name=tag,
                           workdir=str(tmp_path / pkg / tag / "work"), **kw)


def _wire_rows(merged):
    return sorted((r["edge"], r["tuples_sent"], r["tuples_delivered"],
                   r["frames_sent"], r["frames_delivered"],
                   r["dropped_frames"], r["gaps"], r["missing_tuples"],
                   r["balanced"])
                  for r in merged["Wire"]["Edges"])


def _flags(merged):
    return (merged["Wire"]["Balanced"],
            merged["Conservation"]["Edges_balanced"],
            merged["Conservation"]["Final_check"])


def _jax_free(probe_dir):
    probes = port_builds.read_probes(str(probe_dir))
    assert [p["jax"] for p in probes] == [False, False]
    assert [p["reference"] for p in probes] == [False, False]
    return probes


@pytest.fixture()
def dist_env(tmp_path, monkeypatch):
    monkeypatch.setenv("WFT_LOG_DIR", str(tmp_path / "log"))
    probes = tmp_path / "probes"
    probes.mkdir()
    monkeypatch.setenv("WFT_PROBE_DIR", str(probes))
    return tmp_path


@pytest.fixture(scope="module")
def ref_q5(tmp_path_factory):
    """The reference's two-process Q5 (host lane), once for the module:
    its serialized rows and merged view, with the sink in the engine's
    worker (the auto cut) and pinned to the source's."""
    tmp = tmp_path_factory.mktemp("ref_q5")
    old = {k: os.environ.get(k) for k in ("WFT_Q5_N", "WFT_Q5_OUT",
                                          "WFT_LOG_DIR")}
    os.environ["WFT_Q5_N"] = str(Q5_N)
    os.environ["WFT_LOG_DIR"] = str(tmp / "log")
    out = {}
    try:
        for tag, assignment in (("auto", None),
                                ("pinned", {"q5_counts": 1,
                                            "q5_sink": 0})):
            path = tmp / f"q5_{tag}.json"
            os.environ["WFT_Q5_OUT"] = str(path)
            rep = _run("windflow_tpu", ref_builds.build_q5, tmp,
                       f"ref_q5_{tag}", config_fn=ref_builds.config_q5,
                       assignment=assignment)
            out[tag] = (path.read_bytes(), rep["merged"])
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def test_keyed_run_matches_reference_and_ledger_closes(dist_env,
                                                       monkeypatch):
    n = 4000
    monkeypatch.setenv("WFT_DIST_N", str(n))
    got = {}
    for pkg, builds in (("windflow_tpu", ref_builds),
                        ("windflow_tpu_torch", port_builds)):
        out = dist_env / f"{pkg}_rows.json"
        monkeypatch.setenv("WFT_DIST_OUT", str(out))
        rep = _run(pkg, builds.build_basic, dist_env, "tp_basic",
                   config_fn=builds.config_counters)
        merged = rep["merged"]
        assert {op["Worker"] for op in merged["Operators"]} == {0, 1}
        got[pkg] = (out.read_bytes(), _wire_rows(merged), _flags(merged))
    assert got["windflow_tpu_torch"] == got["windflow_tpu"]
    rows, _wire, flags = got["windflow_tpu_torch"]
    assert flags == (True, True, True)
    per_key = collections.defaultdict(list)
    for k, tid, v in json.loads(rows):
        per_key[k].append((tid, v))
    assert {k: sorted(vs) for k, vs in per_key.items()} \
        == port_builds.acc_oracle(n) == ref_builds._acc_oracle(n)
    _jax_free(dist_env / "probes")


def _port_q5(dist_env, monkeypatch, tag, placement, assignment=None):
    out = dist_env / f"port_q5_{tag}.json"
    monkeypatch.setenv("WFT_Q5_N", str(Q5_N))
    monkeypatch.setenv("WFT_Q5_OUT", str(out))
    monkeypatch.setenv("WFT_Q5_PLACEMENT", placement)
    rep = _run("windflow_tpu_torch", port_builds.build_q5, dist_env,
               f"port_q5_{tag}", config_fn=port_builds.config_q5,
               assignment=assignment)
    return out.read_bytes(), rep["merged"]


def test_q5_host_lane_rows_equal_reference_byte_for_byte(dist_env,
                                                         monkeypatch,
                                                         ref_q5):
    rows, merged = _port_q5(dist_env, monkeypatch, "host", "host")
    ref_rows, ref_merged = ref_q5["auto"]
    assert rows == ref_rows
    assert json.loads(rows) == port_builds.q5_oracle(Q5_N)
    assert _wire_rows(merged) == _wire_rows(ref_merged)
    assert _flags(merged) == _flags(ref_merged) == (True, True, True)
    assert sum(r["tuples_sent"] for r in merged["Wire"]["Edges"]) >= Q5_N
    probes = _jax_free(dist_env / "probes")
    assert [len(p["engines"]) for p in probes] == [0, 1]
    assert probes[1]["engines"][0]["placement"] == "host"


def test_q5_device_lane_on_cpu_runs_k1_plain_in_worker_1(dist_env,
                                                         monkeypatch,
                                                         ref_q5):
    """placement='device' with device='cpu': worker 1 owns the engine
    and folds pane counts with the window-sum kernel's plain version;
    its rows equal the reference's host-lane rows."""
    rows, merged = _port_q5(dist_env, monkeypatch, "device", "device")
    assert rows == ref_q5["auto"][0]
    assert _flags(merged) == (True, True, True)
    assert [r["tuples_sent"] for r in merged["Wire"]["Edges"]] == [Q5_N]
    probes = _jax_free(dist_env / "probes")
    assert probes[0]["engines"] == []
    (engine,) = probes[1]["engines"]
    assert engine["placement"] == "device" and engine["device"] == "cpu"
    assert engine["batches"] > 0
    # the plain version: no counted kernel launch, no CUDA context
    assert [p["k1_launches"] for p in probes] == [0, 0]
    assert not any(p["cuda_initialized"] for p in probes)
    launches = sum(int(r.get("Device_launches", 0) or 0)
                   for op in merged["Operators"]
                   for r in op.get("Replicas") or ())
    assert launches == engine["batches"]


def test_q5_device_results_cross_the_wire_as_the_reference_sends(
        dist_env, monkeypatch, ref_q5):
    """The sink pinned to the source's worker: the engine's windows
    leave worker 1 over a second wire edge, as columnar batches, and
    arrive as the reference's do."""
    pins = {"q5_counts": 1, "q5_sink": 0}
    rows, merged = _port_q5(dist_env, monkeypatch, "pinned", "device",
                            assignment=pins)
    ref_rows, ref_merged = ref_q5["pinned"]
    assert rows == ref_rows == ref_q5["auto"][0]
    assert _flags(merged) == _flags(ref_merged) == (True, True, True)

    def tuples(m):
        return sorted((r["edge"], r["tuples_sent"], r["balanced"])
                      for r in m["Wire"]["Edges"])

    assert tuples(merged) == tuples(ref_merged)
    assert len(tuples(merged)) == 2
    probes = _jax_free(dist_env / "probes")
    assert [len(p["engines"]) for p in probes] == [0, 1]


def test_drop_link_flagged_with_exact_edge_and_count(dist_env,
                                                     monkeypatch):
    n = 2000
    monkeypatch.setenv("WFT_DIST_N", str(n))
    got = {}
    for pkg, builds in (("windflow_tpu", ref_builds),
                        ("windflow_tpu_torch", port_builds)):
        out = dist_env / f"{pkg}_rows.json"
        monkeypatch.setenv("WFT_DIST_OUT", str(out))
        merged = _run(pkg, builds.build_basic, dist_env, "tp_drop",
                      config_fn=builds.config_drop_link)["merged"]
        assert not merged["Wire"]["Balanced"]
        bad = sorted((r["edge"], r["missing_tuples"], r["dropped_frames"])
                     for r in merged["Wire"]["Edges"] if not r["balanced"])
        lost = sorted((x["edge"], x["count"])
                      for x in merged["Conservation"]["Violations"]
                      if x["kind"] == "lost_wire_delivery")
        got[pkg] = (bad, lost, len(json.loads(out.read_text())))
    assert got["windflow_tpu_torch"] == got["windflow_tpu"]
    bad, lost, n_rows = got["windflow_tpu_torch"]
    assert bad == [("pipe0/dist_fold.0", 1, 1), ("pipe0/dist_fold.1", 1, 1)]
    assert ("pipe0/dist_fold.0", 1) in lost
    assert ("pipe0/dist_fold.1", 1) in lost
    assert n_rows == n - 2
    _jax_free(dist_env / "probes")


def test_doctor_names_remote_bottleneck(dist_env, monkeypatch):
    import importlib
    n = 2600
    monkeypatch.setenv("WFT_DIST_N", str(n))
    got = {}
    for pkg, builds in (("windflow_tpu", ref_builds),
                        ("windflow_tpu_torch", port_builds)):
        monkeypatch.setenv("WFT_DIST_OUT", str(dist_env / f"{pkg}.json"))
        rep = _run(pkg, builds.build_slow_remote, dist_env, "tp_doctor",
                   config_fn=builds.config_traced)
        merged = rep["merged"]
        by_name = {op["Operator_name"]: op["Worker"]
                   for op in merged["Operators"]}
        bn = importlib.import_module(
            f"{pkg}.diagnosis.report").build_report(merged)["Bottleneck"]
        assert bn["Verdict"] in ("backpressure", "mild_pressure",
                                 "service_bound")
        doctor_main = importlib.import_module(f"{pkg}.doctor").main
        assert doctor_main([*rep["stats_paths"], "--merge"]) == 0
        got[pkg] = (by_name["pipe0/slow_remote"], by_name["pipe0/fast_src"],
                    bn["Operator"],
                    json.loads((dist_env / f"{pkg}.json").read_text()))
    assert got["windflow_tpu_torch"] == got["windflow_tpu"] \
        == (1, 0, "pipe0/slow_remote", {"count": n})
    _jax_free(dist_env / "probes")


def test_kill_worker_epoch_restart_matches_oracle(dist_env, monkeypatch):
    from windflow_tpu_torch.distributed.wiring import KILL_EXIT
    n = 4000
    out = dist_env / "effects.jsonl"
    monkeypatch.setenv("WFT_DIST_N", str(n))
    monkeypatch.setenv("WFT_DIST_OUT", str(out))
    monkeypatch.setenv("WFT_EPOCH_DIR", str(dist_env / "epochs"))
    monkeypatch.setenv("WFT_KILL_AT", "2000")
    report = _run("windflow_tpu_torch", port_builds.build_durable,
                  dist_env, "tp_kill", config_fn=port_builds.config_durable,
                  max_restarts=2, timeout_s=RUN_TIMEOUT_S)
    assert report["attempts"] >= 2
    assert report["exit_codes"][0][0] == KILL_EXIT
    restores = [e for e in report["merged"].get("Flight") or []
                if e.get("kind") == "epoch_restore"]
    assert restores and all(e["epoch"] >= 1 for e in restores)
    per_key = collections.defaultdict(list)
    for r in port_builds.resolve_epoch_file(out):
        per_key[r["k"]].append((r["t"], r["v"]))
    oracle = ref_builds._acc_oracle(n)
    assert {k: sorted(set(vs)) for k, vs in per_key.items()} == oracle
    for k, vs in per_key.items():
        assert len(vs) == len(set(vs)) == len(oracle[k])
    assert report["merged"]["Wire"]["Balanced"]


def test_smoke_bitwise_and_balanced(dist_env):
    from windflow_tpu_torch.distributed import smoke
    assert smoke.main(["6000"]) == 0


def test_live_remote_bottleneck_named_2proc(tmp_path, monkeypatch):
    """tests/test_slo.py's chaos acceptance on the port: a slow REMOTE
    operator; the coordinator's live merged view names the
    worker-annotated bottleneck and an slo_breach reaches the merge
    mid-run, with no stats file read."""
    from windflow_tpu_torch.distributed.runtime import run_distributed
    from windflow_tpu_torch.distributed.smoke import (live_build,
                                                      live_config)
    monkeypatch.setenv("WINDFLOW_SMOKE_N", "9000")
    monkeypatch.setenv("WINDFLOW_SMOKE_LOG", str(tmp_path / "log"))
    workdir = str(tmp_path / "work")
    box = {}

    def runner():
        try:
            box["report"] = run_distributed(
                live_build, n_workers=2, config_fn=live_config,
                graph_name="slo_live", workdir=workdir,
                timeout_s=RUN_TIMEOUT_S)
        except BaseException as e:
            box["error"] = e

    t = threading.Thread(target=runner, daemon=True)
    t.start()
    obs_path = os.path.join(workdir, "observer.json")
    deadline = time.monotonic() + 60.0
    url = None
    while url is None and time.monotonic() < deadline:
        try:
            with open(obs_path) as f:
                url = json.load(f)["http"] + "/cluster"
        except (OSError, ValueError, KeyError):
            time.sleep(0.05)
    named = breach = None
    while (named is None or breach is None) \
            and time.monotonic() < deadline and t.is_alive():
        time.sleep(0.2)
        try:
            with urllib.request.urlopen(url, timeout=5) as r:
                doc = json.loads(r.read().decode())
        except (OSError, ValueError, TypeError):
            continue
        merged = doc.get("merged") or {}
        if not merged.get("Operators"):
            continue
        bn = (doc.get("report") or {}).get("Bottleneck") or {}
        ops = {op.get("Operator_name"): op.get("Worker")
               for op in merged.get("Operators") or ()}
        if named is None and "live_slow" in (bn.get("Operator") or ""):
            if ops.get(bn["Operator"]) is not None \
                    and ops.get("pipe0/live_src") is not None:
                named = (ops[bn["Operator"]], ops["pipe0/live_src"])
        if breach is None and any(e.get("kind") == "slo_breach"
                                  for e in merged.get("Flight") or ()):
            breach = True
    t.join(timeout=RUN_TIMEOUT_S + 30.0)
    assert not t.is_alive()
    assert url is not None, "observer endpoint never appeared"
    assert "error" not in box, box.get("error")
    assert named is not None, "remote bottleneck never named live"
    assert named[0] != named[1]              # the operator is remote
    assert breach, "slo_breach never reached the merge"
    live = box["report"]["live_merged"]
    assert live is not None and "Slo" in live


def test_worker_asking_for_the_card_fails_the_run_without_fallback(
        dist_env, monkeypatch):
    """device='cuda' on a box with no card: worker 1 (the engine's
    owner) fails at start, and the coordinator raises WorkerFailure
    with its log tail -- the plain version never runs in its place."""
    import torch
    from windflow_tpu_torch.distributed import WorkerFailure
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device; the rule is about a "
                    "box without one")
    monkeypatch.setenv("WFT_Q5_N", str(Q5_N))
    monkeypatch.setenv("WFT_Q5_OUT", str(dist_env / "q5.json"))
    monkeypatch.setenv("WFT_Q5_PLACEMENT", "device")
    monkeypatch.setenv("WFT_DEVICE", "cuda")
    with pytest.raises(WorkerFailure) as e:
        _run("windflow_tpu_torch", port_builds.build_q5, dist_env,
             "no_card", config_fn=port_builds.config_q5,
             wire={"connect_timeout_s": 2.0})
    assert e.value.exit_codes[1] == 1
    assert "no CUDA device is available" in e.value.logs[1]
    assert not (dist_env / "q5.json").exists()
