"""The harness on the CPU at a small size (it skips its look for a card
and drives the rest of a run): a sound run is correct; a run with the
timed path broken underneath is not, nor is one whose window engines
launch off the run's device or not at all; the lower-precision control
is not; a configuration, a cell and a metric added as files only are
found; and ``run.py`` prints no result where it cannot measure."""
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest

from wfbench_testlib import (ROOT, SMALL_YSB, harness, make_tree,
                             run_small)

CELL = "ysb.saturate"
SEED = 2 ** 35 + 3


@pytest.fixture
def tree(tmp_path):
    return make_tree(tmp_path, {CELL: SMALL_YSB})


def test_wfbench_sound_run_is_correct(tree):
    run, checks, line = run_small(tree, CELL, SEED)
    assert line["correct"] is True
    assert line["attempted"] > 100 and line["failed"] == 0
    assert set(line["metrics"]) == {"throughput", "setup_s"}
    assert list(line)[-1] == "checks"
    assert run.events_in_window > 0 and run.window_s >= 1.0
    assert checks["launches_in_window"][0] >= 1
    assert checks["engines_off_device"][0] == 0
    assert line["checks"]["launches_in_window"]["holds"] == ">="


def test_wfbench_run_off_its_device_is_not_correct(tree, monkeypatch):
    """The window engines judged against another device than the one
    they launch on: the run is not correct, whatever its windows."""
    real = harness.read_counters
    monkeypatch.setattr(harness, "read_counters",
                        lambda graph, device: real(graph, "cuda"))
    run, checks, line = run_small(tree, CELL, SEED)
    assert checks["engines_off_device"][0] >= 1
    assert checks["windows_missing"][0] == 0
    assert line["correct"] is False


def test_wfbench_window_with_no_launch_is_not_correct():
    checks = {"windows_missing": [0, 0], "windows_extra": [0, 0],
              "max_rel_err": [0.0, 0.0], "launches_in_window": [0, 1],
              "engines_off_device": [0, 0]}
    assert harness.verdict(checks) is False
    checks["launches_in_window"] = [3, 1]
    assert harness.verdict(checks) is True


def test_wfbench_traced_run_reads_the_host_metrics(tree):
    run, checks, line = run_small(tree, CELL, SEED, trace=True)
    m = line["metrics"]
    # no card here: the device metrics stay silent, the rest read
    assert {"source_blocked_pct.tput",
            "launches_per_mevent.tput"} <= set(m)
    assert "k1_roofline_pct.tput" not in m
    assert 0.0 < m["source_blocked_pct.tput"]["value"] < 100.0
    assert line["correct"] is True


def _break_answers(monkeypatch):
    """A window's value altered where it is produced."""
    from windflow_tpu_torch.ops import window_compute
    real = window_compute.window_sums

    def altered(values, se, max_extent=None):
        out = real(values, se, max_extent)
        out[0] += 1.0
        return out

    monkeypatch.setattr(window_compute, "window_sums", altered)


def _drop_half(monkeypatch):
    """Half of every batch left out of the window fold."""
    from windflow_tpu_torch.operators.tpu.win_seq_tpu import WinSeqTPULogic
    real = WinSeqTPULogic._svc_batch_native

    def half(self, batch, emit):
        return real(self, batch.take(np.arange(0, len(batch), 2)), emit)

    monkeypatch.setattr(WinSeqTPULogic, "_svc_batch_native", half)


def _state_unchanged(monkeypatch):
    """Every fourth batch leaves the fold's state unchanged."""
    from windflow_tpu_torch.operators.tpu.win_seq_tpu import WinSeqTPULogic
    real = WinSeqTPULogic._svc_batch_native
    seen = {"n": 0}

    def skip(self, batch, emit):
        seen["n"] += 1
        if seen["n"] % 4 == 0:
            return None
        return real(self, batch, emit)

    monkeypatch.setattr(WinSeqTPULogic, "_svc_batch_native", skip)


@pytest.mark.parametrize("fault", [_break_answers, _drop_half,
                                   _state_unchanged])
def test_wfbench_broken_timed_path_is_not_correct(tree, monkeypatch,
                                                  fault):
    fault(monkeypatch)
    run, checks, line = run_small(tree, CELL, SEED + 1)
    assert line["correct"] is False
    assert line["failed"] > 0 or checks["windows_extra"][0] > 0


def test_wfbench_lower_precision_control_is_not_correct(tree):
    sys.path.insert(0, str(ROOT / "wfbench"))
    try:
        import control
    finally:
        sys.path.remove(str(ROOT / "wfbench"))
    spec = harness.Spec(CELL, tree)
    for seed in (1, 2, 3):
        out = control.control(spec, seed, 20_000_000)
        assert out["correct"] is False
        assert out["checks"]["max_rel_err"][0] > 0.0
        assert out["checks"]["windows_missing"][0] == 0


def test_wfbench_added_files_are_found(tree):
    """A configuration, a cell and a per-layer metric added as files
    plus BENCHMARK.json entries run with no edit of any existing
    file."""
    d = tree / "wfbench"
    before = {p: p.read_bytes() for p in d.rglob("*") if p.is_file()}
    for sub, ext in (("configs", "json"), ("configs", "py"),
                     ("reference", "py")):
        shutil.copy(d / sub / f"ysb.{ext}", d / sub / f"ysb_b.{ext}")
    cell = json.loads((d / "workloads" / f"{CELL}.json").read_text())
    cell["config"] = "ysb_b"
    (d / "workloads" / "ysb_b.saturate.json").write_text(json.dumps(cell))
    (d / "metrics" / "events_per_call.py").write_text(
        "def read(run):\n"
        "    calls = run.window_calls()\n"
        "    return calls[:, 2].mean() if len(calls) else None\n")
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="ysb_b",
                                 file="wfbench/configs/ysb_b.json"))
    bench["workloads"].append(dict(bench["workloads"][0],
                                   name="ysb_b.saturate", config="ysb_b"))
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("ysb_b.saturate")
    bench["per_layer"].append(
        {"name": "events_per_call.tput", "unit": "events",
         "better": "higher", "source": "host_clock", "layer": "source",
         "moves": "throughput", "workloads": ["ysb_b.saturate"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    run, checks, line = run_small(tree, "ysb_b.saturate", SEED, trace=True)
    assert line["correct"] is True
    assert line["metrics"]["events_per_call.tput"]["value"] == \
        SMALL_YSB["source_batch"]
    assert all(p.read_bytes() == b for p, b in before.items())


def _run_py(root, *extra, env=None):
    return subprocess.run(
        [sys.executable, str(root / "wfbench" / "run.py"), "--workload",
         CELL, "--seed", "7", "--seconds", "1", "--trace", "0", *extra],
        capture_output=True, text=True, timeout=300, cwd=root, env=env)


def test_wfbench_run_prints_nothing_without_a_card_or_the_program(
        tree, tmp_path_factory):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card exit cannot show")
    out = _run_py(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr
    # a directory with only BENCHMARK.json and the benchmark's folder
    only = tmp_path_factory.mktemp("only")
    shutil.copy(ROOT / "BENCHMARK.json", only / "BENCHMARK.json")
    shutil.copytree(ROOT / "wfbench", only / "wfbench")
    out = _run_py(only, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""
