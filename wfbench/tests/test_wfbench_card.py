"""The benchmark's command on the card: one short run of every cell,
correct, with the contract's result line.  Skips without a card (it
decides inside the test); on the card run it with
``python -m pytest -m cuda wfbench/tests``."""
import json
import subprocess
import sys

import pytest

from wfbench_testlib import ROOT


def _cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", _cells())
def test_wfbench_cell_runs_correct_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "wfbench/run.py", "--workload", cell, "--seed",
         str(2 ** 34 + 1), "--seconds", "10", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, out.stderr[-4000:]
    assert line["device"]["platform"] == "gpu"
    assert "setup_s" in line["metrics"]
    assert list(line)[-1] == "checks"
