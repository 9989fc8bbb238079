"""Each configuration's plain reference agrees with the port's pipeline
on the CPU, every window exactly, at a tiny size."""
import pytest

from wfbench_testlib import harness, run_finite

CELLS = {
    "ysb": ({"rate": 10_000, "source_batch": 4_096, "device_batch": 512,
             "inflight": 8}, 1_000_000),
}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_wfbench_reference_agrees_with_the_port(name):
    cell, n = CELLS[name]
    got, want = run_finite(name, cell, 2 ** 32 + 9, n)
    checks, pairs, wrong = harness.compare(got, want, 0.0)
    assert len(want["key"]) > 100
    assert checks == {"windows_missing": [0, 0], "windows_extra": [0, 0],
                      "max_rel_err": [0.0, 0.0]}
    assert wrong == 0 and (pairs >= 0).all()
