"""The readers of the port's host-chain spans: ``ops_self_pct`` and
``fold_pct`` on a hand-built profile, to the microsecond, and on a
traced run of the YSB cell on the CPU with WINDFLOW_TORCH_PROFILE=1."""
import pytest

from wfbench_testlib import ROOT, SMALL_YSB, harness, make_tree, run_small

CELL = "ysb.saturate"
SEED = 2 ** 35 + 11
US = 1e-6


def _reader(name):
    return harness.load_file(ROOT / "wfbench" / "metrics" / f"{name}.py",
                             f"test_metric_{name}")


class _Profile:
    def __init__(self, host):
        self.host = [(n, a * US, b * US) for n, a, b in host]


class _Run:
    """The window [0, 1000) us and a profile of host ranges in us."""

    def __init__(self, host):
        self.t_start, self.t_end = 0.0, 1000 * US
        self.window_s = self.t_end - self.t_start
        self.profile = None if host is None else _Profile(host)


# the source thread: a generation step holding the chained operators,
# the farm inside them and the fold inside the farm; a dispatcher
# thread's ranges beside them; a second step running past the window
HOST = [
    ("windflow/op/p/src", 100, 900),
    ("wfbench/generate", 100, 200),
    ("windflow/op/p/views.0", 200, 700),
    ("wfbench/filter", 210, 260),
    ("windflow/op/p/campaign.0", 300, 650),
    ("wfbench/join", 310, 400),
    ("windflow/op/p/count.0", 420, 640),
    ("windflow/fold", 430, 600),
    # the dispatcher: inside the views span in time, but neither an
    # operator of the chain nor nested work of one (not subtracted)
    ("windflow/emit/p/sink.0", 650, 680),
    ("windflow/window_launch", 680, 720),
    # the benchmark's sink on the dispatcher, wholly inside the source
    # step in time: not the chain's thread's work (not subtracted)
    ("wfbench/sink", 720, 760),
    # overlapping a step's end only: not nested, not subtracted
    ("wfbench/sink", 880, 960),
    ("wfbench/source thread in the graph", 200, 1100),
    ("windflow/op/p/src", 950, 1100),
    ("windflow/fold", 1020, 1050),
    ("windflow/fold", -50, -10),
]


def test_wfbench_ops_self_pct_subtracts_nested_ranges_only():
    # self: src 700-900 (200); views 200-210, 260-300, 650-700 (100);
    # campaign 300-310, 400-420, 640-650 (40); count 420-430, 600-640
    # (50); the second step 950-1000 in the window (50): 440 of 1000
    got = _reader("ops_self_pct").read(_Run(HOST))
    assert got == pytest.approx(44.0, abs=1e-6)


def test_wfbench_fold_pct_is_the_folds_union_in_the_window():
    got = _reader("fold_pct").read(_Run(HOST))
    assert got == pytest.approx(17.0, abs=1e-6)
    overlapping = HOST + [("windflow/fold", 500, 610)]
    assert _reader("fold_pct").read(_Run(overlapping)) == \
        pytest.approx(18.0, abs=1e-6)


@pytest.mark.parametrize("host", [
    None, [],
    # only dispatcher-thread and benchmark ranges: nothing of theirs
    [("windflow/emit/p/sink.0", 10, 20), ("windflow/window_launch", 30,
                                          40), ("wfbench/generate", 50, 60)],
    # their ranges, all outside the window
    [("windflow/op/p/src", 1100, 1200), ("windflow/fold", 1110, 1120)],
])
def test_wfbench_span_readers_are_silent_without_their_spans(host):
    assert _reader("ops_self_pct").read(_Run(host)) is None
    assert _reader("fold_pct").read(_Run(host)) is None


def test_wfbench_traced_run_reads_the_host_chain(tmp_path, monkeypatch):
    from windflow_tpu_torch.telemetry import profiler
    tree = make_tree(tmp_path, {CELL: SMALL_YSB})
    monkeypatch.setenv("WINDFLOW_TORCH_PROFILE", "1")
    profiler.reset()
    try:
        run, checks, line = run_small(tree, CELL, SEED, trace=True)
    finally:
        monkeypatch.delenv("WINDFLOW_TORCH_PROFILE")
        profiler.reset()
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert line["correct"] is True
    assert m["ops_self_pct.tput"] > 0.0 and m["fold_pct.tput"] > 0.0
    assert m["ops_self_pct.tput"] + m["fold_pct.tput"] <= \
        m["source_blocked_pct.tput"]
