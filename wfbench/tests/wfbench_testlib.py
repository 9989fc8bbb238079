"""Helpers of the benchmark's CPU tests: a copy of the benchmark in a
temporary tree, a cell shrunk to run on the CPU, and a finite stream
through a configuration's pipeline."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from wfbench import harness  # noqa: E402

# a YSB cell the CPU runs in seconds: 10 s windows of 10^6 events
SMALL_YSB = {"rate": 100_000, "source_batch": 16_384, "warm_s": 0.5}
SMALL_POOL = 1 << 18


def make_tree(tmp: Path, cell_edits: dict = None) -> Path:
    """A copy of BENCHMARK.json and wfbench/ under ``tmp`` with
    ``cell_edits`` {cell: {key: value}} applied to the cell files and
    the configurations' pools shrunk."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "wfbench", tmp / "wfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for cell, edits in (cell_edits or {}).items():
        p = tmp / "wfbench" / "workloads" / f"{cell}.json"
        d = json.loads(p.read_text())
        d.update(edits)
        p.write_text(json.dumps(d))
    for p in (tmp / "wfbench" / "configs").glob("*.json"):
        d = json.loads(p.read_text())
        if "pool_events" in d.get("assumed", {}):
            d["assumed"]["pool_events"] = SMALL_POOL
        p.write_text(json.dumps(d))
    return tmp


def run_small(root: Path, cell: str, seed: int, seconds: float = 1.0,
              trace: bool = False):
    """One run of ``cell`` on the CPU; returns (run, checks, line)."""
    spec = harness.Spec(cell, root)
    run, stream = harness.run_cell(spec, seed, seconds, trace,
                                   device="cpu", warm_timeout_s=60.0)
    checks = harness.judge(run, stream)
    ok = harness.verdict(checks)
    return run, checks, harness.result_line(run, checks, ok, "cpu", 1)


def run_finite(name: str, cell: dict, seed: int, n_events: int):
    """``n_events`` of configuration ``name`` through its pipeline on the
    CPU, the stream closed at the end; returns (program's windows,
    reference's windows)."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.core.tuples import TupleBatch

    d = ROOT / "wfbench"
    cfg = harness.load_json(d / "configs" / f"{name}.json")
    mod = harness.load_file(d / "configs" / f"{name}.py", f"cfg_{name}")
    ref = harness.load_file(d / "reference" / f"{name}.py", f"ref_{name}")
    stream = mod.make_stream(cfg, cell, seed)
    batch = int(cell["source_batch"])

    class Finite:
        def __init__(self):
            self.stream = stream
            self.sent = 0

        def __call__(self, ctx=None):
            if self.sent >= n_events:
                return None
            n = min(batch, n_events - self.sent)
            b = TupleBatch(stream.columns(self.sent, n))
            self.sent += n
            return b

    sink = harness.Sink(harness.make_span(False))
    g = wf.PipeGraph(f"t_{name}", wf.Mode.DEFAULT,
                     config=wf.RuntimeConfig(device="cpu"))
    mod.build(g, cfg, cell, Finite(), sink, harness.make_span(False))
    g.run()
    return sink.arrays(), ref.windows(cfg, cell, stream, n_events)
