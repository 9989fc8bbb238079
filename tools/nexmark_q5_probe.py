"""NEXMark Q5 at the Nexmark suite's settings (the benchmark's
``nexmark_q5`` configuration) outside the benchmark's cell: a sweep of
the window engine's launch size and depth, and one run that records
what the cell cannot see.

    python3 tools/nexmark_q5_probe.py sweep --seconds 20 --seed <n> \
        --batches 16384 65536 262144 --inflight 4 8
    python3 tools/nexmark_q5_probe.py state --seconds 30 --seed <n> \
        [--table] [--device cuda] [--rate <events/s of event time>]

``sweep`` runs the cell (``wfbench/harness.run_cell``) once per launch
size and depth and prints each run's throughput and verdict.  ``state``
streams the cell's traffic in a closed loop for ``--seconds``, samples
the window engine's counters (``Keys_live``, ``Keys_evicted``,
``Windows_fired_watermark``) and the process's RSS at every close,
with ``--table`` records every count the engine emits, then stops and
drains, and prints one JSON line: the samples, whether every window
due a slide before the stop reached the sink before it, and the rows
the cell compares (hot rows and window sums; with ``--table`` the full
count table too) compared exactly with the benchmark's reference.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from wfbench import harness  # noqa: E402

CELL = "nexmark_q5.saturate"


def sweep(args) -> None:
    for batch in args.batches:
        for depth in args.inflight:
            spec = harness.Spec(CELL)
            spec.cell.update(device_batch=batch, inflight=depth)
            run, stream = harness.run_cell(spec, args.seed, args.seconds,
                                           False, device=args.device)
            checks = harness.judge(run, stream)
            print(json.dumps({
                "device_batch": batch, "inflight": depth,
                "throughput": run.events_in_window / run.window_s,
                "setup_s": run.setup_s, "events": run.events_total,
                "correct": harness.verdict(checks),
                "launches_in_window": checks["launches_in_window"][0]}),
                flush=True)


def state(args) -> None:
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.core.tuples import TupleBatch
    from windflow_tpu_torch.models.nexmark import build_q5_nexmark
    from windflow_tpu_torch.monitoring.stats import get_mem_usage_kb

    spec = harness.Spec(CELL)
    cfg, cell = spec.config, spec.cell
    if args.rate:
        cfg["event_rate"] = args.rate
    stream = spec.config_mod.make_stream(cfg, cell, args.seed)
    win, slide, lag = spec.config_mod.window_units(cfg)
    batch = int(cell["source_batch"])
    st = {"sent": 0, "t0": None, "t_stop": None, "calls": [], "fired": 0}
    samples = []

    def sample(now):
        """The engine's counters and the RSS, once after each close
        (on the source thread, between two batches)."""
        logics = harness.window_logics(g)
        rec = logics[0].stats if logics else None
        if rec is None or rec.windows_fired_watermark == st["fired"]:
            return
        st["fired"] = rec.windows_fired_watermark
        samples.append({"t": round(now - st["t0"], 3), "events": st["sent"],
                        "keys_live": rec.keys_live,
                        "keys_evicted": rec.keys_evicted,
                        "windows_fired_watermark": st["fired"],
                        "rss_kb": get_mem_usage_kb()})

    def source(ctx=None):
        now = time.perf_counter()
        if st["t0"] is None:
            st["t0"] = now
        sample(now)
        if now - st["t0"] >= args.seconds:
            st["t_stop"] = st["t_stop"] or now
            return None
        b = TupleBatch(stream.columns(st["sent"], batch))
        st["sent"] += batch
        st["calls"].append((time.perf_counter(), st["sent"] - 1))
        return b

    counts, lock = [], threading.Lock()
    sink = harness.Sink(harness.make_span(False))
    totals = spec.config_mod.WindowTotals(sink, harness.make_span(False),
                                          win, slide)

    def record(b):
        totals.record(b)
        if args.table:
            with lock:
                counts.append((np.asarray(b.key, np.int64).copy(),
                               np.asarray(b.id, np.int64).copy(),
                               np.asarray(b["value"], np.float64).copy()))

    g = wf.PipeGraph("nexmark_q5_probe", wf.Mode.DEFAULT,
                     config=wf.RuntimeConfig(device=args.device))
    build_q5_nexmark(g, source, totals, win_len=win, slide_len=slide,
                     watermark_lag=lag,
                     device_batch=int(cell["device_batch"]),
                     inflight_depth=int(cell["inflight"]), record=record)
    g.run()
    drained = time.perf_counter()
    got = sink.arrays()
    n = st["sent"]
    ref = spec.reference
    table, rows = None, 0
    if args.table:
        want_t = ref.counts(cfg, cell, stream, n)
        got_t = {k: np.concatenate([c[i] for c in counts])
                 for i, k in enumerate(("key", "wid", "value"))}
        rows = len(got_t["key"])
        table = harness.compare(got_t, dict(
            want_t, value=want_t["value"].astype(np.float64)), 0.0)[0]
    hot = harness.compare(got, ref.windows(cfg, cell, stream, n), 0.0)[0]
    # windows due a slide before the stop: the watermark after the last
    # call before the stop passed their end by at least a slide
    calls = np.array(st["calls"], np.float64)
    last_before = calls[calls[:, 0] < st["t_stop"], 1].max()
    due = np.unique(got["wid"][got["wid"] * slide + win + lag + slide
                               <= last_before])
    late = [int(w) for w in due
            if got["arrival"][got["wid"] == w].min() >= st["t_stop"]]
    print(json.dumps({
        "seed": args.seed, "device": args.device, "events": n,
        "seconds": args.seconds, "drain_s": drained - st["t_stop"],
        "samples": samples, "windows_due_a_slide_before_stop": len(due),
        "of_them_after_stop": late, "count_rows": rows,
        "count_table": table, "rows": len(got["key"]), "compared": hot,
        "stats": [r for op in json.loads(g.stats.to_json())["Operators"]
                  for r in op["Replicas"] if "Watermarks" in r]}))


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("sweep", "state"))
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 25)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batches", type=int, nargs="+", default=[65536])
    ap.add_argument("--inflight", type=int, nargs="+", default=[8])
    ap.add_argument("--rate", type=int, default=0)
    ap.add_argument("--table", action="store_true")
    args = ap.parse_args(argv)
    (sweep if args.mode == "sweep" else state)(args)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
