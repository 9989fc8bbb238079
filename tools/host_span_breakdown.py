"""One traced run of a benchmark cell with the source thread's window
split among the port's host spans.

Run from the root of a checkout, on the card:

    python3 tools/host_span_breakdown.py --workload ysb.saturate \
        --seed 7300000012 --out spans.json

It runs the cell once through ``wfbench``'s harness with
WINDFLOW_TORCH_PROFILE=1 and writes (and prints) a JSON object with:

* ``share_pct``: each operator's self time (``self windflow/op/<op>``,
  as ``ops_self_pct`` counts it, less the watermark ranges), the fold
  (``windflow/fold``), the window engines' watermarks
  (``windflow/watermark``), the application's ranges
  (``wfbench/filter``, ``wfbench/join``) and the generator
  (``wfbench/generate``), each as a share of the window;
* ``no_span_pct``: the window that none of these covers;
* ``in_graph_pct`` and ``covered_in_graph_pct``: the source thread's
  time between two generator calls, and how much of it the program's
  spans and the application's ranges cover;
* ``dispatcher_pct``: the dispatcher thread's ranges;
* ``idle_pct``, ``idle_by_span_pct``, ``idle_no_span_pct``: the
  device's idle time, put down to the same categories;
* ``metrics``: the cell's per-layer metrics as the harness reads them.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ["WINDFLOW_TORCH_PROFILE"] = "1"

from wfbench import harness, roofline  # noqa: E402

WATERMARK = "windflow/watermark"
CHAIN = ("windflow/op/", "windflow/fold", WATERMARK, "wfbench/filter",
         "wfbench/join")
NAMED = ("windflow/fold", "wfbench/filter", "wfbench/join",
         "wfbench/generate")


def size(intervals):
    return sum(b - a for a, b in intervals)


def intersect(x, y):
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(x, y):
    """The sorted disjoint intervals ``x`` less the union ``y``."""
    out, j = [], 0
    for a, b in x:
        while j < len(y) and y[j][1] <= a:
            j += 1
        k = j
        while k < len(y) and y[k][0] < b:
            if y[k][0] > a:
                out.append((a, y[k][0]))
            a = max(a, y[k][1])
            k += 1
        if a < b:
            out.append((a, b))
    return out


def breakdown(run, spec):
    lo, hi, window = run.t_start, run.t_end, run.window_s
    host = run.profile.host

    def union(intervals):
        return roofline.merge(intervals, lo, hi)

    ops = harness.load_file(spec.metrics_dir / "ops_self_pct.py",
                            "breakdown_ops_self_pct")
    cats = {}
    for name, a, b in ops.self_intervals(host):
        cats.setdefault("self " + name, []).append((a, b))
    # a watermark's work runs inside the operator that takes it
    marks = union([(a, b) for n, a, b in host if n == WATERMARK])
    cats = {k: subtract(union(v), marks) for k, v in cats.items()}
    if marks:
        cats[WATERMARK] = marks
    for name in NAMED:
        cats[name] = union([(a, b) for n, a, b in host if n == name])
    every = union([iv for v in cats.values() for iv in v])
    covered = union([(a, b) for n, a, b in host if n.startswith(CHAIN)])
    gen_calls = union([(c[0], c[1]) for c in run.window_calls()])
    in_graph = window - size(gen_calls)
    idle = roofline.gaps(run.profile.device_intervals(), lo, hi)
    others = sorted({n for n, _, _ in host
                     if not n.startswith(CHAIN + NAMED
                                         + ("wfbench/source",))})
    return {
        "window_s": window,
        "events": run.events_in_window,
        "throughput": run.events_in_window / window,
        "setup_s": run.setup_s,
        "in_graph_pct": 100 * in_graph / window,
        "generator_calls_pct": 100 * size(gen_calls) / window,
        "covered_in_graph_pct": 100 * (
            size(covered) - size(intersect(covered, gen_calls)))
        / in_graph,
        "share_pct": {k: 100 * size(v) / window for k, v in cats.items()},
        "no_span_pct": 100 * (window - size(every)) / window,
        "dispatcher_pct": {
            n: 100 * size(union([(a, b) for m, a, b in host if m == n]))
            / window for n in others},
        "counts": {n: sum(1 for m, a, _ in host if m == n and lo <= a < hi)
                   for n in sorted({m for m, _, _ in host})},
        "device_busy_s": size(union(run.profile.device_intervals())),
        "idle_pct": 100 * size(idle) / window,
        "idle_by_span_pct": {k: 100 * size(intersect(v, idle)) / window
                             for k, v in cats.items()},
        "idle_no_span_pct": 100 * (size(idle)
                                   - size(intersect(every, idle))) / window,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    spec = harness.Spec(args.workload, ROOT)
    t0 = time.perf_counter()
    run, stream = harness.run_cell(spec, args.seed, args.seconds, True,
                                   device=args.device)
    res = {"workload": args.workload, "seed": args.seed,
           "correct": harness.verdict(harness.judge(run, stream))}
    res.update(breakdown(run, spec))
    res["metrics"] = {k: v["value"]
                      for k, v in harness.read_metrics(run).items()}
    res["wall_s"] = time.perf_counter() - t0
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    return 0 if res["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
