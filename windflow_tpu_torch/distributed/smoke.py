"""Two-process localhost smoke of the distributed runtime::

    python -m windflow_tpu_torch.distributed.smoke [n_tuples]
    python -m windflow_tpu_torch.distributed.smoke --live [n_tuples]

Default mode builds a tiny keyed pipeline (source -> KEYBY accumulator
-> sink), runs it once in-process and once as a real 2-worker run over
the shuffle transport, and asserts the distributed results are
identical and every wire edge balanced.

``--live`` smokes the mission-control plane (docs/OBSERVABILITY.md
"Live cluster view" / "SLO plane"): a 2-worker run with a deliberately
slow REMOTE operator is polled MID-RUN through the coordinator's
ClusterObserver ``/cluster`` endpoint -- zero stats files read -- and
the exit asserts the live merged doctor verdict named the remote
bottleneck (worker-annotated) and an ``slo_breach`` episode opened
within seconds of onset; then ``doctor --watch --once`` renders the
same view through the CLI.  CI runs both modes in both channel-plane
jobs; exit 0 == the zero-to-distributed(-and-observed) path works on
this box.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile

N_KEYS = 8


def _records(n):
    # absolute import: under ``python -m`` this module is __main__ and
    # the workers re-load it straight from the source file, where a
    # relative import has no package context
    from windflow_tpu_torch.core.tuples import BasicRecord
    for i in range(n):
        yield BasicRecord(i % N_KEYS, i // N_KEYS, i, float(i % 13))


def _build_ops(g, n, sink_fn):
    import windflow_tpu_torch as wf

    it = iter(_records(n))

    def src(shipper):
        for rec in it:
            shipper.push(rec)
            return True
        return False

    def fold(t, acc):
        acc.value += t.value

    g.add_source(wf.SourceBuilder(src).with_name("smoke_src").build()) \
        .add(wf.AccumulatorBuilder(fold).with_name("smoke_fold")
             .with_parallelism(2).build()) \
        .add_sink(wf.SinkBuilder(sink_fn).with_name("smoke_sink").build())
    return g


def smoke_build(g):
    """Worker-side build (imported by both worker processes)."""
    n = int(os.environ.get("WINDFLOW_SMOKE_N", "20000"))
    out_path = os.environ["WINDFLOW_SMOKE_OUT"]
    out = []

    def sink(rec):
        if rec is None:
            with open(out_path, "w") as f:
                json.dump(sorted(out), f)
        else:
            out.append([rec.key, rec.id, rec.value])

    _build_ops(g, n, sink)


def _local_run(n):
    import windflow_tpu_torch as wf
    out = []

    def sink(rec):
        if rec is not None:
            out.append([rec.key, rec.id, rec.value])

    g = wf.PipeGraph("smoke_local")
    _build_ops(g, n, sink)
    g.run()
    return sorted(out)


def live_build(g):
    """Worker-side build of the --live mode: fast source -> KEYBY
    deliberately slow map (the partition planner cuts at the KEYBY
    edge, so the slow operator lands on the REMOTE worker) -> sink."""
    import time

    import windflow_tpu_torch as wf
    from windflow_tpu_torch.core.tuples import BasicRecord
    n = int(os.environ.get("WINDFLOW_SMOKE_N", "6000"))
    it = iter(range(n))

    def src(shipper):
        for i in it:
            shipper.push(BasicRecord(i % N_KEYS, i // N_KEYS, i,
                                     float(i % 13)))
            return True
        return False

    def slow(t):
        time.sleep(0.001)
        return t

    seen = []

    def sink(rec):
        if rec is not None:
            seen.append(1)

    g.add_source(wf.SourceBuilder(src).with_name("live_src").build()) \
        .add(wf.MapBuilder(slow).with_name("live_slow")
             .with_key_by().build()) \
        .add_sink(wf.SinkBuilder(sink).with_name("live_sink").build())


def live_config(worker_id):
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.slo import SloConfig
    # traced (e2e p99 observable), a hopelessly tight p99 budget so the
    # slow operator burns the error budget immediately, fast diagnosis
    # ticks so detection rides a sub-second cadence
    return wf.RuntimeConfig(
        tracing=True, trace_sample=16, diagnosis_interval_s=0.2,
        slo=SloConfig(p99_ms=0.5, target=0.9, fast_burn=5.0),
        log_dir=os.environ.get("WINDFLOW_SMOKE_LOG", "log"))


def _live_main(n: int) -> int:
    from windflow_tpu_torch.distributed.runtime import run_distributed
    with tempfile.TemporaryDirectory(
            prefix="windflow_live_smoke_") as td:
        return _live_run(td, n, run_distributed)


def _live_run(td: str, n: int, run_distributed) -> int:
    import threading
    import time
    import urllib.request
    workdir = os.path.join(td, "work")
    os.environ["WINDFLOW_SMOKE_N"] = str(n)
    os.environ["WINDFLOW_SMOKE_LOG"] = os.path.join(td, "log")
    box = {}

    def runner():
        try:
            box["report"] = run_distributed(
                live_build, n_workers=2, config_fn=live_config,
                graph_name="live_smoke", workdir=workdir,
                timeout_s=240.0)
        except BaseException as e:  # surfaced after the poll loop
            box["error"] = e

    t = threading.Thread(target=runner, daemon=True)
    t.start()
    # find the observer endpoint (written by the coordinator), then
    # poll /cluster until the live merged verdict names the remote
    # bottleneck AND an slo_breach episode is open -- all MID-RUN,
    # reading zero stats files
    obs_path = os.path.join(workdir, "observer.json")
    deadline = time.monotonic() + 120.0
    url = None
    while url is None and time.monotonic() < deadline:
        try:
            with open(obs_path) as f:
                url = json.load(f)["http"] + "/cluster"
        except (OSError, ValueError, KeyError):
            time.sleep(0.1)
    if url is None:
        print("live smoke: observer endpoint never appeared",
              file=sys.stderr)
        return 1
    named_at = breach_at = None
    onset = time.monotonic()
    while (named_at is None or breach_at is None) \
            and time.monotonic() < deadline and t.is_alive():
        time.sleep(0.25)
        try:
            with urllib.request.urlopen(url, timeout=5) as r:
                doc = json.loads(r.read().decode())
        except (OSError, ValueError):
            continue
        merged = doc.get("merged") or {}
        rep = doc.get("report") or {}
        bn = rep.get("Bottleneck") or {}
        ops = {op.get("Operator_name"): op.get("Worker")
               for op in merged.get("Operators") or ()}
        if named_at is None and bn.get("Operator") \
                and "live_slow" in bn["Operator"] \
                and ops.get(bn["Operator"]) is not None \
                and ops.get("pipe0/live_src") is not None \
                and ops[bn["Operator"]] != ops["pipe0/live_src"]:
            named_at = time.monotonic()
        if breach_at is None and any(
                e.get("kind") == "slo_breach"
                for e in merged.get("Flight") or ()):
            breach_at = time.monotonic()
    mid_run = t.is_alive()
    # the CLI's watch mode against the SAME live endpoint, while the
    # run is still going (one refresh; the in-place loop is the same
    # code path)
    from windflow_tpu_torch.doctor import main as doctor_main
    watch_rc = doctor_main(["--watch", url, "--once"]) if mid_run else 0
    t.join(timeout=240.0)
    if "error" in box:
        print(f"live smoke: run failed: {box['error']}", file=sys.stderr)
        return 1
    if named_at is None or breach_at is None or watch_rc != 0:
        print(f"live smoke: FAILED -- remote bottleneck named: "
              f"{named_at is not None}, slo_breach seen: "
              f"{breach_at is not None}, watch rc={watch_rc} "
              f"(mid_run={mid_run})",
              file=sys.stderr)
        return 1
    rep = box["report"]
    rc = doctor_main([*rep["stats_paths"], "--merge"])
    if rc != 0:
        print("live smoke: doctor --merge failed", file=sys.stderr)
        return 1
    slo = (rep.get("live_merged") or {}).get("Slo") or {}
    print(f"live smoke: OK -- remote bottleneck named live in "
          f"{named_at - onset:.1f}s, slo_breach in "
          f"{breach_at - onset:.1f}s (mid_run={mid_run}, "
          f"budget {slo.get('Budget_burned', 0) * 100:.0f}% burned)")
    return 0


def main(argv=None) -> int:
    from windflow_tpu_torch.distributed.observe import check_wire_conservation
    from windflow_tpu_torch.distributed.runtime import run_distributed
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--live":
        return _live_main(int(argv[1]) if len(argv) > 1 else 8000)
    n = int(argv[0]) if argv else 20000
    expect = _local_run(n)
    with tempfile.TemporaryDirectory() as td:
        out_path = os.path.join(td, "smoke_out.json")
        os.environ["WINDFLOW_SMOKE_N"] = str(n)
        os.environ["WINDFLOW_SMOKE_OUT"] = out_path
        report = run_distributed(smoke_build, n_workers=2,
                                 graph_name="smoke",
                                 workdir=os.path.join(td, "work"),
                                 timeout_s=120.0)
        with open(out_path) as f:
            got = json.load(f)
        violations = check_wire_conservation(report["worker_stats"])
        wire = (report["merged"].get("Wire") or {}).get("Edges") or []
        if got != expect:
            print(f"smoke: MISMATCH ({len(got)} vs {len(expect)} rows)",
                  file=sys.stderr)
            return 1
        if violations or not all(r["balanced"] for r in wire):
            print(f"smoke: wire imbalance {violations}", file=sys.stderr)
            return 1
    print(f"smoke: OK -- {n} tuples, {len(expect)} sink rows bitwise "
          f"equal across 2 workers; {len(wire)} wire edge(s) balanced")
    return 0


if __name__ == "__main__":
    sys.exit(main())
