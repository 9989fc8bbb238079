"""The doctor CLI: render the diagnosis report away from the code
(docs/OBSERVABILITY.md "Diagnosis plane").

    python -m windflow_tpu_torch.doctor http://127.0.0.1:20208
    python -m windflow_tpu_torch.doctor log/
    python -m windflow_tpu_torch.doctor log/1234_app_stats.json
    python -m windflow_tpu_torch.doctor log/ --json
    python -m windflow_tpu_torch.doctor --watch http://127.0.0.1:41234

* **URL** -- a live dashboard HTTP server (monitoring/dashboard.py):
  fetches ``/apps`` and renders one report per registered app (the
  server-side ``/explain`` endpoint returns the same reports as JSON).
* **--watch URL** -- live CLUSTER mode (docs/OBSERVABILITY.md "Live
  cluster view"): polls the ``/cluster`` endpoint (the coordinator's
  ClusterObserver, or a dashboard HTTP server) every ``--interval``
  seconds and refreshes the MERGED doctor verdict in place -- a
  bottleneck on a remote worker is named mid-run with zero stats
  files read.  ``--once`` renders a single refresh (CI smoke).
* **directory** -- an offline dump dir: picks the newest stats-JSON
  dump (the monitor's ``*_stats.json`` snapshot fallback or
  ``PipeGraph._dump_logs``'s ``<pid>_<graph>.json``) and, when a
  matching ``*_flight.jsonl`` post-mortem dump sits next to it, folds
  its events in.
* **file** -- one stats-JSON dump.

The loader is schema-tolerant by contract: every block is optional
(``Schema_version`` is informational), so dumps from older runtimes
still render -- with the bottleneck walk and attribution recomputed
from ``Operators``/``Trace_records`` when no precomputed ``Diagnosis``
block exists.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Tuple

from .diagnosis.report import build_report, render_text


def _load_flight_jsonl(path: str) -> List[dict]:
    events = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    continue  # torn tail line of a crash dump
    except OSError:
        pass
    return events


def _newest(paths: List[str]) -> Optional[str]:
    best, best_mt = None, -1.0
    for p in paths:
        try:
            mt = os.path.getmtime(p)
        except OSError:
            continue
        if mt > best_mt:
            best, best_mt = p, mt
    return best


def _find_dump(d: str) -> Tuple[Optional[str], Optional[str]]:
    """Newest stats-JSON dump in ``d`` plus its sibling flight JSONL
    (matched by the ``<pid>_<graph>`` prefix when possible, else the
    newest one)."""
    stats_paths, flight_paths = [], []
    try:
        names = os.listdir(d)
    except OSError:
        return None, None
    for n in names:
        p = os.path.join(d, n)
        if n.endswith("_flight.jsonl"):
            flight_paths.append(p)
        elif n.endswith(".json") and not n.endswith("_runtime.json"):
            stats_paths.append(p)
    stats = _newest(stats_paths)
    if stats is None:
        return None, None
    base = os.path.basename(stats)
    prefix = base[:-len("_stats.json")] if base.endswith("_stats.json") \
        else base[:-len(".json")]
    sib = os.path.join(d, prefix + "_flight.jsonl")
    flight = sib if sib in flight_paths else _newest(flight_paths)
    return stats, flight


def load_stats(target: str) -> List[Tuple[str, dict, Optional[list]]]:
    """Resolve ``target`` (file or directory) into
    ``[(label, stats_dict, flight_events_or_None)]``.  Tolerant: a
    malformed or partial dump raises ValueError with the path named."""
    if os.path.isdir(target):
        stats_path, flight_path = _find_dump(target)
        if stats_path is None:
            raise ValueError(f"no stats-JSON dump under {target!r}")
    else:
        stats_path, flight_path = target, None
        guess = target[:-len(".json")] if target.endswith(".json") else target
        if guess.endswith("_stats"):
            guess = guess[:-len("_stats")]
        cand = guess + "_flight.jsonl"
        if os.path.exists(cand):
            flight_path = cand
    try:
        with open(stats_path) as f:
            stats = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(f"unreadable stats dump {stats_path!r}: {e}")
    if not isinstance(stats, dict):
        raise ValueError(f"{stats_path!r} is not a stats-JSON object")
    flight = _load_flight_jsonl(flight_path) if flight_path else None
    return [(stats_path, stats, flight)]


def fetch_reports(url: str) -> List[Tuple[str, dict, Optional[list]]]:
    """Pull ``/apps`` from a live dashboard HTTP server and return one
    (label, stats, flight) triple per app that has reported."""
    import urllib.request
    base = url.rstrip("/")
    with urllib.request.urlopen(base + "/apps", timeout=5) as r:
        apps = json.loads(r.read().decode())
    out = []
    for aid in sorted(apps, key=str):
        app = apps[aid]
        if not isinstance(app, dict):
            continue
        rep = app.get("report")
        if rep:
            out.append((f"app {aid}", rep, rep.get("Flight")))
    if not out:
        raise ValueError(f"no reporting apps at {base}/apps")
    return out


def fetch_cluster(url: str) -> Tuple[dict, dict]:
    """Pull one ``/cluster`` snapshot: ``(merged_stats, meta)``.  The
    report is re-derived locally from the merged stats (the tolerant-
    loading contract applies to the live endpoint too)."""
    import urllib.request
    with urllib.request.urlopen(url, timeout=5) as r:
        doc = json.loads(r.read().decode())
    merged = doc.get("merged") or {}
    meta = {"workers": doc.get("workers"), "pushes": doc.get("pushes"),
            "now": doc.get("now")}
    return merged, meta


def _watch_url(target: str) -> str:
    base = target if target.startswith(("http://", "https://")) \
        else "http://" + target
    base = base.rstrip("/")
    return base if base.endswith("/cluster") else base + "/cluster"


def watch(target: str, interval_s: float = 2.0, once: bool = False,
          as_json: bool = False) -> int:
    """The ``--watch`` loop: poll the merged cluster view and refresh
    the verdict in place (clears the screen on a tty; plain appends
    otherwise, so piping to a file keeps every refresh)."""
    import time
    url = _watch_url(target)
    seen_any = False
    while True:
        try:
            merged, meta = fetch_cluster(url)
        except (OSError, ValueError) as e:
            if once and not seen_any:
                print(f"doctor: cannot reach {url}: {e}",
                      file=sys.stderr)
                return 2
            merged, meta = None, None
        out: List[str] = []
        if merged:
            seen_any = True
            rep = build_report(merged, merged.get("Flight"))
            rep["Source"] = url
            if as_json:
                out.append(json.dumps(rep, indent=1))
            else:
                n_workers = len((meta or {}).get("workers") or {})
                out.append(f"-- live cluster view {url} "
                           f"({n_workers} worker(s), "
                           f"{(meta or {}).get('pushes', 0)} pushes) --")
                out.append(render_text(rep))
        else:
            out.append(f"-- waiting for worker pushes at {url} --")
        if sys.stdout.isatty() and not as_json:
            sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
        print("\n".join(out), flush=True)
        if once:
            return 0
        try:
            time.sleep(max(0.1, interval_s))
        except KeyboardInterrupt:
            return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m windflow_tpu_torch.doctor",
        description="Render the diagnosis report of a live dashboard "
                    "endpoint or an offline stats/flight dump.")
    ap.add_argument("targets", nargs="+",
                    help="dashboard URL (http://host:port), a dump "
                         "directory, or stats-JSON file(s); several "
                         "files with --merge fold into one report")
    ap.add_argument("--json", action="store_true",
                    help="emit the structured report as JSON instead "
                         "of text")
    ap.add_argument("--merge", action="store_true",
                    help="merge multiple per-worker stats dumps of one "
                         "distributed run into ONE graph view "
                         "(distributed/observe.py) before reporting")
    ap.add_argument("--watch", action="store_true",
                    help="live cluster mode: poll the target's "
                         "/cluster endpoint and refresh the merged "
                         "verdict in place")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="seconds between --watch refreshes")
    ap.add_argument("--once", action="store_true",
                    help="with --watch: render a single refresh and "
                         "exit (smoke tests)")
    args = ap.parse_args(argv)
    if args.watch:
        if len(args.targets) != 1:
            print("doctor: --watch takes exactly one URL",
                  file=sys.stderr)
            return 2
        return watch(args.targets[0], args.interval, args.once,
                     args.json)
    try:
        urls = [t for t in args.targets
                if t.startswith(("http://", "https://"))]
        if urls and (args.merge or len(args.targets) > 1):
            raise ValueError(
                "dashboard URLs take a single target without --merge "
                "(the server already aggregates its apps); offline "
                "merging works on stats-JSON files/directories")
        if args.merge:
            from .distributed.observe import merge_stats
            loaded = []
            for t in args.targets:
                loaded.extend(load_stats(t))
            merged = merge_stats([s for _l, s, _f in loaded])
            triples = [("merged:" + ",".join(l for l, _s, _f in loaded),
                        merged, merged.get("Flight"))]
        elif len(args.targets) > 1:
            triples = []
            for t in args.targets:
                triples.extend(load_stats(t))
        elif urls:
            triples = fetch_reports(args.targets[0])
        else:
            triples = load_stats(args.targets[0])
    except (ValueError, OSError) as e:
        print(f"doctor: {e}", file=sys.stderr)
        return 2
    reports = []
    for label, stats, flight in triples:
        rep = build_report(stats, flight)
        rep["Source"] = label
        reports.append(rep)
    if args.json:
        print(json.dumps(reports if len(reports) > 1 else reports[0],
                         indent=1))
    else:
        for i, rep in enumerate(reports):
            if i:
                print()
            print(f"[{rep['Source']}]")
            print(render_text(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
