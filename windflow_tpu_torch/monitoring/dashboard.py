"""Minimal dashboard server: receives the framed TCP protocol.

The reference's dashboard directory is empty in its snapshot (a Java
Spring + React app upstream, README "Web Dashboard"); the wire protocol
is fully specified by monitoring.hpp (SURVEY.md §3.5).  This module
provides a self-contained receiver speaking that protocol so traced
graphs have somewhere to report: it stores the latest stats per app and
can serve them as JSON over HTTP for any front-end.

Run standalone:  python -m windflow_tpu_torch.monitoring.dashboard
(ingest on :20207, HTTP snapshot on :20208/apps)
"""
from __future__ import annotations

import json
import socket
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict


class DashboardServer(threading.Thread):
    """Accepts many apps; keeps per-app diagram + latest report."""

    def __init__(self, host: str = "127.0.0.1", port: int = 20207):
        super().__init__(name="windflow-dashboard", daemon=True)
        self.server = socket.create_server((host, port))
        # the accept timeout is set here, before the thread starts: a
        # server stopped right after start() closes the socket, and a
        # settimeout in run() would then fail on the closed descriptor
        self.server.settimeout(0.5)
        self.port = self.server.getsockname()[1]
        self.lock = threading.Lock()
        self.apps: Dict[int, dict] = {}
        self._next_id = 1
        self._stop_evt = threading.Event()

    # -- framed protocol (mirror of monitoring.hpp:232-313) ---------------
    @staticmethod
    def _recv_exact(conn, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("peer closed")
            buf += chunk
        return buf

    def _serve_conn(self, conn) -> None:
        app_id = None
        try:
            with conn:
                mtype, length = struct.unpack(
                    "<ii", self._recv_exact(conn, 8))
                if mtype != 0:
                    return
                diagram = self._recv_exact(conn, length).decode(
                    errors="replace")
                with self.lock:
                    app_id = self._next_id
                    self._next_id += 1
                    self.apps[app_id] = {"diagram": diagram, "report": None,
                                         "reports_received": 0,
                                         "active": True}
                conn.sendall(struct.pack("<i", app_id))
                while True:
                    mtype, aid, length = struct.unpack(
                        "<iii", self._recv_exact(conn, 12))
                    if mtype == 2:
                        with self.lock:
                            if aid in self.apps:
                                self.apps[aid]["active"] = False
                        return
                    payload = self._recv_exact(conn, length)
                    with self.lock:
                        if aid in self.apps:
                            try:
                                self.apps[aid]["report"] = json.loads(payload)
                            except json.JSONDecodeError:
                                pass
                            self.apps[aid]["reports_received"] += 1
        except (ConnectionError, OSError, struct.error):
            if app_id is not None:
                with self.lock:
                    if app_id in self.apps:
                        self.apps[app_id]["active"] = False

    def run(self) -> None:
        while not self._stop_evt.is_set():
            try:
                conn, _ = self.server.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def stop(self) -> None:
        self._stop_evt.set()
        self.server.close()
        if self.ident is not None:  # never started: nothing to join
            self.join(timeout=2)

    def snapshot(self) -> dict:
        with self.lock:
            return json.loads(json.dumps(self.apps))


def serve_http(dash: DashboardServer, port: int = 20208, server=None):
    """Expose the dashboard over HTTP: the self-contained HTML
    front-end at ``/`` (webui.py -- the React-dashboard equivalent),
    the registered-apps index at ``/index`` (one row per app with its
    per-app links, so a multi-tenant operator discovers tenants
    without knowing names a priori), the OpenMetrics text exposition
    at ``/metrics`` (telemetry/metrics.py -- point a Prometheus
    scraper here and every traced graph's counters and latency
    histograms come along), the diagnosis surfaces at ``/flight``
    (per-app FlightRecorder ring, as shipped inside the monitor
    reports -- reachable without a stall or crash triggering a JSONL
    dump) and ``/explain`` (per-app doctor report, the same pure fold
    as ``PipeGraph.explain()`` and the doctor CLI), the serving
    plane's ``/tenants`` view (per-app ``Tenant`` blocks, plus the
    hosting Server's Tenants block when ``server`` is given), and the
    JSON state at ``/apps`` (and any other path, kept permissive for
    curl users).  ``/apps``, ``/explain`` and ``/flight`` accept an
    ``?app=<id>`` filter.  ``port=0`` binds an ephemeral port (read it
    back from ``httpd.server_address``)."""

    class Handler(BaseHTTPRequestHandler):
        def _filtered(self):
            """Dashboard snapshot, narrowed by ?app=<id> when given."""
            from urllib.parse import parse_qs, urlsplit
            snap = dash.snapshot()
            qs = parse_qs(urlsplit(self.path).query)
            wanted = qs.get("app")
            if wanted:
                snap = {aid: app for aid, app in snap.items()
                        if str(aid) in wanted}
            return snap

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path in ("/", "/index.html"):
                from .webui import HTML_PAGE
                body = HTML_PAGE.encode()
                ctype = "text/html; charset=utf-8"
            elif path == "/index":
                # registered-apps index: discovery endpoint for
                # multi-tenant operators -- every app with its name,
                # tenant identity (when served) and per-app links
                snap = dash.snapshot()
                out = {}
                for aid, app in sorted(snap.items(),
                                       key=lambda kv: str(kv[0])):
                    if not isinstance(app, dict):
                        continue
                    rep = app.get("report") or {}
                    out[str(aid)] = {
                        "graph": rep.get("PipeGraph_name"),
                        "active": bool(app.get("active")),
                        "tenant": rep.get("Tenant"),
                        "links": {
                            "apps": f"/apps?app={aid}",
                            "explain": f"/explain?app={aid}",
                            "flight": f"/flight?app={aid}",
                            "metrics": "/metrics",
                        },
                    }
                body = json.dumps(out).encode()
                ctype = "application/json"
            elif path == "/tenants":
                # serving plane: per-app Tenant blocks (+ the hosting
                # Server's own Tenants view when one is attached)
                snap = dash.snapshot()
                tenants = {}
                for aid, app in sorted(snap.items(),
                                       key=lambda kv: str(kv[0])):
                    if not isinstance(app, dict):
                        continue
                    rep = app.get("report") or {}
                    if rep.get("Tenant"):
                        tenants[str(aid)] = dict(
                            rep["Tenant"],
                            graph=rep.get("PipeGraph_name"),
                            active=bool(app.get("active")))
                out = {"apps": tenants}
                if server is not None:
                    out["server"] = server.stats()
                body = json.dumps(out).encode()
                ctype = "application/json"
            elif path == "/metrics":
                from ..telemetry.metrics import (CONTENT_TYPE,
                                                 render_openmetrics)
                body = render_openmetrics(dash.snapshot()).encode()
                ctype = CONTENT_TYPE
            elif path == "/flight":
                snap = self._filtered()
                body = json.dumps({
                    str(aid): (app.get("report") or {}).get("Flight") or []
                    for aid, app in snap.items()
                    if isinstance(app, dict)}).encode()
                ctype = "application/json"
            elif path == "/cluster":
                # live cluster view (docs/OBSERVABILITY.md): fold every
                # registered app's latest report with merge_stats --
                # the workers of one distributed run each register as
                # an app carrying a Worker id, so the fold is the same
                # one-graph view the coordinator's ClusterObserver
                # serves (and `doctor --watch` polls either endpoint)
                from ..diagnosis.report import build_report
                from ..distributed.observe import merge_stats
                snap = dash.snapshot()
                reports = []
                for aid, app in sorted(snap.items(),
                                       key=lambda kv: str(kv[0])):
                    if not isinstance(app, dict) or not app.get("report"):
                        continue
                    rep = dict(app["report"])
                    if rep.get("Worker") is None:
                        # single-process apps carry no worker id; give
                        # each a distinct pseudo-id so the merge's
                        # (worker, seq) flight dedup cannot collide
                        # two unrelated graphs' per-process seqs
                        rep["Worker"] = f"app{aid}"
                    reports.append(rep)
                # live=True: these are mid-run snapshots captured at
                # different instants -- merge-time wire imbalances are
                # skew, not loss (online detectors own live loss)
                merged = merge_stats(reports, live=True)
                rep = build_report(merged, merged.get("Flight")) \
                    if merged else None
                body = json.dumps({"merged": merged,
                                   "report": rep}).encode()
                ctype = "application/json"
            elif path == "/explain":
                from ..diagnosis.report import build_report
                snap = self._filtered()
                out = {}
                for aid, app in snap.items():
                    if isinstance(app, dict) and app.get("report"):
                        out[str(aid)] = build_report(app["report"])
                body = json.dumps(out).encode()
                ctype = "application/json"
            else:
                body = json.dumps(self._filtered()).encode()
                ctype = "application/json"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


if __name__ == "__main__":
    dash = DashboardServer()
    dash.start()
    serve_http(dash)
    print(f"windflow dashboard: ingest :{dash.port}, http :20208/apps")
    dash.join()
