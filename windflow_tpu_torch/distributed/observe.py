"""Cross-worker observability: merge per-worker stats into one graph
view -- offline from dumps, and LIVE over a side socket
(docs/DISTRIBUTED.md "One graph view", docs/OBSERVABILITY.md "Live
cluster view").

Each worker of a distributed run reports exactly like a single-process
graph -- same stats JSON, same Conservation/Diagnosis/Wire blocks,
plus a ``Worker`` id -- and this module folds N such dumps into the
ONE report the operator actually wants:

* **operators** concatenate (every operator lives on exactly one
  worker; its rows carry the worker id);
* **topology** edges union, including the ``wire`` edges each
  producer-side worker recorded, so the bottleneck walk crosses the
  process boundary and can name an operator on a REMOTE worker;
* the **cross-process conservation identity**: every wire edge's
  producer-side book (tuples/frames sent) must equal the consumer-side
  book (delivered) -- with per-worker ledgers already balanced
  per-edge, the composition proves end-to-end transport conservation;
  any shortfall is reported with the exact edge and tuple count;
* trace records concatenate, so the merged attribution charges the
  ``wire`` hop class alongside service/queueing/device.

``build_report`` (diagnosis/report.py) accepts the merged dict as-is:
the per-worker ``Diagnosis`` blocks are folded into their recompute
inputs (sustained-depth union), so the bottleneck/attribution are
re-derived over the whole graph rather than per partition.

Two further folds make the merged view *cluster-true*:

* **trace stitching** -- a trace that crosses a wire edge leaves a
  producer-side *partial* record (hops up to and past the send,
  flagged ``partial`` with the shared trace id) and a consumer-side
  *closed* record (the full rebuilt span).  :func:`stitch_traces`
  joins the per-worker records by id into single e2e records: the
  closed record is the base, producer-only hops (stamped after the
  frame header snapshot -- fused segments unwind outward) merge in,
  and the redundant fragments drop -- so the merged attribution
  charges every class exactly once and ``Share_sum`` stays ~1.0;
* **flight dedup** -- every flight event carries a per-process ``seq``
  (telemetry/recorder.py); folding overlapping per-worker rings (live
  pushes resend unacked tails, offline dumps may overlap snapshots)
  dedups by ``(worker, seq)`` so one episode never appears twice.

The LIVE half: each worker runs a :class:`StatsPusher` (attached by
the distributed wiring when the spec names an observe endpoint) that
pushes its stats JSON plus a bounded flight-delta frame to the
coordinator's :class:`ClusterObserver` over a cheap side socket; the
observer folds the latest per-worker states with ``merge_stats``
continuously and serves the merged view (plus its doctor report) at
HTTP ``GET /cluster`` -- which is what ``python -m windflow_tpu_torch.doctor
--watch <addr>`` polls.  A remote bottleneck is therefore nameable
mid-run with zero stats files read.
"""
from __future__ import annotations

import json
import struct
import threading
import time as _time
from collections import deque
from typing import Dict, List, Optional, Tuple

MAX_TRACES = 128
MAX_FLIGHT = 256
MAX_EDGE_ROWS = 128
# flight events kept per worker by the live observer
OBSERVER_FLIGHT_KEEP = 512
# flight-delta events shipped per push frame (bounded like the ring)
PUSH_FLIGHT_MAX = 256
# push frame: [u32 len][json]
_PUSH_HEADER = struct.Struct("<I")
_PUSH_MAX_BYTES = 1 << 26


def wire_table(stats_list: List[dict]) -> List[dict]:
    """Per-wire-edge cross-process delivery books: producer-side sums
    vs consumer-side sums."""
    sent: Dict[str, dict] = {}
    got: Dict[str, dict] = {}
    for stats in stats_list:
        wire = (stats or {}).get("Wire") or {}
        w = wire.get("Worker")
        for row in wire.get("out") or ():
            agg = sent.setdefault(row["edge"], {
                "tuples": 0, "frames": 0, "barriers": 0,
                "dropped_frames": 0, "unacked": 0, "from": []})
            agg["tuples"] += int(row.get("tuples", 0) or 0)
            agg["frames"] += int(row.get("frames", 0) or 0)
            agg["barriers"] += int(row.get("barriers", 0) or 0)
            agg["dropped_frames"] += int(row.get("dropped_frames", 0)
                                         or 0)
            # TUPLE sum of the replay buffer (frames != tuples on the
            # batch plane); rows from older runtimes carry neither
            # field and fold as 0 -> the strict identity applies
            agg["unacked"] += int(row.get("unacked_tuples", 0) or 0)
            agg["from"].append(w)
        for row in wire.get("in") or ():
            agg = got.setdefault(row["edge"], {
                "tuples": 0, "frames": 0, "barriers": 0, "gaps": 0,
                "on": w})
            agg["tuples"] += int(row.get("tuples", 0) or 0)
            agg["frames"] += int(row.get("frames", 0) or 0)
            agg["barriers"] += int(row.get("barriers", 0) or 0)
            agg["gaps"] += int(row.get("gaps", 0) or 0)
    rows = []
    for edge in sorted(set(sent) | set(got)):
        s = sent.get(edge) or {}
        g = got.get(edge) or {}
        st, gt = int(s.get("tuples", 0)), int(g.get("tuples", 0))
        # a LIVE fold (cluster observer pushes) legitimately sees
        # tuples in flight: sent counts them, delivered does not, and
        # the sender's unacked replay buffer bounds exactly how many --
        # a SHORTFALL within that bound is "settling", not a loss
        # (over-delivery never is: gt > st is flagged regardless).
        # Offline (post-flush) the buffer is empty and the old strict
        # identity applies.
        unacked = int(s.get("unacked", 0) or 0)
        rows.append({
            "edge": edge,
            "from_workers": sorted(x for x in s.get("from", [])
                                   if x is not None),
            "on_worker": g.get("on"),
            "tuples_sent": st, "tuples_delivered": gt,
            "frames_sent": int(s.get("frames", 0)),
            "frames_delivered": int(g.get("frames", 0)),
            "barriers_sent": int(s.get("barriers", 0)),
            "barriers_delivered": int(g.get("barriers", 0)),
            "dropped_frames": int(s.get("dropped_frames", 0)),
            "gaps": int(g.get("gaps", 0)),
            "in_flight": unacked,
            "missing_tuples": max(0, st - gt - unacked),
            "extra_tuples": max(0, gt - st),
            "settling": gt < st <= gt + unacked,
            "balanced": st == gt,
        })
    return rows


def stitch_traces(traces: List[dict]) -> List[dict]:
    """Join per-worker trace records by trace id into single e2e
    records (module docstring).  Records without an id (pre-stitching
    runtimes) pass through untouched; groups with no closed record
    keep their longest fragment (still flagged ``partial``, so
    attribution keeps skipping it)."""
    by_id: Dict[str, List[dict]] = {}
    out: List[dict] = []
    for rec in traces:
        if not isinstance(rec, dict):
            continue
        tid = rec.get("id")
        if not tid:
            out.append(rec)
            continue
        by_id.setdefault(tid, []).append(rec)
    for tid, group in by_id.items():
        closed = [r for r in group if not r.get("partial")]
        workers = sorted({r.get("worker") for r in group
                          if r.get("worker") is not None})
        if not closed:
            # the closing sink record fell off its worker's bounded
            # ring: keep one fragment for display, still partial
            out.append(max(group, key=lambda r: r.get("e2e_ms") or 0.0))
            continue
        base = dict(max(closed, key=lambda r: r.get("e2e_ms") or 0.0))
        names = {h[0] for h in base.get("hops") or ()
                 if isinstance(h, (list, tuple)) and h}
        extra = []
        for r in group:
            if r.get("partial"):
                for h in r.get("hops") or ():
                    try:
                        name = h[0]
                    except (TypeError, IndexError):
                        continue
                    if name not in names:
                        names.add(name)
                        extra.append(list(h))
        if extra:
            # hop offsets share the logical span start (the consumer
            # rebuilt t0 from the shipped age + wall send stamp), so
            # fragments merge positionally; attribution clamps any
            # residual clock-estimate skew into [0, e2e]
            hops = [list(h) for h in base.get("hops") or ()] + extra
            hops.sort(key=lambda h: (h[1:2] or [0.0])[0])
            base["hops"] = hops
            base["stitched"] = True
        if len(workers) > 1:
            base["workers"] = workers
        out.append(base)
    return out


def merge_stats(stats_list: List[dict], live: bool = False) -> dict:
    """Fold per-worker stats dicts into one graph view (see module
    docstring).  Tolerant: blocks are optional per worker, like every
    stats-JSON reader in the repo.

    ``live=True`` marks a fold of UNSYNCHRONIZED mid-run snapshots
    (the cluster observer's continuous merge): the producer's and
    consumer's books were captured at different instants, so a
    shortfall beyond the sender's replay buffer is snapshot skew, not
    evidence -- the merge then never *synthesizes* a wire-loss
    violation of its own (the per-worker ONLINE detectors -- receiver
    sequence gaps + the sender's STATS trailer -- remain the
    authoritative live loss reporters and their violations still fold
    in).  Offline (the default: settled post-run dumps) the strict
    identity applies."""
    stats_list = [s for s in stats_list if isinstance(s, dict)]
    if not stats_list:
        return {}
    first = stats_list[0]
    operators: List[dict] = []
    edges_seen = set()
    topology: List[List[str]] = []
    traces: List[dict] = []
    flight: List[dict] = []
    cons_rows: List[dict] = []
    violations: List[dict] = []
    sustained: Dict[str, float] = {}
    qcap: Optional[int] = None
    sums = {"Dropped_tuples": 0, "Svc_failures": 0,
            "Dead_letter_tuples": 0, "Shed_tuples": 0}
    edges_balanced = True
    final_check = True
    committed: Optional[int] = None
    workers: List[dict] = []
    slo_blocks: List[dict] = []
    pool_blocks: List[dict] = []
    sched_blocks: List[dict] = []
    flight_seen = set()
    for stats in stats_list:
        w = stats.get("Worker")
        workers.append({"Worker": w,
                        "PipeGraph_name": stats.get("PipeGraph_name")})
        for op in stats.get("Operators") or ():
            row = dict(op)
            row["Worker"] = w
            operators.append(row)
        topo = (stats.get("Topology") or {}).get("Edges") or []
        for e in topo:
            key = tuple(e[:2])
            if key not in edges_seen:
                edges_seen.add(key)
                topology.append(list(e))
        for rec in stats.get("Trace_records") or ():
            if isinstance(rec, dict):
                rec = dict(rec)
                rec.setdefault("worker", w)
            traces.append(rec)
        for ev in stats.get("Flight") or ():
            # dedup by (worker, seq): overlapping flight tails (live
            # pushes resend unacked deltas, offline snapshot dumps may
            # overlap) must never duplicate an episode in the merged
            # view.  Events without a seq (older runtimes) pass
            # through undeduped.
            seq = ev.get("seq")
            if seq is not None:
                key = (w, seq)
                if key in flight_seen:
                    continue
                flight_seen.add(key)
            ev = dict(ev)
            ev.setdefault("worker", w)
            flight.append(ev)
        if stats.get("Slo"):
            slo_blocks.append(stats["Slo"])
        if stats.get("Pool"):
            pool_blocks.append(stats["Pool"])
        sched = stats.get("Scheduler")
        if isinstance(sched, dict):
            sched = dict(sched)
            sched.setdefault("Worker", w)
            sched_blocks.append(sched)
        for k in sums:
            sums[k] += int(stats.get(k, 0) or 0)
        cons = stats.get("Conservation")
        if cons:
            edges_balanced = edges_balanced \
                and bool(cons.get("Edges_balanced"))
            final_check = final_check and bool(cons.get("Final_check"))
            cons_rows.extend(cons.get("Edges") or ())
            for v in cons.get("Violations") or ():
                v = dict(v)
                v.setdefault("worker", w)
                violations.append(v)
        diag = stats.get("Diagnosis") or {}
        for k, v in (diag.get("Sustained_depth") or {}).items():
            sustained[k] = max(sustained.get(k, 0.0), float(v or 0.0))
        if diag.get("Queue_capacity"):
            qcap = max(qcap or 0, int(diag["Queue_capacity"]))
        dur = stats.get("Durability")
        if dur is not None:
            c = int(dur.get("Committed_epoch", 0) or 0)
            committed = c if committed is None else min(committed, c)
    wire_rows = wire_table(stats_list)
    for row in wire_rows:
        if row["balanced"]:
            continue
        if live:
            # snapshot skew / in-flight tuples between unsynchronized
            # pushes; the per-worker ONLINE detectors own live loss
            # reporting (their violations fold in above)
            continue
        # OFFLINE (settled dumps): the strict identity applies -- a
        # post-run unacked residue IS a loss (the flush timed out on
        # genuinely undelivered tuples), so "settling" never excuses
        # an imbalance here.  The consumer worker usually flagged the
        # loss online already (STATS-trailer check); synthesize a
        # violation only when no per-worker book carried it, so one
        # loss never counts twice in the merged report
        edges_balanced = False
        if not any(v.get("kind") == "lost_wire_delivery"
                   and v.get("edge") == row["edge"]
                   for v in violations):
            violations.append({
                "kind": "lost_wire_delivery", "edge": row["edge"],
                "count": abs(row["tuples_sent"]
                             - row["tuples_delivered"]),
                "frames": (row["frames_sent"]
                           - row["frames_delivered"]),
            })
    flight.sort(key=lambda e: e.get("t", 0))
    from ..slo.plane import merge_slo
    # stitch cross-worker traces by id BEFORE bounding, so a closed
    # record near the cut cannot lose its producer fragment
    traces = stitch_traces(traces)
    merged = {
        "PipeGraph_name": first.get("PipeGraph_name", "?"),
        "Schema_version": first.get("Schema_version"),
        "Merged_workers": workers,
        "Operators": operators,
        "Operator_number": len(operators),
        "Topology": {"Edges": topology} if topology else None,
        "Trace_records": traces[-MAX_TRACES:],
        "Flight": flight[-MAX_FLIGHT:],
        "Conservation": {
            "Edges_balanced": edges_balanced,
            "Final_check": final_check,
            "Violations_total": len(violations),
            "Violations": violations,
            "Edges": cons_rows[:MAX_EDGE_ROWS],
            # wire edges already appear as the sender-side
            # "wire:<consumer>" ledger rows; only count ones the
            # per-worker books somehow missed
            "Edges_total": len(cons_rows) + sum(
                1 for r in wire_rows
                if f"wire:{r['edge']}"
                not in {c.get("edge") for c in cons_rows}),
        },
        "Wire": {
            "Edges": wire_rows,
            "Balanced": all(r["balanced"] for r in wire_rows),
            # live folds: in-flight-bounded shortfalls are settling,
            # not lost -- the strict Balanced stays the offline truth
            "Settling": any(r["settling"] for r in wire_rows),
        },
        # recompute inputs only: bottleneck/attribution re-derive over
        # the merged operator set (diagnosis/report.py offline path)
        "Diagnosis": {
            "Sustained_depth": sustained,
            "Queue_capacity": qcap,
        } if (sustained or qcap) else None,
        "Durability": ({"Committed_epoch": committed}
                       if committed is not None else None),
        # SLO plane: worst news wins across the fleet (slo/plane.py)
        "Slo": merge_slo(slo_blocks),
        "Pool": ({
            "Buffers": sum(int(p.get("Buffers", 0) or 0)
                           for p in pool_blocks),
            "Bytes": sum(int(p.get("Bytes", 0) or 0)
                         for p in pool_blocks),
        } if pool_blocks else None),
        # scheduler plane (scheduler/): per-worker blocks kept whole
        # (placement is per-worker truth, never re-derived here) plus
        # the two fleet-level aggregates readers actually chart
        "Scheduler": ({
            "Workers": sched_blocks,
            "Sched_wait_s": round(sum(
                float(b.get("Sched_wait_s", 0) or 0)
                for b in sched_blocks), 3),
            "Placements": [row for b in sched_blocks
                           for row in (b.get("Placements") or ())],
        } if sched_blocks else None),
    }
    merged.update(sums)
    return merged


def check_wire_conservation(stats_list: List[dict]) -> List[dict]:
    """The cross-process final check: every wire edge balanced to the
    tuple (post-run books: an unacked replay-buffer residue is a loss
    here, unlike in a live fold).  Returns violations ([] == the
    identity holds)."""
    return [{"kind": "lost_wire_delivery", "edge": r["edge"],
             "count": max(0, r["tuples_sent"] - r["tuples_delivered"])}
            for r in wire_table(stats_list) if not r["balanced"]]


# ---------------------------------------------------------------------------
# live cluster view: StatsPusher (worker side) -> ClusterObserver
# (coordinator side) over a cheap framed-JSON side socket
# ---------------------------------------------------------------------------

class ClusterObserver(threading.Thread):
    """Coordinator-side live view of a distributed run.

    Accepts worker push connections on a loopback TCP port, keeps the
    latest stats dict per worker plus a bounded accumulated flight
    ring (deltas dedup by ``(worker, pid, seq)`` so resent tails after
    a reconnect or a worker restart never duplicate an episode), and
    folds everything with :func:`merge_stats` on demand.
    :meth:`serve_http` exposes the merged view at ``GET /cluster`` --
    the endpoint ``python -m windflow_tpu_torch.doctor --watch`` polls."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 flight_keep: int = OBSERVER_FLIGHT_KEEP):
        super().__init__(name="windflow-cluster-observer", daemon=True)
        import socket
        self._lsock = socket.create_server((host, port))
        self._lsock.settimeout(0.2)
        self.host = host
        self.port = self._lsock.getsockname()[1]
        self.flight_keep = flight_keep
        self.lock = threading.Lock()
        self.latest: Dict[int, dict] = {}       # worker -> stats dict
        self.flight: Dict[int, deque] = {}      # worker -> event ring
        self._flight_seen: Dict[int, deque] = {}  # dedup key memory
        self.updated: Dict[int, float] = {}
        # worker -> its latest push was the FINAL (settled-books) one;
        # until every worker is final, merged() folds in live mode
        self.final: Dict[int, bool] = {}
        self.pushes = 0
        self.http_port: Optional[int] = None
        self._httpd = None
        self._stop_evt = threading.Event()

    # -- ingest --------------------------------------------------------
    def run(self) -> None:
        import socket
        while not self._stop_evt.is_set():
            try:
                conn, _addr = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True,
                             name="windflow-observer-rx").start()

    def _serve(self, conn) -> None:
        import socket
        conn.settimeout(0.5)
        buf = bytearray()
        try:
            with conn:
                while not self._stop_evt.is_set():
                    try:
                        data = conn.recv(1 << 20)
                    except socket.timeout:
                        continue
                    if not data:
                        return
                    buf.extend(data)
                    while len(buf) >= _PUSH_HEADER.size:
                        (ln,) = _PUSH_HEADER.unpack_from(bytes(
                            buf[:_PUSH_HEADER.size]))
                        if ln > _PUSH_MAX_BYTES:
                            return  # desynced stream: drop the conn
                        end = _PUSH_HEADER.size + ln
                        if len(buf) < end:
                            break
                        payload = bytes(buf[_PUSH_HEADER.size:end])
                        del buf[:end]
                        try:
                            self.ingest(json.loads(payload))
                        except ValueError:
                            return
        except OSError:
            return

    def ingest(self, doc: dict) -> None:
        """Fold one push frame: ``{"pid": ..., "stats": {...}}`` where
        the stats dict's ``Flight`` holds only the delta events."""
        stats = doc.get("stats")
        if not isinstance(stats, dict):
            return
        pid = doc.get("pid")
        w = stats.get("Worker")
        wkey = -1 if w is None else int(w)
        delta = stats.pop("Flight", None) or ()
        with self.lock:
            self.latest[wkey] = stats
            self.updated[wkey] = _time.time()
            self.final[wkey] = bool(doc.get("final"))
            self.pushes += 1
            ring = self.flight.get(wkey)
            if ring is None:
                ring = self.flight[wkey] = deque(
                    maxlen=max(1, self.flight_keep))
                self._flight_seen[wkey] = deque(
                    maxlen=max(1, self.flight_keep))
            seen = self._flight_seen[wkey]
            seen_set = set(seen)
            for ev in delta:
                seq = ev.get("seq")
                if seq is not None:
                    key = (pid, seq)
                    if key in seen_set:
                        continue
                    seen.append(key)
                    seen_set.add(key)
                ring.append(ev)

    # -- fold ----------------------------------------------------------
    def worker_stats(self) -> List[dict]:
        """Latest per-worker stats dicts with their accumulated flight
        rings re-attached (what ``merge_stats`` consumes).  The ring
        was already deduped by ``(pid, seq)`` at ingest, so the events
        are RE-sequenced here: a restarted worker process reuses seqs
        from 1, and handing the raw values to ``merge_stats`` would
        let its ``(worker, seq)`` dedup swallow the new attempt's
        events as duplicates of the old one's."""
        with self.lock:
            return [dict(stats,
                         Flight=[dict(ev, seq=i + 1) for i, ev in
                                 enumerate(self.flight.get(w) or ())])
                    for w, stats in sorted(self.latest.items())]

    def merged(self) -> dict:
        with self.lock:
            settled = bool(self.latest) and all(
                self.final.get(w) for w in self.latest)
        return merge_stats(self.worker_stats(), live=not settled)

    # -- HTTP ----------------------------------------------------------
    def serve_http(self, port: int = 0):
        """Serve ``GET /cluster`` (and every other path): the merged
        stats dict, its doctor report, and per-worker liveness meta as
        one JSON object."""
        from http.server import BaseHTTPRequestHandler, \
            ThreadingHTTPServer
        obs = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                from ..diagnosis.report import build_report
                merged = obs.merged()
                rep = build_report(merged, merged.get("Flight")) \
                    if merged else None
                with obs.lock:
                    meta = {str(w): {"updated": obs.updated.get(w)}
                            for w in obs.latest}
                    pushes = obs.pushes
                body = json.dumps({
                    "merged": merged, "report": rep,
                    "workers": meta, "pushes": pushes,
                    "now": round(_time.time(), 3),
                }).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        httpd = ThreadingHTTPServer((self.host, port), Handler)
        self.http_port = httpd.server_address[1]
        self._httpd = httpd
        threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="windflow-observer-http").start()
        return httpd

    @property
    def http_url(self) -> Optional[str]:
        if self.http_port is None:
            return None
        return f"http://{self.host}:{self.http_port}"

    def stop(self) -> None:
        self._stop_evt.set()
        try:
            self._lsock.close()
        except OSError:
            pass
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()  # release the listening fd now
        self.join(timeout=2.0)


class StatsPusher(threading.Thread):
    """Worker-side live reporter: every ``interval_s`` it refreshes
    the gauges, rides the diagnosis tick (rate-limited internally, so
    stacking on the monitor cadence cannot multiply the cost), and
    pushes the stats JSON plus the flight-delta tail to the
    coordinator's :class:`ClusterObserver`.

    Best-effort by design: a dead observer must never take the graph
    down -- send failures drop the connection and the next tick
    reconnects.  ``_last_seq`` only advances after a successful send,
    so a reconnect re-ships the unacknowledged flight tail and the
    observer's ``(worker, pid, seq)`` dedup absorbs the overlap."""

    def __init__(self, graph, host: str, port: int,
                 interval_s: float = 0.5):
        super().__init__(name="windflow-stats-pusher", daemon=True)
        self.graph = graph
        self.host = host
        self.port = int(port)
        self.interval_s = max(0.05, float(interval_s))
        self._stop_evt = threading.Event()
        self._sock = None
        self._last_seq = 0
        self._final = False
        self.pushes = 0
        self.errors = 0

    def _frame(self) -> Tuple[bytes, int]:
        import os
        g = self.graph
        try:
            g.refresh_gauges()
        except Exception:  # gauge reads race teardown; push what we can
            pass
        diag = getattr(g, "diagnosis", None)
        if diag is not None:
            # the final frame reports the SETTLED state: force the
            # tick past its rate limit so the last published blocks
            # (Slo, History, Diagnosis) are end-of-run fresh -- a
            # short run could otherwise end inside the rate window
            # with the blocks never published at all
            diag.maybe_tick(force=self._final)
        events = [ev for ev in g.flight.snapshot()
                  if (ev.get("seq") or 0) > self._last_seq]
        events = events[:PUSH_FLIGHT_MAX]
        top = max((ev.get("seq") or 0 for ev in events),
                  default=self._last_seq)
        dls = getattr(g, "dead_letters", None)
        stats_json = g.stats.to_json(
            g.get_num_dropped_tuples(),
            dls.count() if dls is not None else 0,
            flight_events=events)
        # wrap without re-parsing the (already serialized) stats JSON;
        # the final frame (sent from stop(), after the wire flushed)
        # marks this worker's books settled -- once every worker is
        # final the observer's fold applies the strict wire identity
        doc = '{"pid":%d,"final":%s,"stats":%s}' % (
            os.getpid(), "true" if self._final else "false", stats_json)
        payload = doc.encode("utf-8")
        return _PUSH_HEADER.pack(len(payload)) + payload, top

    def _push_once(self) -> None:
        import socket
        frame, top = self._frame()
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=2.0)
        self._sock.sendall(frame)
        self._last_seq = top
        self.pushes += 1

    def _close(self) -> None:
        s, self._sock = self._sock, None
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def run(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            try:
                self._push_once()
            except OSError:
                self.errors += 1
                self._close()
        self._final = True
        try:
            self._push_once()  # final (settled-books) state at stop
        except OSError:
            self.errors += 1
        self._close()

    def stop(self) -> None:
        self._stop_evt.set()
        self.join(timeout=5.0)


def attach_pusher(graph, host: str, port: int,
                  interval_s: float = 0.5) -> StatsPusher:
    """Start a :class:`StatsPusher` for ``graph`` (distributed wiring
    calls this when the spec names an observe endpoint; single-process
    graphs can attach one by hand -- e.g. bench ``13_slo_overhead``)."""
    p = StatsPusher(graph, host, port, interval_s)
    p.start()
    return p
