"""MonitoringThread: the dashboard TCP reporter.

Re-design of reference ``wf/monitoring.hpp`` (:162-314): connects to a
dashboard at (machine, port) -- default localhost:20207 -- and speaks
the same framed protocol:

* type 0: registerApp    [int32 type][int32 len][payload: SVG diagram]
          -> ack [int32 app_id]                        (:232-257)
* type 1: sendReport     [int32 type][int32 app_id][int32 len][JSON]
          every second                                 (:260-285)
* type 2: deregisterApp  [int32 type][int32 app_id][int32 0]  (:288-313)

Integers are little-endian int32 (the reference sends raw host-order
ints from x86).  The registerApp payload is an SVG diagram, as the
reference renders via libgvc (:243) -- here produced by the pure-python
``graph_to_svg`` (no graphviz binary); ``graph_to_dot`` still provides
the DOT text for the log-dir artifact dump (multipipe.hpp:522-591).
"""
from __future__ import annotations

import os
import socket
import struct
import threading
import warnings

# flight-recorder events shipped inside each monitor report (the
# dashboard's /flight endpoint and the doctor's offline path read
# them; the full ring still dumps as JSONL on failure)
FLIGHT_IN_REPORT = 256


def _dot_quote(s: str) -> str:
    """DOT double-quoted-string escaping: a backslash or quote in an
    operator name must not break the generated graph (graph_to_svg
    already escapes its XML; this is the DOT twin)."""
    return s.replace("\\", "\\\\").replace('"', '\\"')


def graph_to_dot(graph) -> str:
    """Graphviz description of the PipeGraph topology
    (multipipe.hpp:522-591: vertices per operator, edges labelled by
    routing mode)."""
    lines = [f'digraph "{_dot_quote(graph.name)}" {{', "  rankdir=LR;"]
    # bare-word node ids (the web UI's parseDot expects \w+), made
    # collision-free: sanitizing 'op.1' and 'op-1' both to 'op_1'
    # would otherwise silently merge two operators into one vertex
    assigned: dict = {}
    used: set = set()

    def node_id(raw: str) -> str:
        nid = assigned.get(raw)
        if nid is None:
            base = "".join(c if c.isalnum() or c == "_" else "_"
                           for c in raw)
            nid, k = base, 2
            while nid in used:
                nid = f"{base}_{k}"
                k += 1
            used.add(nid)
            assigned[raw] = nid
        return nid

    for pipe in graph.pipes:
        prev = None
        for name in pipe._op_names:
            nid = node_id(f"{pipe.name}_{name}")
            lines.append(f'  {nid} [label="{_dot_quote(name)}"];')
            if prev is not None:
                lines.append(f"  {prev} -> {nid};")
            prev = nid
    lines.append("}")
    return "\n".join(lines)


def graph_to_svg(graph) -> str:
    """Pure-python SVG render of the PipeGraph topology -- the diagram
    artifact twin of the reference's graphviz PDF/SVG dump
    (pipegraph.hpp:683-709) without an external graphviz binary.
    Layout: one row per MultiPipe, operators left to right."""
    BOX_W, BOX_H, GAP_X, GAP_Y, PAD = 148, 40, 42, 26, 16
    rows = [list(pipe._op_names) for pipe in graph.pipes]
    if not rows:
        rows = [[]]
    width = PAD * 2 + max((len(r) for r in rows), default=0) * \
        (BOX_W + GAP_X) - (GAP_X if any(rows) else 0)
    height = PAD * 2 + len(rows) * (BOX_H + GAP_Y) - GAP_Y
    out = [f'<svg xmlns="http://www.w3.org/2000/svg" '
           f'width="{max(width, 60)}" height="{max(height, 60)}" '
           f'font-family="monospace" font-size="11">',
           f'<title>{_xml(graph.name)}</title>']
    for ri, names in enumerate(rows):
        y = PAD + ri * (BOX_H + GAP_Y)
        for ci, name in enumerate(names):
            x = PAD + ci * (BOX_W + GAP_X)
            out.append(
                f'<rect x="{x}" y="{y}" width="{BOX_W}" height="{BOX_H}"'
                f' rx="6" fill="#eef3fa" stroke="#47618a"/>')
            label = name if len(name) <= 20 else name[:19] + "…"
            out.append(f'<text x="{x + BOX_W / 2}" y="{y + BOX_H / 2 + 4}"'
                       f' text-anchor="middle">{_xml(label)}</text>')
            if ci:
                ax = x - GAP_X
                out.append(
                    f'<line x1="{ax}" y1="{y + BOX_H / 2}" x2="{x - 6}"'
                    f' y2="{y + BOX_H / 2}" stroke="#47618a"/>'
                    f'<polygon points="{x - 6},{y + BOX_H / 2 - 4} '
                    f'{x},{y + BOX_H / 2} {x - 6},{y + BOX_H / 2 + 4}"'
                    f' fill="#47618a"/>')
    out.append("</svg>")
    return "\n".join(out)


def _xml(s: str) -> str:
    import html
    return html.escape(s, quote=True)


class MonitoringThread(threading.Thread):
    """1 Hz stats reporter (monitoring.hpp:162-314)."""

    def __init__(self, graph, machine: str = None, port: int = None,
                 interval_s: float = 1.0):
        super().__init__(name="windflow-monitor", daemon=True)
        self.graph = graph
        cfg = graph.config
        self.machine = machine or cfg.dashboard_machine
        self.port = port or cfg.dashboard_port
        self.interval_s = interval_s
        self._stop_evt = threading.Event()
        self.app_id = -1
        self.sock = None
        self.snapshot_path = None  # set by the dashboard-less fallback

    # -- framed protocol ---------------------------------------------------
    def _send_frame(self, *parts: bytes) -> None:
        self.sock.sendall(b"".join(parts))

    def _register(self) -> bool:
        try:
            self.sock = socket.create_connection(
                (self.machine, self.port), timeout=2.0)
            diagram = graph_to_svg(self.graph).encode()
            self._send_frame(struct.pack("<ii", 0, len(diagram)), diagram)
            ack = b""
            while len(ack) < 4:  # the 4-byte app-id ack may fragment
                chunk = self.sock.recv(4 - len(ack))
                if not chunk:
                    break
                ack += chunk
            if len(ack) == 4:
                self.app_id = struct.unpack("<i", ack)[0]
                return True
        except OSError:
            pass
        # failure: don't carry a half-registered connection into the
        # long-lived snapshot fallback (leaked fd + a ghost app on the
        # dashboard side if the register frame landed)
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None
        return False

    def _report(self) -> None:
        payload = self._stats_json().encode()
        self._send_frame(struct.pack("<iii", 1, self.app_id, len(payload)),
                         payload)

    def _deregister(self) -> None:
        try:
            self._send_frame(struct.pack("<iii", 2, self.app_id, 0))
        except OSError:
            pass

    def _stats_json(self) -> str:
        stats = getattr(self.graph, "stats", None)
        refresh = getattr(self.graph, "refresh_gauges", None)
        if refresh is not None:
            refresh()  # channel-depth / credit-wait gauges per replica
        # diagnosis plane (diagnosis/): the monitor tick doubles as the
        # history/anomaly/attribution cadence (rate-limited internally)
        diag = getattr(self.graph, "diagnosis", None)
        if diag is not None:
            diag.maybe_tick()
        if stats is not None:
            dls = getattr(self.graph, "dead_letters", None)
            flight = getattr(self.graph, "flight", None)
            events = None
            if flight is not None and flight.enabled:
                events = flight.snapshot()[-FLIGHT_IN_REPORT:]
            return stats.to_json(self.graph.get_num_dropped_tuples(),
                                 dls.count() if dls is not None else 0,
                                 flight_events=events)
        return "{}"

    # -- thread body -------------------------------------------------------
    def _fallback(self) -> None:
        """Dashboard unreachable (at registration or mid-run): never
        silently stop reporting -- drop the socket, warn once per
        process and switch to periodic log-dir stats-JSON snapshots,
        so the run is not silently untraced."""
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None
        _warn_dashboard_unreachable(self.machine, self.port,
                                    self.graph.config.log_dir)
        self._snapshot_loop()

    def run(self) -> None:
        if not self._register():
            self._fallback()
            return
        while not self._stop_evt.is_set():
            try:
                self._report()
            except OSError:
                self._fallback()  # dashboard died mid-run
                return
            self._stop_evt.wait(self.interval_s)
        try:
            self._report()
            self._deregister()
        except OSError:
            pass  # shutdown path: the graph is ending anyway
        finally:
            if self.sock is not None:
                self.sock.close()

    def _snapshot_loop(self) -> None:
        """Dashboard-less fallback: refresh + write the stats JSON to
        ``log_dir/<pid>_<graph>_stats.json`` every reporting interval
        (atomic rename so a reader never sees a torn file).  Each run
        writes ONE file keyed by pid+graph, but successive runs used to
        accumulate in ``log_dir`` without bound; rotation keeps the
        newest ``RuntimeConfig.snapshot_keep`` snapshot files (default
        16; <= 0 disables rotation)."""
        from ..distributed.identity import worker_suffix
        d = self.graph.config.log_dir
        # worker-id component (distributed/identity.py): two workers of
        # one graph on one box never clobber each other's snapshots
        path = os.path.join(
            d,
            f"{os.getpid()}_{self.graph.name}{worker_suffix()}_stats.json")
        self.snapshot_path = path

        def write():
            try:
                os.makedirs(d, exist_ok=True)
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    f.write(self._stats_json())
                os.replace(tmp, path)
            except OSError:
                pass  # log dir gone read-only: keep trying, stay alive

        write()
        rotate_snapshots(d, self.graph.config.snapshot_keep)
        while True:
            if self._stop_evt.wait(self.interval_s):
                write()  # final state at wait_end
                return
            write()

    def stop(self) -> None:
        self._stop_evt.set()
        self.join(timeout=5.0)


# the per-run artifact families rotation prunes INDEPENDENTLY (keep
# the newest N of each): periodic stats snapshots, flight-recorder
# JSONL dumps, raw runtime-channel stats, and the tracing log dump's
# json/dot/svg triple.  Families are suffix-disjoint by construction
# (the log dump's plain ``.json`` carries no ``_stats``/``_runtime``
# marker), so one family's churn never evicts another's history.
_ROTATED_FAMILIES = ("_stats.json", "_flight.jsonl", "_runtime.json",
                     ".dot", ".svg", ".json")


def _family_of(name: str) -> Optional[str]:
    for suffix in _ROTATED_FAMILIES:
        if name.endswith(suffix):
            return suffix
    return None


def rotate_snapshots(log_dir: str, keep: int) -> None:
    """Keep-last-N rotation of ``log_dir``'s per-run artifact
    families: stats snapshots (``*_stats.json``), flight-recorder
    dumps (``*_flight.jsonl``), runtime channel stats
    (``*_runtime.json``) and tracing log dumps (``*.json/.dot/.svg``)
    -- each family pruned independently, oldest (by mtime) first, so a
    long supervised soak no longer grows ``log/`` without bound.
    Stall reports and anything unrecognized stay.  ``keep <= 0``
    disables rotation.  Called when a snapshot fallback loop starts
    and after every flight/log dump."""
    if keep is None or keep <= 0:
        return
    try:
        by_family: dict = {}
        for n in os.listdir(log_dir):
            fam = _family_of(n)
            if fam is None:
                continue
            p = os.path.join(log_dir, n)
            try:
                by_family.setdefault(fam, []).append(
                    (os.path.getmtime(p), p))
            except OSError:
                continue  # raced with another process's rotation
        for paths in by_family.values():
            if len(paths) <= keep:
                continue
            paths.sort()
            for _mt, p in paths[:len(paths) - keep]:
                try:
                    os.remove(p)
                except OSError:
                    pass
    except OSError:
        pass  # unreadable log dir: rotation is best-effort


_dash_warned = False


def _warn_dashboard_unreachable(machine: str, port: int,
                                log_dir: str) -> None:
    global _dash_warned
    if _dash_warned:
        return
    _dash_warned = True
    warnings.warn(
        f"windflow_tpu_torch monitoring: dashboard at {machine}:{port} is "
        f"unreachable; falling back to periodic stats-JSON snapshots "
        f"under {log_dir!r}", RuntimeWarning, stacklevel=2)
