"""Fleet worker entry point: ``python -m windflow_tpu_torch.scheduler.worker``.

One worker process = one fair-share, device-scheduling
:class:`~windflow_tpu_torch.serving.server.Server` plus two side channels:

* a framed-JSON **control** listener the FleetServer drives
  (submit / tenant / stats / evict / shutdown);
* a **push** loop feeding the fleet's ClusterObserver the worker's
  ``Scheduler`` block (capacity, placements, fair-share leases with
  their waits, device leases) and its flight ring, every interval and
  once more -- marked final -- at shutdown.

Build/config functions arrive as importable references and are loaded
with the distributed plane's ``_load_ref`` (module path first, source
file fallback), never pickled.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import threading
from typing import Optional

from .fleet import FRAME_HEADER, recv_frame, send_frame


def _tenant_row(server, name: str) -> Optional[dict]:
    handle = server.get(name)
    if handle is None:
        return None
    g = handle.graph
    row = {
        "Tenant": name,
        "State": handle.state,
        "Credits": handle.credits,
        "Arbitrations": handle.arbitrations,
        "Error": repr(handle.error)
        if handle.error is not None else None,
    }
    with g.stats.lock:
        row["Conservation"] = g.stats.audit_conservation
        row["Slo"] = g.stats.slo
        row["Scheduler"] = g.stats.scheduler
    try:
        # per-tenant latency books (bench 20 gates fleet p99 on this)
        doc = json.loads(g.stats.to_json(0, 0))
        row["Latency_e2e"] = doc.get("Latency_e2e")
    except Exception:
        row["Latency_e2e"] = None
    try:
        row["Dead_letters"] = g.dead_letters.count()
    except Exception:
        row["Dead_letters"] = None
    return row


class _Pusher(threading.Thread):
    """Best-effort observer feed (the StatsPusher discipline: a dead
    observer must never take the worker down)."""

    def __init__(self, server, wid: int, endpoint, interval: float):
        super().__init__(name="windflow-fleet-pusher", daemon=True)
        self.server = server
        self.wid = wid
        self.endpoint = endpoint
        self.interval = interval
        self._sock = None
        self._stop = threading.Event()

    def _push(self, final: bool = False) -> None:
        doc = {"pid": os.getpid(), "final": final,
               "stats": {"Worker": self.wid,
                         "Scheduler": self.server.scheduler_block(),
                         "Flight": self.server.flight.snapshot()}}
        payload = json.dumps(doc, default=str).encode()
        if self._sock is None:
            self._sock = socket.create_connection(self.endpoint,
                                                  timeout=2.0)
        self._sock.sendall(FRAME_HEADER.pack(len(payload)) + payload)

    def run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self._push()
            except OSError:
                if self._sock is not None:
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    self._sock = None

    def stop(self) -> None:
        self._stop.set()
        try:
            self._push(final=True)
        except OSError:
            pass
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass


def _handle(server, doc: dict) -> dict:
    cmd = doc.get("cmd")
    if cmd == "ping":
        return {"ok": True}
    if cmd == "submit":
        from ..distributed.runtime import _load_ref
        from ..serving.tenant import TenantSpec
        try:
            build_fn = _load_ref(doc["build"])
            config = None
            if doc.get("config") is not None:
                config = _load_ref(doc["config"])()
            spec = TenantSpec(**(doc.get("spec") or {}))
            handle = server.submit(doc["name"], build_fn, tenant=spec,
                                   config=config)
            if handle.error is not None:
                # a graph that could not start ends FAILED: its
                # traceback goes to this worker's log, whose tail the
                # fleet attaches to the tenant's row
                import traceback
                print(f"tenant {doc['name']!r} failed to start:",
                      file=sys.stderr)
                traceback.print_exception(handle.error, file=sys.stderr)
                sys.stderr.flush()
            return {"ok": True, "tenant": doc["name"]}
        except BaseException as e:
            return {"ok": False, "error": str(e),
                    "kind": type(e).__name__}
    if cmd == "tenant":
        row = _tenant_row(server, doc["name"])
        if row is None:
            return {"ok": False,
                    "error": f"no tenant {doc['name']!r}"}
        return {"ok": True, "row": row}
    if cmd == "stats":
        return {"ok": True, "stats": server.stats()}
    if cmd == "evict":
        try:
            handle = server.evict(doc["name"])
            return {"ok": True,
                    "row": {"Tenant": doc["name"],
                            "State": handle.state}}
        except BaseException as e:
            return {"ok": False, "error": str(e),
                    "kind": type(e).__name__}
    return {"ok": False, "error": f"unknown command {cmd!r}"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="windflow_tpu_torch.scheduler.worker",
        description="fleet worker: a fair-share tenant host under a "
                    "FleetServer control connection")
    ap.add_argument("--worker-id", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--capacity", type=int, default=1 << 20)
    ap.add_argument("--lanes", type=int, default=1)
    ap.add_argument("--observer", default=None,
                    help="host:port of the fleet's ClusterObserver")
    ap.add_argument("--push-interval", type=float, default=0.25)
    args = ap.parse_args(argv)

    from ..serving.server import Server
    server = Server(args.capacity,
                    name=f"fleet-worker{args.worker_id}",
                    fair_share=True, devices=args.lanes,
                    worker_id=args.worker_id)
    pusher = None
    if args.observer:
        host, port = args.observer.rsplit(":", 1)
        pusher = _Pusher(server, args.worker_id, (host, int(port)),
                         args.push_interval)
        pusher.start()

    lsock = socket.create_server(("127.0.0.1", args.port))
    lsock.settimeout(0.2)
    stop = False
    try:
        while not stop:
            try:
                conn, _addr = lsock.accept()
            except socket.timeout:
                continue
            with conn:
                while True:
                    try:
                        doc = recv_frame(conn, timeout=None)
                    except (OSError, ValueError):
                        break  # fleet went away; await a reconnect
                    if doc.get("cmd") == "shutdown":
                        send_frame(conn, {"ok": True})
                        stop = True
                        break
                    try:
                        send_frame(conn, _handle(server, doc))
                    except OSError:
                        break
    finally:
        lsock.close()
        server.close()
        if pusher is not None:
            pusher.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
