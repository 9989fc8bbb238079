"""FleetServer: tenant->worker placement over spawned worker processes.

The serving plane's ``Server`` hosts many tenants in ONE process; the
distributed plane runs one graph across MANY processes.  The
``FleetServer`` is the production shape of both at once: it spawns a
bounded pool of worker processes (each hosting a fair-share,
device-scheduling ``Server`` -- scheduler/worker.py), places every
submitted tenant onto one worker via the pure policy
(scheduler/policy.py, re-reading the live cluster view pushed by the
workers into a PR 13 ``ClusterObserver``), and supervises the pool:
one worker's death fails only its own tenants (per-tenant crash
isolation is per-PROCESS here), and the victims are re-placed onto the
survivors under their original specs.

Control protocol: one persistent framed-JSON connection per worker
(``[u32 len][json]``, the same framing as the observer push channel).
Build/config functions travel as importable ``(file, qualname)``
references (distributed/runtime.py ``_callable_ref``), never pickled.

Every decision is a flight event in the fleet's own ring:
``sched_place`` / ``sched_replace`` / ``sched_rejected`` /
``worker_death`` -- the doctor explains each (diagnosis/report.py).

Workers are ``python -m windflow_tpu_torch.scheduler.worker`` processes
that import this checkout's package, each writing its output to
``<log_dir>/worker_<id>.log``; a tenant row that ends ``FAILED`` (a
graph that asked for the CUDA card on a worker without one, say)
carries the tail of its worker's log as ``Log_tail``.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

from .errors import SchedulerError
from .policy import Placement, WorkerCaps, plan_placement, request_for

# framed-JSON control channel (same shape as the observer push frames)
FRAME_HEADER = struct.Struct("<I")
FRAME_MAX_BYTES = 1 << 26

# how much of a worker's log a FAILED tenant's row carries
LOG_TAIL_BYTES = 2000

# terminal tenant states (mirrors serving.tenant.TenantState.TERMINAL,
# but the fleet must not import the serving plane just for strings)
_TERMINAL = ("COMPLETED", "STOPPED", "FAILED")


def send_frame(sock, doc: dict) -> None:
    payload = json.dumps(doc).encode()
    sock.sendall(FRAME_HEADER.pack(len(payload)) + payload)


def recv_frame(sock, timeout: Optional[float] = None) -> dict:
    """Read one length-prefixed JSON frame; raises OSError on EOF or a
    desynced stream (the caller treats the peer as dead)."""
    sock.settimeout(timeout)
    buf = b""
    while len(buf) < FRAME_HEADER.size:
        chunk = sock.recv(FRAME_HEADER.size - len(buf))
        if not chunk:
            raise OSError("control connection closed")
        buf += chunk
    (ln,) = FRAME_HEADER.unpack(buf)
    if ln > FRAME_MAX_BYTES:
        raise OSError(f"oversized control frame ({ln} bytes)")
    payload = b""
    while len(payload) < ln:
        chunk = sock.recv(ln - len(payload))
        if not chunk:
            raise OSError("control connection closed mid-frame")
        payload += chunk
    return json.loads(payload)


class _Worker:
    """One spawned worker process + its control connection."""

    def __init__(self, wid: int, port: int, proc) -> None:
        self.wid = wid
        self.port = port
        self.proc = proc
        self.sock = None
        self.lock = threading.Lock()
        self.alive = True
        # separate from ``alive``: an _rpc that hits the broken
        # channel first flips alive, but the death must still be
        # handled (exactly once) when the process exit is observed
        self.death_handled = False
        self.exit_code: Optional[int] = None


class _FleetPlacement:
    """The fleet's memory of one submitted tenant (original spec +
    refs kept so a crash victim can be re-placed as submitted)."""

    def __init__(self, name: str, spec, build_ref: dict,
                 config_ref: Optional[dict], worker: int) -> None:
        self.name = name
        self.spec = spec
        self.build_ref = build_ref
        self.config_ref = config_ref
        self.worker = worker
        self.state = "PLACED"
        self.attempts = 1
        self.error: Optional[str] = None

    def row(self) -> dict:
        return {"Tenant": self.name, "Worker": self.worker,
                "State": self.state, "Attempts": self.attempts,
                "Credits": self.spec.credits,
                "Devices": getattr(self.spec, "devices", 0),
                "Priority": self.spec.priority,
                "Weight": self.spec.weight,
                "Error": self.error}


class FleetServer:
    """Fleet-level control plane: spawn workers, place tenants, watch
    the pool, re-place crash victims.  Context-manager friendly."""

    def __init__(self, workers: int = 2, capacity: int = 1 << 20, *,
                 device_lanes: int = 1,
                 name: str = "windflow-fleet",
                 push_interval_s: float = 0.25,
                 spawn_timeout_s: float = 30.0,
                 python: Optional[str] = None,
                 log_dir: Optional[str] = None) -> None:
        if workers < 1:
            raise ValueError("FleetServer needs at least one worker")
        from ..distributed.observe import ClusterObserver
        from ..distributed.runtime import free_ports
        from ..telemetry import FlightRecorder
        self.name = name
        self.capacity = capacity
        self.device_lanes = device_lanes
        self.flight = FlightRecorder(512)
        self._lock = threading.RLock()
        self._placements: Dict[str, _FleetPlacement] = {}
        self._closed = False
        self.observer = ClusterObserver()
        self.observer.start()
        py = python or sys.executable
        ports = free_ports(workers)
        self._workers: Dict[int, _Worker] = {}
        # worker logs: the caller's directory, else a temporary one
        # removed at close
        self._own_log_dir = log_dir is None
        self.log_dir = log_dir or tempfile.mkdtemp(prefix="windflow-fleet-")
        os.makedirs(self.log_dir, exist_ok=True)
        # the workers must import THIS windflow_tpu_torch whatever the
        # caller's cwd or install mode
        env = dict(os.environ)
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + \
            env.get("PYTHONPATH", "")
        for wid in range(workers):
            argv = [py, "-m", "windflow_tpu_torch.scheduler.worker",
                    "--worker-id", str(wid),
                    "--port", str(ports[wid]),
                    "--capacity", str(capacity),
                    "--lanes", str(device_lanes),
                    "--observer",
                    f"{self.observer.host}:{self.observer.port}",
                    "--push-interval", str(push_interval_s)]
            with open(self._log_path(wid), "ab") as logf:
                proc = subprocess.Popen(argv, cwd=os.getcwd(), env=env,
                                        stdout=logf,
                                        stderr=subprocess.STDOUT)
            self._workers[wid] = _Worker(wid, ports[wid], proc)
        try:
            self._connect_all(spawn_timeout_s)
        except BaseException:
            self.close()
            raise
        self._supervisor = threading.Thread(
            target=self._supervise, daemon=True,
            name=f"windflow-fleet-supervisor-{name}")
        self._supervisor.start()

    def _log_path(self, wid: int) -> str:
        return os.path.join(self.log_dir, f"worker_{wid}.log")

    def log_tail(self, wid: int) -> str:
        """The last LOG_TAIL_BYTES of worker ``wid``'s output."""
        try:
            with open(self._log_path(wid), "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - LOG_TAIL_BYTES))
                return f.read().decode(errors="replace")
        except OSError:
            return ""

    # -- spawn / connect ------------------------------------------------
    def _connect_all(self, timeout: float) -> None:
        import socket
        deadline = time.monotonic() + timeout
        for wk in self._workers.values():
            last_err: Optional[BaseException] = None
            while time.monotonic() < deadline:
                if wk.proc.poll() is not None:
                    raise SchedulerError(
                        f"worker {wk.wid} exited rc={wk.proc.returncode}"
                        " before accepting control connections",
                        worker=wk.wid)
                try:
                    wk.sock = socket.create_connection(
                        ("127.0.0.1", wk.port), timeout=1.0)
                    wk.sock.settimeout(None)
                    break
                except OSError as e:
                    last_err = e
                    time.sleep(0.05)
            if wk.sock is None:
                raise SchedulerError(
                    f"worker {wk.wid} did not come up within "
                    f"{timeout}s ({last_err!r})", worker=wk.wid)

    # -- placement ------------------------------------------------------
    def _live_view(self) -> Dict[int, bool]:
        """Worker liveness for the policy: the process must be up AND,
        once the observer has heard from anyone, only workers it still
        tracks count (a wedged worker that stopped pushing is as dead
        to placement as an exited one after its process goes)."""
        return {wid: wk.alive and wk.proc.poll() is None
                for wid, wk in self._workers.items()}

    def _placed_view(self) -> List[Placement]:
        """Current load for the policy: the union of the observer's
        live per-worker placements (a COMPLETED tenant frees its
        reservation automatically on the next push) and the fleet's
        own records (a just-placed tenant counts immediately, before
        any push carries it)."""
        rows: Dict[str, Placement] = {}
        for stats in self.observer.worker_stats():
            sched = stats.get("Scheduler")
            if not isinstance(sched, dict):
                continue
            for p in sched.get("Placements") or ():
                if p.get("State") == "RUNNING":
                    rows[p["Tenant"]] = Placement(
                        name=p["Tenant"], worker=int(p["Worker"]),
                        credits=int(p["Credits"]),
                        devices=int(p.get("Devices") or 0))
        with self._lock:
            for rec in self._placements.values():
                if rec.state == "PLACED" and rec.name not in rows:
                    rows[rec.name] = Placement(
                        name=rec.name, worker=rec.worker,
                        credits=rec.spec.credits,
                        devices=getattr(rec.spec, "devices", 0))
        return list(rows.values())

    def _choose_worker(self, name: str, spec) -> int:
        caps = [WorkerCaps(wid, self.capacity, self.device_lanes)
                for wid in self._workers]
        return plan_placement(
            [request_for(name, spec)], caps,
            placed=self._placed_view(),
            live=self._live_view())[name]

    def submit(self, name: str, build_fn: Callable, tenant=None,
               config_fn: Optional[Callable] = None) -> dict:
        """Place one tenant onto a worker and start it there.

        ``build_fn`` (and the optional ``config_fn`` returning a
        RuntimeConfig) must be importable top-level functions -- they
        run in the worker process.  Returns the placement row."""
        from ..distributed.runtime import _callable_ref
        from ..serving.tenant import TenantSpec
        spec = tenant or TenantSpec()
        build_ref = _callable_ref(build_fn)
        config_ref = _callable_ref(config_fn) \
            if config_fn is not None else None
        with self._lock:
            if self._closed:
                raise SchedulerError("FleetServer is closed")
            if name in self._placements \
                    and self._placements[name].state != "FAILED":
                raise ValueError(f"tenant {name!r} already placed "
                                 "(evict it first)")
            try:
                wid = self._choose_worker(name, spec)
            except SchedulerError as e:
                self.flight.record("sched_rejected", tenant=name,
                                   error=str(e), hint=e.hint,
                                   path="scheduler.FleetServer")
                raise
            rec = _FleetPlacement(name, spec, build_ref, config_ref,
                                  wid)
            self._placements[name] = rec
        try:
            self._submit_to(wid, rec)
        except BaseException:
            with self._lock:
                self._placements.pop(name, None)
            raise
        self.flight.record("sched_place", tenant=name, worker=wid,
                           credits=spec.credits,
                           devices=getattr(spec, "devices", 0),
                           priority=spec.priority, weight=spec.weight)
        return rec.row()

    def _submit_to(self, wid: int, rec: _FleetPlacement) -> None:
        import dataclasses
        spec_doc = dataclasses.asdict(rec.spec)
        reply = self._rpc(wid, {
            "cmd": "submit", "name": rec.name,
            "build": rec.build_ref, "config": rec.config_ref,
            "spec": spec_doc})
        if not reply.get("ok"):
            raise SchedulerError(
                f"worker {wid} refused tenant {rec.name!r}: "
                f"{reply.get('error')}",
                worker=wid, tenant=rec.name,
                hint=reply.get("kind", ""))

    # -- control RPC ----------------------------------------------------
    def _rpc(self, wid: int, doc: dict, timeout: float = 60.0) -> dict:
        wk = self._workers[wid]
        with wk.lock:
            if not wk.alive or wk.sock is None:
                raise SchedulerError(f"worker {wid} is dead",
                                     worker=wid)
            try:
                send_frame(wk.sock, doc)
                return recv_frame(wk.sock, timeout)
            except OSError as e:
                wk.alive = False
                raise SchedulerError(
                    f"worker {wid} control channel failed: {e!r}",
                    worker=wid)

    # -- tenant surface -------------------------------------------------
    def tenant_state(self, name: str) -> dict:
        """The owning worker's live row for one tenant (state, lease,
        conservation books once terminal)."""
        with self._lock:
            rec = self._placements.get(name)
            if rec is None:
                raise KeyError(f"no tenant {name!r}")
            wid, state = rec.worker, rec.state
        if state != "PLACED":
            row = rec.row()
        else:
            reply = self._rpc(wid, {"cmd": "tenant", "name": name})
            if not reply.get("ok"):
                raise SchedulerError(
                    f"worker {wid} has no tenant {name!r}: "
                    f"{reply.get('error')}", worker=wid, tenant=name)
            row = reply["row"]
            row["Worker"] = wid
        if row.get("State") == "FAILED":
            row["Log_tail"] = self.log_tail(wid)
        return row

    def wait(self, name: str, timeout: float = 120.0) -> dict:
        """Poll the owning worker until the tenant is terminal (the
        owner may CHANGE mid-wait when a crash re-places it)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                row = self.tenant_state(name)
            except SchedulerError:
                # owning worker just died: give the supervisor a beat
                # to re-place or fail the tenant, then re-read
                time.sleep(0.1)
                continue
            if row.get("State") in _TERMINAL:
                return row
            time.sleep(0.05)
        raise TimeoutError(
            f"tenant {name!r} not terminal within {timeout}s")

    def evict(self, name: str) -> dict:
        with self._lock:
            rec = self._placements.get(name)
            if rec is None:
                raise KeyError(f"no tenant {name!r}")
            wid = rec.worker
        reply = self._rpc(wid, {"cmd": "evict", "name": name})
        with self._lock:
            self._placements.pop(name, None)
        if not reply.get("ok"):
            raise SchedulerError(
                f"worker {wid} failed to evict {name!r}: "
                f"{reply.get('error')}", worker=wid, tenant=name)
        return reply.get("row") or {}

    # -- supervision ----------------------------------------------------
    def _supervise(self) -> None:
        while True:
            with self._lock:
                if self._closed:
                    return
            for wid, wk in list(self._workers.items()):
                rc = wk.proc.poll()
                if rc is not None and not wk.death_handled:
                    self._on_worker_death(wid, rc)
            time.sleep(0.1)

    def _on_worker_death(self, wid: int, rc: int) -> None:
        wk = self._workers[wid]
        wk.death_handled = True
        wk.alive = False
        wk.exit_code = rc
        try:
            if wk.sock is not None:
                wk.sock.close()
        except OSError:
            pass
        with self._lock:
            if self._closed:
                return
            victims = [rec for rec in self._placements.values()
                       if rec.worker == wid and rec.state == "PLACED"]
            for rec in victims:
                # not FAILED yet: a wait() polling mid-recovery must
                # keep waiting while the re-placement is in flight
                rec.state = "REPLACING"
                rec.error = f"worker {wid} died rc={rc}"
        self.flight.record("worker_death", worker=wid, exit=rc,
                           tenants=[r.name for r in victims])
        # re-place every victim under its ORIGINAL spec on a survivor
        # -- the same pure policy path as first placement, against the
        # re-read live view (the dead worker is gone from it)
        for rec in victims:
            try:
                with self._lock:
                    new_wid = self._choose_worker(rec.name, rec.spec)
                    rec.worker = new_wid
                    rec.state = "PLACED"
                    rec.attempts += 1
                    rec.error = None
                self._submit_to(new_wid, rec)
                self.flight.record("sched_replace", tenant=rec.name,
                                   worker=new_wid, from_worker=wid,
                                   attempts=rec.attempts)
            except (SchedulerError, ValueError) as e:
                with self._lock:
                    rec.state = "FAILED"
                    rec.error = str(e)
                self.flight.record("sched_rejected", tenant=rec.name,
                                   worker=wid, error=str(e),
                                   path="scheduler.FleetServer")

    def kill_worker(self, wid: int) -> None:
        """Chaos hook: SIGKILL one worker; the supervisor observes the
        death and re-places its tenants."""
        self._workers[wid].proc.kill()

    # -- observability --------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            placements = [r.row() for r in self._placements.values()]
        return {
            "Fleet": self.name,
            "Capacity": self.capacity,
            "Device_lanes": self.device_lanes,
            "Workers": [{"Worker": wid, "Alive": wk.alive,
                         "Pid": wk.proc.pid, "Exit": wk.exit_code}
                        for wid, wk in sorted(self._workers.items())],
            "Placements": placements,
            "Flight": self.flight.snapshot(),
        }

    def cluster(self) -> dict:
        """The merged live cluster view (distributed/observe.py):
        worker Scheduler blocks folded fleet-wide."""
        return self.observer.merged()

    # -- shutdown -------------------------------------------------------
    def close(self, timeout: float = 30.0) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for wid, wk in self._workers.items():
            if wk.alive and wk.sock is not None:
                try:
                    self._rpc(wid, {"cmd": "shutdown"}, timeout=10.0)
                except SchedulerError:
                    pass
        deadline = time.monotonic() + timeout
        for wk in self._workers.values():
            if wk.proc.poll() is None:
                try:
                    wk.proc.wait(max(0.1,
                                     deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    wk.proc.kill()
                    wk.proc.wait(5.0)
            if wk.exit_code is None:
                wk.exit_code = wk.proc.returncode
            wk.alive = False
            if wk.sock is not None:
                try:
                    wk.sock.close()
                except OSError:
                    pass
        self.observer.stop()
        if self._own_log_dir:
            shutil.rmtree(self.log_dir, ignore_errors=True)

    def __enter__(self) -> "FleetServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
