"""Worker-process orchestration of a distributed PipeGraph
(docs/DISTRIBUTED.md "Running a distributed graph").

The model mirrors ``run_with_epochs``: the user provides a BUILD
function (top-level, importable -- each worker imports and calls it
against a fresh graph, so nothing needs to pickle) and optionally a
CONFIG factory ``config_fn(worker_id) -> RuntimeConfig`` next to it.
:func:`run_distributed` is the coordinator: it allocates loopback
endpoints, spawns one clean ``python -m windflow_tpu_torch.distributed.worker``
process per worker (no parent state inherited -- a worker
only imports what its partition runs), waits for them, and merges the
per-worker stats JSON dumps into one graph view whose cross-process
wire books must balance.

With ``RuntimeConfig.durability`` set, the coordinator is also the
restart loop: each worker commits its partition's epoch manifests
under ``<path>/w<i>``; on a worker death (a crash, or an injected
``FaultPlan.kill_worker``) every process is reaped and the whole graph
restarts from the newest epoch committed by EVERY worker -- a globally
consistent cut, because aligned barriers crossed the wire before any
worker committed them.
"""
from __future__ import annotations

import inspect
import json
import os
import socket
import subprocess
import sys
import time as _time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .wiring import KILL_EXIT


@dataclass
class DistributedSpec:
    """Per-worker distributed-runtime parameters
    (``RuntimeConfig.distributed``)."""

    worker_id: int
    n_workers: int
    # shuffle-server endpoint per worker, index == worker id
    endpoints: Sequence[Tuple[str, int]]
    # operator-substring -> worker pins, merged over .with_worker
    assignment: Optional[Dict[str, int]] = None
    # credit window of each wire edge (tuples outstanding past the
    # consumer's bounded channel)
    wire_credits: int = 1 << 15
    # transparent reconnect budget per sender before the edge fails
    wire_reconnects: int = 2
    # how long a receiver waits for a producer to come back before the
    # edge counts as lost (graph cancels)
    reconnect_grace_s: float = 2.0
    connect_timeout_s: float = 15.0
    # live cluster view (observe.py): the coordinator's ClusterObserver
    # ingest endpoint -- when set, the wiring attaches a StatsPusher
    # that pushes stats + flight deltas every push_interval_s
    observe_endpoint: Optional[Tuple[str, int]] = None
    push_interval_s: float = 0.5
    extra: dict = field(default_factory=dict)


class WorkerFailure(RuntimeError):
    """One or more workers exited abnormally past the restart budget."""

    def __init__(self, msg: str, exit_codes=None, logs=None):
        super().__init__(msg)
        self.exit_codes = exit_codes or {}
        self.logs = logs or {}


def _callable_ref(fn: Callable) -> Dict[str, str]:
    """(file, qualname) reference a worker can import without pickling.
    Lambdas/closures are rejected loudly -- the build function runs in
    another process."""
    name = getattr(fn, "__qualname__", getattr(fn, "__name__", ""))
    if not name or "<" in name:
        raise ValueError(
            f"distributed build/config functions must be importable "
            f"top-level functions, not {name or fn!r} "
            "(docs/DISTRIBUTED.md)")
    try:
        path = inspect.getfile(fn)
    except TypeError as e:
        raise ValueError(
            f"cannot locate source file of {name} for worker import"
        ) from e
    return {"file": os.path.abspath(path), "name": name,
            "module": getattr(fn, "__module__", None)}


def _load_ref(ref: Dict[str, str]) -> Callable:
    """Worker-side import: prefer the real module path (package files
    keep their relative imports), fall back to loading the source file
    directly (test files / scripts that are not importable as modules
    in a fresh interpreter)."""
    import importlib
    import importlib.util
    mod = None
    modname = ref.get("module")
    if modname and modname != "__main__":
        try:
            mod = importlib.import_module(modname)
        except ImportError:
            mod = None
    if mod is None:
        alias = "_windflow_dist_" + os.path.basename(
            ref["file"]).replace(".", "_")
        mod = sys.modules.get(alias)
        if mod is None:
            spec = importlib.util.spec_from_file_location(alias,
                                                          ref["file"])
            mod = importlib.util.module_from_spec(spec)
            sys.modules[alias] = mod
            spec.loader.exec_module(mod)
    obj = mod
    for part in ref["name"].split("."):
        obj = getattr(obj, part)
    return obj


def free_ports(n: int, host: str = "127.0.0.1") -> List[int]:
    """``n`` currently-free TCP ports (best-effort: bound then released,
    so a race is possible but the spawn follows immediately)."""
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


# ---------------------------------------------------------------------------
# worker side (invoked by distributed/worker.py with the spec JSON)
# ---------------------------------------------------------------------------

def _worker_durability(cfg, worker_id: int):
    """Re-root the manifest store per worker: one partition, one
    manifest stream."""
    import dataclasses
    if cfg.durability is None:
        return None
    cfg.durability = dataclasses.replace(
        cfg.durability,
        path=os.path.join(cfg.durability.path, f"w{worker_id}"))
    return cfg.durability


def _restore_worker(graph, store, epoch: int, plan, worker_id: int,
                    overrides: Optional[dict] = None) -> int:
    """Load this worker's slice of epoch ``epoch`` into an unstarted
    graph.  The manifest was written by the same partition, so its
    stateful-name set must equal the owned stateful set -- a silent
    partial restore would desync the workers.  ``overrides``
    (operator name -> new parallelism, from
    ``run_distributed(parallelism_overrides=...)``) lifts named replica
    groups out of that contract and repartitions their keyed state
    through the elastic ``hash % n`` owner function, PROVIDED the
    whole group lives on this worker -- a group split across workers
    cannot be repartitioned from one worker's manifest alone."""
    import pickle
    from ..utils.checkpoint import (_is_stateful, _override_for,
                                    _replica_group, _repartition_group)
    from ..durability.delta import load_into
    payload = store.load(epoch)
    states = payload.get("states") or {}
    owned_stateful = set()
    loaded = 0
    owned_nodes = {}
    for n in graph._all_nodes():
        if plan.get(n.name) != worker_id:
            continue
        if not _is_stateful(n.logic):
            continue
        owned_stateful.add(n.name)
        owned_nodes[n.name] = n
    missing = owned_stateful - set(states)
    foreign = set(states) - owned_stateful
    handled = set()
    if (missing or foreign) and overrides:
        groups = set()
        for name in list(missing) + list(foreign):
            prefix, _idx = _replica_group(name)
            if prefix is not None and _override_for(prefix, overrides):
                groups.add(prefix)
        for prefix in sorted(groups):
            off_worker = [n.name for n in graph._all_nodes()
                          if _replica_group(n.name)[0] == prefix
                          and plan.get(n.name) != worker_id]
            if off_worker:
                raise RuntimeError(
                    f"parallelism override for {prefix!r} needs the "
                    f"whole replica group on worker {worker_id}, but "
                    f"{sorted(off_worker)} are placed elsewhere -- pin "
                    "the operator to one worker to restore it into a "
                    "different parallelism (docs/DISTRIBUTED.md)")
            manifest_names = sorted(
                n for n in states if _replica_group(n)[0] == prefix)
            group_logics = sorted(
                ((_replica_group(nm)[1], nd.logic)
                 for nm, nd in owned_nodes.items()
                 if _replica_group(nm)[0] == prefix),
                key=lambda t: t[0])
            if not manifest_names or not group_logics:
                continue
            _repartition_group(
                prefix, f"epoch manifest (epoch {epoch})", states,
                pickle.loads, manifest_names, group_logics)
            loaded += len(group_logics)
            handled.update(manifest_names)
            handled.update(nm for nm in owned_nodes
                           if _replica_group(nm)[0] == prefix)
            missing -= {nm for nm in missing
                        if _replica_group(nm)[0] == prefix}
            foreign -= set(manifest_names)
    if missing or foreign:
        raise RuntimeError(
            f"epoch manifest (epoch {epoch}) does not match worker "
            f"{worker_id}'s partition: missing states {sorted(missing)}, "
            f"foreign states {sorted(foreign)} -- was the graph or the "
            "partition changed between restarts? (docs/DISTRIBUTED.md)")
    for name, n in owned_nodes.items():
        if name in handled:
            continue
        blob = states.get(name)
        if blob is not None:
            load_into(n.logic, pickle.loads(blob))
            loaded += 1
    return loaded


def worker_main(spec_doc: dict) -> int:
    """One worker process: build, partition, restore, run, dump."""
    from ..core.basic import RuntimeConfig
    from .identity import ENV_WORKER_ID
    from .partition import plan_partition
    wid = int(spec_doc["worker_id"])
    os.environ[ENV_WORKER_ID] = str(wid)
    build = _load_ref(spec_doc["build"])
    config_fn = (_load_ref(spec_doc["config"])
                 if spec_doc.get("config") else None)
    cfg = config_fn(wid) if config_fn is not None else RuntimeConfig()
    dcfg = _worker_durability(cfg, wid)
    observe = spec_doc.get("observe")
    cfg.distributed = DistributedSpec(
        worker_id=wid,
        n_workers=int(spec_doc["n_workers"]),
        endpoints=[tuple(e) for e in spec_doc["endpoints"]],
        assignment=spec_doc.get("assignment") or None,
        observe_endpoint=(observe[0], int(observe[1]))
        if observe else None,
        **(spec_doc.get("wire") or {}))
    from ..graph.pipegraph import PipeGraph
    g = PipeGraph(spec_doc.get("graph_name", "dist"), config=cfg)
    build(g)
    restore = spec_doc.get("restore_epoch")
    if restore:
        from ..durability.store import EpochStore
        plan = plan_partition(g)
        store = EpochStore(dcfg.path, dcfg.retained)
        n = _restore_worker(g, store, int(restore), plan, wid,
                            overrides=spec_doc.get("overrides") or None)
        g._epoch_restored = int(restore)
        g.flight.record("epoch_restore", epoch=int(restore), replicas=n,
                        worker=wid, attempt=spec_doc.get("attempt", 0))
    stats_path = spec_doc.get("stats_path")
    try:
        g.run()
        return 0
    except BaseException:
        import traceback
        traceback.print_exc()
        return 1
    finally:
        if stats_path:
            try:
                g.refresh_gauges()
                with open(stats_path, "w") as f:
                    f.write(g.stats.to_json(
                        g.get_num_dropped_tuples(),
                        g.dead_letters.count(),
                        flight_events=g.flight.snapshot()))
            except Exception:
                pass  # post-mortem dump is best-effort


# ---------------------------------------------------------------------------
# coordinator side
# ---------------------------------------------------------------------------

def _common_epoch(dcfg, n_workers: int) -> Optional[int]:
    """Newest epoch committed by EVERY worker (the globally consistent
    restore point), or None when any worker has nothing loadable."""
    from ..durability.store import EpochStore
    floor = None
    for w in range(n_workers):
        store = EpochStore(os.path.join(dcfg.path, f"w{w}"),
                           dcfg.retained)
        e, _payload = store.latest()
        if e is None:
            return None
        floor = e if floor is None else min(floor, e)
    return floor


def run_distributed(build: Callable, n_workers: int = 2, *,
                    config_fn: Optional[Callable] = None,
                    graph_name: str = "dist",
                    assignment: Optional[Dict[str, int]] = None,
                    workdir: Optional[str] = None,
                    max_restarts: int = 0,
                    timeout_s: float = 300.0,
                    wire: Optional[dict] = None,
                    observe: bool = True,
                    parallelism_overrides: Optional[dict] = None) -> dict:
    """Run ``build`` as one PipeGraph across ``n_workers`` processes.

    Returns a report dict: per-worker stats paths, the merged one-graph
    view (:func:`~.observe.merge_stats`), attempts taken, and per-worker
    exit codes.  Raises :class:`WorkerFailure` when workers still fail
    past ``max_restarts``.

    With ``observe`` (the default) the coordinator also runs a live
    :class:`~.observe.ClusterObserver`: workers push stats + flight
    deltas to it mid-run, the continuously-merged view (and its doctor
    report) is served at ``GET /cluster``, and the endpoint is written
    to ``<workdir>/observer.json`` so tools -- notably ``python -m
    windflow_tpu_torch.doctor --watch <url>`` -- can find it while the run
    is still going.  The observer survives restart attempts, so the
    live view spans a kill-restart cycle.
    """
    from .observe import ClusterObserver, merge_stats
    build_ref = _callable_ref(build)
    config_ref = _callable_ref(config_fn) if config_fn else None
    workdir = workdir or os.path.join("log", f"dist_{graph_name}")
    os.makedirs(workdir, exist_ok=True)
    dcfg = config_fn(0).durability if config_fn else None
    observer = None
    if observe:
        observer = ClusterObserver()
        observer.start()
        observer.serve_http()
        with open(os.path.join(workdir, "observer.json"), "w") as f:
            json.dump({"http": observer.http_url,
                       "ingest": [observer.host, observer.port]}, f)
    attempts = 0
    history: List[Dict[int, int]] = []
    while True:
        ports = free_ports(n_workers)
        endpoints = [["127.0.0.1", p] for p in ports]
        restore = (_common_epoch(dcfg, n_workers)
                   if dcfg is not None and attempts > 0 else None)
        procs: Dict[int, subprocess.Popen] = {}
        logs: Dict[int, str] = {}
        stats_paths: Dict[int, str] = {}
        for w in range(n_workers):
            spec_doc = {
                "worker_id": w, "n_workers": n_workers,
                "endpoints": endpoints,
                "build": build_ref, "config": config_ref,
                "graph_name": graph_name,
                "assignment": assignment,
                "stats_path": os.path.join(
                    workdir, f"stats_w{w}.json"),
                "restore_epoch": restore,
                "attempt": attempts,
                "overrides": parallelism_overrides,
                "wire": wire or {},
                "observe": ([observer.host, observer.port]
                            if observer is not None else None),
            }
            stats_paths[w] = spec_doc["stats_path"]
            logs[w] = os.path.join(workdir, f"worker_{w}.log")
            env = dict(os.environ)
            env["WINDFLOW_WORKER_ID"] = str(w)
            # restart context for build-side effect writers (e.g. an
            # epoch-keyed sink file that supersedes a crashed attempt's
            # uncommitted tail at read time)
            env["WINDFLOW_DIST_ATTEMPT"] = str(attempts)
            env["WINDFLOW_DIST_RESTORE"] = str(restore or 0)
            # the workers must import THIS windflow_tpu_torch regardless
            # of the coordinator's cwd / install mode
            pkg_root = os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))))
            env["PYTHONPATH"] = pkg_root + os.pathsep + \
                env.get("PYTHONPATH", "")
            with open(logs[w], "ab") as logf:
                logf.write(f"==== attempt {attempts} ====\n".encode())
                procs[w] = subprocess.Popen(
                    [sys.executable, "-m",
                     "windflow_tpu_torch.distributed.worker",
                     json.dumps(spec_doc)],
                    stdout=logf, stderr=subprocess.STDOUT, env=env,
                    cwd=os.getcwd())
        deadline = _time.monotonic() + timeout_s
        codes: Dict[int, int] = {}
        try:
            while len(codes) < n_workers:
                for w, p in procs.items():
                    if w in codes:
                        continue
                    rc = p.poll()
                    if rc is not None:
                        codes[w] = rc
                if _time.monotonic() > deadline:
                    if observer is not None:
                        observer.stop()
                    raise WorkerFailure(
                        f"distributed run timed out after {timeout_s}s "
                        f"(exited: {codes})", codes, logs)
                if any(rc != 0 for rc in codes.values()) \
                        and len(codes) < n_workers:
                    # one worker died: give peers a moment to observe
                    # the broken wire and unwind, then reap them
                    grace = _time.monotonic() + 20.0
                    while len(codes) < n_workers \
                            and _time.monotonic() < grace:
                        for w, p in procs.items():
                            if w not in codes and p.poll() is not None:
                                codes[w] = p.returncode
                        _time.sleep(0.05)
                    for w, p in procs.items():
                        if w not in codes:
                            p.terminate()
                            try:
                                codes[w] = p.wait(timeout=10.0)
                            except subprocess.TimeoutExpired:
                                # wedged past SIGTERM (native code):
                                # hard-kill; the exception contract
                                # stays WorkerFailure, never a raw
                                # TimeoutExpired
                                p.kill()
                                codes[w] = p.wait(timeout=10.0)
                    break
                _time.sleep(0.05)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    try:
                        p.wait(timeout=10.0)
                    except subprocess.TimeoutExpired:
                        pass  # unkillable zombie: reporting still wins
        history.append(dict(codes))
        if all(rc == 0 for rc in codes.values()):
            stats = []
            for w in range(n_workers):
                try:
                    with open(stats_paths[w]) as f:
                        stats.append(json.load(f))
                except (OSError, ValueError):
                    stats.append(None)
            live_merged = None
            observer_info = None
            if observer is not None:
                # the live view's final fold (what --watch last saw),
                # next to the authoritative file-based merge below
                live_merged = observer.merged()
                observer_info = {"url": observer.http_url,
                                 "pushes": observer.pushes}
                observer.stop()
            return {
                "attempts": attempts + 1,
                "exit_codes": history,
                "stats_paths": [stats_paths[w] for w in range(n_workers)],
                "worker_stats": stats,
                "merged": merge_stats([s for s in stats if s]),
                "live_merged": live_merged,
                "observer": observer_info,
                "logs": [logs[w] for w in range(n_workers)],
            }
        attempts += 1
        if attempts > max_restarts:
            tails = {}
            for w, lp in logs.items():
                try:
                    with open(lp, errors="replace") as f:
                        tails[w] = f.read()[-2000:]
                except OSError:
                    tails[w] = ""
            killed = [w for w, rc in codes.items() if rc == KILL_EXIT]
            if observer is not None:
                observer.stop()
            raise WorkerFailure(
                f"distributed run failed after {attempts} attempt(s): "
                f"exit codes {codes}"
                + (f" (injected kill on worker(s) {killed})"
                   if killed else ""),
                codes, tails)
