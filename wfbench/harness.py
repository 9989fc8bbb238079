"""One run of one benchmark cell through windflow_tpu_torch.

A cell is found by name: ``wfbench/workloads/<cell>.json`` holds its
traffic (event-time rate, batch sizes, warm-up) and names its
configuration; ``wfbench/configs/<config>.json`` holds the
configuration's sizes and ``wfbench/configs/<config>.py`` its generator
and its pipeline on the port's builder API; ``wfbench/reference/
<config>.py`` recomputes every window from the same inputs.  Which
metrics a run reports comes from ``BENCHMARK.json``; each is read by
``wfbench/metrics/<metric>.py`` (the whole name, else the part before
the first dot).  So a configuration, a cell or a metric is added as
files, with no edit here.

A run, in order: build the cell's graph with the default
``RuntimeConfig``; stream the cell's traffic until its first window has
closed and the warm-up time has passed (set-up); measure for
``seconds`` of steady stream; stop the source and drain; read the
device's peak memory; free the program; compare every window result
with the reference and check that the window engines ran on the run's
device; print the result unless a forbidden module was loaded.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
PROGRAM = "windflow_tpu_torch"
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "windflow_tpu")


def _process_start() -> float:
    """perf_counter() reading at this process's start (Linux: from the
    kernel's start time of the process; elsewhere: now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_PROCESS = _process_start()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: Path, name: str):
    """Import the Python file at ``path`` as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


# ---------------------------------------------------------------------------
# what a run is made of, found by name
# ---------------------------------------------------------------------------

class Spec:
    """A cell, its configuration, its reference and its metrics."""

    def __init__(self, workload: str, root: Path = ROOT):
        self.root = Path(root)
        self.bench = load_json(self.root / "BENCHMARK.json")
        self.workload = workload
        bench_dir = self.root / "wfbench"
        cell_path = bench_dir / "workloads" / f"{workload}.json"
        if not cell_path.is_file():
            raise SystemExit(f"no cell file {cell_path}")
        self.cell = load_json(cell_path)
        entry = [w for w in self.bench["workloads"] if w["name"] == workload]
        if entry and entry[0]["config"] != self.cell["config"]:
            raise SystemExit(f"{workload}: BENCHMARK.json names config "
                             f"{entry[0]['config']}, the cell file "
                             f"{self.cell['config']}")
        self.chips = int(entry[0]["chips"]) if entry else int(
            self.cell.get("chips", 1))
        name = self.cell["config"]
        self.config = load_json(bench_dir / "configs" / f"{name}.json")
        self.config_mod = load_file(bench_dir / "configs" / f"{name}.py",
                                    f"wfbench_config_{name}")
        self.reference = load_file(bench_dir / "reference" / f"{name}.py",
                                   f"wfbench_reference_{name}")
        self.metrics_dir = bench_dir / "metrics"
        e2e = [m for m in self.bench["end_to_end"] if self._has(m)]
        e2e_names = {m["name"] for m in e2e}
        self.end_to_end = e2e
        self.per_layer = [
            m for m in self.bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in e2e_names)]

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or \
            self.workload in metric["workloads"]

    def reader(self, metric: str):
        """The reader module of ``metric``: metrics/<name>.py, else
        metrics/<name up to its first dot>.py."""
        for stem in (metric, metric.split(".", 1)[0]):
            path = self.metrics_dir / f"{stem}.py"
            if path.is_file():
                return load_file(path, "wfbench_metric_"
                                 + stem.replace(".", "_"))
        raise SystemExit(f"no reader for metric {metric} in "
                         f"{self.metrics_dir}")


# ---------------------------------------------------------------------------
# the run's record: what the readers read
# ---------------------------------------------------------------------------

class Run:
    """Everything one run measured.  Times are ``time.perf_counter()``
    seconds; the window is [t_start, t_end)."""

    def __init__(self, spec: Spec, seed: int, seconds: float, trace: bool):
        self.spec = spec
        self.cell = spec.cell
        self.config = spec.config
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.t_process = T_PROCESS
        self.t_stream = None          # first source call
        self.t_start = None
        self.t_end = None
        # one row per source call: entry and exit of the generator,
        # events, first event index
        self.calls: List[tuple] = []
        self.counters_start: Dict[str, float] = {}
        self.counters_end: Dict[str, float] = {}
        self.events_total = 0
        self.profile = None           # Profile, traced runs only
        self.results = None           # dict of arrays, after the drain
        self.memory_peak_bytes = 0
        self.graph_shape = ""
        self.attempted = 0
        self.failed = 0
        self.marks: Dict[str, float] = {}   # set-up's steps, for stderr

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    @property
    def setup_s(self) -> float:
        return self.t_start - self.t_process

    def window_calls(self) -> np.ndarray:
        """The source calls of the window as a float array
        [t_in, t_out, n, first]."""
        rows = [c for c in self.calls if self.t_start <= c[0] < self.t_end]
        return np.array(rows, dtype=np.float64).reshape(-1, 4)

    @property
    def events_in_window(self) -> int:
        return int(self.window_calls()[:, 2].sum())

    def counter_delta(self, name: str) -> float:
        return self.counters_end[name] - self.counters_start[name]


# ---------------------------------------------------------------------------
# the program's counters
# ---------------------------------------------------------------------------

def window_logics(graph) -> list:
    """Every device window engine's logic in a started graph, seen
    through fused, chained and device-step nodes."""
    from windflow_tpu_torch.operators.tpu.win_seq_tpu import WinSeqTPULogic
    from windflow_tpu_torch.runtime.node import ChainedLogic, FusedLogic
    found = []
    for node in graph._all_nodes():
        lg = node.logic
        parts = ([s.logic for s in lg.segments]
                 if isinstance(lg, FusedLogic) else [lg])
        for p in parts:
            halves = [p.a, p.b] if isinstance(p, ChainedLogic) else [p]
            found += [h for h in halves if isinstance(h, WinSeqTPULogic)]
    return found


def read_counters(graph, device: str) -> Dict[str, float]:
    """The program's own counters, summed over its window engines:
    launches (stats ``Device_launches``), windows staged into launches
    (each ``WindowComputeEngine.launch_shapes``), and the engines that
    do not launch on ``device`` (a host lane, or a device engine bound
    elsewhere; 1 where the graph has no window engine at all)."""
    from windflow_tpu_torch.ops.host_compute import HostComputeEngine
    from windflow_tpu_torch.ops.window_compute import WindowComputeEngine
    launches = windows = 0
    logics = window_logics(graph)
    off = 0 if logics else 1
    for lg in logics:
        st = lg.stats
        launches += st.num_launches if st is not None else \
            lg.launched_batches
        if lg.resolved_placement == "host":
            off += 1
        for eng in list(vars(lg).values()):
            if isinstance(eng, HostComputeEngine):
                off += 1
            if not isinstance(eng, WindowComputeEngine):
                continue
            if eng.device is None or eng.device.type != device:
                off += 1
            for _ in range(8):  # the dispatcher may add a shape meanwhile
                try:
                    rows = list(eng.launch_shapes.values())
                    break
                except RuntimeError:
                    continue
            else:
                rows = []
            windows += sum(r[2] for r in rows)
    return {"launches": launches, "windows_launched": windows,
            "engines_off_device": off}


# ---------------------------------------------------------------------------
# the source: a closed loop over the configuration's generator
# ---------------------------------------------------------------------------

class Source:
    """The graph's source function: a closed loop, a batch of
    ``source_batch`` events whenever the graph takes one, as the
    configuration's generator makes them (it stamps the event times:
    ``rate`` events a second of event time)."""

    def __init__(self, run: Run, stream, make_batch: Callable,
                 span: Callable, device: str):
        self.run = run
        self.stream = stream
        self.make_batch = make_batch
        self.span = span
        self.device = device
        self.batch = int(run.cell["source_batch"])
        self.sent = 0
        self.begin = threading.Event()     # set by the harness: measure
        self.ended = threading.Event()     # set here: the window closed
        self.stopped = False
        self.graph = None

    def __call__(self, ctx=None):
        run = self.run
        now = time.perf_counter()
        if run.t_stream is None:
            run.t_stream = now
        if self.stopped:
            return None
        if run.t_start is None and self.begin.is_set():
            run.t_start = now
            run.counters_start = read_counters(self.graph, self.device)
        elif run.t_start is not None and now >= run.t_start + run.seconds:
            run.t_end = now
            run.counters_end = read_counters(self.graph, self.device)
            run.events_total = self.sent
            self.stopped = True
            self.ended.set()
            return None
        n, first = self.batch, self.sent
        t_in = time.perf_counter()
        with self.span("wfbench/generate"):
            batch = self.make_batch(self.stream.columns(first, n))
        t_out = time.perf_counter()
        self.sent += n
        run.calls.append((t_in, t_out, n, first))
        return batch


class Sink:
    """Stamps each result batch's arrival and keeps its columns."""

    def __init__(self, span: Callable):
        self.span = span
        self.lock = threading.Lock()
        self.parts: List[tuple] = []
        self.count = 0

    def __call__(self, item):
        if item is None:
            return
        t = time.perf_counter()
        with self.span("wfbench/sink"):
            key = np.asarray(item.key, np.int64)
            wid = np.asarray(item.id, np.int64)
            val = np.asarray(item["value"], np.float64)
            with self.lock:
                self.parts.append((key, wid, val, t))
                self.count += len(key)

    def arrays(self) -> Dict[str, np.ndarray]:
        with self.lock:
            parts = list(self.parts)
        if not parts:
            z = np.zeros(0, np.int64)
            return {"key": z, "wid": z, "value": z.astype(np.float64),
                    "arrival": z.astype(np.float64)}
        return {
            "key": np.concatenate([p[0] for p in parts]),
            "wid": np.concatenate([p[1] for p in parts]),
            "value": np.concatenate([p[2] for p in parts]),
            "arrival": np.concatenate([np.full(len(p[0]), p[3])
                                       for p in parts]),
        }


# ---------------------------------------------------------------------------
# the device trace
# ---------------------------------------------------------------------------

class Profile:
    """A torch.profiler capture over the window, as perf_counter
    intervals: the device's kernels, copies and sets, and the host's
    named ranges (the benchmark's own spans, the port's
    ``launch_span``, and the source thread's stretches inside the graph
    between two generator calls)."""

    HOST_PREFIXES = ("wfbench/", "windflow/")

    def __init__(self, prof, offset_s: float, calls: List[tuple]):
        from torch.autograd import DeviceType
        self.device: List[tuple] = []
        self.host: List[tuple] = []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            a = e.start_ns() / 1e9 - offset_s
            b = a + e.duration_ns() / 1e9
            if name.startswith(self.HOST_PREFIXES):
                # a named host range (its mirror on the device's
                # timeline is an annotation, not device work)
                if e.device_type() != DeviceType.CUDA:
                    self.host.append((name, a, b))
            elif e.device_type() == DeviceType.CUDA:
                self.device.append((name, a, b))
        self.host += [("wfbench/source thread in the graph", c0[1], c1[0])
                      for c0, c1 in zip(calls, calls[1:])]

    def device_intervals(self, substr: str = "") -> List[tuple]:
        return [(a, b) for n, a, b in self.device if substr in n]


def start_profiler(device: str):
    """A started torch.profiler over the host and the card, recording
    the host ranges of every thread (the graph runs on several)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    try:
        from torch._C._profiler import _ExperimentalConfig
        prof = profile(activities=acts, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True)))
    except (ImportError, TypeError):
        prof = profile(activities=acts)
    prof.start()
    return prof


def make_span(trace: bool) -> Callable:
    if not trace:
        from contextlib import nullcontext
        return lambda label: nullcontext()
    from torch.profiler import record_function
    return record_function


# ---------------------------------------------------------------------------
# correctness
# ---------------------------------------------------------------------------

def match(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]):
    """Pair the program's windows with the reference's by (key, wid).
    Returns (for each reference window the index of the first program
    window with its (key, wid), else -1; program windows with no
    reference window; program windows produced a second time)."""
    n_got = len(got["key"])
    k = np.concatenate([got["key"], want["key"]]).astype(np.int64)
    w = np.concatenate([got["wid"], want["wid"]]).astype(np.int64)
    src = np.concatenate([np.zeros(n_got, np.int8),
                          np.ones(len(want["key"]), np.int8)])
    idx = np.concatenate([np.arange(n_got), np.arange(len(want["key"]))])
    order = np.lexsort((src, w, k))    # a program window first in a pair
    k, w, src, idx = k[order], w[order], src[order], idx[order]
    n = len(k)
    new = np.ones(n, bool)
    new[1:] = (k[1:] != k[:-1]) | (w[1:] != w[:-1])
    head = np.maximum.accumulate(np.where(new, np.arange(n), 0))
    want_pos = np.nonzero(src == 1)[0]
    got_pos = np.nonzero(src == 0)[0]
    found = src[head[want_pos]] == 0
    pairs = np.full(len(want["key"]), -1, np.int64)
    pairs[idx[want_pos]] = np.where(found, idx[head[want_pos]], -1)
    has_want = np.zeros(n, bool)
    has_want[head[want_pos]] = True
    extra = int((~has_want[head[got_pos]]).sum())
    dup = int((got_pos != head[got_pos]).sum())
    return pairs, extra, dup


def compare(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
            rtol: float):
    """Every window the program produced against the reference's.
    Returns ({check: [reading, limit]}, pairs, windows wrong), each
    reading held at or below its limit: windows
    missing, windows extra (not in the reference, or produced twice),
    and the largest departure of a window's value from the reference's,
    relative to the reference's value (at least 1); ``rtol`` 0 asks for
    equality."""
    pairs, extra, dup = match(got, want)
    found = pairs >= 0
    gv = got["value"][pairs[found]]
    wv = want["value"][found]
    rel = np.abs(gv - wv) / np.maximum(np.abs(wv), 1.0)
    rel = np.where(np.isnan(rel), np.inf, rel)
    checks = {"windows_missing": [int((~found).sum()), 0],
              "windows_extra": [extra + dup, 0],
              "max_rel_err": [float(rel.max()) if len(rel) else 0.0,
                              rtol]}
    return checks, pairs, int((rel > rtol).sum())


def verdict(checks: Dict[str, list]) -> bool:
    """Every reading at or below its limit (``launches_in_window``: at
    or above it)."""
    return all(math.isfinite(v) and (v >= lim if k in AT_LEAST else
                                     v <= lim)
               for k, (v, lim) in checks.items())


# checks whose reading is held at or above its limit
AT_LEAST = ("launches_in_window",)


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def card_facts() -> Dict[str, str]:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        name, limit = out[0].rsplit(",", 1)
        return {"name": name.strip(), "power_limit": limit.strip()}
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return {}


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool,
             device: str = "cuda", warm_timeout_s: float = 240.0,
             marks: Optional[Dict[str, float]] = None):
    """Run the cell once on ``device`` ("cuda" on the card; "cpu" only
    where a test drives the harness without one).  ``marks`` are set-up
    steps already taken.  Returns the run and the generator, which the
    reference reads again."""
    import torch
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.core.tuples import TupleBatch

    here = Path(wf.__file__).resolve()
    if spec.root.resolve() not in here.parents and \
            ROOT.resolve() not in here.parents:
        raise SystemExit(f"{PROGRAM} loaded from {here}, outside the "
                         f"checkout")
    run = Run(spec, seed, seconds, trace)
    run.marks.update(marks or {})
    run.marks["program imported"] = time.perf_counter()
    cfg_mod = spec.config_mod
    span = make_span(trace)
    stream = cfg_mod.make_stream(spec.config, spec.cell, seed)
    run.marks["generator made"] = time.perf_counter()
    graph = wf.PipeGraph(f"wfbench_{spec.workload}", wf.Mode.DEFAULT,
                         config=wf.RuntimeConfig(device=device))
    source = Source(run, stream, TupleBatch, span, device)
    sink = Sink(span)
    cfg_mod.build(graph, spec.config, spec.cell, source, sink, span)
    source.graph = graph
    run.marks["graph built"] = time.perf_counter()

    failure: List[BaseException] = []

    def drive():
        try:
            graph.run()
        except BaseException as e:  # reported by the main thread
            failure.append(e)
            source.ended.set()

    th = threading.Thread(target=drive, name="wfbench-graph", daemon=True)
    th.start()
    # set-up ends once the first window has closed and the warm-up time
    # has passed: the first window's shapes are built and launched
    warm_s = float(spec.cell.get("warm_s", 0.0))
    t_give_up = time.perf_counter() + warm_timeout_s
    while not failure:
        if run.t_stream is not None and sink.count > 0 and \
                time.perf_counter() - run.t_stream >= warm_s:
            break
        if time.perf_counter() > t_give_up:
            source.stopped = True
            th.join()
            raise RuntimeError("warm-up: no window result within "
                               f"{warm_timeout_s} s")
        time.sleep(0.005)
    run.marks["stream started"] = run.t_stream or math.nan
    with sink.lock:
        run.marks["first result"] = sink.parts[0][3] if sink.parts \
            else math.nan
    prof = None
    if trace and not failure:
        prof = start_profiler(device)
        offset = time.time_ns() / 1e9 - time.perf_counter()
    source.begin.set()
    source.ended.wait()
    if prof is not None:
        prof.stop()
    th.join()
    if failure:
        raise failure[0]
    if device == "cuda":
        torch.cuda.synchronize()
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(0))
    if prof is not None:
        run.profile = Profile(prof, offset, run.calls)
        del prof
    run.graph_shape = (f"{len(graph._all_nodes())} node(s) "
                       f"{[n.name for n in graph._all_nodes()]}, channels "
                       f"of {graph.config.queue_capacity} items")
    run.results = sink.arrays()
    del graph, source, sink
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return run, stream


def judge(run: Run, stream) -> Dict[str, list]:
    """Compare every result with the reference, and check that the
    window engines launched on the run's device inside the window."""
    spec = run.spec
    want = spec.reference.windows(spec.config, spec.cell, stream,
                                  run.events_total)
    checks, pairs, wrong = compare(run.results, want,
                                   float(spec.config.get("rtol", 0.0)))
    checks["launches_in_window"] = [run.counter_delta("launches"), 1]
    checks["engines_off_device"] = [
        max(run.counters_start["engines_off_device"],
            run.counters_end["engines_off_device"]), 0]
    run.attempted = len(want["key"])
    run.failed = checks["windows_missing"][0] + wrong
    return checks


def read_metrics(run: Run) -> Dict[str, dict]:
    spec = run.spec
    wanted = spec.per_layer if run.trace else spec.end_to_end
    out = {}
    for m in wanted:
        v = spec.reader(m["name"]).read(run)
        if v is None:
            continue
        out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def breakdown(run: Run) -> Optional[dict]:
    """The ten device ops that took most time in the window, and the ten
    longest idle stretches of the device named by the host range that
    covers most of each."""
    from wfbench import roofline
    prof = run.profile
    if prof is None:
        return None
    lo, hi = run.t_start, run.t_end
    by_name: Dict[str, float] = {}
    for name, a, b in prof.device:
        d = min(b, hi) - max(a, lo)
        if d > 0:
            by_name[name] = by_name.get(name, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(roofline.gaps(prof.device_intervals(), lo, hi),
                  key=lambda g: g[0] - g[1])[:10]
    named = []
    for a, b in idle:
        cover: Dict[str, float] = {}
        for name, x, y in prof.host:
            d = min(b, y) - max(a, x)
            if d > 0:
                cover[name] = cover.get(name, 0.0) + d
        label = max(cover, key=cover.get) if cover else \
            "untraced host work"
        named.append([label, b - a])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def result_line(run: Run, checks: Dict[str, list], correct: bool,
                device_kind: str, n_devices: int) -> dict:
    dev = {"platform": "gpu", "kind": device_kind, "count": n_devices,
           "memory_peak_bytes": run.memory_peak_bytes}
    if run.trace and run.profile is not None:
        from wfbench import roofline
        dev["busy_s"] = roofline.busy_s(run.profile.device_intervals(),
                                        run.t_start, run.t_end)
        dev["window_s"] = run.window_s
    line = {"correct": correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": read_metrics(run),
            "device": dev}
    bd = breakdown(run) if run.trace else None
    if bd is not None:
        line["breakdown"] = bd
    # JSON has no infinity or NaN: such a reading is written as text
    line["checks"] = {k: {"value": v if math.isfinite(v) else str(v),
                          "limit": lim,
                          "holds": ">=" if k in AT_LEAST else "<="}
                      for k, (v, lim) in checks.items()}
    return line


def main(argv: List[str]) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = Spec(args.workload)
    if args.trace:
        # the port's launch_span becomes a record_function range
        os.environ["WINDFLOW_TORCH_PROFILE"] = "1"
    import torch
    marks = {"torch imported": time.perf_counter()}
    if not torch.cuda.is_available():
        print("wfbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec.chips:
        print(f"wfbench: the cell needs {spec.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    run, stream = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                           marks=marks)
    checks = judge(run, stream)
    correct = verdict(checks)
    line = result_line(run, checks, correct, torch.cuda.get_device_name(0),
                       spec.chips)
    card = card_facts()
    steps = ", ".join(f"{k} {v - run.t_process:.3f}"
                      for k, v in run.marks.items())
    print(f"wfbench: set-up steps (s from the process's start): {steps}",
          file=sys.stderr)
    print(f"wfbench: {args.workload} seed {args.seed}: window "
          f"{run.window_s:.3f} s, {run.events_in_window} events in it, "
          f"{run.events_total} in all; set-up {run.setup_s:.3f} s; "
          f"graph: {run.graph_shape}; card "
          f"{card.get('name', '?')}, power limit "
          f"{card.get('power_limit', '?')}", file=sys.stderr)
    calls = run.window_calls()
    edges = run.t_start + np.arange(0.0, run.window_s + 1e-9, 5.0)
    slices = [calls[(calls[:, 0] >= a) & (calls[:, 0] < b), 2].sum()
              / (min(b, run.t_end) - a) for a, b in zip(edges, edges[1:])]
    print("wfbench: events/s in 5 s slices of the window: "
          + ", ".join(f"{v:.0f}" for v in slices), file=sys.stderr)
    # last, once every reader has run: nothing the run loaded may be
    # JAX or the JAX package
    found = forbidden_modules()
    if found:
        print(f"wfbench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, (v, lim) in checks.items():
        print(f"check {k} {v} {'>=' if k in AT_LEAST else '<='} limit "
              f"{lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0
