"""Worker-side builds and configs of the port's two-process tests
(tests/test_torch_distributed_procs.py, tests/test_torch_card.py).

A distributed run's workers are fresh interpreters that load the build
and config functions by reference (distributed/runtime._load_ref): the
module is imported by name, or else executed from its file.  So this
module imports only ``windflow_tpu_torch`` (never ``jax`` and never
the reference package): a port worker must not pull JAX in.  Each
function mirrors the reference twin of the same name in
tests/test_distributed.py, on the port; parameters travel as
environment variables, as there.

Every build registers :func:`probe` to run at the worker's exit when
``WFT_PROBE_DIR`` is set: it writes ``w<worker>.json`` there, with
whether ``jax`` is in ``sys.modules``, the window-sum kernel's counted
launches and the device engines this worker owned.
"""
import atexit
import collections
import json
import os
import sys
import time

import numpy as np

import windflow_tpu_torch as wf
from windflow_tpu_torch.core.basic import Pattern, RoutingMode, RuntimeConfig
from windflow_tpu_torch.core.tuples import BasicRecord, TupleBatch
from windflow_tpu_torch.operators.base import Operator, StageSpec
from windflow_tpu_torch.resilience import FaultPlan
from windflow_tpu_torch.runtime.emitters import StandardEmitter
from windflow_tpu_torch.runtime.node import SourceLoopLogic

N_KEYS = 8


# ---------------------------------------------------------------------------
# the worker's exit probe
# ---------------------------------------------------------------------------

def device_engines(g) -> list:
    """Every window-engine logic of ``g``'s (owned) nodes, chained
    stages included."""
    from windflow_tpu_torch.runtime.node import ChainedLogic, FusedLogic
    out, todo = [], [n.logic for n in g._all_nodes()]
    while todo:
        lg = todo.pop()
        if isinstance(lg, ChainedLogic):
            todo += [lg.a, lg.b]
        elif isinstance(lg, FusedLogic):
            todo += [seg.logic for seg in lg.segments]
        elif hasattr(lg, "launched_batches"):
            out.append(lg)
    return out


def probe_doc(g) -> dict:
    from windflow_tpu_torch.ops.cuda import window_sum
    import torch
    engines = device_engines(g)
    return {
        "worker": int(os.environ.get("WINDFLOW_WORKER_ID", "-1")),
        "jax": "jax" in sys.modules,
        "reference": "windflow_tpu" in sys.modules,
        "k1_launches": window_sum.launch_count(),
        "engines": [{"placement": getattr(lg, "resolved_placement", None),
                     "device": str(getattr(lg, "device", None)),
                     "batches": int(lg.launched_batches)}
                    for lg in engines],
        "cuda_initialized": bool(torch.cuda.is_initialized()),
        "device_name": (torch.cuda.get_device_name(0)
                        if torch.cuda.is_initialized() else None),
    }


def register_probe(g) -> None:
    """Write :func:`probe_doc` at this process's exit, when asked."""
    out_dir = os.environ.get("WFT_PROBE_DIR")
    if not out_dir:
        return

    def write():
        doc = probe_doc(g)
        with open(os.path.join(out_dir, f"w{doc['worker']}.json"),
                  "w") as f:
            json.dump(doc, f)

    atexit.register(write)


def read_probes(out_dir, n_workers: int = 2) -> list:
    docs = []
    for w in range(n_workers):
        with open(os.path.join(out_dir, f"w{w}.json")) as f:
            docs.append(json.load(f))
    return docs


# ---------------------------------------------------------------------------
# keyed runs (the reference's _keyed_build family)
# ---------------------------------------------------------------------------

def _dist_records(n):
    for i in range(n):
        yield i % N_KEYS, i // N_KEYS, i, float(i % 13)


def acc_oracle(n):
    out = collections.defaultdict(list)
    sums = collections.defaultdict(float)
    for k, tid, _ts, v in _dist_records(n):
        sums[k] += v
        out[k].append((tid, sums[k]))
    return dict(out)


def _keyed_build(g, sink_fn, pace_every=0, pace_s=0.0,
                 fold_name="dist_fold"):
    """source -> KEYBY rolling fold (2 replicas) -> sink."""
    n = int(os.environ["WFT_DIST_N"])
    it = iter(enumerate(_dist_records(n)))

    def src(shipper):
        for i, (k, tid, ts, v) in it:
            if pace_every and i % pace_every == 0:
                time.sleep(pace_s)
            shipper.push(BasicRecord(k, tid, ts, v))
            return True
        return False

    def fold(t, acc):
        acc.value += t.value

    g.add_source(wf.SourceBuilder(src).with_name("dist_src").build()) \
        .add(wf.AccumulatorBuilder(fold).with_name(fold_name)
             .with_parallelism(2).build()) \
        .add_sink(sink_fn)
    register_probe(g)
    return g


def _rows_sink(out_path):
    rows = []

    def sink(rec):
        if rec is None:
            with open(out_path, "w") as f:
                json.dump(sorted(rows), f)
        else:
            rows.append([rec.key, rec.id, rec.value])

    return wf.SinkBuilder(sink).with_name("dist_sink").build()


def build_basic(g):
    _keyed_build(g, _rows_sink(os.environ["WFT_DIST_OUT"]))


def config_counters(worker_id):
    return RuntimeConfig(tracing=True, trace_sample=0,
                         log_dir=os.environ.get("WFT_LOG_DIR", "log"))


def config_drop_link(worker_id):
    plan = FaultPlan().drop_link("dist_fold", at_frame=5)
    return RuntimeConfig(fault_plan=plan,
                         log_dir=os.environ.get("WFT_LOG_DIR", "log"))


def build_slow_remote(g):
    out_path = os.environ["WFT_DIST_OUT"]
    n = int(os.environ["WFT_DIST_N"])
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

    done = []

    def sink(rec):
        if rec is None:
            with open(out_path, "w") as f:
                json.dump({"count": len(done)}, f)
        else:
            done.append(1)

    g.add_source(wf.SourceBuilder(src).with_name("fast_src").build()) \
        .add(wf.MapBuilder(slow).with_name("slow_remote")
             .with_key_by().build()) \
        .add_sink(wf.SinkBuilder(sink).with_name("obs_sink").build())
    register_probe(g)


def config_traced(worker_id):
    return RuntimeConfig(tracing=True, trace_sample=32,
                         log_dir=os.environ.get("WFT_LOG_DIR", "log"))


# ---------------------------------------------------------------------------
# durable run: kill a worker, restart from the newest common epoch
# ---------------------------------------------------------------------------

class FileEpochWriter:
    """File-backed idempotent sink target: every effect appends a JSONL
    row tagged (attempt, epoch); a restarted attempt first appends a
    truncation marker carrying its restore epoch, which
    :func:`resolve_epoch_file` replays at read time."""

    def __init__(self, path=None):
        self.path = path or os.environ["WFT_DIST_OUT"]
        self.attempt = int(os.environ.get("WINDFLOW_DIST_ATTEMPT", "0"))
        restore = int(os.environ.get("WINDFLOW_DIST_RESTORE", "0"))
        with open(self.path, "a") as f:
            f.write(json.dumps({"marker": True, "a": self.attempt,
                                "truncate_above": restore}) + "\n")

    def write(self, epoch, item):
        with open(self.path, "a") as f:
            f.write(json.dumps({"a": self.attempt, "e": epoch,
                                "k": item.key, "t": item.id,
                                "v": item.value}) + "\n")
            f.flush()
            os.fsync(f.fileno())


def resolve_epoch_file(path):
    """Fold the JSONL effect log: each attempt's truncation marker
    drops earlier attempts' rows above its restore epoch."""
    rows = []
    with open(path) as f:
        for line in f:
            doc = json.loads(line)
            if doc.get("marker"):
                rows = [r for r in rows
                        if r["e"] <= doc["truncate_above"]]
            else:
                rows.append(doc)
    return rows


class _DistCkptSourceLogic(SourceLoopLogic):
    def __init__(self, n, pace_every, pace_s):
        self.i = 0
        self.n = n
        self.pace_every = pace_every
        self.pace_s = pace_s
        super().__init__(self._step)

    def _step(self, emit):
        i = self.i
        if i >= self.n:
            return False
        if self.pace_every and i % self.pace_every == 0:
            time.sleep(self.pace_s)
        emit(BasicRecord(i % N_KEYS, i // N_KEYS, i, float(i % 13)))
        self.i = i + 1
        return True

    def state_dict(self):
        return {"i": self.i}

    def load_state(self, st):
        self.i = st["i"]

    def progress_frontier(self):
        return self.i


class DistCkptSource(Operator):
    def __init__(self, n, pace_every=8, pace_s=0.003):
        super().__init__("dur_src", 1, RoutingMode.NONE, Pattern.SOURCE)
        self.n = n
        self.pace_every = pace_every
        self.pace_s = pace_s

    def stages(self):
        logic = _DistCkptSourceLogic(self.n, self.pace_every, self.pace_s)
        return [StageSpec(self.name, [logic], StandardEmitter(),
                          self.routing)]


def build_durable(g):
    n = int(os.environ["WFT_DIST_N"])

    def fold(t, acc):
        acc.value += t.value

    g.add_source(DistCkptSource(n)) \
        .add(wf.AccumulatorBuilder(fold).with_name("dur_fold")
             .with_parallelism(2).build()) \
        .add_sink(wf.SinkBuilder(FileEpochWriter())
                  .with_exactly_once("idempotent")
                  .with_name("dur_sink").build())
    register_probe(g)


def config_durable(worker_id):
    from windflow_tpu_torch.core import DurabilityConfig
    plan = FaultPlan()
    kill_at = int(os.environ.get("WFT_KILL_AT", "0"))
    if kill_at:
        plan.kill_worker(0, at_tuple=kill_at)
    return RuntimeConfig(
        durability=DurabilityConfig(
            epoch_interval_s=0.05,
            path=os.environ["WFT_EPOCH_DIR"], retained=64),
        fault_plan=plan,
        log_dir=os.environ.get("WFT_LOG_DIR", "log"))


# ---------------------------------------------------------------------------
# NEXMark Q5 (bench config 12's build at a test size)
# ---------------------------------------------------------------------------

def q5_rows_sink(out_path):
    """A Q5 sink writing its sorted [auction, window, count] rows at
    EOS, as the reference test's build_q5 does."""
    rows = []

    def sink(item):
        if item is None:
            with open(out_path, "w") as f:
                json.dump(sorted(rows), f)
            return
        if isinstance(item, TupleBatch):
            for j in range(len(item)):
                rows.append([int(item.key[j]), int(item.id[j]),
                             float(item["value"][j])])
        else:
            rows.append([int(item.key), int(item.id),
                         float(item.value)])

    return sink


def build_q5(g):
    """The reference test's build_q5 on the port; ``WFT_Q5_PLACEMENT``
    picks the lane ('host', as the reference's, or 'device')."""
    from windflow_tpu_torch.models.nexmark import build_q5_hot_items
    n = int(os.environ["WFT_Q5_N"])
    build_q5_hot_items(g, n, 8192, 4096,
                       q5_rows_sink(os.environ["WFT_Q5_OUT"]),
                       n_auctions=40, batch_size=16_384, device_batch=512,
                       parallelism=2,
                       placement=os.environ.get("WFT_Q5_PLACEMENT",
                                                "host"))
    register_probe(g)


def config_q5(worker_id):
    """``WFT_DEVICE`` names the device engines' device: the CPU here
    (the kernels' plain versions); 'cuda' asks for the card."""
    return RuntimeConfig(log_dir=os.environ.get("WFT_LOG_DIR", "log"),
                         device=os.environ.get("WFT_DEVICE", "cpu"))


def q5_oracle(n: int) -> list:
    """The sorted [auction, window, count] rows of build_q5 by numpy:
    per-auction bid counts of every window of 8192 / 4096 a key has
    bids in, over the synthetic stream the source emits."""
    from windflow_tpu_torch.models.nexmark import synth_bids
    batch, win, slide = 16_384, 8192, 4096
    pool = synth_bids(batch, 40)["auction"]
    keys = np.concatenate([pool[:min(batch, n - i)]
                           for i in range(0, n, batch)])
    ts = np.arange(n)
    rows = []
    for k in np.unique(keys):
        kts = ts[keys == k]
        last = int(kts[-1]) // slide
        for w in range(last + 1):
            c = int(np.count_nonzero((kts >= w * slide)
                                     & (kts < w * slide + win)))
            rows.append([int(k), w, float(c)])
    return sorted(rows)
