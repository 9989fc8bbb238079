"""Tenant builds and configs of the port's fleet tests
(tests/test_torch_scheduler.py, tests/test_torch_card.py).

A ``FleetServer``'s workers are fresh interpreters that load a tenant's
build and config functions by reference (distributed/runtime._load_ref:
the module by name, else its file).  So this module imports only
``windflow_tpu_torch`` (never ``jax`` and never the reference package):
a port worker must not pull JAX in.  Parameters travel as environment
variables, which the workers inherit.

* :func:`fleet_build` / :func:`fleet_cfg` -- the reference's
  tests/test_scheduler.py twins of the same names, on the CPU;
* :func:`device_build` / :func:`device_cfg` -- one window-sum lane
  (``WinSeqTPU("sum")``, the window-sum kernel's path on the card) over
  ``WFT_SCHED_N`` tuples of :func:`batch_source`, its windows written
  to ``<WFT_SCHED_OUT>/<tenant>.json`` at the end of the stream, its
  engine on ``WFT_DEVICE`` (the CPU unless set);
* :func:`cuda_cfg` -- the same lane asking for the CUDA card, which a
  worker on a box without one refuses (the tenant ends FAILED).

:func:`device_build` registers :func:`probe_doc` to run at the worker's
exit when ``WFT_PROBE_DIR`` is set: it writes ``p<pid>.json`` there,
with whether ``jax`` or the reference package is in ``sys.modules``,
the hand kernels' counted launches, the window engines of every tenant
the worker built with their batches, and whether it opened a CUDA
context.
"""
import atexit
import glob
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

import windflow_tpu_torch as wf
from windflow_tpu_torch.core.tuples import BasicRecord, TupleBatch
from windflow_tpu_torch.elastic import ElasticityConfig
from windflow_tpu_torch.operators.basic_ops import Sink
from windflow_tpu_torch.operators.batch_ops import BatchSource
from windflow_tpu_torch.operators.tpu.win_seq_tpu import WinSeqTPU

N_KEYS = 8
WIN, SLIDE = 64, 32


def record_source(n, pace_s=0.0):
    state = {}

    def fn(shipper, ctx):
        i = state.setdefault("i", 0)
        if i >= n:
            return False
        if pace_s:
            time.sleep(pace_s)
        shipper.push(BasicRecord(i % 4, i // 4, i, float(i)))
        state["i"] = i + 1
        return True

    return fn


def fleet_build(g):
    """Worker-side tenant graph (the reference's ``fleet_build``)."""
    g.add_source(wf.SourceBuilder(
        record_source(1200, pace_s=0.003)).build()) \
        .add(wf.MapBuilder(lambda t: None).with_name("m").build()) \
        .add_sink(wf.SinkBuilder(lambda r: None).build())


def fleet_cfg():
    return wf.RuntimeConfig(log_dir=tempfile.gettempdir(),
                            elasticity=ElasticityConfig(enabled=False),
                            device="cpu")


def batch_source(n, sb=2048, pace_s=0.0, stop_evt=None, vmod=97):
    """The reference scheduler tests' batch source: key = i % 8,
    id = ts = i // 8, value = i % vmod; ``n=None`` runs until
    ``stop_evt``."""
    state = {"i": 0}

    def fn(ctx):
        if stop_evt is not None and stop_evt.is_set():
            return None
        i = state["i"]
        if n is not None and i >= n:
            return None
        if pace_s:
            time.sleep(pace_s)
        m = sb if n is None else min(sb, n - i)
        idx = np.arange(i, i + m)
        ids = idx // N_KEYS
        state["i"] = i + m
        return TupleBatch({"key": idx % N_KEYS, "id": ids, "ts": ids,
                           "value": (idx % vmod).astype(np.float64)})

    return fn


def window_rows_sink(out_path=None):
    """(rows, sink): the sink appends (key, id, value) of every window
    it receives and, at the end of the stream, writes them sorted to
    ``out_path`` when given."""
    rows = []
    lock = threading.Lock()

    def sink(item):
        if item is None:
            if out_path:
                with open(out_path, "w") as f:
                    json.dump(sorted(rows), f)
            return
        with lock:
            for j in range(len(item)):
                rows.append((int(item.key[j]), int(item.id[j]),
                             float(item["value"][j])))

    return rows, sink


def device_window_pipe(g, n, sink, pace_s=0.0, stop_evt=None):
    """One device-pinned window lane (the card's lease holder)."""
    op = WinSeqTPU("sum", WIN, SLIDE, wf.WinType.TB, batch_len=128,
                   emit_batches=True, placement="device")
    g.add_source(BatchSource(
        batch_source(n, pace_s=pace_s, stop_evt=stop_evt))) \
        .add(op).add_sink(Sink(sink))


def device_build(g):
    n = int(os.environ.get("WFT_SCHED_N", "8192"))
    out = os.path.join(os.environ["WFT_SCHED_OUT"], f"{g.name}.json")
    device_window_pipe(g, n, window_rows_sink(out)[1])
    register_probe(g)


def device_cfg():
    return wf.RuntimeConfig(log_dir=tempfile.gettempdir(),
                            elasticity=ElasticityConfig(enabled=False),
                            device=os.environ.get("WFT_DEVICE", "cpu"))


def cuda_cfg():
    cfg = device_cfg()
    cfg.device = "cuda"
    return cfg


# ---------------------------------------------------------------------------
# the worker's exit probe
# ---------------------------------------------------------------------------

_HOSTED = []  # every tenant graph this process built, for its probe


def register_probe(g) -> None:
    """Count ``g`` into this process's exit probe, when asked."""
    out_dir = os.environ.get("WFT_PROBE_DIR")
    if not out_dir:
        return
    if not _HOSTED:
        atexit.register(write_probe, out_dir)
    _HOSTED.append(g)


def probe_doc() -> dict:
    import torch
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq
    from windflow_tpu_torch.ops.cuda import window_sum
    return {
        "pid": os.getpid(),
        "jax": "jax" in sys.modules,
        "reference": "windflow_tpu" in sys.modules,
        "counts": {"window_sum": window_sum.launch_count(),
                   "flatfat_query": fq.launch_count(),
                   "flatfat_update_query": fq.fused_launch_count(),
                   "flatfat_build_query": fq.build_query_launch_count()},
        # the planner's placed lanes (graph.placed_engines)
        "engines": [{"tenant": g.name,
                     "placement": lg.resolved_placement,
                     "device": str(lg.device),
                     "batches": int(lg.launched_batches)}
                    for g in _HOSTED
                    for _name, lg, _entry in getattr(g, "placed_engines",
                                                     [])],
        "cuda": bool(torch.cuda.is_initialized()),
    }


def write_probe(out_dir) -> None:
    with open(os.path.join(out_dir, f"p{os.getpid()}.json"), "w") as f:
        json.dump(probe_doc(), f)


def read_probes(out_dir) -> list:
    docs = []
    for path in sorted(glob.glob(os.path.join(out_dir, "p*.json"))):
        with open(path) as f:
            docs.append(json.load(f))
    return docs
