"""The port's profiler spans (telemetry/profiler.py) on a small
``BatchSource -> BatchFilter -> BatchMap -> KeyFarmTPU -> Sink`` graph
on the CPU, wired three ways: the filter and map chained into the
source (one segment of a device step), added as their own stages and
fused by LEVEL2 (segments of a device step), and unfused (LEVEL0, a
thread a node).

Off, running the graph enters no ``record_function``.  On, a capture
of every thread holds ``windflow/op/<operator>`` for each operator on
the source's thread, ``windflow/fold`` inside the farm's operator span
on that thread, and, where the sink is fused behind the farm,
``windflow/emit/<sink>`` on the farm's dispatcher thread.  The window
results are the same either way.
"""
import numpy as np
import pytest
import torch

import windflow_tpu_torch as wf
from windflow_tpu_torch.core.tuples import TupleBatch
from windflow_tpu_torch.operators.basic_ops import Sink
from windflow_tpu_torch.operators.batch_ops import (BatchFilter, BatchMap,
                                                    BatchSource)
from windflow_tpu_torch.operators.tpu.farms_tpu import KeyFarmTPU
from windflow_tpu_torch.runtime import native
from windflow_tpu_torch.telemetry import profiler

N_BATCHES = 24
BATCH = 4096
N_KEYS = 13
WIN, SLIDE = 8192, 8192

WIRINGS = ("chained", "fused", "unfused")


@pytest.fixture(autouse=True)
def _native_lane():
    if not native.native_available():
        pytest.skip("the native engine needs a C++ toolchain")


@pytest.fixture
def switch(monkeypatch):
    """Set WINDFLOW_TORCH_PROFILE for one test; read it again after."""
    def set_(on: bool):
        monkeypatch.setenv("WINDFLOW_TORCH_PROFILE", "1" if on else "0")
        profiler.reset()
    yield set_
    monkeypatch.delenv("WINDFLOW_TORCH_PROFILE", raising=False)
    profiler.reset()


def _source():
    sent = {"n": 0}

    def fn(ctx=None):
        i = sent["n"]
        if i >= N_BATCHES:
            return None
        sent["n"] = i + 1
        ids = np.arange(i * BATCH, (i + 1) * BATCH, dtype=np.int64)
        return TupleBatch({"key": ids * 7 % 101, "id": ids, "ts": ids,
                           "value": (ids % 5).astype(np.float64)})
    return fn


def _views(batch):
    return batch.key % 3 != 0


def _campaign(batch):
    return TupleBatch({"key": batch.key % N_KEYS, "id": batch.id,
                       "ts": batch.ts, "value": np.ones(len(batch))})


def _run(wiring: str):
    """Run the graph; returns (its windows sorted, the graph)."""
    parts = []
    level = wf.OptLevel.LEVEL0 if wiring == "unfused" else wf.OptLevel.LEVEL2
    g = wf.PipeGraph(f"spans_{wiring}", wf.Mode.DEFAULT,
                     config=wf.RuntimeConfig(device="cpu",
                                             opt_level=level))
    pipe = g.add_source(BatchSource(_source(), name="src"))
    join = pipe.chain if wiring == "chained" else pipe.add
    join(BatchFilter(_views, name="views"))
    join(BatchMap(_campaign, name="campaign"))
    pipe.add(KeyFarmTPU("count", WIN, SLIDE, wf.WinType.TB,
                        batch_len=64, name="count", emit_batches=True))
    pipe.add_sink(Sink(lambda b: b is not None and parts.append(
        (np.asarray(b.key), np.asarray(b.id), np.asarray(b["value"]))),
        name="sink"))
    g.run()
    key, wid, val = (np.concatenate(c) for c in zip(*parts))
    order = np.lexsort((wid, key))
    return (key[order], wid[order], val[order]), pipe.name


def _capture(wiring: str):
    from torch._C._profiler import _ExperimentalConfig
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=_ExperimentalConfig(
                profile_all_threads=True)) as prof:
        out, pipe = _run(wiring)
    spans = [(e.name, e.thread, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("windflow/")]
    return out, pipe, spans


@pytest.mark.parametrize("wiring", WIRINGS)
def test_torch_spans_off_enter_no_record_function(wiring, switch,
                                                  monkeypatch):
    """Off, the chain's closures and per-chunk sites hold the plain
    calls: no record_function is built.  On, the same stand-in counts
    the spans (the count is not vacuous)."""
    made = []

    class Counting:
        def __init__(self, name, *args):
            made.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    switch(False)
    _run(wiring)
    assert made == []
    switch(True)
    _run(wiring)
    assert any(n.startswith("windflow/op/") for n in made)
    assert made.count("windflow/fold") == N_BATCHES


@pytest.mark.parametrize("wiring", WIRINGS)
def test_torch_spans_name_each_operator_and_its_thread(wiring, switch):
    switch(True)
    _out, pipe, spans = _capture(wiring)
    names = {n for n, *_ in spans}
    source = f"windflow/op/{pipe}/src"
    src_thread = {t for n, t, *_ in spans if n == source}
    assert len(src_thread) == 1
    # every operator on the source's thread, under its own name
    ops = {f"windflow/op/{pipe}/{op}.0" for op in ("views", "campaign")}
    if wiring != "unfused":
        ops.add(f"windflow/op/{pipe}/count.0")
        assert {t for n, t, *_ in spans if n in ops} == src_thread
    assert ops | {source} <= names
    # the fold lies inside the farm's operator span on its thread
    farm = [(t, a, b) for n, t, a, b in spans
            if n == f"windflow/op/{pipe}/count.0"]
    folds = [(t, a, b) for n, t, a, b in spans if n == "windflow/fold"]
    assert len(folds) == N_BATCHES
    for t, a, b in folds:
        assert any(t == ft and fa <= a and b <= fb for ft, fa, fb in farm)
    sink = f"{pipe}/sink.0"
    if wiring == "unfused":
        # its own node: an operator span on the sink's own thread
        assert f"windflow/op/{sink}" in names
        assert not any(n.startswith("windflow/emit/") for n in names)
    else:
        # fused behind the farm: run by its dispatcher thread
        emit = {t for n, t, *_ in spans if n == f"windflow/emit/{sink}"}
        launch = {t for n, t, *_ in spans if n == "windflow/window_launch"}
        assert emit and emit == launch and not emit & src_thread
        assert f"windflow/op/{sink}" not in names


@pytest.mark.parametrize("wiring", WIRINGS)
def test_torch_spans_leave_the_windows_unchanged(wiring, switch):
    switch(False)
    (k0, w0, v0), _ = _run(wiring)
    switch(True)
    (k1, w1, v1), _ = _run(wiring)
    assert len(k0) > 0
    np.testing.assert_array_equal(k0, k1)
    np.testing.assert_array_equal(w0, w1)
    np.testing.assert_array_equal(v0, v1)
