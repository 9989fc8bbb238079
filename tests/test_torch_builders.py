"""The port's builders, planner strategies and state conversion against
the reference, on the CPU: the README's quick start through both
packages; every builder name of the reference umbrella resolves in the
port and builds its operator class; ``plan_window_operator`` builds the
farm each strategy names; ``from_reference_state`` carries a
PaneCombineLogic snapshot, a farm's per-replica snapshots and the fused
PaneFarmTPU stage (bench config 3's) across mid-stream.

Windows (keys, ids, per-key order) must be equal exactly, values too:
the streams are integer-valued and the reference tests compare them
with ``==``.
"""
import importlib
import pickle

import numpy as np
import pytest
import torch

from torch_graphs import PACKAGES, PORT, assert_same, mod

N_KEYS = 4


def _gen(pkg, per_replica):
    """The quick start's source: each of its replicas pushes its own
    records, keys 0..3, ts = the record's index, values signed."""
    BasicRecord = mod(pkg, "core").BasicRecord

    def gen(shipper, ctx):
        st = ctx.get_local_storage()
        i = st.get("i", lambda: 0)
        if i >= per_replica:
            return False
        r = ctx.get_replica_index()
        ts = i * 2 + r
        shipper.push(BasicRecord(ts % N_KEYS, ts, ts,
                                 float((ts * 7) % 11 - 3)))
        st.put("i", i + 1)
        return True

    return gen


def _quick_start(pkg, device_farm):
    """README.md's quick start (a filter, then a keyed window farm):
    with the host KeyFarm and a Python window function, or with the
    device KeyFarmTPU and the builtin 'sum' in batch output."""
    import threading
    wf = importlib.import_module(pkg)
    TupleBatch = mod(pkg, "core.tuples").TupleBatch
    rows, lock = [], threading.Lock()

    def sink(item):
        if item is None:
            return
        with lock:
            if isinstance(item, TupleBatch):
                rows.extend(zip(np.asarray(item.key).tolist(),
                                np.asarray(item.id).tolist(),
                                np.asarray(item["value"]).tolist()))
            else:
                rows.append((item.key, item.id, item.value))

    def sum_win(gwid, window, result):
        result.value = sum(t.value for t in window)

    if device_farm:
        op = wf.KeyFarmTPUBuilder("sum").with_parallelism(2) \
            .with_batch(64).with_tb_windows(100, 50) \
            .with_batch_output().build()
    else:
        op = wf.KeyFarmBuilder(sum_win).with_parallelism(4) \
            .with_tb_windows(100, 50).build()
    cfg = wf.RuntimeConfig()
    if pkg == PORT:
        cfg.device = "cpu"
    g = wf.PipeGraph("app", wf.Mode.DEFAULT, config=cfg)
    g.add_source(wf.SourceBuilder(_gen(pkg, 600)).with_parallelism(2)
                 .build()) \
        .chain(wf.FilterBuilder(lambda t: t.value > 0).build()) \
        .add(op) \
        .add_sink(wf.SinkBuilder(sink).build())
    g.run()
    return rows


@pytest.mark.parametrize("device_farm", [False, True])
def test_readme_quick_start_matches_reference(device_farm):
    want = _quick_start(PACKAGES[0], device_farm)
    got = _quick_start(PORT, device_farm)
    assert len(got) > 20
    assert_same(got, want)


BUILDERS = {
    "SourceBuilder": ((lambda s, c: False,), "Source"),
    "FilterBuilder": ((lambda t: True,), "Filter"),
    "MapBuilder": ((lambda t: t,), "Map"),
    "FlatMapBuilder": ((lambda t, s: None,), "FlatMap"),
    "AccumulatorBuilder": ((lambda t, acc: None,), "Accumulator"),
    "SinkBuilder": ((lambda t: None,), "Sink"),
    "WinSeqBuilder": ((lambda g, it, r: None,), "WinSeq"),
    "WinFarmBuilder": ((lambda g, it, r: None,), "WinFarm"),
    "KeyFarmBuilder": ((lambda g, it, r: None,), "KeyFarm"),
    "PaneFarmBuilder": ((lambda g, it, r: None,) * 2, "PaneFarm"),
    "WinMapReduceBuilder": ((lambda g, it, r: None,) * 2, "WinMapReduce"),
    "WinSeqFFATBuilder": ((lambda t, r: None, lambda a, b, o: None),
                          "WinSeqFFAT"),
    "KeyFFATBuilder": ((lambda t, r: None, lambda a, b, o: None),
                       "KeyFFAT"),
    "WinSeqTPUBuilder": (("sum",), "WinSeqTPU"),
    "WinFarmTPUBuilder": (("sum",), "WinFarmTPU"),
    "KeyFarmTPUBuilder": (("sum",), "KeyFarmTPU"),
    "PaneFarmTPUBuilder": (("sum", "sum"), "PaneFarmTPU"),
    "WinMapReduceTPUBuilder": (("sum", lambda g, it, r: None),
                               "WinMapReduceTPU"),
    "WinSeqFFATTPUBuilder": ((lambda t: t.value, "max"), "WinSeqFFATTPU"),
    "KeyFFATTPUBuilder": ((lambda t: t.value, "max"), "KeyFFATTPU"),
}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_builder_resolves_and_builds_its_operator(name):
    """The port's builder of each reference name builds the port's
    operator class of the reference's name, from the mirrored module."""
    args, cls_name = BUILDERS[name]
    built = {}
    for pkg in PACKAGES:
        wf = importlib.import_module(pkg)
        b = getattr(wf, name)(*args)
        if hasattr(b, "with_tb_windows"):
            b = b.with_tb_windows(12, 4)
        built[pkg] = b.build()
    ref, port = built[PACKAGES[0]], built[PORT]
    assert type(ref).__name__ == type(port).__name__ == cls_name
    assert type(port).__module__ == type(ref).__module__.replace(
        PACKAGES[0], PORT, 1)
    assert port.parallelism == ref.parallelism
    assert len(port.stages()) == len(ref.stages())


def test_resident_ffat_builder_takes_a_torch_function():
    import windflow_tpu_torch as wf
    op = wf.WinSeqFFATTPUBuilder(lambda t: t.value, "sum") \
        .with_cb_windows(12, 4).build()
    assert type(op).__name__ == "WinSeqFFATResident"
    assert op.kwargs["combine"] is torch.add
    with pytest.raises(ValueError, match="torch function"):
        wf.WinSeqFFATTPUBuilder(lambda t: t.value, "median") \
            .with_cb_windows(12, 4).with_rebuild(False).build()


@pytest.mark.parametrize("strategy,args,cls_name", [
    ("pane_farm", ("sum", 4096, 2048, 64), "PaneFarmTPU"),
    ("key_farm", ("sum", 12, 4, 64), "KeyFarmTPU"),
    ("win_farm", ("sum", 1 << 16, 1 << 16, 1), "WinFarmTPU"),
    ("ffat", ("max", 64, 4, 1), "WinSeqFFATTPU"),
    ("win_seq", ("sum", 12, 4, 1), "WinSeqTPU"),
])
def test_plan_window_operator_builds_each_strategy(strategy, args,
                                                   cls_name):
    kind, win, slide, keys = args
    for pkg in PACKAGES:
        planner = mod(pkg, "graph.planner")
        wf = importlib.import_module(pkg)
        assert planner.select_strategy(kind, win, slide, keys) == strategy
        op = planner.plan_window_operator(kind, win, slide, wf.WinType.TB,
                                          key_cardinality=keys)
        assert type(op).__name__ == cls_name
        assert type(op).__module__.startswith(pkg + ".")


# ---------------------------------------------------------------------------
# from_reference_state across a checkpoint
# ---------------------------------------------------------------------------

def _pane_batches(pkg, lo, hi, n_keys=3):
    """The PLQ output a columnar WLQ consumes: per key, dense pane ids
    with ts = pane id and value = (id * 5 + key) % 13."""
    TupleBatch = mod(pkg, "core.tuples").TupleBatch
    for start in range(lo, hi, 10):
        ids = np.arange(start, min(start + 10, hi))
        yield TupleBatch({
            "key": np.repeat(np.arange(n_keys), len(ids)),
            "id": np.tile(ids, n_keys), "ts": np.tile(ids, n_keys),
            "value": ((np.tile(ids, n_keys) * 5
                       + np.repeat(np.arange(n_keys), len(ids))) % 13)
            .astype(np.float64)})


def _rows(out):
    return sorted((r.key, r.id, r.value) for r in out)


@pytest.mark.parametrize("kind", ["sum", "max"])
def test_pane_combine_snapshot_resumes_in_port(kind):
    from windflow_tpu_torch.convert import from_reference_state
    n, half = 95, 47

    def logic(pkg):
        return mod(pkg, "operators.tpu.pane_combine").PaneCombineLogic(
            kind, 4, 2)

    full, full_out = logic(PACKAGES[0]), []
    for b in _pane_batches(PACKAGES[0], 0, n):
        full.svc(b, 0, full_out.append)
    full.eos_flush(full_out.append)

    ref, first = logic(PACKAGES[0]), []
    for b in _pane_batches(PACKAGES[0], 0, half):
        ref.svc(b, 0, first.append)
    snap = pickle.loads(pickle.dumps(ref.state_dict()))
    port, rest = logic(PORT), []
    port.load_state(from_reference_state(snap))
    for b in _pane_batches(PORT, half, n):
        port.svc(b, 0, rest.append)
    port.eos_flush(rest.append)
    assert len(first) and len(rest)
    assert _rows(first + rest) == _rows(full_out)


def _synth_batches(pkg, lo, hi, n_keys=8, step=500):
    SynthChunk = mod(pkg, "core.tuples").SynthChunk
    for s in range(lo, hi, step):
        yield SynthChunk(s, min(step, hi - s), n_keys, 97, 1.0, 0.0)


def _records(out):
    rows = []
    for item in out:
        if hasattr(item, "get_control_fields"):
            rows.append((item.key, item.id, item.value))
        else:
            rows.extend(zip(np.asarray(item.key).tolist(),
                            np.asarray(item.id).tolist(),
                            np.asarray(item["value"]).tolist()))
    return sorted(rows)


@pytest.mark.parametrize("farm", ["pane_farm_level2", "key_farm_par2"])
def test_farm_snapshot_resumes_in_port(farm, monkeypatch):
    """A device farm checkpointed mid-stream in the reference resumes in
    the port: config 3's fused PaneFarmTPU stage (a ChainedLogic of the
    device PLQ and the columnar WLQ) and the per-replica snapshots of a
    two-replica KeyFarmTPU (Python staging lane)."""
    from windflow_tpu_torch.convert import from_reference_state
    for pkg in PACKAGES:
        monkeypatch.setenv("WINDFLOW_NATIVE", "0")
        monkeypatch.setattr(mod(pkg, "runtime.native"), "_lib", None)
    n, half = 40_000, 19_500

    def replicas(pkg, **kw):
        wf = importlib.import_module(pkg)
        farms = mod(pkg, "operators.tpu.farms_tpu")
        common = dict(batch_len=64, max_batch_delay_ms=1e9, **kw)
        if farm == "pane_farm_level2":
            op = farms.PaneFarmTPU("sum", "sum", 256, 128, wf.WinType.TB,
                                   opt_level=wf.OptLevel.LEVEL2,
                                   emit_batches=True, **common)
        else:
            op = farms.KeyFarmTPU("sum", 256, 128, wf.WinType.TB,
                                  parallelism=2, coalesce=False, **common)
        return op.stages()[0].replicas

    def route(reps, pkg, lo, hi, out):
        """Feed the stream: one replica, or the farm's key hash."""
        for b in _synth_batches(pkg, lo, hi):
            if len(reps) == 1:
                reps[0].svc(b, 0, out.append)
                continue
            cols = b.materialize() if hasattr(b, "materialize") else b
            for i, r in enumerate(reps):
                sel = (np.asarray(cols.key) % len(reps)) == i
                r.svc(cols.take(np.nonzero(sel)[0]), 0, out.append)

    def drain(reps, out):
        for r in reps:
            r.quiesce(out.append)

    full, full_out = replicas(PACKAGES[0]), []
    route(full, PACKAGES[0], 0, n, full_out)
    for r in full:
        r.eos_flush(full_out.append)

    ref, first = replicas(PACKAGES[0]), []
    route(ref, PACKAGES[0], 0, half, first)
    drain(ref, first)
    snap = pickle.loads(pickle.dumps([r.state_dict() for r in ref]))
    port, rest = replicas(PORT, device="cpu"), []
    for r, st in zip(port, from_reference_state(snap)):
        r.load_state(st)
    route(port, PORT, half, n, rest)
    for r in port:
        r.eos_flush(rest.append)
    assert len(first) and len(rest)
    assert _records(first + rest) == _records(full_out)
