"""The port's parallel feed (windflow_tpu_torch/ingest/feed.py) and its
whole-partition device step (graph/device_step.py) held side by side
with the reference's: twins of the feed cases of tests/test_planner.py
and of the device step's crash and kill-restart cases of
tests/test_fusion.py.

Each twin runs the reference test's scenario through ``windflow_tpu``
and through ``windflow_tpu_torch`` (on the CPU) with the same inputs,
made with numpy, asserts the reference test's own checks on both, and
holds the port to the reference: window keys and ids exactly, values
within the reference test's tolerance (its oracle's rtol 1e-5 for the
feed; exact for the integer streams of the device step).  The port's
run restarted after a kill is held to the reference's uninterrupted
run, never to the reference's restarted one (ROADMAP C2).
"""
import importlib
import threading

import numpy as np
import pytest

from torch_graphs import PACKAGES, PORT, mod

REF = PACKAGES[0]
N_KEYS = 8
WIN, SLIDE = 64, 32
FEED_SB = 8192
FEED_CHUNKS = 24
RTOL_F32 = 1e-5


def wf_of(pkg):
    return importlib.import_module(pkg)


def cfg(pkg, **kw):
    """``RuntimeConfig(**kw)`` of ``pkg``; the port's on the CPU."""
    c = wf_of(pkg).RuntimeConfig(**kw)
    if pkg == PORT:
        c.device = "cpu"
    return c


def both(scenario, *args):
    return {pkg: scenario(pkg, *args) for pkg in PACKAGES}


def feed_chunk_fn(i, take):
    """tests/test_planner.py:418-428: chunk i of the dense stream (key e
    % 8, id = ts = e // 8, value e % 97) through the arena."""
    if i >= FEED_CHUNKS:
        return None
    idx = take(FEED_SB, np.int64)
    idx[:] = np.arange(i * FEED_SB, (i + 1) * FEED_SB)
    keys = np.mod(idx, N_KEYS, out=take(FEED_SB, np.int64))
    vals = np.mod(idx, 97, out=take(FEED_SB, np.int64)) \
        .astype(np.float64)
    ids = np.floor_divide(idx, N_KEYS, out=idx)
    return keys, ids, ids, vals


def expected_windows(n, vmod=97):
    """tests/test_planner.py:79-97: per-key TB sliding sums, EOS firing
    the opened partial windows."""
    idx = np.arange(n)
    out = {}
    for k in range(N_KEYS):
        vals = (idx[idx % N_KEYS == k] % vmod).astype(np.float64)
        ids = idx[idx % N_KEYS == k] // N_KEYS
        hi = int(ids.max())
        w = 0
        while w * SLIDE <= hi:
            out[(k, w)] = float(vals[(ids >= w * SLIDE)
                                     & (ids < w * SLIDE + WIN)].sum())
            w += 1
    return out


class WindowDict:
    """(key, id) -> value of every window, and how often each came."""

    def __init__(self):
        self.lock = threading.Lock()
        self.res, self.counts = {}, {}

    def add(self, key, wid, value):
        k = (int(key), int(wid))
        self.res[k] = float(value)
        self.counts[k] = self.counts.get(k, 0) + 1

    def __call__(self, item):
        if item is None:
            return
        with self.lock:
            if hasattr(item, "get_control_fields"):
                self.add(item.key, item.id, item.value)
                return
            for k, i, v in zip(np.asarray(item.key).tolist(),
                               np.asarray(item.id).tolist(),
                               np.asarray(item["value"]).tolist()):
                self.add(k, i, v)


def assert_close_dicts(got, want, rtol=RTOL_F32):
    assert set(got) == set(want) and want
    keys = sorted(want)
    np.testing.assert_allclose([got[k] for k in keys],
                               [want[k] for k in keys], rtol=rtol)


def win_seq(pkg, **kw):
    wf = wf_of(pkg)
    return mod(pkg, "operators.tpu.win_seq_tpu").WinSeqTPU(
        "sum", WIN, SLIDE, wf.WinType.TB, **kw)


# ---------------------------------------------------------------------------
# the parallel zero-copy feed plane (tests/test_planner.py:431-514)
# ---------------------------------------------------------------------------

def _feed_source(pkg, feeders):
    wf = wf_of(pkg)
    sink = WindowDict()
    g = wf.PipeGraph(f"feed{feeders}", wf.Mode.DEFAULT, config=cfg(pkg))
    g.add_source(mod(pkg, "ingest.feed").FeedSource(
        feed_chunk_fn, feeders=feeders)) \
        .add(win_seq(pkg, batch_len=256, emit_batches=True)) \
        .add_sink(mod(pkg, "operators.basic_ops").Sink(sink))
    g.run()
    assert max(sink.counts.values()) == 1
    assert_close_dicts(sink.res, expected_windows(FEED_SB * FEED_CHUNKS))
    return sink.res


@pytest.mark.parametrize("feeders", [1, 4])
def test_feed_source_conserves_windows(feeders):
    got = both(_feed_source, feeders)
    assert_close_dicts(got[PORT], got[REF])


def _direct_into_staging(pkg):
    wf = wf_of(pkg)
    win_mod = mod(pkg, "operators.tpu.win_seq_tpu")
    feed = mod(pkg, "ingest.feed")

    def run(feeders):
        kw = {"device": "cpu"} if pkg == PORT else {}
        logic = win_mod.WinSeqTPULogic("sum", WIN, SLIDE, wf.WinType.TB,
                                       batch_len=256, emit_batches=True,
                                       async_dispatch=False, **kw)
        got = WindowDict()
        feeder = feed.ParallelColumnFeeder(
            feed_chunk_fn,
            lambda k, i, t, v: logic.feed_columns(k, i, t, v, got),
            feeders=feeders)
        fed = feeder.run()
        logic.feed_eos(got)
        return fed, got.res, feeder

    fed1, got1, _ = run(1)
    fed4, got4, feeder4 = run(4)
    assert fed1 == fed4 == FEED_SB * FEED_CHUNKS
    assert got1 == got4
    assert feeder4.chunks_fed == FEED_CHUNKS
    stats = feeder4.pool.stats()
    assert stats["hits"] > stats["misses"]
    return got4


def test_parallel_feeder_direct_into_staging():
    """Channel-free: feeder threads write through the pooled arena
    straight into WinSeqTPULogic staging (the port's logic on the
    CPU); one and four feeders give the same windows, the reference's."""
    got = both(_direct_into_staging)
    assert_close_dicts(got[PORT], got[REF])


def _native_record_plane(pkg):
    native = mod(pkg, "runtime.native")
    assert native.native_available()
    rp = native.NativeRecordPipeline("threaded", 1)
    rp.add_window(WIN, SLIDE, True, "sum")
    rp.set_feed()
    rp.start()
    feeder = mod(pkg, "ingest.feed").ParallelColumnFeeder(
        feed_chunk_fn, lambda k, i, t, v: rp.feed(k, i, t, v), feeders=3)
    fed = feeder.run()
    rp.feed_eos()
    n_results, total, _dropped = rp.wait()
    want = expected_windows(FEED_SB * FEED_CHUNKS)
    assert fed == FEED_SB * FEED_CHUNKS
    assert n_results == len(want)
    assert total == pytest.approx(sum(want.values()), rel=1e-9)
    return n_results, total


def test_parallel_feeder_into_native_record_plane():
    """The feeder plane into each package's native record pipeline (its
    SPSC feed ring, serialized by the turnstile): the same result count
    and total."""
    got = both(_native_record_plane)
    assert got[PORT] == got[REF]


def _chunk_fn_failing_at(at, msg):
    def bad_chunk(i, take):
        if i == at:
            raise RuntimeError(msg)
        return feed_chunk_fn(i, take)
    return bad_chunk


def _feeder_error(pkg):
    feeder = mod(pkg, "ingest.feed").ParallelColumnFeeder(
        _chunk_fn_failing_at(3, "boom"), lambda *a: None, feeders=2)
    with pytest.raises(RuntimeError, match="boom") as ei:
        feeder.run()
    return str(ei.value)


def _feed_source_error(pkg):
    wf = wf_of(pkg)
    g = wf.PipeGraph("feed_err", wf.Mode.DEFAULT, config=cfg(pkg))
    g.add_source(mod(pkg, "ingest.feed").FeedSource(
        _chunk_fn_failing_at(2, "feeder boom"), feeders=3)) \
        .add(win_seq(pkg, batch_len=256, emit_batches=True)) \
        .add_sink(mod(pkg, "operators.basic_ops").Sink(WindowDict()))
    with pytest.raises(RuntimeError) as ei:
        g.run()  # hangs without the cursor's end on the raise path
    assert "feeder boom" in str(ei.value)
    return type(ei.value).__name__


@pytest.mark.parametrize("case", ["feeder", "feed_source"])
def test_feed_errors_propagate(case):
    """A chunk_fn failure surfaces: from ParallelColumnFeeder.run, and
    from a FeedSource graph whose peer feeders unwind through EOS
    instead of deadlocking on the turnstile."""
    got = both({"feeder": _feeder_error,
                "feed_source": _feed_source_error}[case])
    assert got[PORT] == got[REF]


# ---------------------------------------------------------------------------
# the whole-partition device step (tests/test_fusion.py:553-675)
# ---------------------------------------------------------------------------

def _step_crash(pkg):
    wf = wf_of(pkg)
    levels = mod(pkg, "core.basic").OptLevel
    faults = mod(pkg, "resilience.faults")
    nexmark = mod(pkg, "models.nexmark")
    failed = []
    for step in (False, True):
        with faults.FaultPlan(seed=11).crash_replica(
                "q5_counts", at_tuple=5) as plan:
            g = wf.PipeGraph("step_crash", wf.Mode.DEFAULT,
                             config=cfg(pkg, opt_level=levels.LEVEL2,
                                        fault_plan=plan, device_step=step))
            nexmark.build_q5_hot_items(g, 60_000, 1 << 12, 1 << 11,
                                       WindowDict(), batch_size=4096,
                                       device_batch=512)
            with pytest.raises(wf.NodeFailureError) as ei:
                g.run()
            nodes = sorted(n for n, e in ei.value.errors
                           if isinstance(e, faults.InjectedFailure))
            assert nodes, step
            failed.append(nodes)
    return failed


def test_device_step_crash_mid_chunk():
    """A FaultPlan crash inside the step node fires mid-chunk and
    surfaces as any fused crash, step on and off: the same failing
    nodes in both packages."""
    got = both(_step_crash)
    assert got[PORT] == got[REF]


def _ckpt_batch_source(pkg, n, batch=512, pace_s=0.002):
    """tests/test_fusion.py:575-615: an offset-checkpointable paced
    batch source (key e % 4, id = ts = e // 4, value e % 7)."""
    import time
    basic = mod(pkg, "core.basic")
    base = mod(pkg, "operators.base")
    TupleBatch = mod(pkg, "core.tuples").TupleBatch

    class Logic(mod(pkg, "runtime.node").SourceLoopLogic):
        def __init__(self):
            self.i = 0
            super().__init__(self._step)

        def _step(self, emit):
            i = self.i
            if i >= n:
                return False
            time.sleep(pace_s)
            m = min(batch, n - i)
            idx = i + np.arange(m)
            self.i = i + m
            emit(TupleBatch({"key": idx % 4, "id": idx // 4,
                             "ts": idx // 4,
                             "value": (idx % 7).astype(np.float64)}))
            return True

        def state_dict(self):
            return {"i": self.i}

        def load_state(self, st):
            self.i = st["i"]

        def progress_frontier(self):
            return self.i

    class Source(base.Operator):
        def __init__(self):
            super().__init__("ckpt_bsrc", 1, basic.RoutingMode.NONE,
                             basic.Pattern.SOURCE)

        def stages(self):
            return [base.StageSpec(
                self.name, [Logic()],
                mod(pkg, "runtime.emitters").StandardEmitter(),
                self.routing)]

    return Source()


def _step_epochs(pkg, path, fault, force_python):
    """One durable device-step run (test_fusion.py:620-675): window
    results, how often each arrived, the graph and its step nodes."""
    wf = wf_of(pkg)
    levels = mod(pkg, "core.basic").OptLevel
    fuse = mod(pkg, "graph.fuse")
    step_cls = mod(pkg, "graph.device_step").DeviceStepLogic
    sink = WindowDict()

    def factory(attempt):
        plan = fault if attempt == 0 else None
        durability = mod(pkg, "core").DurabilityConfig(
            epoch_interval_s=0.03, path=path)
        g = wf.PipeGraph("step_dur", wf.Mode.DEFAULT,
                         config=cfg(pkg, opt_level=levels.LEVEL2,
                                    durability=durability,
                                    fault_plan=plan))
        op = mod(pkg, "operators.tpu.win_seq_tpu").WinSeqTPU(
            "sum", 256, 128, wf.WinType.TB, batch_len=256,
            emit_batches=True, name="stepwin")
        g.add_source(_ckpt_batch_source(pkg, 30_000)).add(op) \
            .add_sink(wf.SinkBuilder(sink).with_exactly_once().build())
        if force_python:
            for _name, logic in fuse.iter_logics(g):
                if hasattr(logic, "_native"):
                    logic._native = None
        return g

    g = mod(pkg, "durability").run_with_epochs(factory, max_restarts=2)
    steps = [n for n in g._all_nodes() if isinstance(n.logic, step_cls)]
    return sink, g, steps


@pytest.mark.parametrize("force_python", [False, True])
def test_device_step_epoch_kill_restart_bitwise(tmp_path, force_python):
    """Exactly-once across a kill-restart with the step active, on both
    channel planes: the port's uninterrupted run equals the reference's,
    and the port's run killed on its 30th tuple and restarted from its
    committed epoch gives every window once, bitwise the reference's
    uninterrupted run."""
    ref, _g, ref_steps = _step_epochs(REF, str(tmp_path / "ref"), None,
                                      force_python)
    assert ref.res and max(ref.counts.values()) == 1 and ref_steps
    clean, _g, steps = _step_epochs(PORT, str(tmp_path / "port"), None,
                                    force_python)
    assert steps, "step should be active"
    assert max(clean.counts.values()) == 1 and clean.res == ref.res
    plan = mod(PORT, "resilience.faults").FaultPlan(seed=13).crash_replica(
        "stepwin", at_tuple=30)
    chaos, g, _steps = _step_epochs(PORT, str(tmp_path / "chaos"), plan,
                                    force_python)
    assert getattr(g, "_epoch_restored", None) is not None
    assert max(chaos.counts.values()) == 1, "duplicate window results"
    assert chaos.res == ref.res
