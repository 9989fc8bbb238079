"""The port's ingestion plane (windflow_tpu_torch/ingest/) held side by
side with the reference's: twins of tests/test_ingest.py and of the
ingest case of tests/test_fusion.py.

Each twin runs the reference test's scenario through ``windflow_tpu``
and through ``windflow_tpu_torch`` (on the CPU) with the same inputs,
made with numpy, asserts the reference test's own checks on both, and
holds the port's results to the reference's: tuples, keys, ids and
their order exactly, f32 window values within rtol 1e-5.  Where a
count depends on thread timing (what an overloaded source sheds,
credit waits), each package is held to the invariants the reference
test states, and the two to the same node names and books.  Sockets
bind port 0; no wall time is asserted, only deadlines against a hang.
"""
import importlib
import json
import socket
import threading
import time

import numpy as np
import pytest

from torch_graphs import PACKAGES, PORT, mod

REF = PACKAGES[0]
RTOL_F32 = 1e-5
HANG_S = 60.0


def wf_of(pkg):
    return importlib.import_module(pkg)


def cfg(pkg, **kw):
    """``RuntimeConfig(**kw)`` of ``pkg``; the port's on the CPU."""
    c = wf_of(pkg).RuntimeConfig(**kw)
    if pkg == PORT:
        c.device = "cpu"
    return c


def make_trace(pkg, n, n_keys=4, seed=0, value=None):
    ar = np.arange(n, dtype=np.int64)
    ids = ar // n_keys
    vals = (np.full(n, value, np.float64) if value is not None
            else np.random.default_rng(seed).random(n))
    return mod(pkg, "core.tuples").TupleBatch(
        {"key": ar % n_keys, "id": ids, "ts": ids, "value": vals})


class BatchSink:
    """The reference test's sink, keeping every batch's columns in
    arrival order."""

    def __init__(self, delay_s=0.0):
        self.lock = threading.Lock()
        self.cols = []
        self.tuples = 0
        self.total = 0.0
        self.delay_s = delay_s

    def __call__(self, item):
        if item is None:
            return
        if self.delay_s:
            time.sleep(self.delay_s)
        with self.lock:
            self.cols.append(tuple(np.asarray(item[c]).copy()
                                   for c in ("key", "id", "value")))
            self.tuples += len(item)
            self.total += float(item["value"].sum())

    def stream(self):
        """(keys, ids, values) of every tuple in arrival order."""
        if not self.cols:
            return tuple(np.empty(0) for _ in range(3))
        return tuple(np.concatenate(c) for c in zip(*self.cols))


def both(scenario, *args):
    """{pkg: scenario(pkg, *args)} for the reference and the port."""
    return {pkg: scenario(pkg, *args) for pkg in PACKAGES}


def assert_streams_equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def run_plain(pkg, src, sink, name, **kw):
    wf = wf_of(pkg)
    g = wf.PipeGraph(name, wf.Mode.DEFAULT, config=cfg(pkg, **kw))
    g.add_source(src).add_sink(mod(pkg, "operators.basic_ops").Sink(sink))
    g.run()
    return g


# ---------------------------------------------------------------------------
# codec (tests/test_ingest.py:54-75)
# ---------------------------------------------------------------------------

def test_codec_frames_are_byte_equal_and_cross_decode():
    """The wire format is one format: each package's frames of the same
    batches are byte-equal, and each decodes the other's, fragmented."""
    frames = {}
    for pkg in PACKAGES:
        b1 = make_trace(pkg, 1000, n_keys=3, seed=1)
        b2 = make_trace(pkg, 17, n_keys=2, seed=2).with_cols(
            extra=np.arange(17, dtype=np.int64))
        enc = mod(pkg, "ingest").encode_batch
        frames[pkg] = enc(b1) + enc(b2)
    assert frames[PORT] == frames[REF]
    for pkg in PACKAGES:
        dec = mod(pkg, "ingest").StreamDecoder()
        out = []
        wire = frames[REF if pkg == PORT else PORT]
        for i in range(0, len(wire), 997):
            out.extend(dec.feed(wire[i:i + 997]))
        assert len(out) == 2 and dec.pending_bytes() == 0
        np.testing.assert_array_equal(out[1]["extra"], np.arange(17))
        with pytest.raises(ValueError, match="magic"):
            mod(pkg, "ingest").StreamDecoder().feed(b"XXXX" + b"\x00" * 16)


# ---------------------------------------------------------------------------
# replay source (tests/test_ingest.py:80-166)
# ---------------------------------------------------------------------------

def _replay_end_to_end(pkg):
    n = 100_000
    wf = wf_of(pkg)
    src = wf.SourceBuilder.from_replay(make_trace(pkg, n, value=1.0),
                                       speedup=None, chunk=8192).build()
    sink = BatchSink()
    g = run_plain(pkg, src, sink, "replay_e2e")
    assert sink.tuples == n and sink.total == float(n)
    assert src.shed_count() == 0 and g.dead_letters.count() == 0
    m = src.metrics()[0]
    assert m["raw_emitted"] == n
    assert m["credits_peak_outstanding"] <= m["credits_budget"]
    return sink.stream(), m["credits_budget"]


def test_replay_source_end_to_end_no_shed():
    got = both(_replay_end_to_end)
    assert_streams_equal(got[PORT][0], got[REF][0])
    assert got[PORT][1] == got[REF][1]


def _replay_deterministic(pkg):
    trace = make_trace(pkg, 20_000, n_keys=3, seed=5)
    wf = wf_of(pkg)

    def run_once():
        src = wf.SourceBuilder.from_replay(trace, speedup=None, chunk=1024,
                                           seed=7).build()
        sink = BatchSink()
        run_plain(pkg, src, sink, "replay_det")
        return sink.stream()

    a, b = run_once(), run_once()
    assert_streams_equal(a, b)
    return a


def test_replay_deterministic_under_seed():
    got = both(_replay_deterministic)
    assert_streams_equal(got[PORT], got[REF])


def _replay_fault(pkg):
    wf = wf_of(pkg)
    faults = mod(pkg, "resilience")
    plan = faults.FaultPlan(seed=3).crash_replica("sink", at_tuple=2)
    src = wf.SourceBuilder.from_replay(make_trace(pkg, 50_000),
                                       speedup=None, chunk=4096).build()
    with pytest.raises(wf.NodeFailureError) as ei:
        run_plain(pkg, src, BatchSink(), "replay_fault", fault_plan=plan)
    injected = [node for node, e in ei.value.errors
                if isinstance(e, faults.InjectedFailure)]
    assert injected
    return sorted(injected)


def test_replay_composes_with_fault_plan():
    got = both(_replay_fault)
    assert got[PORT] == got[REF]


# ---------------------------------------------------------------------------
# socket source: credits throttle a slow consumer, cancel unblocks recv
# (tests/test_ingest.py:147-245)
# ---------------------------------------------------------------------------

def _serve(pkg, batches):
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    enc = mod(pkg, "ingest").encode_batch

    def run():
        conn, _ = srv.accept()
        try:
            for b in batches:
                conn.sendall(enc(b))
        except OSError:
            pass
        finally:
            conn.close()
            srv.close()

    threading.Thread(target=run, daemon=True).start()
    return port


def _socket_slow_consumer(pkg):
    n_batches, per, budget = 40, 1000, 2048
    batches = [make_trace(pkg, per, seed=i, value=1.0)
               for i in range(n_batches)]
    port = _serve(pkg, batches)
    src = wf_of(pkg).SourceBuilder.from_socket("127.0.0.1", port) \
        .with_credits(budget).build()
    sink = BatchSink(delay_s=0.01)
    run_plain(pkg, src, sink, "sock_slow", watchdog_timeout_s=30.0)
    assert sink.tuples == n_batches * per
    assert sink.total == float(n_batches * per)
    m = src.metrics()[0]
    assert m["credits_peak_outstanding"] <= budget
    assert m["peak_staged"] <= budget
    assert m["credit_waits"] > 0
    assert src.shed_count() == 0
    return sink.stream()


def test_socket_source_slow_consumer_throttled_by_credits():
    got = both(_socket_slow_consumer)
    assert_streams_equal(got[PORT], got[REF])


def _oversize_frame(pkg):
    n_batches, per, budget = 6, 7000, 2048
    batches = [make_trace(pkg, per, seed=i, value=1.0)
               for i in range(n_batches)]
    port = _serve(pkg, batches)
    src = wf_of(pkg).SourceBuilder.from_socket("127.0.0.1", port) \
        .with_credits(budget).build()
    sink = BatchSink()
    run_plain(pkg, src, sink, "sock_oversize", watchdog_timeout_s=30.0)
    assert sink.tuples == n_batches * per
    assert src.shed_count() == 0
    return sink.stream()


def test_oversize_frame_does_not_deadlock_small_credit_budget():
    got = both(_oversize_frame)
    assert_streams_equal(got[PORT], got[REF])


def _credits_parallel_consumers(pkg):
    n = 30_000
    src = wf_of(pkg).SourceBuilder.from_replay(
        make_trace(pkg, n, value=1.0), speedup=None, chunk=512) \
        .with_credits(2048).build()
    sink = BatchSink(delay_s=0.002)
    wf = wf_of(pkg)
    g = wf.PipeGraph("par_consumers", wf.Mode.DEFAULT,
                     config=cfg(pkg, watchdog_timeout_s=30.0))
    g.add_source(src).add_sink(
        mod(pkg, "operators.basic_ops").Sink(sink, parallelism=2))
    g.run()
    assert sink.tuples == n
    m = src.metrics()[0]
    assert m["credits_peak_outstanding"] <= 2048
    assert m["credits_available"] == 2048
    keys, ids, _vals = sink.stream()
    return sorted(zip(keys.tolist(), ids.tolist()))


def test_credits_balance_across_parallel_consumers():
    got = both(_credits_parallel_consumers)
    assert got[PORT] == got[REF]


def _socket_cancel(pkg):
    wf = wf_of(pkg)
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    threading.Thread(target=lambda: srv.accept(), daemon=True).start()
    src = wf.SourceBuilder.from_socket("127.0.0.1", port).build()
    g = wf.PipeGraph("sock_cancel", wf.Mode.DEFAULT, config=cfg(pkg))
    g.add_source(src).add_sink(
        mod(pkg, "operators.basic_ops").Sink(BatchSink()))
    g.start()
    time.sleep(0.3)                        # source parked in recv timeout
    g.cancel()
    raised = []

    def wait():
        try:
            g.wait_end()
        except wf.NodeFailureError as e:
            raised.append(e)

    waiter = threading.Thread(target=wait, daemon=True)
    waiter.start()
    waiter.join(HANG_S)
    srv.close()
    assert not waiter.is_alive(), "cancel did not unblock the recv"
    assert raised, "a cancelled graph ends in NodeFailureError"
    return type(raised[0]).__name__


def test_socket_source_cancel_unblocks_mid_recv():
    got = both(_socket_cancel)
    assert got[PORT] == got[REF]


# ---------------------------------------------------------------------------
# admission control (tests/test_ingest.py:251-273)
# ---------------------------------------------------------------------------

def _overloaded(pkg, policy, log_dir):
    n, budget = 60_000, 1024
    wf = wf_of(pkg)
    src = wf.SourceBuilder.from_replay(
        make_trace(pkg, n, value=1.0), speedup=None, chunk=512) \
        .with_credits(budget).with_admission(policy, max_wait_ms=0,
                                             seed=11).build()
    sink = BatchSink(delay_s=0.005)
    g = wf.PipeGraph(f"adm_{policy}", wf.Mode.DEFAULT,
                     config=cfg(pkg, tracing=True, watchdog_timeout_s=60.0,
                                log_dir=str(log_dir)))
    g.add_source(src).add_sink(mod(pkg, "operators.basic_ops").Sink(sink))
    g.run()
    shed = src.shed_count()
    assert shed > 0
    assert sink.tuples + shed == n
    assert g.dead_letters.count() == shed
    by_node = g.dead_letters.counts_by_node()
    assert sum(by_node.values()) == shed
    assert all("replay" in k for k in by_node)
    shed_cls = mod(pkg, "ingest").ShedTuples
    assert any(isinstance(e.error, shed_cls)
               for e in g.dead_letters.entries)
    data = json.loads(g.stats.to_json(g.get_num_dropped_tuples(),
                                      g.dead_letters.count()))
    assert data["Shed_tuples"] == shed
    assert data["Dead_letter_tuples"] == shed
    replay_op = next(o for o in data["Operators"]
                     if "replay" in o["Operator_name"])
    assert sum(r["Shed_tuples"] for r in replay_op["Replicas"]) == shed
    # what is shed depends on the consumer's timing; which node sheds,
    # and that every tuple is either sunk or quarantined, does not
    return sorted(by_node), replay_op["Operator_name"]


@pytest.mark.parametrize("policy", ["drop_newest", "drop_oldest", "sample"])
def test_admission_policy_sheds_into_dead_letters(policy, tmp_path):
    got = {pkg: _overloaded(pkg, policy, tmp_path / pkg)
           for pkg in PACKAGES}
    assert got[PORT] == got[REF]


# ---------------------------------------------------------------------------
# microbatch controller (AIMD) (tests/test_ingest.py:279-330)
# ---------------------------------------------------------------------------

def _controller(pkg, case):
    mc_cls = mod(pkg, "ingest").MicrobatchController
    if case == "static":
        mc = mc_cls(latency_target_ms=None, initial_batch=2048,
                    adjust_interval_s=0.0)
        for lat in (0.001, 5.0, 0.2):
            mc.observe(lat)
        assert mc.batch_size == 2048
        return [mc.batch_size]
    mc = mc_cls(latency_target_ms=10.0, min_batch=128, max_batch=8192,
                initial_batch=1024, adjust_interval_s=0.0)
    sizes = [mc.batch_size]
    mc.observe(0.001)
    assert mc.batch_size > sizes[0]
    grown = mc.batch_size
    mc.observe(0.5)
    assert mc.batch_size == max(128, grown // 2)
    for lat in [0.5] * 64 + [0.001] * 256:
        mc.observe(lat)
        sizes.append(mc.batch_size)
    assert sizes[64] == 128 and mc.batch_size == 8192
    assert len(mc.trace) > 2
    return sizes


@pytest.mark.parametrize("case", ["aimd", "static"])
def test_controller_twins(case):
    """The AIMD shape (additive increase, halving, the floor and the
    cap) and the static controller without a target: the same batch
    size after every observation in both packages."""
    got = both(_controller, case)
    assert got[PORT] == got[REF]


class WindowRows:
    """(key, id, value) of every window of result batches or records."""

    def __init__(self):
        self.lock = threading.Lock()
        self.rows = []

    def __call__(self, item):
        if item is None:
            return
        with self.lock:
            if hasattr(item, "get_control_fields"):
                self.rows.append((item.key, item.id, float(item.value)))
            else:
                self.rows.extend(zip(np.asarray(item.key).tolist(),
                                     np.asarray(item.id).tolist(),
                                     np.asarray(item["value"],
                                                np.float64).tolist()))


def assert_windows_close(got, want, rtol=RTOL_F32):
    """Equal (key, id) sets in the same sorted order; values within
    ``rtol``."""
    got, want = sorted(got), sorted(want)
    assert [r[:2] for r in got] == [r[:2] for r in want]
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want],
                               rtol=rtol)


def _steer(pkg):
    wf = wf_of(pkg)
    src = wf.SourceBuilder.from_replay(make_trace(pkg, 50_000, value=1.0),
                                       speedup=None, chunk=4096).build()
    g = wf.PipeGraph("steer", wf.Mode.DEFAULT,
                     config=cfg(pkg, latency_target_ms=20.0))
    op = mod(pkg, "operators.tpu.win_seq_tpu").WinSeqTPU(
        "sum", 1024, 512, wf.WinType.TB, emit_batches=True,
        max_batch_delay_ms=10.0)
    sink = WindowRows()
    g.add_source(src).add(op).add_sink(
        mod(pkg, "operators.basic_ops").Sink(sink))
    g.run()
    assert src.logics[0].controller.latency_target_ms == 20.0
    eng = mod(pkg, "graph.fuse").find_logic(
        g, lambda lg: isinstance(
            lg, mod(pkg, "operators.tpu.win_seq_tpu").WinSeqTPULogic))
    assert eng.max_batch_delay_ms == pytest.approx(5.0)
    return sink.rows


def test_controller_steers_engine_launch_delay():
    got = both(_steer)
    assert got[REF]
    assert_windows_close(got[PORT], got[REF])


# ---------------------------------------------------------------------------
# pane pre-reduction (tests/test_ingest.py:331-440)
# ---------------------------------------------------------------------------

def _prereduce_windows(pkg, pre_reduce, n=60_000, n_keys=4):
    wf = wf_of(pkg)
    src = wf.SourceBuilder.from_replay(
        make_trace(pkg, n, n_keys=n_keys, seed=9), speedup=None,
        chunk=4096).build()
    src.pre_reduce = pre_reduce
    sink = WindowRows()
    g = wf.PipeGraph(f"prered_{pre_reduce}", wf.Mode.DEFAULT,
                     config=cfg(pkg))
    op = mod(pkg, "operators.tpu.win_seq_tpu").WinSeqTPU(
        "sum", 2048, 1024, wf.WinType.TB, emit_batches=True)
    g.add_source(src).add(op).add_sink(
        mod(pkg, "operators.basic_ops").Sink(sink))
    g.run()
    return {(k, i): v for k, i, v in sink.rows}, src


def _prereduce(pkg):
    a, src_a = _prereduce_windows(pkg, "auto")
    b, _ = _prereduce_windows(pkg, False)
    assert src_a.logics[0].coalescer.pre_reduce is not None
    assert set(a) == set(b) and len(a) > 50
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=1e-9)
    m = src_a.metrics()[0]
    assert m["tuples_emitted"] < m["raw_emitted"] // 100
    return a, b, m["tuples_emitted"], m["raw_emitted"]


def test_pane_prereduce_into_win_seq_matches_raw_results():
    """Pane pre-reduction at the ingest edge into WinSeqTPU (an A12
    case): the same pane partials on the wire in both packages, and the
    port's windows with and without it those of the reference."""
    got = both(_prereduce)
    assert got[PORT][2:] == got[REF][2:]
    for i in (0, 1):
        assert_windows_close([k + (v,) for k, v in got[PORT][i].items()],
                             [k + (v,) for k, v in got[REF][i].items()])


def _flusher_error(pkg):
    ingest = mod(pkg, "ingest")
    coalesce = mod(pkg, "ingest.coalesce")

    class Boom:
        def reduce(self, batch):
            raise RuntimeError("pre-reduce exploded")

    co = coalesce.ChunkCoalescer(mod(pkg, "ingest.credits").CreditGate(
        10_000), ingest.MicrobatchController(), stage_cap=600)
    co.pre_reduce = Boom()
    co.ensure_started(lambda item: None)
    with pytest.raises(RuntimeError, match="pre-reduce exploded"):
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            co.put(make_trace(pkg, 500, value=1.0))
    co.abort()
    return True


def test_flusher_error_surfaces_instead_of_deadlocking_put():
    assert both(_flusher_error) == {REF: True, PORT: True}


def _reduced(pkg, batch, pane, native):
    pr = mod(pkg, "ingest.coalesce").PanePreReducer(pane, "ts")
    if not native:
        pr._native = False
    out = pr.reduce(batch)
    return sorted(zip(np.asarray(out.key).tolist(),
                      np.asarray(out.ts).tolist(),
                      np.asarray(out["value"], np.float64).tolist()))


def _negative_ts(pkg):
    n = 4096
    ts = np.arange(n, dtype=np.int64) - n // 2
    b = mod(pkg, "core.tuples").TupleBatch(
        {"key": np.zeros(n, np.int64), "id": ts, "ts": ts,
         "value": np.ones(n)})
    return _reduced(pkg, b, 256, True), _reduced(pkg, b, 256, False)


def _numpy_fallback(pkg):
    b = make_trace(pkg, 30_000, n_keys=3, seed=2)
    return _reduced(pkg, b, 512, True), _reduced(pkg, b, 512, False)


@pytest.mark.parametrize("case", ["negative_ts", "numpy_fallback"])
def test_pane_prereducer_twins(case):
    """PanePreReducer's native and numpy paths (negative timestamps
    floored into their pane; the numpy fallback on random values): the
    same (key, pane ts) rows in both packages and on both paths, values
    within the reference test's rel 1e-12."""
    got = both({"negative_ts": _negative_ts,
                "numpy_fallback": _numpy_fallback}[case])
    for pkg in PACKAGES:
        native, numpy_ = got[pkg]
        assert [r[:2] for r in native] == [r[:2] for r in numpy_]
        np.testing.assert_allclose([r[2] for r in native],
                                   [r[2] for r in numpy_], rtol=1e-12)
    for path in (0, 1):
        assert got[PORT][path] == got[REF][path]
    if case == "negative_ts":
        assert got[PORT][0][0][1] == -2048   # floored, not truncated


# ---------------------------------------------------------------------------
# async generator source (tests/test_ingest.py:443-468)
# ---------------------------------------------------------------------------

def _async_source(pkg, records):
    wf = wf_of(pkg)

    async def batches():
        for i in range(20):
            yield make_trace(pkg, 500, n_keys=2, seed=i, value=1.0)

    async def tuples():
        for i in range(300):
            yield (i % 3, i // 3, i // 3, 1.0)

    src = wf.SourceBuilder.from_async(tuples if records else batches) \
        .build()
    sink = BatchSink()
    run_plain(pkg, src, sink, "async_src")
    n = 300 if records else 20 * 500
    assert sink.tuples == n and sink.total == float(n)
    return sink.stream()


@pytest.mark.parametrize("records", [False, True])
def test_async_generator_source(records):
    got = both(_async_source, records)
    assert_streams_equal(got[PORT], got[REF])


# ---------------------------------------------------------------------------
# the ingest feed under the compile pass (tests/test_fusion.py:464-490)
# ---------------------------------------------------------------------------

def _ingest_fused(pkg):
    wf = wf_of(pkg)
    n = 40_000
    arange = np.arange(n, dtype=np.int64)
    ids = arange // 4
    trace = mod(pkg, "core.tuples").TupleBatch(
        {"key": arange % 4, "id": ids, "ts": ids,
         "value": (arange % 31).astype(np.float64)})
    levels = mod(pkg, "core.basic").OptLevel
    win_seq = mod(pkg, "operators.tpu.win_seq_tpu")
    results = {}
    for lvl in (levels.LEVEL0, levels.LEVEL2):
        sink = WindowRows()
        src = wf.SourceBuilder.from_replay(trace, speedup=None,
                                           chunk=2048).build()
        g = wf.PipeGraph("ing", wf.Mode.DEFAULT,
                         config=cfg(pkg, opt_level=lvl))
        op = win_seq.WinSeqTPU("sum", 256, 128, wf.WinType.TB,
                               batch_len=256, emit_batches=True)
        g.add_source(src).add(op).add_sink(
            mod(pkg, "operators.basic_ops").Sink(sink))
        g.run()
        results[lvl] = sorted(sink.rows)
        if lvl == levels.LEVEL2:
            assert g.fused_nodes, "engine+sink should have fused"
            assert mod(pkg, "graph.fuse").find_logic(
                g, lambda lg: isinstance(lg, win_seq.WinSeqTPULogic))
    assert results[levels.LEVEL0] == results[levels.LEVEL2]
    assert results[levels.LEVEL0], "no windows emitted"
    return results[levels.LEVEL2]


def test_ingest_feed_fused_equivalence():
    """LEVEL0 and LEVEL2 equal in each package (the credit boundary
    kept, the engine fused with the sink), and the port's windows the
    reference's exactly (integer values)."""
    got = both(_ingest_fused)
    assert got[PORT] == got[REF]
