"""The port's distributed runtime plane (windflow_tpu_torch/distributed/)
held against the reference's, in one process: the in-process classes
of tests/test_distributed.py (the wire codec, the partition planner,
the shuffle transport over both channel planes, the per-worker
artifacts) and the wire backoff of tests/test_supervision.py.

Each case runs the reference test's scenario through both packages on
the same inputs; both meet the reference test's assertions and their
results are equal, with no tolerance.  Wire frames are compared byte
for byte, and a frame one package encodes decodes in the other.  The
two-process runs are in tests/test_torch_distributed_procs.py.

Every shuffle server binds port 0 and is stopped in a ``finally``.
"""
import os
import random
import threading
import time
import zlib
from importlib import import_module

import numpy as np
import pytest

from torch_graphs import PACKAGES, PORT, mod

REF = PACKAGES[0]
N_KEYS = 8


def _batch(pkg, lo, n, keys=N_KEYS):
    i = np.arange(lo, lo + n)
    return mod(pkg, "core.tuples").TupleBatch({
        "key": i % keys, "id": i // keys, "ts": i,
        "value": (i % 13).astype(np.float64)})


def _both(scenario, *args, **kw):
    """``scenario(pkg, *args, **kw)`` in both packages; the results
    equal."""
    want = scenario(REF, *args, **kw)
    got = scenario(PORT, *args, **kw)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# wire codec: shared framing + shuffle message layer
# ---------------------------------------------------------------------------

def _legacy_path(pkg):
    legacy = mod(pkg, "ingest.codec")
    wire = mod(pkg, "distributed.wire")
    b = _batch(pkg, 0, 100)
    rt = legacy.decode_batch(legacy.encode_batch(b)[8:])
    assert np.array_equal(rt.key, b.key)
    legacy._warned = False  # warn-once is per process
    with pytest.warns(DeprecationWarning):
        assert legacy.MsgDecoder is wire.MsgDecoder
    assert legacy.encode_batch is wire.encode_batch
    assert legacy.StreamDecoder is wire.StreamDecoder
    return rt.key.tolist()


def test_wire_legacy_import_path_still_works():
    _both(_legacy_path)


def _msg_blob(pkg):
    wire = mod(pkg, "distributed.wire")
    msgs = []
    for i in range(40):
        kind, payload, _c = wire.encode_item(_batch(pkg, i * 50, 50))
        msgs.append((kind, i % 3, i + 1, payload))
    msgs.append((wire.MSG_EOS, 0, 41, b""))
    return msgs, b"".join(wire.encode_msg(*m) for m in msgs)


def _fuzz_decode(pkg, blob, seed):
    wire = mod(pkg, "distributed.wire")
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(5):
        dec = wire.MsgDecoder()
        got = []
        off = 0
        while off < len(blob):
            n = int(rng.integers(1, 97))
            got.extend(dec.feed(blob[off:off + n]))
            off += n
        assert dec.pending_bytes() == 0
        out.append(got)
    return out


def test_wire_msg_roundtrip_fuzzed_partial_frames():
    msgs_r, blob_r = _msg_blob(REF)
    msgs_p, blob_p = _msg_blob(PORT)
    assert blob_p == blob_r                       # byte for byte
    for dec_pkg in PACKAGES:                      # and across packages
        for got in _fuzz_decode(dec_pkg, blob_r, 7):
            assert len(got) == len(msgs_r)
            for (k, p, s, pl), (k2, p2, s2, pl2) in zip(msgs_p, got):
                assert (k, p, s) == (k2, p2, s2) and pl == pl2


def _stream_decode(pkg, blob):
    wire = mod(pkg, "distributed.wire")
    rng = np.random.default_rng(3)
    dec = wire.StreamDecoder()
    got = []
    off = 0
    while off < len(blob):
        n = int(rng.integers(1, 61))
        got.extend(dec.feed(blob[off:off + n]))
        off += n
    return [(b.key.tolist(), b["value"].tolist()) for b in got]


def test_wire_stream_decoder_fuzzed_partials():
    blobs = {pkg: b"".join(mod(pkg, "distributed.wire").encode_batch(
        _batch(pkg, i * 100, 100)) for i in range(10)) for pkg in PACKAGES}
    assert blobs[PORT] == blobs[REF]
    want = [(_batch(REF, i * 100, 100).key.tolist(),
             _batch(REF, i * 100, 100)["value"].tolist())
            for i in range(10)]
    for pkg in PACKAGES:
        assert _stream_decode(pkg, blobs[REF]) == want


def _zero_tuple(pkg):
    wire = mod(pkg, "distributed.wire")
    empty = mod(pkg, "core.tuples").TupleBatch({
        "key": np.array([], np.int64), "id": np.array([], np.int64),
        "ts": np.array([], np.int64), "value": np.array([], np.float64)})
    rt = wire.decode_batch(wire.encode_batch(empty)[8:])
    assert len(rt) == 0 and set(rt.cols) == set(empty.cols)
    kind, payload, cost = wire.encode_item(empty)
    assert kind == wire.MSG_DATA and cost == 1
    item, cost2 = wire.decode_item(kind, payload, "e")
    assert len(item) == 0 and cost2 == 1
    return kind, payload, cost, sorted(rt.cols)


def test_wire_zero_tuple_frame():
    _both(_zero_tuple)


def _oversized(pkg):
    wire = mod(pkg, "distributed.wire")
    errors = []
    big = wire.encode_msg(wire.MSG_RECORD, 0, 1, b"x" * 256)
    with pytest.raises(ValueError, match="exceeds") as e1:
        wire.MsgDecoder(max_frame_bytes=64).feed(big)
    with pytest.raises(ValueError, match="exceeds") as e2:
        wire.StreamDecoder(max_frame_bytes=64).feed(
            wire.encode_batch(_batch(pkg, 0, 1000)))
    with pytest.raises(ValueError, match="desync") as e3:
        wire.MsgDecoder().feed(b"JUNKJUNKJUNKJUNKJUNKJUNK")
    for e in (e1, e2, e3):
        errors.append(str(e.value))
    return errors


def test_wire_oversized_frame_rejected():
    _both(_oversized)


def _item_kinds(pkg):
    wire = mod(pkg, "distributed.wire")
    BasicRecord = mod(pkg, "core.tuples").BasicRecord
    EOSMarker = mod(pkg, "runtime.node").EOSMarker
    EpochBarrier = mod(pkg, "runtime.queues").EpochBarrier
    rec = BasicRecord(3, 7, 11, 2.5)
    out = []
    for item, want_kind in (
            (rec, wire.MSG_RECORD),
            (EOSMarker(rec), wire.MSG_RECORD),
            (EpochBarrier(9), wire.MSG_BARRIER),
            (EpochBarrier(-1, final=True), wire.MSG_BARRIER)):
        kind, payload, _c = wire.encode_item(item)
        assert kind == want_kind
        back, _c2 = wire.decode_item(kind, payload, "e")
        if isinstance(item, EpochBarrier):
            assert type(back) is EpochBarrier
            out.append((kind, payload, back.epoch, back.final))
        elif isinstance(item, EOSMarker):
            assert isinstance(back, EOSMarker)
            out.append((kind, back.record.key))
        else:
            out.append((kind, back.key, back.id, back.value))
    return out


def test_wire_item_kinds_roundtrip():
    got = _both(_item_kinds)
    assert got[0][1:] == (3, 7, 2.5) and got[1][1] == 3
    assert got[2][2:] == (9, False) and got[3][2:] == (-1, True)


def _trace_hop(pkg):
    wire = mod(pkg, "distributed.wire")
    TraceContext = mod(pkg, "telemetry.trace").TraceContext
    trace_breakdown = mod(pkg, "diagnosis.attribution").trace_breakdown
    b = _batch(pkg, 0, 10)
    t0 = time.perf_counter() - 0.050
    ctx = TraceContext("pipe0/src", t0)
    ctx.hop("pipe0/map", t0 + 0.010, t0 + 0.030)
    b.trace = ctx
    kind, payload, _c = wire.encode_item(b)
    assert b.trace is ctx
    item, _cost = wire.decode_item(kind, payload, "pipe0/agg.0")
    rb = item.trace
    assert rb is not None and rb.src == "pipe0/src"
    a = rb.hops[0][1] - rb.t0
    assert 0.005 < a < 0.02
    bd = trace_breakdown(rb.to_dict(time.perf_counter()))
    assert bd is not None and bd["classes"]["wire"] > 0.0
    return [h[0] for h in rb.hops], sorted(bd["classes"])


def test_wire_trace_rides_the_frame_as_wire_hop():
    names, _classes = _both(_trace_hop)
    assert names == ["pipe0/map", "pipe0/agg.0@wire"]


def test_wire_attribution_classes_sum_with_wire():
    rec = {"e2e_ms": 10.0,
           "hops": [["src", 0.0, 1.0], ["agg.0@wire", 1.0, 5.0],
                    ["agg.0", 6.0, 9.0]]}
    bd = _both(lambda pkg: mod(pkg, "diagnosis.attribution")
               .trace_breakdown(rec))
    assert abs(sum(bd["classes"].values()) - 10.0) < 1e-6
    assert abs(bd["classes"]["wire"] - 4.0) < 1e-6
    assert abs(bd["classes"]["queueing"] - 2.0) < 1e-6
    assert abs(bd["classes"]["service"] - 4.0) < 1e-6


# ---------------------------------------------------------------------------
# partition planner: the same graph, the same plan
# ---------------------------------------------------------------------------

def _keyed_pipeline(pkg, name, acc_par=2):
    wf = import_module(pkg)
    g = wf.PipeGraph(name)
    out = []

    def fold(t, acc):
        acc.value += t.value

    g.add_source(wf.SourceBuilder(lambda s: False)
                 .with_name("psrc").build()) \
        .add(wf.AccumulatorBuilder(fold).with_name("pfold")
             .with_parallelism(acc_par).build()) \
        .add_sink(wf.SinkBuilder(out.append).with_name("psink").build())
    return g


def _chain3(pkg, name, names, pins=(None, None, None), chain_sink=False):
    wf = import_module(pkg)
    g = wf.PipeGraph(name)
    src = wf.SourceBuilder(lambda s: False).with_name(names[0])
    mp = wf.MapBuilder(lambda t: t).with_name(names[1])
    snk = wf.SinkBuilder(lambda r: None).with_name(names[2])
    for b, pin in zip((src, mp, snk), pins):
        if pin is not None:
            b.with_worker(pin)
    pipe = g.add_source(src.build()).add(mp.build())
    if chain_sink:
        pipe.chain_sink(snk.build())
    else:
        pipe.add_sink(snk.build())
    return g


def _plan(pkg, make, n, **kw):
    return mod(pkg, "distributed.partition").plan_partition(make(pkg), n,
                                                            **kw)


def test_partition_auto_cut_at_keyby_edge():
    plan = _both(_plan, lambda p: _keyed_pipeline(p, "p"), 2)
    assert plan["pipe0/psrc"] == 0
    assert plan["pipe0/pfold.0"] == plan["pipe0/pfold.1"] \
        == plan["pipe0/psink.0"] == 1


def test_partition_single_worker_collapses():
    plan = _both(_plan, lambda p: _keyed_pipeline(p, "p1"), 1)
    assert set(plan.values()) == {0}


def test_partition_forward_chain_stays_colocated():
    plan = _both(_plan, lambda p: _chain3(p, "pf", ("fsrc", "fmap",
                                                    "fsink")), 2)
    assert len(set(plan.values())) == 1


def test_partition_pins_cut_forward_edges():
    plan = _both(_plan, lambda p: _chain3(p, "pp", ("asrc", "amap",
                                                    "asink"), (0, 1, None)),
                 2)
    assert plan["pipe0/asrc"] == 0
    assert plan["pipe0/amap.0"] == 1
    assert plan["pipe0/asink.0"] == 1


def _conflict(pkg):
    part = mod(pkg, "distributed.partition")
    g = _chain3(pkg, "pc", ("csrc", "cmap", "csink"))
    with pytest.raises(part.PartitionError, match="conflicting") as e:
        part.plan_partition(g, 2, overrides={"csrc": 0, "csink": 1})
    return str(e.value)


def test_partition_conflicting_pins_in_one_group_raise():
    _both(_conflict)


def test_partition_override_assignment_beats_auto():
    plan = _both(_plan, lambda p: _keyed_pipeline(p, "po"), 2,
                 overrides={"pfold": 0, "psrc": 1})
    assert plan["pipe0/psrc"] == 1
    assert plan["pipe0/pfold.0"] == 0


def test_partition_pin_survives_chaining():
    plan = _both(_plan, lambda p: _chain3(p, "pch", ("hsrc", "hmap",
                                                     "hsink"),
                                          (None, None, 1), chain_sink=True),
                 2)
    assert set(plan.values()) == {1}


def _fused_owners(pkg):
    g = _chain3(pkg, "pfz", ("zsrc", "zmap", "zsink"), (0, 1, 1))
    part = mod(pkg, "distributed.partition")
    plan = part.plan_partition(g, 2)
    mod(pkg, "graph.fuse").fuse_graph(g)
    return plan, sorted((n.name, part.node_owner(n, plan))
                        for n in g._all_nodes())


def test_partition_fusion_respects_partition():
    _plan_, owners = _both(_fused_owners)
    assert {w for _n, w in owners} == {0, 1}


# ---------------------------------------------------------------------------
# shuffle transport, in-process over loopback (both channel planes)
# ---------------------------------------------------------------------------

def _planes():
    planes = ["python"]
    if all(mod(pkg, "runtime.native").native_available()
           for pkg in PACKAGES):
        planes.append("native")
    return planes


class _Rig:
    """One in-process shuffle edge of package ``pkg``: consumer graph +
    server on worker 1, producer graph + sender on worker 0."""

    EDGE = "pipe0/rig_sink.0"

    def __init__(self, pkg, plane, n_pids=2, capacity=2048,
                 wire_credits=1 << 15, grace_s=0.5, faults=None):
        wf = import_module(pkg)
        self.pkg = pkg
        cfg = mod(pkg, "core.basic").RuntimeConfig(
            queue_capacity=capacity, use_native_runtime=(plane == "native"))
        self.chan = mod(pkg, "runtime.queues").make_channel(cfg)
        self.pids = [self.chan.register_producer() for _ in range(n_pids)]
        self.cgraph = wf.PipeGraph("rig_consumer")
        self.pgraph = wf.PipeGraph("rig_producer")
        DistributedSpec = mod(pkg, "distributed.runtime").DistributedSpec
        tr = mod(pkg, "distributed.transport")
        cspec = DistributedSpec(1, 2, [("127.0.0.1", 0), ("127.0.0.1", 0)],
                                reconnect_grace_s=grace_s)
        self.edge = tr.EdgeState(self.EDGE, self.chan, {0: set(self.pids)})
        self.server = tr.ShuffleServer(self.cgraph, cspec,
                                       {self.EDGE: self.edge})
        self.server.start()
        pspec = DistributedSpec(0, 2, [("127.0.0.1", 0),
                                       ("127.0.0.1", self.server.port)],
                                wire_credits=wire_credits)
        self.sender = tr.RemoteEdgeSender(self.EDGE, "127.0.0.1",
                                          self.server.port, self.pgraph,
                                          self.pids, pspec)
        if faults is not None:
            self.sender.faults = faults.for_link(self.EDGE)

    def batch(self, lo, n):
        return _batch(self.pkg, lo, n)

    def drain(self, timeout=10.0):
        out = []
        deadline = time.monotonic() + timeout
        while True:
            got = self.chan.get(timeout=0.2)
            if got is None:
                return out
            if isinstance(got, tuple):
                out.append(got)
            if time.monotonic() > deadline:
                raise AssertionError(f"drain timed out with {len(out)}")

    def close(self):
        self.server.stop()


def _settle(pred, timeout=5.0):
    """Wait until ``pred()`` holds, for state the receiver's thread sets
    just after it closes the consumer channel on EOS (edge completion)
    or when the producer's trailer, shipped after its EOS, arrives (the
    delivery check): a drain can return before either."""
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)


def _with_rig(pkg, plane, body, **kw):
    rig = _Rig(pkg, plane, **kw)
    try:
        return body(rig)
    finally:
        rig.close()


def _roundtrip(rig):
    BasicRecord = mod(rig.pkg, "core.tuples").BasicRecord
    TupleBatch = mod(rig.pkg, "core.tuples").TupleBatch
    for i in range(10):
        rig.sender.put(rig.pids[i % 2], rig.batch(i * 64, 64))
    rig.sender.put(rig.pids[0], BasicRecord(1, 2, 3, 4.0))
    for pid in rig.pids:
        rig.sender.close(pid)
    got = rig.drain()
    batches = [it for _pid, it in got if isinstance(it, TupleBatch)]
    recs = [it for _pid, it in got if isinstance(it, BasicRecord)]
    assert len(batches) == 10 and len(recs) == 1
    assert rig.sender.flush(5.0)
    assert rig.sender.gets == rig.sender.puts
    assert rig.sender.qsize() == 0
    deadline = time.monotonic() + 2.0
    while rig.sender.gate.available < rig.sender.gate.budget:
        assert time.monotonic() < deadline
        time.sleep(0.005)
    rows = rig.edge.blocks()
    assert rig.edge.completed
    assert not rig.cgraph._cancel.cancelled
    return (sorted((pid, int(b.ts[0]), len(b)) for pid, b in got
                   if isinstance(b, TupleBatch)),
            rig.sender.tuples_sent, rig.sender.frames_sent,
            [(r["tuples"], r["frames"], r["gaps"], r["sender_tuples"])
             for r in rows])


def _backpressure(rig):
    sent = []

    def producer():
        for i in range(64):
            rig.sender.put(rig.pids[0], rig.batch(i, 1))
            sent.append(i)
        rig.sender.close(rig.pids[0])

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    time.sleep(0.8)
    assert len(sent) < 40          # credit-stalled short of the stream
    stalled_at = len(sent)
    got = rig.drain()
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert len(got) == 64 > stalled_at
    assert rig.sender.gate.credit_waits > 0
    return [int(b.ts[0]) for _pid, b in got]


def _reconnect(rig):
    for i in range(10):
        rig.sender.put(rig.pids[0], rig.batch(i * 10, 10))
    assert rig.sender.flush(5.0)
    sock = rig.sender._sock
    assert sock is not None
    sock.close()
    for i in range(10, 20):
        rig.sender.put(rig.pids[0], rig.batch(i * 10, 10))
    rig.sender.close(rig.pids[0])
    got = rig.drain()
    _settle(lambda: rig.edge.completed)
    assert rig.sender.reconnects >= 1
    assert not rig.cgraph._cancel.cancelled
    assert rig.edge.completed
    return sorted(int(b.ts[0]) for _pid, b in got)


def _broken(rig):
    rig.sender.put(rig.pids[0], rig.batch(0, 5))
    assert rig.sender.flush(5.0)
    rig.sender._cancelled = True
    rig.sender._close_sock()
    deadline = time.monotonic() + 5.0
    while not rig.cgraph._cancel.cancelled:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    return "rig_sink" in str(rig.cgraph._cancel.reason)


def _dropped(rig):
    for i in range(6):
        rig.sender.put(rig.pids[0], rig.batch(i * 10, 10))
    rig.sender.close(rig.pids[0])
    got = rig.drain()
    _settle(lambda: any(e.get("kind") == "conservation_violation"
                        for e in rig.cgraph.flight.snapshot()))
    rows = rig.edge.blocks()
    events = rig.cgraph.flight.snapshot()
    gap = any(e.get("kind") == "wire_gap"
              and e.get("edge") == "pipe0/rig_sink.0" for e in events)
    violation = [e.get("count") for e in events
                 if e.get("kind") == "conservation_violation"
                 and e.get("edge") == "pipe0/rig_sink.0"]
    return (len(got), rig.sender.frames_dropped, rig.sender.tuples_sent,
            rows[0]["tuples"], rows[0]["gaps"], gap, violation)


def _delayed(rig):
    t0 = time.monotonic()
    for i in range(6):
        rig.sender.put(rig.pids[0], rig.batch(i, 4))
    elapsed = time.monotonic() - t0
    assert elapsed >= 0.10            # 3 delayed frames x 40 ms
    rig.sender.close(rig.pids[0])
    return len(rig.drain())


def _barriers(rig):
    EpochBarrier = mod(rig.pkg, "runtime.queues").EpochBarrier
    rig.sender.put(rig.pids[0], rig.batch(0, 8))
    rig.sender.put(rig.pids[0], EpochBarrier(1))
    rig.sender.put(rig.pids[1], EpochBarrier(1))
    for pid in rig.pids:
        rig.sender.close(pid)
    got = rig.drain()
    barriers = [(pid, it) for pid, it in got if type(it) is EpochBarrier]
    assert {pid for pid, _ in barriers} == set(rig.pids)
    return (sorted((pid, b.epoch) for pid, b in barriers),
            rig.sender.barriers_sent,
            sum(r["barriers"] for r in rig.edge.blocks()))


def _faults(pkg, action):
    FaultPlan = mod(pkg, "resilience").FaultPlan
    if action == "drop":
        return FaultPlan().drop_link("rig_sink", at_frame=3)
    return FaultPlan().delay_link("rig_sink", delay_ms=40, every_n=2)


@pytest.mark.parametrize("plane", _planes())
class TestTransport:
    def test_roundtrip_data_records_eos(self, plane):
        order, tuples, _frames, rows = _both(
            lambda pkg: _with_rig(pkg, plane, _roundtrip))
        assert len(order) == 10 and tuples == 641
        assert sum(r[0] for r in rows) == 641

    def test_credit_backpressure_throttles_producer(self, plane):
        ts = _both(lambda pkg: _with_rig(pkg, plane, _backpressure,
                                         n_pids=1, capacity=4,
                                         wire_credits=8))
        assert ts == list(range(64))

    def test_reconnect_mid_stream_no_loss_no_dup(self, plane):
        ids = _both(lambda pkg: _with_rig(pkg, plane, _reconnect,
                                          n_pids=1))
        assert ids == [i * 10 for i in range(20)]   # exactly once

    def test_broken_link_cancels_consumer_after_grace(self, plane):
        assert _both(lambda pkg: _with_rig(pkg, plane, _broken, n_pids=1,
                                           grace_s=0.3))

    def test_drop_link_flags_edge_and_count(self, plane):
        got = _both(lambda pkg: _with_rig(pkg, plane, _dropped, n_pids=1,
                                          faults=_faults(pkg, "drop")))
        assert got == (5, 1, 60, 50, 1, True, [10])

    def test_delay_link_applies(self, plane):
        assert _both(lambda pkg: _with_rig(
            pkg, plane, _delayed, n_pids=1,
            faults=_faults(pkg, "delay"))) == 6

    def test_barriers_ride_frames(self, plane):
        barriers, sent, rows = _both(
            lambda pkg: _with_rig(pkg, plane, _barriers, n_pids=2))
        assert [e for _pid, e in barriers] == [1, 1]
        assert sent == 2 and rows == 2


# ---------------------------------------------------------------------------
# per-worker log/snapshot naming + merged view
# ---------------------------------------------------------------------------

class TestWorkerArtifacts:
    def test_worker_suffix_in_flight_dump(self, tmp_path, monkeypatch):
        def scenario(pkg):
            FlightRecorder = mod(pkg, "telemetry.recorder").FlightRecorder
            monkeypatch.setenv("WINDFLOW_WORKER_ID", "3")
            fr = FlightRecorder(8)
            fr.record("x", a=1)
            path = fr.dump(str(tmp_path / pkg), "gname")
            monkeypatch.delenv("WINDFLOW_WORKER_ID")
            path2 = fr.dump(str(tmp_path / pkg), "gname")
            return os.path.basename(path), os.path.basename(path2)

        got = _both(scenario)
        assert got == (f"{os.getpid()}_gname_w3_flight.jsonl",
                       f"{os.getpid()}_gname_flight.jsonl")

    def test_worker_identity_helpers(self, monkeypatch):
        def scenario(pkg):
            ident = mod(pkg, "distributed.identity")
            out = []
            monkeypatch.delenv("WINDFLOW_WORKER_ID", raising=False)
            out.append((ident.worker_id(), ident.worker_suffix()))
            monkeypatch.setenv("WINDFLOW_WORKER_ID", "7")
            out.append((ident.worker_id(), ident.worker_suffix()))
            monkeypatch.setenv("WINDFLOW_WORKER_ID", "junk")
            out.append((ident.worker_id(), ident.worker_suffix()))
            return out

        assert _both(scenario) == [(None, ""), (7, "_w7"), (None, "")]

    def test_merge_stats_flags_wire_imbalance(self):
        w0 = {"PipeGraph_name": "g", "Worker": 0, "Schema_version": 5,
              "Operators": [{"Operator_name": "pipe0/src",
                             "Replicas": []}],
              "Wire": {"Worker": 0, "in": [], "out": [
                  {"edge": "pipe0/agg.0", "tuples": 100, "frames": 12,
                   "barriers": 0, "dropped_frames": 1}]}}
        w1 = {"PipeGraph_name": "g", "Worker": 1, "Schema_version": 5,
              "Operators": [{"Operator_name": "pipe0/agg",
                             "Replicas": []}],
              "Conservation": {"Edges_balanced": True,
                               "Final_check": True},
              "Wire": {"Worker": 1, "out": [], "in": [
                  {"edge": "pipe0/agg.0", "from_worker": 0,
                   "tuples": 90, "frames": 11, "barriers": 0,
                   "gaps": 1}]}}

        def scenario(pkg):
            obs = mod(pkg, "distributed.observe")
            return (obs.merge_stats([w0, w1]),
                    obs.check_wire_conservation([w0, w1]))

        merged, violations = _both(scenario)
        assert merged["Operator_number"] == 2
        assert not merged["Wire"]["Balanced"]
        assert merged["Wire"]["Edges"][0]["missing_tuples"] == 10
        assert violations == [{"kind": "lost_wire_delivery",
                               "edge": "pipe0/agg.0", "count": 10}]


# ---------------------------------------------------------------------------
# backoff envelopes (tests/test_supervision.py's wire cases)
# ---------------------------------------------------------------------------

def _backoff_envelope(pkg):
    tr = mod(pkg, "distributed.transport")
    rng = random.Random(42)
    prev_base = 0.0
    delays = []
    for attempt in range(12):
        base = min(tr._BACKOFF_CAP_S, tr._BACKOFF_BASE_S * (2 ** attempt))
        d = tr.backoff_delay(attempt, rng)
        assert base <= d <= base * (1.0 + tr._BACKOFF_JITTER) + 1e-12
        assert base >= prev_base
        prev_base = base
        delays.append(d)
    assert prev_base == tr._BACKOFF_CAP_S
    mk = lambda: random.Random(zlib.crc32(b"wire:pipe0/acc.1"))  # noqa
    seq1 = [tr.backoff_delay(a, mk()) for a in range(4)]
    assert seq1 == [tr.backoff_delay(a, mk()) for a in range(4)]
    return (tr._BACKOFF_BASE_S, tr._BACKOFF_CAP_S, tr._BACKOFF_JITTER,
            delays, seq1)


def test_wire_backoff_delay_envelope_and_determinism():
    _both(_backoff_envelope)


def test_wire_reconnect_backoff_rides_flight_ring(monkeypatch):
    def scenario(pkg):
        tr = mod(pkg, "distributed.transport")
        FlightRecorder = mod(pkg, "telemetry").FlightRecorder

        class _Spec:
            wire_reconnects = 2
            wire_credits = 64
            connect_timeout_s = 0.1

        class _Graph:
            flight = FlightRecorder(32)
            stats = None

        sender = tr.RemoteEdgeSender("pipe0/acc.0", "127.0.0.1", 1,
                                     _Graph(), pids=[0], spec=_Spec())

        def boom(self=None):
            raise OSError("connection refused (test)")

        monkeypatch.setattr(sender, "_ensure_open", boom)
        with monkeypatch.context() as m:
            m.setattr("time.sleep", lambda s: None)
            with pytest.raises(tr.WireError, match="failed after"):
                sender._send_frame(b"frame")
        return [(e["attempt"], e["edge"], e["delay_s"])
                for e in _Graph.flight.snapshot()
                if e["kind"] == "wire_reconnect_backoff"]

    evs = _both(scenario)
    assert [a for a, _e, _d in evs] == [1, 2]
    assert all(e == "wire:pipe0/acc.0" and d > 0 for _a, e, d in evs)


# ---------------------------------------------------------------------------
# what a device engine's results put on the wire
# ---------------------------------------------------------------------------

def _q5_items(pkg, placement):
    wf = import_module(pkg)
    from torch_graphs import cpu_config
    items = []
    g = wf.PipeGraph("q5_wire", config=cpu_config(pkg))
    mod(pkg, "models.nexmark").build_q5_hot_items(
        g, 60_000, 8192, 4096,
        lambda it: it is not None and items.append(it), n_auctions=40,
        batch_size=16_384, device_batch=512, parallelism=2,
        placement=placement)
    g.run()
    wire = mod(pkg, "distributed.wire")
    frames = [wire.encode_item(it) for it in items]
    rows = sorted(
        (int(b.key[j]), int(b.id[j]), float(b["value"][j]))
        for kind, payload, _cost in frames
        for b in [wire.decode_item(kind, payload, "pipe0/q5_sink.0")[0]]
        for j in range(len(b)))
    return items, frames, rows


@pytest.mark.parametrize("placement", ["host", "device"])
def test_q5_results_cross_the_wire_as_columnar_batches(placement):
    """What Q5's window stage hands a wire sender, on either lane: plain
    TupleBatches of numpy columns (never a tensor or a device handle),
    encoded as DATA frames, whose rows equal the reference's."""
    import torch
    ref_items, ref_frames, ref_rows = _q5_items(REF, "host")
    items, frames, rows = _q5_items(PORT, placement)
    TupleBatch = mod(PORT, "core.tuples").TupleBatch
    wire = mod(PORT, "distributed.wire")
    assert all(type(it) is TupleBatch for it in items)
    for it in items:
        assert all(type(c) is np.ndarray for c in it.cols.values())
        assert not any(isinstance(c, torch.Tensor)
                       for c in it.cols.values())
    assert {k for k, _p, _c in frames} == {wire.MSG_DATA}
    schema = {(n, str(c.dtype)) for it in items for n, c in it.cols.items()}
    assert schema == {(n, str(c.dtype)) for it in ref_items
                      for n, c in it.cols.items()}
    assert rows == ref_rows and len(rows) == 600
