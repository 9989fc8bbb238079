"""The port's elastic scaling plane (windflow_tpu_torch/elastic/) held
against the reference's (tests/test_elastic.py):

* key ownership, the state partition and the merge: the same keys and
  states through both packages give the same owners, parts and errors;
* the load signals and the hysteresis policy: the same scripted
  LoadReports give the same decisions;
* rescale under load (1->4->1, 1->3->2, a stateless keyed map, a
  credited ingest source, a FaultPlan crash in a replica that only
  exists after the rescale): every tuple once, per-key output
  sequences equal to the reference's run of the same graph, the same
  rescale events (operator, old and new parallelism, trigger);
* the controller: one load-driven scale-up, results exact;
* validation and API errors, the chain and fusion barriers, the stats
  JSON surface.

The port runs with ``device="cpu"``; no elastic graph here has a device
engine.  Every graph is run to its end, and its controller and sampler
threads are gone when ``run()``/``wait_end()`` returns.
"""
import importlib
import json
import random
import threading
import time
from collections import Counter

import numpy as np
import pytest

from torch_graphs import PACKAGES, PORT, mod

REF = PACKAGES[0]


def _wf(pkg):
    return importlib.import_module(pkg)


def _config(pkg, **kw):
    """RuntimeConfig of a test graph: the controller off unless asked
    for, the port on the CPU."""
    wf = _wf(pkg)
    kw.setdefault("elasticity",
                  mod(pkg, "elastic").ElasticityConfig(enabled=False))
    cfg = wf.RuntimeConfig(**kw)
    if pkg == PORT:
        cfg.device = "cpu"
    return cfg


def _no_elastic_threads():
    names = {t.name for t in threading.enumerate()}
    return not names & {"windflow-elastic-controller",
                        "windflow-elastic-sampler"}


# ---------------------------------------------------------------------------
# key repartitioning properties
# ---------------------------------------------------------------------------

def _random_keys(rng, n):
    keys = [rng.randrange(1 << 31) for _ in range(n // 2)]
    keys += [f"user-{rng.randrange(10_000)}" for _ in range(n - len(keys))]
    return keys


def test_owner_deterministic_and_total():
    keys = _random_keys(random.Random(7), 200)
    for n in (1, 2, 3, 4, 7):
        owners = {pkg: {k: mod(pkg, "elastic").owner_of(k, n) for k in keys}
                  for pkg in PACKAGES}
        assert all(0 <= d < n for d in owners[PORT].values())
        assert owners[PORT] == owners[REF]


def test_owner_matches_emitter_routing():
    """Ownership equals where the port's KEYBY emitter routes: the
    record path (default_hash % n) and the int64 batch path
    (abs(key) % n)."""
    owner_of = mod(PORT, "elastic").owner_of
    default_hash = mod(PORT, "core.meta").default_hash
    rng = random.Random(3)
    for n in (2, 3, 5):
        for k in [rng.randrange(1 << 31) for _ in range(50)]:
            assert owner_of(k, n) == default_hash(k) % n == abs(k) % n
            assert owner_of(k, n) == mod(REF, "elastic").owner_of(k, n)
        for k in [f"k{rng.randrange(999)}" for _ in range(50)]:
            assert owner_of(k, n) == default_hash(k) % n


def test_partition_state_conserving():
    rng = random.Random(11)
    merged = {k: [k, rng.random()] for k in _random_keys(rng, 300)}
    for n_to in (4, 1, 5, 2):
        parts = mod(PORT, "elastic").partition_keyed_state(dict(merged),
                                                           n_to)
        assert parts == mod(REF, "elastic").partition_keyed_state(
            dict(merged), n_to)
        seen = {}
        for i, part in enumerate(parts):
            for k, v in part.items():
                assert k not in seen
                assert mod(PORT, "elastic").owner_of(k, n_to) == i
                seen[k] = v
        assert seen == merged


class _FakeLogic:
    def __init__(self, st):
        self._st = st

    def keyed_state_dict(self):
        return self._st


class _FakeNode:
    name = "op.0"

    def __init__(self, st):
        self.logic = _FakeLogic(st)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_merge_detects_duplicate_keys(pkg):
    el = mod(pkg, "elastic")
    merged, stateful = el.merge_keyed_states(
        [_FakeNode({1: "a"}), _FakeNode({2: "b"})])
    assert stateful and merged == {1: "a", 2: "b"}
    with pytest.raises(el.RescaleError, match="invariant"):
        el.merge_keyed_states([_FakeNode({1: "a"}), _FakeNode({1: "b"})])


def test_channel_depth_gauge():
    depths = {}
    for pkg in PACKAGES:
        ch = mod(pkg, "runtime.queues").Channel(capacity=8)
        pid = ch.register_producer()
        seen = [ch.depth]
        ch.put(pid, "x")
        ch.put(pid, "y")
        seen.append(ch.depth)
        ch.get()
        seen.append(ch.depth)
        depths[pkg] = seen
    assert depths[PORT] == depths[REF] == [0, 2, 1]


# ---------------------------------------------------------------------------
# the policy and the signals
# ---------------------------------------------------------------------------

def _decisions(pkg):
    el = mod(pkg, "elastic")
    ElasticSpec = mod(pkg, "core.basic").ElasticSpec
    spec = ElasticSpec(1, 8, target_util=0.75)
    cfg = el.ElasticityConfig()

    def rep(util, n=2, depth_frac=0.0, credit=0.0, skew=0.0, bott=0.0):
        return el.LoadReport("op", n, util, int(depth_frac * 100),
                             depth_frac, credit, 1000.0, 0.0, skew, bott)

    cases = [rep(0.75), rep(0.80), rep(1.5), rep(0.2, depth_frac=0.9),
             rep(0.2), rep(0.0, n=4), rep(0.2, credit=0.7),
             rep(0.3, bott=0.8), rep(1.2, skew=0.9), rep(0.5, n=3)]
    out = [el.decide(r, spec, cfg) for r in cases]
    out.append(el.decide(rep(4.0, n=8), ElasticSpec(1, 8), cfg))
    stepped = el.ElasticityConfig(max_step=1)
    out.append(el.decide(rep(3.0), spec, stepped))
    return out


def test_decide_hysteresis_band():
    got, want = _decisions(PORT), _decisions(REF)
    assert got == want
    assert got[0] is None and got[1] is None        # inside the band
    assert got[2][0] == 4                           # proportional
    assert got[3][0] >= 3                           # backlog
    assert got[4][0] == 1                           # scale down
    assert got[10] is None                          # never above max
    assert got[11][0] == 3                          # max_step


def test_signals_sample_replicas():
    """OperatorSignals over stand-in replicas: the same stats, depths
    and credit waits give the same LoadReports in both packages."""
    reports = {}
    for pkg in PACKAGES:
        stats_mod = mod(pkg, "monitoring.stats")
        signals = mod(pkg, "elastic.signals")
        queues = mod(pkg, "runtime.queues")

        class Node:
            def __init__(self):
                self.stats = stats_mod.StatsRecord()
                self.channel = queues.Channel(capacity=16)
                self.pid = self.channel.register_producer()

        class Graph:
            auditor = None
            diagnosis = None

        class Pipe:
            graph = Graph()

        class Handle:
            name = "pipe0/acc"
            pipe = Pipe()
            replicas = [Node(), Node()]

        sig = signals.OperatorSignals(Handle(), alpha=0.5)
        assert sig.sample(now=10.0) is None       # priming
        out = []
        for t, (n_in, svc_us, depth) in enumerate(
                [(100, 2000.0, 3), (400, 1500.0, 8), (50, 100.0, 0)]):
            for node in Handle.replicas:
                node.stats.inputs_received += n_in
                node.stats.service_time_us = svc_us
                node.stats.samples = 1
                for _ in range(depth):
                    node.channel.put(node.pid, "x")
            r = sig.sample(now=11.0 + t)
            out.append((r.replicas, round(r.util, 9), r.depth,
                        round(r.depth_frac, 9), r.credit_wait_frac,
                        round(r.rate, 9)))
        reports[pkg] = out
    assert reports[PORT] == reports[REF]
    assert reports[PORT][1][1] > reports[PORT][0][1]


# ---------------------------------------------------------------------------
# end-to-end rescale under load
# ---------------------------------------------------------------------------

def _paced_source(pkg, records, state, pace_every=64, pace_s=0.001):
    BasicRecord = mod(pkg, "core").BasicRecord

    def fn(shipper, ctx):
        i = state["i"]
        if i >= len(records):
            return False
        if pace_every and i % pace_every == 0:
            time.sleep(pace_s)
        k, v = records[i]
        shipper.push(BasicRecord(k, i, i, v))
        state["i"] = i + 1
        return True
    return fn


class _Collect:
    def __init__(self):
        self.lock = threading.Lock()
        self.items = []

    def __call__(self, r):
        if r is not None:
            with self.lock:
                self.items.append((r.key, r.value))

    def per_key(self):
        out = {}
        for k, v in self.items:
            out.setdefault(k, []).append(v)
        return out


def _fold(t, acc):
    acc.value += t.value


def _acc_graph(pkg, records, state, elastic, config=None, **src_kw):
    wf = _wf(pkg)
    got = _Collect()
    g = wf.PipeGraph("elastic", wf.Mode.DEFAULT,
                     config=config or _config(pkg))
    b = wf.AccumulatorBuilder(_fold).with_name("acc") \
        .with_initial_value(mod(pkg, "core").BasicRecord())
    if elastic:
        b = b.with_elasticity(1, 4)
    g.add_source(wf.SourceBuilder(
        _paced_source(pkg, records, state, **src_kw)).build()) \
        .add(b.build()).add_sink(wf.SinkBuilder(got).build())
    return g, got


def _wait_progress(state, upto, deadline_s=30.0):
    deadline = time.monotonic() + deadline_s
    while state["i"] < upto:
        assert time.monotonic() < deadline, "source made no progress"
        time.sleep(0.002)


def _scripted(pkg, records, steps):
    """The elastic accumulator graph rescaled to each of ``steps`` at
    equal fractions of the stream; returns the sink, the events and the
    stats report."""
    state = {"i": 0}
    g, got = _acc_graph(pkg, records, state, elastic=True)
    g.start()
    events = []
    for j, n_new in enumerate(steps):
        _wait_progress(state, (j + 1) * len(records) // (len(steps) + 1))
        events.append(g.rescale("acc", n_new, trigger="scripted step"))
    g.wait_end()
    return got, events, json.loads(g.stats.to_json())


def _event_rows(events):
    return [(e["operator"], e["old_parallelism"], e["new_parallelism"],
             e["trigger"]) for e in events]


@pytest.mark.parametrize("steps", [(4, 1), (3, 2)], ids=["1-4-1", "1-3-2"])
def test_scripted_rescale_conserves_and_matches_reference(steps):
    """The acceptance scenario through both packages: an elastic keyed
    accumulator rescaled mid-stream loses and duplicates nothing, its
    per-key output sequences equal the reference's (and a fixed run's),
    and the rescale events in the stats JSON are the reference's."""
    n = 6000
    records = [(i % 8, 1.0) for i in range(n)]
    fixed_state = {"i": 0}
    g_fixed, fixed = _acc_graph(REF, records, fixed_state, elastic=False)
    g_fixed.run()
    runs = {pkg: _scripted(pkg, records, steps) for pkg in PACKAGES}
    for pkg, (got, events, rep) in runs.items():
        assert len(got.items) == n, pkg
        assert got.per_key() == fixed.per_key(), pkg
        assert rep["Rescales"] == len(steps)
        assert all(e["at"] > 0 for e in rep["Rescale_events"])
        acc_op = next(o for o in rep["Operators"]
                      if o["Operator_name"] == "pipe0/acc")
        assert acc_op["Parallelism"] == steps[-1]
        assert len(acc_op["Replicas"]) == max(steps)   # history kept
    assert _event_rows(runs[PORT][2]["Rescale_events"]) \
        == _event_rows(runs[REF][2]["Rescale_events"])
    assert [(e.old_parallelism, e.new_parallelism) for e in runs[PORT][1]] \
        == [(1, steps[0]), (steps[0], steps[1])]
    assert _no_elastic_threads()


def test_rescale_updates_kept_replica_context():
    n = 6000
    records = [(i % 8, 1.0) for i in range(n)]
    seen = {}
    for pkg in PACKAGES:
        state = {"i": 0}
        g, got = _acc_graph(pkg, records, state, elastic=True)
        g.start()
        handle = g.elastic["pipe0/acc"]
        out = []
        for j, n_new in enumerate((3, 2)):
            _wait_progress(state, (j + 1) * n // 3)
            g.rescale("acc", n_new)
            out.append([r.logic.context.parallelism
                        for r in handle.replicas])
        g.wait_end()
        assert len(got.items) == n
        seen[pkg] = out
    assert seen[PORT] == seen[REF] == [[3, 3, 3], [2, 2]]


def test_scale_down_retires_replica_threads():
    n = 4000
    records = [(i % 5, 1.0) for i in range(n)]
    state = {"i": 0}
    g, got = _acc_graph(PORT, records, state, elastic=True)
    g.start()
    _wait_progress(state, n // 4)
    g.rescale("acc", 4)
    handle = g.elastic["pipe0/acc"]
    grown = list(handle.replicas)
    assert len(grown) == 4 and all(nd.is_alive() for nd in grown)
    _wait_progress(state, n // 2)
    g.rescale("acc", 2)
    assert len(handle.replicas) == 2
    retired = [nd for nd in grown if nd not in handle.replicas]
    assert len(retired) == 2
    for nd in retired:
        nd.join(timeout=10.0)
        assert not nd.is_alive() and nd.error is None
    assert all(nd not in handle.pipe.nodes for nd in retired)
    g.wait_end()
    assert sorted(got.items) == sorted(
        (k, float(c)) for k in range(5) for c in range(1, n // 5 + 1))


def _map_run(pkg, n):
    wf = _wf(pkg)
    state = {"i": 0}
    got = _Collect()
    g = wf.PipeGraph("elastic_map", wf.Mode.DEFAULT, config=_config(pkg))
    records = [(i % 7, float(i)) for i in range(n)]

    def double(t):
        t.value *= 2

    m = wf.MapBuilder(double).with_name("dbl").with_key_by() \
        .with_elasticity(1, 3).build()
    g.add_source(wf.SourceBuilder(
        _paced_source(pkg, records, state)).build()) \
        .add(m).add_sink(wf.SinkBuilder(got).build())
    g.start()
    _wait_progress(state, n // 3)
    g.rescale("dbl", 3)
    _wait_progress(state, 2 * n // 3)
    g.rescale("dbl", 1)
    g.wait_end()
    return sorted(got.items), records


def test_stateless_keyed_map_rescale():
    n = 5000
    got, records = _map_run(PORT, n)
    want, _ = _map_run(REF, n)
    assert len(got) == n
    assert got == want == sorted((k, 2.0 * v) for k, v in records)


def _credited_run(pkg, n):
    wf = _wf(pkg)
    TupleBatch = mod(pkg, "core.tuples").TupleBatch
    CreditedChannel = mod(pkg, "ingest.credits").CreditedChannel
    trace = {"key": (np.arange(n) % 16).astype(np.int64),
             "id": np.arange(n, dtype=np.int64),
             "ts": np.arange(n, dtype=np.int64) * 40,
             "value": np.ones(n)}
    got = Counter()
    lock = threading.Lock()

    def sink(r):
        if r is None:
            return
        with lock:
            if isinstance(r, TupleBatch):
                got.update(int(k) for k in r.key)
            else:
                got[r.key] += 1

    def work(t):
        time.sleep(0.0002)
        return t

    g = wf.PipeGraph("elastic_ingest", wf.Mode.DEFAULT, config=_config(pkg))
    m = wf.MapBuilder(work).with_name("work").with_key_by() \
        .with_elasticity(1, 4).build()
    src = wf.SourceBuilder.from_replay(trace, speedup=1.0, chunk=256) \
        .with_credits(4096).build()
    g.add_source(src).add(m).add_sink(wf.SinkBuilder(sink).build())
    g.start()
    time.sleep(0.3)
    g.rescale("work", 3)
    handle = g.elastic["pipe0/work"]
    proxies = [(isinstance(nd.channel, CreditedChannel),
                bool(nd.channel.gates)) for nd in handle.replicas]
    time.sleep(0.3)
    g.rescale("work", 1)
    g.wait_end()
    return got, proxies


def test_rescale_rewires_credit_proxies():
    """A credited ingest source feeds the elastic map: the new replica
    channels are CreditedChannel proxies bound to the source's gate, and
    every tuple reaches the sink once, per key as in the reference."""
    n = 30000
    got, proxies = _credited_run(PORT, n)
    want, ref_proxies = _credited_run(REF, n)
    assert proxies == ref_proxies == [(True, True)] * 3
    assert sum(got.values()) == n
    assert got == want


def _controller_run(pkg, n, n_keys):
    wf = _wf(pkg)
    el = mod(pkg, "elastic")
    records = [(i % n_keys, 1.0) for i in range(n)]
    state = {"i": 0}

    def slow_fold(t, acc):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 0.001:
            pass
        acc.value += t.value

    got = _Collect()
    cfg = _config(pkg, elasticity=el.ElasticityConfig(
        sample_period_s=0.1, cooldown_s=0.4, ewma_alpha=0.6))
    g = wf.PipeGraph("elastic_auto", wf.Mode.DEFAULT, config=cfg)
    acc = wf.AccumulatorBuilder(slow_fold).with_name("acc") \
        .with_initial_value(mod(pkg, "core").BasicRecord()) \
        .with_elasticity(1, 4, target_util=0.7).build()
    g.add_source(wf.SourceBuilder(
        _paced_source(pkg, records, state, pace_every=0)).build()) \
        .add(acc).add_sink(wf.SinkBuilder(got).build())
    g.run()
    return g, got, records


def test_controller_scales_up_under_load():
    """A deliberately slow keyed fold fed unpaced: the port's controller
    adds replicas on its own (a utilization or backlog trigger), within
    the declared interval, and the per-key results are the reference's
    fixed-parallelism ones.  No wall-clock bound: the scale-up is the
    assertion, and the graph's controller and sampler threads are gone
    after ``run()``."""
    n, n_keys = 3000, 16
    g, got, records = _controller_run(PORT, n, n_keys)
    rep = json.loads(g.stats.to_json())
    evs = rep["Rescale_events"]
    assert any(e["new_parallelism"] > e["old_parallelism"] for e in evs), \
        f"controller never scaled up: {evs}"
    assert all(1 <= e["new_parallelism"] <= 4 for e in evs)
    assert all(e["trigger"].startswith("util=") for e in evs)
    assert not g._controller.is_alive()
    assert not g._controller.sampler.is_alive()
    assert _no_elastic_threads()
    assert len(got.items) == n
    fixed_state = {"i": 0}
    g_ref, ref = _acc_graph(REF, records, fixed_state, elastic=False,
                            pace_every=0)
    g_ref.run()
    assert {k: sorted(v) for k, v in got.per_key().items()} \
        == {k: sorted(v) for k, v in ref.per_key().items()}
    counts = Counter(k for k, _ in records)
    assert {k: max(vs) for k, vs in got.per_key().items()} \
        == {k: float(c) for k, c in counts.items()}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_faultplan_crash_in_rescaled_replica(pkg):
    """A FaultPlan crash aimed at acc.2, a replica that exists only
    after the rescale: both packages contain the failure and surface it
    from wait_end, and refuse a later rescale."""
    wf = _wf(pkg)
    InjectedFailure = mod(pkg, "resilience").InjectedFailure
    n = 6000
    records = [(i % 8, 1.0) for i in range(n)]
    state = {"i": 0}
    plan = wf.FaultPlan(seed=3).crash_replica("acc.2", at_tuple=40)
    g, _got = _acc_graph(pkg, records, state, elastic=True,
                         config=_config(pkg, fault_plan=plan))
    g.start()
    _wait_progress(state, n // 4)
    g.rescale("acc", 4)
    with pytest.raises(wf.NodeFailureError) as ei:
        g.wait_end()
    assert any(isinstance(err, InjectedFailure)
               for _, err in ei.value.errors)
    with pytest.raises((RuntimeError, KeyError)):
        g.rescale("acc", 2)


# ---------------------------------------------------------------------------
# validation + API errors
# ---------------------------------------------------------------------------

def _validation_errors(pkg):
    wf = _wf(pkg)
    out = []
    for build in (lambda: wf.MapBuilder(lambda t: t).with_elasticity(0, 4),
                  lambda: wf.MapBuilder(lambda t: t).with_elasticity(4, 2),
                  lambda: wf.MapBuilder(lambda t: t).with_elasticity(
                      1, 4, target_util=1.5),
                  lambda: wf.SourceBuilder(lambda s: False)
                  .with_elasticity(1, 4),
                  lambda: wf.MapBuilder(lambda t: t).with_key_by()
                  .with_parallelism(8).with_elasticity(1, 4).build()):
        with pytest.raises(ValueError) as ei:
            build()
        out.append(str(ei.value))
    op = wf.MapBuilder(lambda t: t).with_key_by().with_elasticity(2, 4) \
        .build()
    out.append(op.parallelism)
    return out


def test_with_elasticity_validation():
    got = _validation_errors(PORT)
    assert got == _validation_errors(REF)
    assert "not elastically scalable" in got[3]
    assert "exceeds" in got[4]
    assert got[5] == 2


@pytest.mark.parametrize("pkg", PACKAGES)
def test_elastic_rejects_unsupported_shapes(pkg):
    wf = _wf(pkg)

    def src(shipper, ctx):
        return False

    g = wf.PipeGraph("bad1", wf.Mode.DEFAULT, config=_config(pkg))
    mp = g.add_source(wf.SourceBuilder(src).build())
    win = wf.KeyFarmBuilder(lambda g_, it, r: None) \
        .with_cb_windows(4, 2).with_elasticity(1, 4).build()
    with pytest.raises(ValueError, match="cannot be elastic"):
        mp.add(win)
    g2 = wf.PipeGraph("bad2", wf.Mode.DETERMINISTIC, config=_config(pkg))
    mp2 = g2.add_source(wf.SourceBuilder(src).build())
    m = wf.MapBuilder(lambda t: t).with_key_by().with_elasticity(1, 4) \
        .build()
    with pytest.raises(ValueError, match="Mode.DEFAULT"):
        mp2.add(m)


def test_rescale_api_errors():
    n = 2000
    records = [(i % 4, 1.0) for i in range(n)]
    state = {"i": 0}
    g, got = _acc_graph(PORT, records, state, elastic=True)
    with pytest.raises(RuntimeError, match="started"):
        g.rescale("acc", 2)
    g.start()
    with pytest.raises(KeyError):
        g.rescale("nope", 2)
    with pytest.raises(ValueError, match="elastic interval"):
        g.rescale("acc", 9)
    assert g.rescale("acc", 1) is None
    g.wait_end()
    with pytest.raises(RuntimeError):
        g.rescale("acc", 2)
    assert len(got.items) == n


def test_chain_falls_back_to_add_for_elastic():
    """chain() does not thread-fuse an elastic operator away, in either
    package, and both sinks see the same records."""
    n = 1000
    records = [(i % 4, float(i)) for i in range(n)]
    seen = {}
    for pkg in PACKAGES:
        wf = _wf(pkg)
        state = {"i": 0}
        got = _Collect()
        g = wf.PipeGraph("elastic_chain", wf.Mode.DEFAULT,
                         config=_config(pkg))
        m = wf.MapBuilder(lambda t: t).with_name("em") \
            .with_elasticity(1, 2).build()
        g.add_source(wf.SourceBuilder(_paced_source(
            pkg, records, state, pace_every=0)).build()) \
            .chain(m).chain_sink(wf.SinkBuilder(got).build())
        assert "pipe0/em" in g.elastic
        g.run()
        seen[pkg] = sorted(got.items)
    assert seen[PORT] == seen[REF] and len(seen[PORT]) == n


def test_fusion_pass_skips_elastic_nodes():
    n = 2000
    records = [(i % 4, 1.0) for i in range(n)]
    state = {"i": 0}
    g, got = _acc_graph(PORT, records, state, elastic=True)
    assert g.config.opt_level == _wf(PORT).OptLevel.LEVEL2
    g.start()
    handle = g.elastic["pipe0/acc"]
    FusedLogic = mod(PORT, "runtime.node").FusedLogic
    assert all(not isinstance(nd.logic, FusedLogic)
               for nd in handle.replicas)
    assert all(nd.is_alive() for nd in handle.replicas)
    g.rescale("acc", 2)
    g.wait_end()
    assert len(got.items) == n


def _gauge_run(pkg, n):
    records = [(i % 4, 1.0) for i in range(n)]
    state = {"i": 0}
    g, got = _acc_graph(pkg, records, state, elastic=True)
    g.start()
    _wait_progress(state, n // 3)
    g.rescale("acc", 2, trigger="gauge test")
    g.refresh_gauges()
    g.wait_end()
    g.refresh_gauges()
    return json.loads(g.stats.to_json()), got


def test_gauges_and_events_in_stats_json():
    n = 1500
    rep, got = _gauge_run(PORT, n)
    ref, _ = _gauge_run(REF, n)
    acc_op = next(o for o in rep["Operators"]
                  if o["Operator_name"] == "pipe0/acc")
    for r in acc_op["Replicas"]:
        assert "Queue_depth" in r and "Credit_wait_s" in r
    assert rep["Rescales"] == ref["Rescales"] == 1
    e = rep["Rescale_events"][0]
    assert set(e) == set(ref["Rescale_events"][0])
    assert set(e) >= {"at", "operator", "old_parallelism",
                      "new_parallelism", "trigger", "duration_s"}
    assert _event_rows(rep["Rescale_events"]) \
        == _event_rows(ref["Rescale_events"])
    assert len(got.items) == n
