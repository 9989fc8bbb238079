"""Shared harness of the port's graph tests: one graph, built by a
function of the package, runs through the reference (``windflow_tpu``)
and the port (``windflow_tpu_torch``, on the CPU) on the same record
stream, and the two sinks are compared.

The stream is the reference tests' ordered source: key = i % n_keys,
id = ts = i // n_keys, value = float(id).  What must match: the set of
keys, and for every key the window ids in the order the sink received
them.  Values are compared as the reference test of the same graph
compares them with its oracle (exact, or a stated relative tolerance).
The interleaving of keys at the sink depends on thread timing in both
packages, so it is not compared.
"""
import importlib
import threading
import time
import warnings

import numpy as np

PACKAGES = ("windflow_tpu", "windflow_tpu_torch")
PORT = "windflow_tpu_torch"


def mod(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


def ordered_source(pkg, n_keys, per_key):
    BasicRecord = mod(pkg, "core").BasicRecord
    state = {}

    def fn(shipper, ctx):
        i = state.setdefault("i", 0)
        if i >= n_keys * per_key:
            return False
        key = i % n_keys
        tid = i // n_keys
        shipper.push(BasicRecord(key, tid, tid, float(tid)))
        state["i"] = i + 1
        return True

    return fn


class Collector:
    def __init__(self):
        self.lock = threading.Lock()
        self.results = []

    def __call__(self, rec):
        if rec is not None:
            with self.lock:
                self.results.append((rec.key, rec.id, rec.value))


def cpu_config(pkg, **kw):
    """``RuntimeConfig(**kw)`` of package ``pkg``; the port's on the
    CPU."""
    cfg = importlib.import_module(pkg).RuntimeConfig(**kw)
    if pkg == PORT:
        cfg.device = "cpu"
    return cfg


def record_source(pkg, n, pace_s=0.0, endless=False):
    """The diagnosis, SLO, serving and scheduler tests' record source:
    key = i % 4, id = i // 4, ts = i, value = float(i); one record every
    ``pace_s`` when given, without end when ``endless``."""
    BasicRecord = mod(pkg, "core").BasicRecord
    state = {}

    def fn(shipper, ctx):
        i = state.setdefault("i", 0)
        if not endless and i >= n:
            return False
        if pace_s:
            time.sleep(pace_s)
        shipper.push(BasicRecord(i % 4, i // 4, i, float(i)))
        state["i"] = i + 1
        return True

    return fn


def doctor(pkg, argv):
    """``doctor.main(argv)`` of package ``pkg``: (exit code, stdout,
    stderr)."""
    import contextlib
    import io
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod(pkg, "doctor").main(argv)
    return rc, out.getvalue(), err.getvalue()


def run_graph(pkg, make_op, n_keys=3, per_key=48, mode="DEFAULT",
              config_kw=None):
    """Run source -> ``make_op(wf)`` -> sink in package ``pkg``; the
    port on the CPU.  Returns the sink's (key, id, value) rows in
    arrival order and the graph."""
    wf = importlib.import_module(pkg)
    cfg = wf.RuntimeConfig(**(config_kw or {}))
    if pkg == PORT:
        cfg.device = "cpu"
    coll = Collector()
    g = wf.PipeGraph("t", getattr(wf.Mode, mode), config=cfg)
    g.add_source(wf.SourceBuilder(ordered_source(pkg, n_keys, per_key))
                 .build()).add(make_op(wf)).add_sink(
        wf.SinkBuilder(coll).build())
    g.run()
    return coll.results, g


def per_key(rows):
    """key -> ([ids in arrival order], [values])."""
    out = {}
    for k, i, v in rows:
        ids, vals = out.setdefault(k, ([], []))
        ids.append(i)
        vals.append(v)
    return out


def assert_same(got, want, rtol=0.0):
    """Equal keys and per-key id order exactly; values equal (rtol 0)
    or within ``rtol``."""
    g, w = per_key(got), per_key(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k][0] == w[k][0], (k, g[k][0], w[k][0])
        if rtol:
            np.testing.assert_allclose(g[k][1], w[k][1], rtol=rtol)
        else:
            assert g[k][1] == w[k][1], (k, g[k][1], w[k][1])


def by_key(rows):
    out = {}
    for k, i, v in rows:
        out.setdefault(k, {})[i] = v
    return out


def oracle(per_key_n, win, slide, agg=sum):
    """gwid -> agg over ids [g*slide, g*slide + win), every window whose
    start was reached (partial tail windows flush at EOS)."""
    out = {}
    g = 0
    while g * slide < per_key_n:
        vals = [float(v) for v in range(per_key_n)
                if g * slide <= v < g * slide + win]
        out[g] = float(agg(vals)) if vals else 0.0
        g += 1
    return out


def both(make_op, n_keys=3, per_key=48, mode="DEFAULT", rtol=0.0,
         config_kw=None):
    """The graph through both packages, held equal; returns the port's
    rows and graph."""
    want, _ = run_graph(PACKAGES[0], make_op, n_keys, per_key, mode,
                        config_kw)
    got, g = run_graph(PORT, make_op, n_keys, per_key, mode, config_kw)
    assert_same(got, want, rtol)
    return got, g


# ---------------------------------------------------------------------------
# user FFAT combines: compiled by no kernel, lowered into each one
# ---------------------------------------------------------------------------

def left_weighted(a, b):
    """The reference tests' non-commutative combine (0.5 a is exact, so
    every side rounds it alike): it shows that a fold keeps oldest ->
    newest order.  The same function serves jnp and torch arrays."""
    return a * 0.5 + b


def user_combines(pkg):
    """name -> (combine, neutral) of the user FFAT combines in package
    ``pkg``'s array library (jnp for the reference, torch for the port):
    ``left_weighted``, a product, ``logaddexp`` and a NaN-skipping max
    written with ``where``."""
    if pkg == PORT:
        import torch as xp
        mul = xp.mul
    else:
        import jax.numpy as xp
        mul = xp.multiply

    def where_max(a, b):
        return xp.where(xp.isnan(a) | (b > a), b, a)

    return {"left_weighted": (left_weighted, 0.0), "mul": (mul, 1.0),
            "logaddexp": (xp.logaddexp, -np.inf),
            "where_max": (where_max, -np.inf)}


# the arithmetic ones are exact (both sides round every op alike in the
# same order); logaddexp is held within rtol 1e-5: jnp.logaddexp and
# torch.logaddexp take other exp/log1p forms and may part by an ulp a
# combine, over a fold of up to ~2 log2(n) + 1 combines
USER_EXACT = {"left_weighted": True, "mul": True, "logaddexp": False,
              "where_max": True}
USER_RTOL = 1e-5


def user_values(name, rng, shape):
    """f32 leaves for a user combine: near 1 for the product (no
    overflow over a whole tree), with a few NaNs for the NaN-skipping
    max, normal otherwise."""
    if name == "mul":
        return rng.uniform(0.9, 1.1, shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    if name == "where_max" and v.size:
        flat = v.reshape(-1)
        flat[rng.integers(0, flat.size, max(1, flat.size // 16))] = np.nan
    return v


# ---------------------------------------------------------------------------
# numpy oracles of the application models (models/yahoo.py, nexmark.py)
# ---------------------------------------------------------------------------

def tb_counts(keys, ts, win, slide):
    """{(key, w): count}: window w of a key covers ts [w*slide,
    w*slide + win), for every w up to the key's last timestamp."""
    out = {}
    for k in np.unique(keys):
        kts = ts[keys == k]
        w = np.arange(int(kts.max()) // slide + 1)
        lo = np.searchsorted(np.sort(kts), w * slide)
        hi = np.searchsorted(np.sort(kts), w * slide + win)
        out.update({(int(k), int(i)): float(n) for i, n in zip(w, hi - lo)})
    return out


def pool_concat(col, pool_n, n):
    """A column of the models' re-timestamped pool: the first
    min(pool_n, n - i) entries for every batch start i."""
    return np.concatenate([col[:min(pool_n, n - i)]
                           for i in range(0, n, pool_n)])


def yahoo_oracle(pkg, n, n_ads, n_campaigns, win, batch):
    """{(campaign, w): view count} of the Yahoo pipeline's tumbling
    windows, the stream made by package ``pkg``'s generators."""
    yahoo = mod(pkg, "models.yahoo")
    pool = yahoo.synth_events(batch, n_ads, seed=0)
    camp = yahoo.make_campaign_map(n_ads, n_campaigns)
    ad = pool_concat(pool["ad_id"], batch, n)
    view = pool_concat(pool["event_type"], batch, n) == yahoo.VIEW
    return tb_counts(camp[ad][view], np.arange(n)[view], win, win)


def q5_oracle(pkg, n, n_auctions, win, slide, batch):
    """{(auction, w): bid count} of NEXMark Q5's sliding windows."""
    pool = mod(pkg, "models.nexmark").synth_bids(batch, n_auctions)
    return tb_counts(pool_concat(pool["auction"], batch, n),
                     np.arange(n), win, slide)


def q7_oracle(pkg, n, win, batch):
    """{w: float32 of the float64 max} of NEXMark Q7's tumbling windows,
    every window up to the last timestamp (the last one partial):
    rounding to f32 is monotone, so the max of the rounded prices is the
    rounding of the max."""
    nx = mod(pkg, "models.nexmark")
    prices = pool_concat(nx.synth_bids(batch, 1000)["price"], batch, n) \
        * nx.DOL_TO_EUR
    return {w: float(np.float32(prices[w * win:(w + 1) * win].max()))
            for w in range((n - 1) // win + 1)}


# ---------------------------------------------------------------------------
# durable graphs (durability/): a source that drives its own epochs
# ---------------------------------------------------------------------------

# epochs a durable graph commits only where its source asks (the
# coordinator's own cadence is pushed out of reach): a run's epochs,
# and so where a fault lands, depend on the stream, not on the clock
NO_CADENCE_S = 3600.0
# bound on a source's wait for a commit; a run that reaches it goes on
# and its test fails on the restored epoch, never hangs
COMMIT_WAIT_S = 60.0


def dur_val(i):
    return float(i % 7)


def _resolved(coord, epoch):
    """True once ``epoch`` committed, or left the coordinator's pending
    set without committing (a failed manifest write, an abort)."""
    with coord._cond:
        return coord.committed >= epoch or (
            epoch not in coord._pending and coord._committing != epoch)


def gated_source(pkg, n, n_keys=4, epochs_at=(), name="ckpt_source",
                 hooks=None):
    """An offset-checkpointable source of package ``pkg`` (the reference
    suites' ``CkptSource`` contract: ``state_dict``/``load_state``/
    ``progress_frontier``) emitting record i = (key i % n_keys, id
    i // n_keys, ts i, value i % 7).  At every index in ``epochs_at``
    it begins an epoch itself and emits nothing more until the
    coordinator has committed that epoch (or given it up), so an
    epoch's cut always
    precedes the tuples after its index, and a fault placed past an
    index lands after that epoch's commit.  Without the durability
    plane the indices are ignored.  ``hooks`` maps an index to a
    function called there once, which returns a ``threading.Event``:
    the source emits nothing more until it is set (a lane flip run on
    another thread, say)."""
    core = mod(pkg, "core")
    basic = mod(pkg, "core.basic")
    base = mod(pkg, "operators.base")
    emitters = mod(pkg, "runtime.emitters")
    node = mod(pkg, "runtime.node")
    marks = frozenset(epochs_at)
    hooks = dict(hooks or {})

    class Logic(node.SourceLoopLogic):
        def __init__(self):
            self.i = 0
            self._began = -1          # index whose epoch was begun
            self._wait = None         # (epoch, deadline)
            self._hook = None         # (event, deadline)
            super().__init__(self._step)

        def _step(self, emit):
            import time
            i = self.i
            if i >= n:
                return False
            inj = self.epoch_injector
            if self._wait is not None:
                epoch, deadline = self._wait
                if not _resolved(inj.coord, epoch) \
                        and time.monotonic() < deadline:
                    time.sleep(0.0005)
                    return True   # the loop head injects and polls
                self._wait = None
            elif inj is not None and i in marks and self._began != i:
                self._began = i
                self._wait = (inj.coord.begin_epoch(),
                              time.monotonic() + COMMIT_WAIT_S)
                return True
            if i in hooks:
                done = hooks.pop(i)()
                deadline = time.monotonic() + COMMIT_WAIT_S
                self._hook = (done, deadline)
            if self._hook is not None:
                done, deadline = self._hook
                if not done.is_set() and time.monotonic() < deadline:
                    time.sleep(0.0005)
                    return True
                self._hook = None
            emit(core.BasicRecord(i % n_keys, i // n_keys, i, dur_val(i)))
            self.i = i + 1
            return True

        def state_dict(self):
            return {"i": self.i}

        def load_state(self, st):
            self.i = st["i"]

        def progress_frontier(self):
            return self.i

    class Source(base.Operator):
        def __init__(self):
            super().__init__(name, 1, basic.RoutingMode.NONE,
                             basic.Pattern.SOURCE)

        def stages(self):
            return [base.StageSpec(self.name, [Logic()],
                                   emitters.StandardEmitter(),
                                   self.routing)]

    return Source()


def durable_config(pkg, path, plan=None, durable=True, interval=None,
                   **dur_kw):
    """RuntimeConfig of a durable test graph (the port on the CPU);
    ``durable=False`` gives the same graph without epochs or faults."""
    wf = importlib.import_module(pkg)
    cfg = wf.RuntimeConfig()
    if durable:
        cfg.durability = mod(pkg, "core").DurabilityConfig(
            epoch_interval_s=interval or NO_CADENCE_S, path=path, **dur_kw)
        cfg.fault_plan = plan
    if pkg == PORT:
        cfg.device = "cpu"
    return cfg


def acc_graph(pkg, n, path, sink, plan=None, durable=True, epochs_at=(),
              sink_mode="transactional", n_keys=4, interval=None,
              acc_fn=None, restartable=False, cfg_kw=None, acc_par=2,
              hooks=None, **dur_kw):
    """source -> keyed map (2 replicas: two producers to align) ->
    keyed accumulator (2 replicas) -> exactly-once sink: the reference
    suites' ``_acc_graph`` (and, with ``cfg_kw`` such as
    ``state_budget_bytes`` or ``supervision``, their ``_tiered_graph``
    and ``_sup_graph``).  ``sink`` is the sink's function; ``hooks`` go
    to the source (``gated_source``)."""
    wf = importlib.import_module(pkg)
    BasicRecord = mod(pkg, "core").BasicRecord

    def add(t, a):
        a.value += t.value

    cfg = durable_config(pkg, path, plan, durable, interval, **dur_kw)
    for k, v in (cfg_kw or {}).items():
        setattr(cfg, k, v)
    g = wf.PipeGraph("dur_acc", wf.Mode.DEFAULT, config=cfg)
    sb = wf.SinkBuilder(sink)
    if durable:
        sb = sb.with_exactly_once(sink_mode)
    accb = wf.AccumulatorBuilder(acc_fn or add) \
        .with_initial_value(BasicRecord(value=0.0)) \
        .with_parallelism(acc_par)
    if restartable:
        accb = accb.with_restartable()
    g.add_source(gated_source(pkg, n, n_keys, epochs_at, hooks=hooks)) \
        .add(wf.MapBuilder(lambda t: None).with_key_by()
             .with_parallelism(2).build()) \
        .add(accb.build()) \
        .add_sink(sb.build())
    return g


def acc_oracle(n, n_keys=4):
    """key -> [(id, running sum)] of ``acc_graph``'s stream."""
    out, sums = {}, {}
    for i in range(n):
        k = i % n_keys
        sums[k] = sums.get(k, 0.0) + dur_val(i)
        out.setdefault(k, []).append((i // n_keys, sums[k]))
    return out


class Effects:
    """A durable sink's function: (key, id, value) of every result, in
    arrival order, from any sink thread."""

    def __init__(self):
        self.lock = threading.Lock()
        self.rows = []

    def __call__(self, r):
        if r is not None:
            with self.lock:
                self.rows.append((r.key, r.id, r.value))


def reference_clean(path, n, n_keys=4):
    """The reference's sink output of ``acc_graph`` without epochs or
    faults, per key: the output every durable run must equal."""
    eff = Effects()
    acc_graph(PACKAGES[0], n, path, eff, durable=False, n_keys=n_keys).run()
    return effects_per_key(eff.rows)


def effects_per_key(effects):
    out = {}
    for k, tid, v in effects:
        out.setdefault(k, []).append((tid, v))
    return out


def assert_ledger_exact(graph, healed=False):
    """The conservation ledger of a (final) run: no violation, every
    edge balanced, and the graph-wide identity in stream tuples exact
    (barriers counted once on each end).  After an in-place heal the
    rewound source re-emits a replay window the sink discards, so the
    identity is ``>=`` there."""
    import json
    cons = json.loads(graph.stats.to_json())["Conservation"]
    assert cons["Violations_total"] == 0, cons["Violations"]
    assert cons["Edges_balanced"], cons
    rhs = cons["Sinks_consumed"] + cons["Dead_letters"] \
        + cons["Shed_tuples"]
    if healed:
        assert cons["Sources_emitted"] >= rhs, cons
    else:
        assert cons["Sources_emitted"] == rhs, cons


# ---------------------------------------------------------------------------
# the serving plane and the global scheduler (test_torch_serving.py,
# test_torch_scheduler.py)
# ---------------------------------------------------------------------------

SERVE_WAIT_S = 120


def quiet_cfg(pkg, tmp_path, **kw):
    """The reference serving tests' tenant config: logs under the test's
    directory, the elastic controller off; the port's on the CPU."""
    kw.setdefault("log_dir", str(tmp_path / pkg))
    kw.setdefault("elasticity", mod(pkg, "elastic").ElasticityConfig(
        enabled=False))
    return cpu_config(pkg, **kw)


def open_server(pkg, **kw):
    """``Server(**kw)`` of package ``pkg`` (capacity 2^16 and no arbiter
    unless given)."""
    kw.setdefault("capacity", 1 << 16)
    kw.setdefault("arbiter", False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return mod(pkg, "serving").Server(**kw)


def close_server(srv):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        srv.close()


def burner_source(pkg, stop_evt):
    """The noisy neighbour's record source: as fast as it can, until
    ``stop_evt``."""
    BasicRecord = mod(pkg, "core").BasicRecord
    state = {}

    def fn(shipper, ctx):
        if stop_evt.is_set():
            return False
        i = state.setdefault("i", 0)
        shipper.push(BasicRecord(i % 64, i, i, 1.0))
        state["i"] = i + 1
        return True

    return fn


def burn_10ms(t):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.01:
        pass
    return None


def wait_for(pred, what, timeout=SERVE_WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.2)
    raise AssertionError(f"{what} within {timeout} s")


def recovered_after_a_decision(srv, victim):
    """True once the arbiter has decided and the victim's SLO recovered
    after its first ``arbitration`` event: an episode that closes
    before the arbiter's ``breach_ticks`` elapse is not the one under
    test, and the starved victim breaches again."""
    if not srv.arbiter.decisions:
        return False
    evs = victim.graph.flight.snapshot()
    first = next((e["seq"] for e in evs if e["kind"] == "arbitration"),
                 None)
    return first is not None and any(
        e["kind"] == "slo_recovered" and e["seq"] > first for e in evs)
