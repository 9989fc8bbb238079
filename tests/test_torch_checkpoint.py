"""The port's checkpoint utilities (windflow_tpu_torch/utils/checkpoint.py)
held against the reference's (tests/test_checkpoint.py): mid-stream
snapshots of the window engines restored into fresh logics, graph
save/restore, the structure-mismatch refusal, ``run_with_recovery``,
the ``ChainedLogic`` halves, ``live_checkpoint`` mid-stream and after
the sources finished, and a reference checkpoint carried into the port
through ``convert.from_reference_state``.

The same inputs go through both packages; values are integer-valued,
so f32 sums are exact and every window must match exactly.  The live
checkpoints are taken at a fixed stream index: the source stops there
and waits for the test, so the stream position a snapshot holds never
depends on thread timing.
"""
import importlib
import pickle
import threading
import time

import numpy as np
import pytest

from torch_graphs import PACKAGES, PORT, mod

REF = PACKAGES[0]


def _wf(pkg):
    return importlib.import_module(pkg)


def _cfg(pkg, **kw):
    cfg = _wf(pkg).RuntimeConfig(**kw)
    if pkg == PORT:
        cfg.device = "cpu"
    return cfg


def _dev(pkg):
    return {"device": "cpu"} if pkg == PORT else {}


# ---------------------------------------------------------------------------
# logics: snapshot half way, restore into a fresh logic
# ---------------------------------------------------------------------------

def _midstream(pkg, make, feed, flush, split):
    """Uninterrupted and interrupted (snapshot at ``split``, pickled,
    restored into a fresh logic) outputs of one logic."""
    ref_out, whole = [], make()
    feed(whole, 0, None, ref_out)
    flush(whole, ref_out)
    out, a = [], make()
    feed(a, 0, split, out)
    drain = getattr(a, "_drain_all", None)
    if drain is not None:
        drain(out.append)       # the quiescent contract
    b = make()
    b.load_state(pickle.loads(pickle.dumps(a.state_dict())))
    feed(b, split, None, out)
    flush(b, out)
    return ref_out, out, b


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_win_seq_tpu_checkpoint_midstream(native, monkeypatch):
    n, n_keys = 40_000, 4
    keys = np.arange(n, dtype=np.int64) % n_keys
    ids = np.arange(n, dtype=np.int64) // n_keys
    vals = np.arange(n, dtype=np.float64) % 97
    got = {}
    for pkg in PACKAGES:
        if not native:
            monkeypatch.setattr(mod(pkg, "runtime.native"), "_lib", None)
        WinSeqTPULogic = mod(pkg, "operators.tpu.win_seq_tpu") \
            .WinSeqTPULogic
        WinType = mod(pkg, "core").WinType
        TupleBatch = mod(pkg, "core.tuples").TupleBatch

        def make():
            lg = WinSeqTPULogic("sum", 32, 16, WinType.TB, batch_len=64,
                                emit_batches=True, **_dev(pkg))
            if not native:
                lg._native = None
            return lg

        def feed(logic, lo, hi, out):
            hi = n if hi is None else hi
            for i in range(lo, hi, 4096):
                j = min(i + 4096, hi)
                logic.svc(TupleBatch({"key": keys[i:j], "id": ids[i:j],
                                      "ts": ids[i:j], "value": vals[i:j]}),
                          0, out.append)

        def flush(logic, out):
            logic.eos_flush(out.append)

        whole, split, b = _midstream(pkg, make, feed, flush, n // 2)
        assert (b._native is not None) == native
        rows = {}
        for out in (whole, split):
            rows_one = {}
            for bt in out:
                for i in range(len(bt)):
                    rows_one[(int(bt.key[i]), int(bt.id[i]))] = \
                        float(bt["value"][i])
            rows[len(rows)] = rows_one
        assert rows[0] == rows[1] and len(rows[0]) > 100
        got[pkg] = rows[0]
    assert got[PORT] == got[REF]


def _records(pkg, n_keys, per_key):
    BasicRecord = mod(pkg, "core").BasicRecord
    return [BasicRecord(i % n_keys, i // n_keys, i // n_keys,
                        float(i // n_keys)) for i in range(n_keys * per_key)]


def _host_midstream(pkg, make, n_keys, per_key):
    recs = _records(pkg, n_keys, per_key)

    def feed(logic, lo, hi, out):
        for r in recs[lo:hi]:
            logic.svc(r, 0, out.append)

    def flush(logic, out):
        logic.eos_flush(out.append)

    whole, split, _b = _midstream(pkg, make, feed, flush, len(recs) // 2)
    rows = [[(r.key, r.id, r.value) for r in out] for out in (whole, split)]
    assert rows[0] == rows[1] and rows[0]
    return rows[0]


def test_win_seq_checkpoint_midstream():
    def make_for(pkg):
        WinSeqLogic = mod(pkg, "operators.win_seq").WinSeqLogic
        WinType = mod(pkg, "core").WinType

        def fsum(gwid, it, result):
            result.value = sum(t.value for t in it)
        return lambda: WinSeqLogic(fsum, 10, 5, WinType.TB)

    got = {pkg: _host_midstream(pkg, make_for(pkg), 3, 40)
           for pkg in PACKAGES}
    assert got[PORT] == got[REF]


def test_ffat_checkpoint_midstream():
    def make_for(pkg):
        WinSeqFFATLogic = mod(pkg, "operators.win_seqffat").WinSeqFFATLogic
        WinType = mod(pkg, "core").WinType

        def lift(t, r):
            r.value = t.value

        def comb(x, y, o):
            o.value = x.value + y.value
        return lambda: WinSeqFFATLogic(lift, comb, 12, 4, WinType.CB)

    got = {pkg: _host_midstream(pkg, make_for(pkg), 2, 40)
           for pkg in PACKAGES}
    assert got[PORT] == got[REF]


def test_resident_ffat_checkpoint_midstream():
    """The resident forest's snapshot (the tree copied off the device)
    restores into a fresh logic, which goes on as the uninterrupted
    one, in both packages alike."""
    import jax.numpy as jnp
    import torch
    combine = {REF: jnp.add, PORT: torch.add}
    got = {}
    for pkg in PACKAGES:
        Logic = mod(pkg, "operators.tpu.ffat_resident") \
            .WinSeqFFATResidentLogic
        WinType = mod(pkg, "core").WinType
        make = (lambda: Logic(lambda t: t.value, combine[pkg], 0.0, 48, 16,
                              win_type=WinType.CB, **_dev(pkg)))
        got[pkg] = _host_midstream(pkg, make, 3, 200)
    assert got[PORT] == got[REF]


# ---------------------------------------------------------------------------
# graphs: save/restore, structure mismatch, recovery runner
# ---------------------------------------------------------------------------

def _acc_build(pkg, n=30):
    wf = _wf(pkg)
    BasicRecord = mod(pkg, "core").BasicRecord
    state = {"i": 0}

    def src(shipper, ctx):
        i = state["i"]
        if i >= n:
            return False
        shipper.push(BasicRecord(i % 2, i // 2, i, float(i)))
        state["i"] = i + 1
        return True

    def acc(t, a):
        a.value += t.value

    g = wf.PipeGraph("ck", config=_cfg(pkg))
    g.add_source(wf.SourceBuilder(src).build()) \
        .add(wf.AccumulatorBuilder(acc)
             .with_initial_value(BasicRecord(value=0.0)).build()) \
        .add_sink(wf.SinkBuilder(lambda r: None).build())
    return g


def test_graph_level_save_restore(tmp_path):
    finals = {}
    for pkg in PACKAGES:
        ck = mod(pkg, "utils.checkpoint")
        g1 = _acc_build(pkg)
        g1.run()
        path = str(tmp_path / f"{pkg}.pkl")
        ck.save_graph(g1, path)
        g2 = _acc_build(pkg)
        assert ck.restore_graph(g2, path) >= 1
        node = next(nd for nd in g2._all_nodes()
                    if "accumulator" in nd.name)
        finals[pkg] = {k: v.value for k, v in node.logic.state.items()}
    assert finals[PORT] == finals[REF] == {0: float(sum(range(0, 30, 2))),
                                           1: float(sum(range(1, 30, 2)))}


def _farm_build(pkg, coalesce):
    wf = _wf(pkg)
    TupleBatch = mod(pkg, "core.tuples").TupleBatch
    BatchSource = mod(pkg, "operators.batch_ops").BatchSource
    KeyFarmTPU = mod(pkg, "operators.tpu.farms_tpu").KeyFarmTPU
    WinType = mod(pkg, "core").WinType
    sent = [False]

    def src(ctx):
        if sent[0]:
            return None
        sent[0] = True
        n = 64
        return TupleBatch({"key": np.arange(n, dtype=np.int64) % 4,
                           "id": np.arange(n, dtype=np.int64) // 4,
                           "ts": np.arange(n, dtype=np.int64) // 4,
                           "value": np.ones(n, np.float32)})
    g = wf.PipeGraph("mismatch", wf.Mode.DEFAULT, config=_cfg(pkg))
    g.add_source(BatchSource(src)).add(
        KeyFarmTPU("sum", 8, 8, WinType.CB, parallelism=2, batch_len=4,
                   coalesce=coalesce)).add_sink(
        wf.SinkBuilder(lambda r: None).build())
    return g


@pytest.mark.parametrize("pkg", PACKAGES)
def test_restore_refuses_structure_mismatch(pkg, tmp_path):
    ck = mod(pkg, "utils.checkpoint")
    path = str(tmp_path / "farm.pkl")
    for saved, restored in ((False, True), (True, False)):
        g = _farm_build(pkg, coalesce=saved)
        g.run()
        ck.save_graph(g, path)
        with pytest.raises(RuntimeError, match="structure mismatch"):
            ck.restore_graph(_farm_build(pkg, coalesce=restored), path)


def _recovery(pkg, tmp_path):
    wf = _wf(pkg)
    BasicRecord = mod(pkg, "core").BasicRecord
    ck = mod(pkg, "utils.checkpoint")
    runs = []

    def factory(attempt):
        collected = []
        state = {"i": 0}

        def src(shipper, ctx):
            i = state["i"]
            if i >= 50:
                return False
            shipper.push(BasicRecord(i % 2, i // 2, i, float(i)))
            state["i"] = i + 1
            return True

        def acc(t, result):
            result.value += t.value

        def snk(rec):
            if rec is None:
                return
            if attempt == 0 and rec.value > 100:
                raise RuntimeError("injected sink failure")
            collected.append((rec.key, rec.id, rec.value))

        g = wf.PipeGraph("rec", wf.Mode.DEFAULT, config=_cfg(pkg))
        g.add_source(wf.SourceBuilder(src).build()) \
            .add(wf.AccumulatorBuilder(acc).build()) \
            .add_sink(wf.SinkBuilder(snk).build())
        runs.append(collected)
        return g

    ck.run_with_recovery(factory, str(tmp_path / f"{pkg}.pkl"),
                         max_restarts=2)
    return len(runs), sorted(runs[-1])


def test_run_with_recovery_restarts_on_node_failure(tmp_path):
    port = _recovery(PORT, tmp_path)
    assert port == _recovery(REF, tmp_path)
    assert port[0] == 2 and port[1]


def test_run_with_recovery_reraises_validation_errors(tmp_path):
    from windflow_tpu_torch.utils.checkpoint import run_with_recovery
    wf = _wf(PORT)
    calls = {"n": 0}

    def factory(attempt):
        calls["n"] += 1
        g = wf.PipeGraph("val", wf.Mode.DEFAULT, config=_cfg(PORT))
        g.add_source(wf.SourceBuilder(lambda s, c: False).build()) \
            .add_sink(wf.SinkBuilder(lambda r: None).build())
        g.run()
        return g

    with pytest.raises(RuntimeError, match="already started"):
        run_with_recovery(factory, str(tmp_path / "c.pkl"), max_restarts=3)
    assert calls["n"] == 1


def test_chained_logic_checkpoints_both_halves():
    got = {}
    for pkg in PACKAGES:
        PaneFarm = mod(pkg, "operators.pane_farm").PaneFarm
        basic = mod(pkg, "core.basic")
        BasicRecord = mod(pkg, "core").BasicRecord

        def fsum(gwid, it, res):
            res.value = sum(t.value for t in it)

        def build():
            pf = PaneFarm(fsum, fsum, 12, 4, basic.WinType.TB, 1, 1,
                          opt_level=basic.OptLevel.LEVEL2)
            return pf.stages()[0].replicas[0]

        a = build()
        for i in range(30):
            a.svc(BasicRecord(0, i, i, float(i)), 0, lambda r: None)
        snap = a.state_dict()
        assert set(snap) == {"a", "b"}
        assert mod(pkg, "utils.checkpoint")._is_stateful(a)
        b = build()
        b.load_state(pickle.loads(pickle.dumps(snap)))
        out_a, out_b = [], []
        a.eos_flush(out_a.append)
        b.eos_flush(out_b.append)
        rows = [[(r.get_control_fields(), r.value) for r in out]
                for out in (out_a, out_b)]
        assert rows[0] == rows[1] and rows[0]
        got[pkg] = rows[0]
    assert got[PORT] == got[REF]


# ---------------------------------------------------------------------------
# live checkpoints at a fixed stream index
# ---------------------------------------------------------------------------

N_KEYS, PER_KEY, WIN, SLIDE = 2, 4000, 10, 5
STOP_AT = 3000
WAIT_S = 30.0


def _live_oracle():
    out = {}
    for k in range(N_KEYS):
        w = 0
        while w * SLIDE < PER_KEY:
            out[(k, w)] = float(sum(v for v in range(PER_KEY)
                                    if w * SLIDE <= v < w * SLIDE + WIN))
            w += 1
    return out


class _Wins:
    def __init__(self):
        self.lock = threading.Lock()
        self.wins = {}

    def __call__(self, rec):
        if rec is not None:
            with self.lock:
                k, w, _ = rec.get_control_fields()
                self.wins[(k, w)] = rec.value


def _live_graph(pkg, start_at, stop_at=None):
    """source -> WinSeqTPU("sum") TB 10/5 -> sink over (key i % 2, id
    i // 2, value id).  With ``stop_at`` the source stops at that index
    (``reached`` is set) and emits nothing more until ``release`` is
    set -- still stepping, so a pause of the sources takes effect."""
    wf = _wf(pkg)
    BasicRecord = mod(pkg, "core").BasicRecord
    total = N_KEYS * PER_KEY
    reached, release = threading.Event(), threading.Event()
    state = {"i": start_at}

    def fn(shipper, ctx):
        i = state["i"]
        if i >= total:
            return False
        if i == stop_at and not release.is_set():
            reached.set()
            time.sleep(0.0005)
            return True
        k, v = i % N_KEYS, i // N_KEYS
        shipper.push(BasicRecord(k, v, v, float(v)))
        state["i"] = i + 1
        return True

    got = _Wins()
    g = wf.PipeGraph("live", wf.Mode.DEFAULT, config=_cfg(pkg))
    g.add_source(wf.SourceBuilder(fn).build()) \
        .add(wf.WinSeqTPUBuilder("sum").with_tb_windows(WIN, SLIDE)
             .build()).add_sink(wf.SinkBuilder(got).build())
    return g, state, got, reached, release


def _checkpoint_at(pkg, path):
    """Run to STOP_AT, ``live_checkpoint`` there, finish the run.
    Returns the windows emitted before the checkpoint and the whole
    run's."""
    g, state, got, reached, release = _live_graph(pkg, 0, STOP_AT)
    pre = {}
    resume = g.resume

    def read_then_resume():
        # what the sink holds while the graph is still paused: once it
        # resumes, a timed launch may emit windows the snapshot holds
        with got.lock:
            pre.update(got.wins)
        resume()

    g.resume = read_then_resume
    g.start()
    try:
        assert reached.wait(WAIT_S), "source never reached the stop"
        assert g.live_checkpoint(path) >= 1
        assert state["i"] == STOP_AT and pre
    finally:
        release.set()
    g.wait_end()
    return pre, got.wins


def _resume(pkg, path, convert=False):
    """A fresh graph, restored from ``path`` and fed from STOP_AT on."""
    ck = mod(pkg, "utils.checkpoint")
    g, _state, got, _r, _rel = _live_graph(pkg, STOP_AT)
    states = ck.read_snapshot(path)
    if convert:
        from windflow_tpu_torch.convert import from_reference_state
        states = {name: from_reference_state(st)
                  for name, st in states.items()}
    assert ck.restore_states(g, states, "snapshot") >= 1
    g.run()
    return got.wins


def test_live_checkpoint_mid_stream(tmp_path):
    """live_checkpoint pauses the sources, drains channels and in-flight
    device batches, snapshots and resumes; a fresh graph restored from
    the file and fed the rest emits exactly the windows the first had
    not, in both packages."""
    for pkg in PACKAGES:
        path = str(tmp_path / f"{pkg}.pkl")
        pre, whole = _checkpoint_at(pkg, path)
        assert whole == _live_oracle()
        # which closed windows had launched by the checkpoint depends on
        # the engine's timed launches; the rest is in the snapshot
        rest = _resume(pkg, path)
        assert not set(pre) & set(rest)
        assert {**pre, **rest} == _live_oracle()


def test_reference_checkpoint_resumes_in_port(tmp_path):
    """A reference graph's mid-stream ``live_checkpoint``, unpickled
    here, converted state by state with ``convert.from_reference_state``
    and restored into the port's graph: the port emits the windows the
    reference's own restore of that file emits."""
    path = str(tmp_path / "ref.pkl")
    pre, _whole = _checkpoint_at(REF, path)
    want = _resume(REF, path)
    got = _resume(PORT, path, convert=True)
    assert got == want
    assert {**pre, **got} == _live_oracle()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_live_checkpoint_after_sources_finished(pkg, tmp_path):
    """Sources that already ended cannot ack a pause: the barrier still
    drains and snapshots."""
    g, state, got, _r, _rel = _live_graph(pkg, 0)
    g.start()
    deadline = time.monotonic() + WAIT_S
    while any(n.is_alive() for n in g._all_nodes()
              if n.channel is None) and time.monotonic() < deadline:
        time.sleep(0.005)
    assert g.live_checkpoint(str(tmp_path / "s.pkl")) >= 1
    g.resume()
    g.wait_end()
    assert got.wins == _live_oracle()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_quiesce_and_live_checkpoint_need_a_running_graph(pkg, tmp_path):
    g = _wf(pkg).PipeGraph("q", config=_cfg(pkg))
    with pytest.raises(RuntimeError, match="running"):
        g.quiesce()
    with pytest.raises(RuntimeError, match="running"):
        g.live_checkpoint(str(tmp_path / "x.pkl"))
