"""The device farms (KeyFarmTPU, WinFarmTPU, PaneFarmTPU,
WinMapReduceTPU) and the host window farms (WinFarm, KeyFarm, PaneFarm,
WinMapReduce, WinSeqFFAT, KeyFFAT) of the port against the reference:
every parametrisation of the reference's device-farm tests
(tests/test_tpu_operators.py) and host-farm tests (tests/test_win_farms.py),
the same graph built through the builders of both packages on the same
record stream (tests/torch_graphs.py).  The port runs on the CPU.

Keys and each key's window ids in arrival order must be equal exactly.
Values: the reference tests compare these integer-valued sums with
``==`` (device sums in f32 are exact here), so the packages must agree
exactly; the columnar-WLQ tests use the reference's ``rel=1e-9``.
"""
import importlib
import threading

import numpy as np
import pytest

from torch_graphs import (PACKAGES, PORT, USER_EXACT, USER_RTOL,
                          assert_same, both, by_key, mod, oracle,
                          ordered_source, run_graph, user_combines)

CB, TB = "CB", "TB"


def _windows(b, win_type, win, slide):
    return (b.with_cb_windows(win, slide) if win_type == CB
            else b.with_tb_windows(win, slide))


def _sum_win(gwid, iterable, result):
    result.value = sum(t.value for t in iterable)


# ---------------------------------------------------------------------------
# device farms: tests/test_tpu_operators.py:194-420
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coalesce", [True, False])
@pytest.mark.parametrize("par", [1, 3])
@pytest.mark.parametrize("win_type", [CB, TB])
def test_key_farm_tpu(par, win_type, coalesce):
    """Both lowerings of KeyFarmTPU (one coalesced engine, or N
    replicas behind the key hash) match the reference."""
    def make(wf):
        b = wf.KeyFarmTPUBuilder("sum").with_parallelism(par) \
            .with_batch(8).with_coalesce(coalesce)
        op = _windows(b, win_type, 12, 4).build()
        assert len(op.stages()[0].replicas) == (1 if coalesce else par)
        return op

    got, _ = both(make, n_keys=5)
    expect = oracle(48, 12, 4)
    assert by_key(got) == {k: expect for k in range(5)}


@pytest.mark.parametrize("par", [2, 4])
@pytest.mark.parametrize("win_type", [CB, TB])
def test_win_farm_tpu(par, win_type):
    def make(wf):
        b = wf.WinFarmTPUBuilder("sum").with_parallelism(par).with_batch(4)
        return _windows(b, win_type, 12, 4).build()

    got, _ = both(make, mode="DETERMINISTIC" if win_type == CB
                  else "DEFAULT")
    expect = oracle(48, 12, 4)
    assert by_key(got) == {k: expect for k in range(3)}


@pytest.mark.parametrize("plq_on_tpu", [True, False])
def test_pane_farm_tpu(plq_on_tpu):
    def make(wf):
        if plq_on_tpu:
            b = wf.PaneFarmTPUBuilder("sum", _sum_win, plq_on_tpu=True)
        else:
            b = wf.PaneFarmTPUBuilder(_sum_win, "sum", plq_on_tpu=False)
        return b.with_parallelism(2, 1).with_batch(8) \
            .with_tb_windows(12, 4).build()

    got, _ = both(make)
    expect = oracle(48, 12, 4)
    assert by_key(got) == {k: expect for k in range(3)}


@pytest.mark.parametrize("opt_level", ["LEVEL0", "LEVEL2"])
@pytest.mark.parametrize("kind,agg", [("sum", sum), ("max", max),
                                      ("min", min)])
@pytest.mark.parametrize("columnar", [True, False])
def test_pane_farm_tpu_columnar_wlq(columnar, kind, agg, opt_level):
    """A builtin-name host WLQ takes the columnar pane->window combine
    (PaneCombineLogic), a callable WLQ the per-record engine; both
    match the reference and the oracle (reference tolerance rel 1e-9)."""
    def host_comb(gwid, iterable, result):
        result.value = agg(t.value for t in iterable)

    def make(wf):
        b = wf.PaneFarmTPUBuilder(kind, kind if columnar else host_comb) \
            .with_parallelism(1, 1).with_batch(8).with_tb_windows(12, 4)
        b.opt_level = getattr(wf.OptLevel, opt_level)
        op = b.build()
        assert op._wlq_columnar == columnar
        return op

    got, _ = both(make, rtol=1e-9)
    expect = oracle(48, 12, 4, agg=agg)
    for k, windows in by_key(got).items():
        assert windows == pytest.approx(expect, rel=1e-9), k


@pytest.mark.parametrize("map_on_tpu", [True, False])
def test_win_mapreduce_tpu(map_on_tpu):
    def make(wf):
        if map_on_tpu:
            b = wf.WinMapReduceTPUBuilder("sum", _sum_win, map_on_tpu=True)
        else:
            b = wf.WinMapReduceTPUBuilder(_sum_win, "sum", map_on_tpu=False)
        return b.with_parallelism(3, 1).with_batch(8) \
            .with_tb_windows(12, 4).build()

    got, _ = both(make)
    expect = oracle(48, 12, 4)
    assert by_key(got) == {k: expect for k in range(3)}


@pytest.mark.parametrize("columnar", [True, False])
def test_nested_pane_farm_builtin_wlq_falls_back_to_record_engine(columnar):
    """A nested PaneFarmTPU copy carries a striped config the columnar
    WLQ cannot reproduce: a builtin-name WLQ falls back to the
    per-record engine there, as in the reference (rel 1e-9)."""
    def make(wf):
        nesting = mod(wf.__name__, "operators.nesting")
        inner = wf.PaneFarmTPUBuilder("sum", "sum" if columnar else _sum_win) \
            .with_parallelism(2, 1).with_tb_windows(12, 4).build()
        if columnar:
            assert inner._wlq_columnar
            assert not nesting._clone_inner(inner, 1, 2, 4, 8)._wlq_columnar
        return wf.WinFarmTPUBuilder(inner).with_parallelism(2).build()

    got, _ = both(make, rtol=1e-9)
    expect = oracle(48, 12, 4)
    for k, windows in by_key(got).items():
        assert windows == pytest.approx(expect, rel=1e-9), k


class _BatchSink:
    """Rows of the TupleBatches a sink receives (records are refused)."""

    def __init__(self, TupleBatch):
        self.TupleBatch = TupleBatch
        self.lock = threading.Lock()
        self.rows = []

    def __call__(self, item):
        if item is None:
            return
        assert isinstance(item, self.TupleBatch)
        with self.lock:
            self.rows.extend(zip(np.asarray(item.key).tolist(),
                                 np.asarray(item.id).tolist(),
                                 np.asarray(item["value"]).tolist()))


def test_pane_farm_tpu_columnar_wlq_batch_output_and_par():
    """Columnar WLQ with keyed parallelism 2 and TupleBatch output: the
    batches of both packages carry the same windows (rel 1e-9)."""
    rows = {}
    for pkg in PACKAGES:
        wf = importlib.import_module(pkg)
        sink = _BatchSink(mod(pkg, "core.tuples").TupleBatch)
        op = wf.PaneFarmTPUBuilder("sum", "sum").with_parallelism(1, 2) \
            .with_batch(8).with_tb_windows(12, 4).with_batch_output() \
            .build()
        cfg = wf.RuntimeConfig()
        if pkg == PORT:
            cfg.device = "cpu"
        g = wf.PipeGraph("pcb", wf.Mode.DEFAULT, config=cfg)
        g.add_source(wf.SourceBuilder(ordered_source(pkg, 4, 48)).build()) \
            .add(op).add_sink(wf.SinkBuilder(sink).build())
        g.run()
        rows[pkg] = sink.rows
    assert_same(rows[PORT], rows[PACKAGES[0]], rtol=1e-9)
    got = by_key(rows[PORT])
    assert set(got) == set(range(4))
    for k in got:
        assert got[k] == pytest.approx(oracle(48, 12, 4), rel=1e-9)


def test_pane_farm_tpu_rejects_unsupported_builtin_wlq():
    import windflow_tpu_torch as wf
    with pytest.raises(ValueError, match="builtin"):
        wf.PaneFarmTPUBuilder("count", "count") \
            .with_tb_windows(12, 4).build()


# ---------------------------------------------------------------------------
# host window farms: tests/test_win_farms.py
# ---------------------------------------------------------------------------

WIN_SLIDE = [(8, 8), (12, 4)]


@pytest.mark.parametrize("win,slide", WIN_SLIDE)
@pytest.mark.parametrize("par", [1, 2, 4])
@pytest.mark.parametrize("win_type", [CB, TB])
def test_win_farm_matches_reference(win, slide, par, win_type):
    def make(wf):
        b = wf.WinFarmBuilder(_sum_win).with_parallelism(par).with_ordered()
        return _windows(b, win_type, win, slide).build()

    got, _ = both(make, mode="DETERMINISTIC" if win_type == CB
                  else "DEFAULT")
    assert by_key(got) == {k: oracle(48, win, slide) for k in range(3)}


@pytest.mark.parametrize("win,slide", WIN_SLIDE)
@pytest.mark.parametrize("par", [1, 3])
@pytest.mark.parametrize("win_type", [CB, TB])
def test_key_farm_matches_reference(win, slide, par, win_type):
    def make(wf):
        b = wf.KeyFarmBuilder(_sum_win).with_parallelism(par)
        return _windows(b, win_type, win, slide).build()

    got, _ = both(make, n_keys=5)
    assert by_key(got) == {k: oracle(48, win, slide) for k in range(5)}


@pytest.mark.parametrize("win,slide", [(8, 2), (12, 4), (10, 5)])
@pytest.mark.parametrize("pars", [(1, 1), (2, 2), (3, 1)])
@pytest.mark.parametrize("win_type", [CB, TB])
def test_pane_farm_matches_reference(win, slide, pars, win_type):
    def make(wf):
        b = wf.PaneFarmBuilder(_sum_win, _sum_win).with_parallelism(*pars)
        return _windows(b, win_type, win, slide).build()

    got, _ = both(make)
    assert by_key(got) == {k: oracle(48, win, slide) for k in range(3)}


@pytest.mark.parametrize("win,slide", [(8, 8), (12, 4)])
@pytest.mark.parametrize("pars", [(2, 1), (3, 2)])
@pytest.mark.parametrize("win_type", [CB, TB])
def test_win_mapreduce_matches_reference(win, slide, pars, win_type):
    def make(wf):
        b = wf.WinMapReduceBuilder(_sum_win, _sum_win) \
            .with_parallelism(*pars)
        return _windows(b, win_type, win, slide).build()

    got, _ = both(make)
    assert by_key(got) == {k: oracle(48, win, slide) for k in range(3)}


def _lift(t, result):
    result.value = t.value


def _comb(a, b, out):
    out.value = a.value + b.value


@pytest.mark.parametrize("win,slide", WIN_SLIDE)
@pytest.mark.parametrize("win_type", [CB, TB])
def test_win_seqffat_matches_reference(win, slide, win_type):
    def make(wf):
        return _windows(wf.WinSeqFFATBuilder(_lift, _comb), win_type, win,
                        slide).build()

    got, _ = both(make)
    assert by_key(got) == {k: oracle(48, win, slide) for k in range(3)}


@pytest.mark.parametrize("par", [1, 3])
@pytest.mark.parametrize("win_type", [CB, TB])
def test_key_ffat_matches_reference(par, win_type):
    def make(wf):
        b = wf.KeyFFATBuilder(_lift, _comb).with_parallelism(par)
        return _windows(b, win_type, 12, 4).build()

    got, _ = both(make, n_keys=5)
    assert by_key(got) == {k: oracle(48, 12, 4) for k in range(5)}


def _value(t):
    """The device FFAT builders' lift: tuple -> float."""
    return t.value


def _lse_oracle(per_key_n, win, slide):
    """gwid -> log(sum(exp(id))) over ids [g*slide, g*slide + win)
    (value = id), in float64."""
    out = {}
    g = 0
    while g * slide < per_key_n:
        vals = np.arange(g * slide, min(g * slide + win, per_key_n),
                         dtype=np.float64)
        out[g] = float(vals.max() + np.log(np.exp(vals - vals.max()).sum()))
        g += 1
    return out


@pytest.mark.parametrize("name", ["logaddexp", "left_weighted"])
@pytest.mark.parametrize("builder", ["winseq_rebuild", "winseq_resident",
                                     "key_replicas", "key_coalesced"])
def test_ffat_tpu_builders_take_a_user_combine(builder, name):
    """A user FFAT combine (one no kernel builds in: the card compiles it
    from its torch ops) through the public builders of both packages:
    WinSeqFFATTPUBuilder on the rebuild lane and on the CB default, the
    resident lane; KeyFFATTPUBuilder at parallelism 2, as two replicas
    and coalesced.  Keys and ids exact; left_weighted (not associative:
    the value is the tree's fold) exact between the packages; logaddexp
    within rtol 1e-5 of each other (jnp's and torch's forms may part by
    an ulp a combine) and of a float64 oracle."""
    win, slide = 12, 4

    def make(wf):
        pkg = wf.__name__
        combine = user_combines(pkg)[name]
        if builder.startswith("winseq"):
            b = wf.WinSeqFFATTPUBuilder(_value, combine)
            if builder == "winseq_rebuild":
                b = b.with_rebuild(True)
        else:
            b = wf.KeyFFATTPUBuilder(_value, combine).with_parallelism(2) \
                .with_coalesce(builder == "key_coalesced")
        # size-triggered launches only: a rebuild lane folds each window
        # where the launch's flat buffer puts it, and a non-associative
        # combine (left_weighted) rounds by that place, so both packages
        # must cut the same batches however loaded the machine is
        op = b.with_cb_windows(win, slide).with_max_batch_delay(1e9).build()
        want = ("WinSeqFFATResident" if builder == "winseq_resident"
                else "WinSeqFFATTPU" if builder == "winseq_rebuild"
                else "KeyFFATTPU")
        assert type(op).__name__ == want
        return op

    got, _ = both(make, n_keys=5,
                  rtol=0.0 if USER_EXACT[name] else USER_RTOL)
    if name != "logaddexp":
        return
    want = _lse_oracle(48, win, slide)
    for k, rows in by_key(got).items():
        assert sorted(rows) == sorted(want)
        np.testing.assert_allclose([rows[g] for g in sorted(want)],
                                   [want[g] for g in sorted(want)],
                                   rtol=USER_RTOL)


def test_wf_cb_default_mode_rejected():
    import windflow_tpu_torch as wf
    b = wf.WinFarmBuilder(_sum_win).with_parallelism(2).with_cb_windows(4, 4)
    g = wf.PipeGraph("t", wf.Mode.DEFAULT,
                     config=wf.RuntimeConfig(device="cpu"))
    pipe = g.add_source(wf.SourceBuilder(ordered_source(PORT, 1, 8)).build())
    with pytest.raises(RuntimeError, match="DEFAULT"):
        pipe.add(b.build())


@pytest.mark.parametrize("tpu", [False, True])
@pytest.mark.parametrize("win_type", [CB, TB])
def test_pane_farm_level2_fusion(tpu, win_type):
    """LEVEL2 single/single PLQ+WLQ fuse into one chained stage, one
    thread fewer, in both packages, with the same windows."""
    def build(wf, lvl):
        if tpu:
            b = wf.PaneFarmTPUBuilder("sum", _sum_win).with_parallelism(1, 1)
        else:
            b = wf.PaneFarmBuilder(_sum_win, _sum_win).with_parallelism(1, 1)
        return _windows(b, win_type, 12, 4).with_opt_level(lvl).build()

    ChainedLogic = mod(PORT, "runtime.node").ChainedLogic
    import windflow_tpu_torch as wft
    stages = build(wft, wft.OptLevel.LEVEL2).stages()
    assert len(stages) == 1 and isinstance(stages[0].replicas[0],
                                           ChainedLogic)
    threads = {}
    for lvl in ("LEVEL0", "LEVEL2"):
        # the graph compile pass pinned off: this measures the
        # operator-level PLQ+WLQ fusion alone
        got, g = both(lambda wf: build(wf, getattr(wf.OptLevel, lvl)),
                      config_kw={"opt_level": 0})
        threads[lvl] = g.thread_count()
        assert by_key(got) == {k: oracle(48, 12, 4) for k in range(3)}
    assert threads["LEVEL2"] == threads["LEVEL0"] - 1


def test_port_farm_stream_on_the_cpu_keeps_its_device():
    """Every device replica of a port farm binds to the graph's device
    (here the CPU), never to a device of its own choosing."""
    def make(wf):
        return wf.KeyFarmTPUBuilder("sum").with_parallelism(2) \
            .with_coalesce(False).with_batch(8).with_tb_windows(12, 4) \
            .build()

    _rows, g = run_graph(PORT, make)
    entries = [e for e in g.placements if "device" in e]
    assert len(entries) == 2 and all(e["device"] == "cpu" for e in entries)


# ---------------------------------------------------------------------------
# nesting: tests/test_nesting.py
# ---------------------------------------------------------------------------

NWIN, NSLIDE = 16, 4


def _inner(wf, kind, pars=(2, 1), win_type=TB):
    b = (wf.PaneFarmBuilder if kind == "pf" else wf.WinMapReduceBuilder)(
        _sum_win, _sum_win).with_parallelism(*pars)
    return _windows(b, win_type, NWIN, NSLIDE).build()


@pytest.mark.parametrize("replicas", [1, 2, 3])
def test_wf_pf_tb(replicas):
    got, _ = both(lambda wf: wf.WinFarmBuilder(_inner(wf, "pf"))
                  .with_parallelism(replicas).build())
    assert by_key(got) == {k: oracle(48, NWIN, NSLIDE) for k in range(3)}


@pytest.mark.parametrize("replicas", [2, 3])
def test_wf_wmr_tb(replicas):
    got, _ = both(lambda wf: wf.WinFarmBuilder(_inner(wf, "wmr"))
                  .with_parallelism(replicas).build())
    assert by_key(got) == {k: oracle(48, NWIN, NSLIDE) for k in range(3)}


@pytest.mark.parametrize("inner,replicas", [("pf", 1), ("pf", 2),
                                             ("pf", 3), ("wmr", 2),
                                             ("wmr", 3)])
@pytest.mark.parametrize("win_type", [CB, TB])
def test_kf_nested(inner, replicas, win_type):
    got, _ = both(lambda wf: wf.KeyFarmBuilder(
        _inner(wf, inner, win_type=win_type))
        .with_parallelism(replicas).build(), n_keys=5)
    assert by_key(got) == {k: oracle(48, NWIN, NSLIDE) for k in range(5)}


def test_wf_pf_cb_deterministic():
    got, _ = both(lambda wf: wf.WinFarmBuilder(_inner(wf, "pf",
                                                      win_type=CB))
                  .with_parallelism(2).build(), mode="DETERMINISTIC")
    assert by_key(got) == {k: oracle(48, NWIN, NSLIDE) for k in range(3)}


@pytest.mark.parametrize("outer", ["win_farm", "key_farm"])
def test_device_nesting_matches_reference(outer):
    """WF_TPU(PF_TPU) and KF_TPU(WMR_TPU): the nested structure has
    device engine replicas in both packages, and the same windows."""
    def make(wf):
        pkg = wf.__name__
        WinSeqTPULogic = mod(pkg, "operators.tpu.win_seq_tpu").WinSeqTPULogic
        if outer == "win_farm":
            inner = wf.PaneFarmTPUBuilder("sum", _sum_win) \
                .with_parallelism(2, 1).with_tb_windows(NWIN, NSLIDE).build()
            op = wf.WinFarmTPUBuilder(inner).with_parallelism(2).build()
            n_dev = 4
        else:
            inner = wf.WinMapReduceTPUBuilder("sum", _sum_win) \
                .with_parallelism(2, 1).with_tb_windows(NWIN, NSLIDE) \
                .build()
            op = wf.KeyFarmTPUBuilder(inner).with_parallelism(3).build()
            n_dev = 6
        reps = op.stages()[0].replicas
        assert len(reps) == n_dev
        assert all(isinstance(r, WinSeqTPULogic) for r in reps)
        return op

    got, _ = both(make, n_keys=5)
    assert by_key(got) == {k: oracle(48, NWIN, NSLIDE) for k in range(5)}


def test_nesting_rejections_match_the_reference():
    import windflow_tpu_torch as wf
    pf = _inner(wf, "pf")
    wf.WinFarmBuilder(pf).with_parallelism(2).build()
    with pytest.raises(RuntimeError, match="nested"):
        wf.WinFarmBuilder(pf).with_parallelism(2).build()
    with pytest.raises(ValueError, match="private slide"):
        wf.WinFarmBuilder(_inner(wf, "pf")).with_parallelism(
            NWIN // NSLIDE).build()
    with pytest.raises(ValueError, match="sliding"):
        wf.PaneFarmTPUBuilder("sum", _sum_win).with_parallelism(1, 1) \
            .with_tb_windows(8, 8).build()


def test_global_dispatch_lock_serialises_farm_replicas(monkeypatch):
    """WINDFLOW_GLOBAL_DISPATCH_LOCK=1: every replica engine of a farm
    shares the one process-wide lock (so concurrent dispatcher threads
    launch one at a time), and the windows stay the reference's."""
    monkeypatch.setenv("WINDFLOW_GLOBAL_DISPATCH_LOCK", "1")
    wc = mod(PORT, "ops.window_compute")

    def make(wf):
        op = wf.KeyFarmTPUBuilder("sum").with_parallelism(3) \
            .with_coalesce(False).with_batch(8).with_tb_windows(12, 4) \
            .build()
        if wf.__name__ == PORT:
            reps = op.stages()[0].replicas
            assert all(r.engine._lock is wc._GLOBAL_DISPATCH_LOCK
                       for r in reps)
        return op

    got, _ = both(make, n_keys=5)
    assert by_key(got) == {k: oracle(48, 12, 4) for k in range(5)}
