"""Side-by-side twins of the reference's pipeline-matrix and audit cases
whose path runs port code that differs from the reference (the window
engine, ``WinSeqTPU``, the device farms): each case runs the same graph
through the reference (``windflow_tpu``) and the port
(``windflow_tpu_torch``, on the CPU) in one test, on the same stream.

* hopping windows (tests/test_mp_matrix.py:683): win 4 < slide 10, gap
  tuples in no window;
* window geometry edges (:710): win 1, tumbling, windows longer than
  the stream, hopping;
* string keys carried back on the device lane's results (:741), and
  the intern tables across a state round trip;
* int and string keys in one stream on the device lane's columnar
  output (:786);
* the dispatcher's in-flight books under the audit plane
  (tests/test_audit.py:111): replay source -> WinSeqTPU -> sink with
  async device batches.

Each case keeps the reference test's geometry and stream; the kinds are
a few of its matrix's, the device ones first.  Keys, each key's window
ids in arrival order and the values (integer-valued sums, exact in f32)
must be equal exactly; the reference test's own oracle is checked on
the port's result.
"""
import importlib
import threading
import warnings

import numpy as np
import pytest

from torch_graphs import (PACKAGES, PORT, assert_same, by_key, mod,
                          run_graph)

N_KEYS = 4  # tests/test_mp_matrix.py's


def _sum_win(gwid, it, result):
    result.value = sum(t.value for t in it)


def _window_op(wf, kind, win_type, par, win, slide):
    """The reference matrix's ``build_window_op`` for ``kind``, through
    package ``wf``'s builders."""
    if kind == "kf":
        b = wf.KeyFarmBuilder(_sum_win).with_parallelism(par)
    elif kind == "kff":
        b = wf.KeyFFATBuilder(
            lambda t, r: setattr(r, "value", t.value),
            lambda a, c, o: setattr(o, "value", a.value + c.value)) \
            .with_parallelism(par)
    elif kind == "kf_tpu":
        b = wf.KeyFarmTPUBuilder("sum").with_parallelism(par)
    else:
        b = wf.KeyFFATTPUBuilder(lambda t: t.value, "sum") \
            .with_parallelism(par)
    return (b.with_tb_windows(win, slide) if win_type == "TB"
            else b.with_cb_windows(win, slide)).build()


def _expected_total(per_key, win, slide):
    """tests/test_mp_matrix.py's oracle: every key's window sums over
    ids (value = id), EOS flush included."""
    total, g = 0.0, 0
    while g * slide < per_key:
        total += sum(v for v in range(per_key)
                     if g * slide <= v < g * slide + win)
        g += 1
    return total * N_KEYS


def _twin(kind, win_type, par, win, slide, per_key):
    """The graph through both packages in DETERMINISTIC mode; the
    port's rows held to the reference's exactly and to the oracle."""
    rows = {}
    for pkg in PACKAGES:
        rows[pkg], _ = run_graph(
            pkg, lambda wf: _window_op(wf, kind, win_type, par, win, slide),
            N_KEYS, per_key, "DETERMINISTIC")
    assert_same(rows[PORT], rows[PACKAGES[0]])
    assert sum(v for _k, _i, v in rows[PORT]) == \
        _expected_total(per_key, win, slide)


@pytest.mark.parametrize("win_type", ["CB", "TB"])
@pytest.mark.parametrize("kind", ["kf", "kff", "kf_tpu", "kff_tpu"])
def test_hopping_windows_match_the_reference(kind, win_type):
    """tests/test_mp_matrix.py:683: gap tuples belong to no window, at
    parallelism 1 and 3."""
    for par in (1, 3):
        _twin(kind, win_type, par, 4, 10, 200)


@pytest.mark.parametrize("geometry", [(1, 1, 40), (1, 2, 40),
                                      (100, 10, 7), (100, 100, 37),
                                      (3, 7, 50)])
@pytest.mark.parametrize("kind", ["kf_tpu", "kff_tpu"])
def test_window_geometry_edges_match_the_reference(kind, geometry):
    """tests/test_mp_matrix.py:710: win 1, tumbling, windows longer
    than the stream (EOS flush emits the opened partials) and hopping,
    CB and TB, parallelism 3."""
    win, slide, per_key = geometry
    for win_type in ("CB", "TB"):
        _twin(kind, win_type, 3, win, slide, per_key)


def _string_rows(pkg):
    """tests/test_mp_matrix.py:741's graph in package ``pkg``: string
    keys through WinSeqTPU("sum") CB 20 / 10; the sink's (key, id,
    value) rows."""
    wf = importlib.import_module(pkg)
    BasicRecord = mod(pkg, "core").BasicRecord
    rows, lock, state = [], threading.Lock(), {"i": 0}

    def sink(rec):
        if rec is not None:
            with lock:
                rows.append((rec.key, rec.id, rec.value))

    def src(shipper, ctx):
        i = state["i"]
        if i >= 400:
            return False
        shipper.push(BasicRecord(f"user_{i % 4}", i // 4, i // 4, float(i)))
        state["i"] = i + 1
        return True

    cfg = wf.RuntimeConfig(device="cpu") if pkg == PORT else None
    g = wf.PipeGraph("strdev", wf.Mode.DEFAULT, config=cfg)
    g.add_source(wf.SourceBuilder(src).build()) \
        .add(wf.WinSeqTPUBuilder("sum").withCBWindows(20, 10).build()) \
        .add_sink(wf.SinkBuilder(sink).build())
    g.run()
    return rows


def test_string_keys_on_device_results_match_the_reference():
    """Interned device-plane keys are restored on the results in both
    packages, with the same windows; the intern tables survive a state
    round trip alike."""
    rows = {pkg: _string_rows(pkg) for pkg in PACKAGES}
    assert_same(rows[PORT], rows[PACKAGES[0]])
    assert {k for k, _i, _v in rows[PORT]} == {f"user_{k}"
                                               for k in range(4)}
    tables = {}
    for pkg in PACKAGES:
        logic_cls = mod(pkg, "operators.tpu.win_seq_tpu").WinSeqTPULogic
        CB = importlib.import_module(pkg).WinType.CB
        kw = {"device": "cpu"} if pkg == PORT else {}
        logic = logic_cls("sum", 20, 10, CB, **kw)
        logic._intern_key("alpha")
        logic._intern_key("beta")
        fresh = logic_cls("sum", 20, 10, CB, **kw)
        fresh.load_state(logic.state_dict())
        tables[pkg] = (logic._native is not None, dict(logic._key_intern),
                       dict(fresh._key_intern), dict(fresh._key_extern))
    assert tables[PORT] == tables[PACKAGES[0]]


def _mixed_rows(pkg):
    """tests/test_mp_matrix.py:786's graph in package ``pkg``: int and
    string keys in one stream through WinSeqTPU("sum") CB 10 / 5 with
    batch output.  Returns the (key, id, value) rows and the set of
    keys each kind of sink item carried."""
    wf = importlib.import_module(pkg)
    BasicRecord = mod(pkg, "core").BasicRecord
    TupleBatch = mod(pkg, "core.tuples").TupleBatch
    rows, carried = [], {"batch": set(), "record": set()}
    lock, state = threading.Lock(), {"i": 0}

    def sink(item):
        if item is None:
            return
        with lock:
            if isinstance(item, TupleBatch):
                for j in range(len(item)):
                    rows.append((int(item.key[j]), int(item.id[j]),
                                 float(item["value"][j])))
                    carried["batch"].add(int(item.key[j]))
            else:
                rows.append((item.key, item.id, item.value))
                carried["record"].add(item.key)

    def src(shipper, ctx):
        i = state["i"]
        if i >= 400:
            return False
        key = i % 2 if i % 4 < 2 else f"s{i % 2}"
        shipper.push(BasicRecord(key, i // 4, i // 4, 1.0))
        state["i"] = i + 1
        return True

    cfg = wf.RuntimeConfig(device="cpu") if pkg == PORT else None
    g = wf.PipeGraph("mixed", wf.Mode.DEFAULT, config=cfg)
    g.add_source(wf.SourceBuilder(src).build()) \
        .add(wf.WinSeqTPUBuilder("sum").withCBWindows(10, 5)
             .withBatchOutput().build()) \
        .add_sink(wf.SinkBuilder(sink).build())
    g.run()
    return rows, carried


def test_mixed_int_and_string_keys_match_the_reference():
    """Every original key comes back in both packages with the same
    windows; result batches stay columnar only for int keys (a batch
    carrying an interned key degrades to records)."""
    got = {pkg: _mixed_rows(pkg) for pkg in PACKAGES}
    assert_same(got[PORT][0], got[PACKAGES[0]][0])
    for pkg, (rows, carried) in got.items():
        assert {k for k, _i, _v in rows} == {0, 1, "s0", "s1"}, pkg
        assert carried["batch"] <= {0, 1}, pkg
        assert {"s0", "s1"} <= carried["record"], pkg


def _audit_feed(pkg):
    """tests/test_audit.py:111's graph in package ``pkg``: a replay
    source of 60,000 tuples in chunks of 4096 -> WinSeqTPU("sum", 512,
    512, TB, batch_len=64, emit_batches) -> sink, tracing on, audit
    passes every 50 ms.  Returns the sink's (key, id, value) rows and
    the graph."""
    wf = importlib.import_module(pkg)
    TupleBatch = mod(pkg, "core.tuples").TupleBatch
    WinSeqTPU = mod(pkg, "operators.tpu.win_seq_tpu").WinSeqTPU
    Sink = mod(pkg, "operators.basic_ops").Sink
    n = 60_000
    ar = np.arange(n, dtype=np.int64)
    trace = TupleBatch({"key": ar % 4, "id": ar // 4, "ts": ar // 4,
                        "value": np.ones(n, np.float64)})
    src = wf.SourceBuilder.from_replay(trace, speedup=None,
                                       chunk=4096).build()
    op = WinSeqTPU("sum", 512, 512, wf.WinType.TB, batch_len=64,
                   emit_batches=True)
    got = []
    cfg = wf.RuntimeConfig(tracing=True, audit_interval_s=0.05,
                           watchdog_timeout_s=60)
    if pkg == PORT:
        cfg.device = "cpu"
    g = wf.PipeGraph("audit_win", wf.Mode.DEFAULT, config=cfg)
    g.add_source(src).add(op).add_sink(
        Sink(lambda b: got.append(b) if b is not None else None))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g.run()
    rows = [(int(b.key[j]), int(b.id[j]), float(b["value"][j]))
            for b in got for j in range(len(b))]
    return rows, g


def test_dispatcher_in_flight_books_match_the_reference():
    """The audit ledger over credited channels and async device batches
    closes in both packages: no violation, every edge balanced, nothing
    in flight (no device batch left in the dispatcher's books); the same
    windows, edges and source count (the sink's count of result batches
    follows the dispatcher's time trigger, so it is not compared)."""
    import json
    got = {pkg: _audit_feed(pkg) for pkg in PACKAGES}
    assert_same(got[PORT][0], got[PACKAGES[0]][0])
    # 15,000 tuples a key of value 1: 29 full windows and one of 152
    assert by_key(got[PORT][0]) == {
        k: {w: 512.0 if w < 29 else 152.0 for w in range(30)}
        for k in range(4)}
    books = {}
    for pkg, (_rows, g) in got.items():
        assert g.auditor.violations == [], pkg
        cons = json.loads(g.stats.to_json())["Conservation"]
        assert cons["Edges_balanced"] is True and cons["Edges_total"] >= 1
        assert cons["In_flight"] == {"channels": 0, "processing": 0,
                                     "device_batches": 0}, pkg
        books[pkg] = (cons["Edges_total"], cons["Sources_emitted"],
                      cons["Final_check"])
    assert books[PORT] == books[PACKAGES[0]]
