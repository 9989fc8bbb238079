"""The headline graph (bench.py config 2: SynthChunk BatchSource ->
WinSeqTPU("sum", TB) -> Sink) through both packages at a small size,
on the native pane-fold lane and on the Python staging lane
(WINDFLOW_NATIVE=0); a reference snapshot resumed in the port; the
port's device rules at the graph entry points.

Keys, window ids and emission order must be equal exactly; values
within ``rtol=1e-6`` (f32 device sums of integer-valued data, in
practice exact).  Launch triggers are size-based here (the time trigger
is pushed out of reach), so both packages cut the stream into the same
batches and emission order is deterministic.
"""
import importlib
import pickle

import numpy as np
import pytest
import torch

N_EVENTS = 200_000
N_KEYS = 64
WIN, SLIDE = 64, 32
SOURCE_BATCH = 20_000
DEVICE_BATCH = 512
NO_TIME_TRIGGER_MS = 1e9

PACKAGES = ("windflow_tpu", "windflow_tpu_torch")


def _mod(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


@pytest.fixture(params=["native", "python"])
def lane(request, monkeypatch):
    """Pin the staging lane in both packages: the native engine, or the
    pure-Python plane exactly as WINDFLOW_NATIVE=0 selects it."""
    for pkg in PACKAGES:
        native = _mod(pkg, "runtime.native")
        if request.param == "python":
            monkeypatch.setenv("WINDFLOW_NATIVE", "0")
            monkeypatch.setattr(native, "_lib", None)
        elif not native.native_available():
            pytest.skip("the native engine needs a C++ toolchain")
    return request.param


def _chunks(lo=0, hi=N_EVENTS):
    for i in range(lo, hi, SOURCE_BATCH):
        yield i, min(SOURCE_BATCH, hi - i)


def _op(pkg, **kw):
    WinSeqTPU = _mod(pkg, "operators.tpu.win_seq_tpu").WinSeqTPU
    wf = importlib.import_module(pkg)
    return WinSeqTPU("sum", WIN, SLIDE, wf.WinType.TB,
                     batch_len=DEVICE_BATCH, emit_batches=True,
                     max_buffer_elems=1 << 21, inflight_depth=8,
                     max_batch_delay_ms=NO_TIME_TRIGGER_MS, **kw)


def _run_graph(pkg, config_kw=None, op_kw=None):
    wf = importlib.import_module(pkg)
    SynthChunk = _mod(pkg, "core.tuples").SynthChunk
    BatchSource = _mod(pkg, "operators.batch_ops").BatchSource
    Sink = _mod(pkg, "operators.basic_ops").Sink
    chunks = iter(list(_chunks()))
    out = []

    def source(ctx):
        nxt = next(chunks, None)
        return None if nxt is None else SynthChunk(nxt[0], nxt[1], N_KEYS,
                                                   97, 1.0, 0.0)

    def sink(item):
        if item is not None:
            out.append(item)

    g = wf.PipeGraph("headline", wf.Mode.DEFAULT,
                     config=wf.RuntimeConfig(**(config_kw or {})))
    g.add_source(BatchSource(source, 1)).add(_op(pkg, **(op_kw or {}))) \
        .add_sink(Sink(sink))
    g.run()
    return g, _columns(out)


def _columns(batches):
    if not batches:
        return np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0)
    return (np.concatenate([np.asarray(b.key) for b in batches]),
            np.concatenate([np.asarray(b.id) for b in batches]),
            np.concatenate([np.asarray(b["value"]) for b in batches]))


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])  # keys, in order
    np.testing.assert_array_equal(got[1], want[1])  # ids, in order
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=0)


def _find_logic(g, pkg):
    WinSeqTPULogic = _mod(pkg, "operators.tpu.win_seq_tpu").WinSeqTPULogic
    FusedLogic = _mod(pkg, "runtime.node").FusedLogic
    for node in g._all_nodes():
        logics = ([s.logic for s in node.logic.segments]
                  if isinstance(node.logic, FusedLogic) else [node.logic])
        for lg in logics:
            if isinstance(lg, WinSeqTPULogic):
                return lg
    raise AssertionError("no WinSeqTPU logic in the graph")


def test_headline_graph_matches_reference(lane):
    _g_ref, want = _run_graph("windflow_tpu")
    g, got = _run_graph("windflow_tpu_torch", config_kw={"device": "cpu"})
    # every opened window fires (partial tail windows flush at EOS)
    M = N_EVENTS // N_KEYS
    assert len(got[0]) == N_KEYS * ((M - 1) // SLIDE + 1)
    _assert_same(got, want)
    logic = _find_logic(g, "windflow_tpu_torch")
    assert (logic._native is None) == (lane == "python")
    assert logic.device == torch.device("cpu")
    assert g.placements[0]["device"] == "cpu"
    assert logic.launched_batches > 1
    if lane == "python":
        # an eligible Python-staging engine is promoted to the resident
        # lane in both packages
        assert g.placements[0]["resident"] is True
        assert _g_ref.placements[0]["resident"] is True


def _feed(logic, pkg, lo, hi, out):
    SynthChunk = _mod(pkg, "core.tuples").SynthChunk
    for start, n in _chunks(lo, hi):
        logic.svc(SynthChunk(start, n, N_KEYS, 97, 1.0, 0.0), 0, out.append)


def _logic(pkg, lane, **kw):
    lg = _op(pkg, **kw).stages()[0].replicas[0]
    if lane == "python":
        assert lg._native is None
    return lg


def test_reference_snapshot_resumes_in_port(lane):
    """A reference run checkpointed mid-stream resumes in the port and
    produces the same remaining windows as the reference itself."""
    from windflow_tpu_torch.convert import from_reference_state
    half = (N_EVENTS // 2 // SOURCE_BATCH) * SOURCE_BATCH + SOURCE_BATCH // 2

    full, full_out = _logic("windflow_tpu", lane), []
    _feed(full, "windflow_tpu", 0, N_EVENTS, full_out)
    full.eos_flush(full_out.append)

    ref, first = _logic("windflow_tpu", lane), []
    _feed(ref, "windflow_tpu", 0, half, first)
    ref._drain_all(first.append)  # quiescent contract: nothing in flight
    snap = pickle.loads(pickle.dumps(ref.state_dict()))
    assert ("native" in snap) == (lane == "native")

    port, rest = _logic("windflow_tpu_torch", lane, device="cpu"), []
    port.load_state(from_reference_state(snap))
    _feed(port, "windflow_tpu_torch", half, N_EVENTS, rest)
    port.eos_flush(rest.append)

    assert len(first) and len(rest)
    got = _columns(first + rest)
    want = _columns(full_out)
    # the resumed run cuts batches at other points than the
    # uninterrupted one: compare as (key, id) -> value, and per key in
    # emission order
    order_g = np.lexsort((got[1], got[0]))
    order_w = np.lexsort((want[1], want[0]))
    _assert_same(tuple(c[order_g] for c in got),
                 tuple(c[order_w] for c in want))
    for k in range(N_KEYS):
        ids = got[1][got[0] == k]
        assert np.all(np.diff(ids) > 0)


def test_from_reference_state_rejects_unknown_fields():
    from windflow_tpu_torch.convert import from_reference_state
    with pytest.raises(ValueError, match="resident"):
        from_reference_state({"descriptors": [], "resident": object()})


def test_graph_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run_graph("windflow_tpu_torch")


def test_resident_true_raises_naming_the_roadmap_item():
    """resident=True is ported.  A custom window function (ported too)
    is not a shape the resident lane serves: resident=True rejects it
    as the reference does.  A user FFAT combine lowers for the card's
    kernels; one that branches in Python on its operands cannot, and
    raises ValueError (at bind, before a build)."""
    logic = _op("windflow_tpu_torch", resident=True,
                device="cpu").stages()[0].replicas[0]
    assert logic._resident is not None and logic._native is None
    for pkg in PACKAGES:
        wf = importlib.import_module(pkg)
        WinSeqTPU = _mod(pkg, "operators.tpu.win_seq_tpu").WinSeqTPU
        with pytest.raises(ValueError, match="eligible engine"):
            WinSeqTPU(lambda g, c, m: 0.0, WIN, SLIDE, wf.WinType.CB,
                      resident=True).stages()
    from windflow_tpu_torch.ops.cuda.combine_lower import lower_combine
    from windflow_tpu_torch.ops.cuda.flatfat_query import resolve_combine
    assert lower_combine(lambda a, b: a * b) == \
        "const float t0 = __fmul_rn(a, b); return t0;"
    with pytest.raises(ValueError, match="control flow"):
        resolve_combine(lambda a, b: a if a > b else b)
