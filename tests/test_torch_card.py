"""The port's kernels and the lanes that run them, on the card: the
window-sum kernel (K1, both forms), the FlatFAT query kernel (K2), the
fused FlatFAT update+query kernel and the fused build+query kernel of
the FFAT rebuild lane against their plain versions, the engines,
the headline graph and the resident lanes on CUDA against the same on
the CPU, one kernel launch per launched batch, and the refusal of
combines the kernels do not compile.

This file imports neither jax nor the reference package, so it runs
where the card is:

    python -m pytest -m cuda tests/test_torch_card.py

Every test is marked ``cuda`` and skips without a card.  Tolerances:
exact for max/min and for add on integer-valued data; ``rtol=1e-5`` for
the non-commutative ``left_weighted`` test combine and for sums of
random f32 data (the kernel and the float64 sum add in other orders).
The build+query kernel is exact for every combine and any data: it
combines the very pairs the plain version combines.
"""
import numpy as np
import pytest
import torch

import windflow_tpu_torch as wf
from windflow_tpu_torch.core.tuples import SynthChunk, TupleBatch
from windflow_tpu_torch.operators.basic_ops import Sink
from windflow_tpu_torch.operators.batch_ops import BatchSource
from windflow_tpu_torch.operators.tpu.ffat_resident import \
    WinSeqFFATResidentLogic
from windflow_tpu_torch.operators.tpu.win_seq_tpu import (WinSeqTPU,
                                                          WinSeqTPULogic)
from windflow_tpu_torch.ops.cuda import flatfat_query as fq
from windflow_tpu_torch.ops.cuda import window_sum as ws
from windflow_tpu_torch.ops.flatfat_torch import (build_tree, pack_step,
                                                  step_inputs)
from windflow_tpu_torch.ops.window_compute import WindowComputeEngine
from windflow_tpu_torch.runtime.node import FusedLogic

pytestmark = pytest.mark.cuda

# name -> (combine, neutral, exact)
COMBINES = {"add": (torch.add, 0.0, True),
            "max": (torch.maximum, -np.inf, True),
            "min": (torch.minimum, np.inf, True),
            "left_weighted": (fq._left_weighted, 0.0, False)}


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m cuda tests/test_torch_card.py)")


def _i32(a):
    return torch.from_numpy(np.asarray(a, np.int32))


@pytest.mark.parametrize("name", list(COMBINES))
def test_kernel_matches_plain(name):
    """A forest query with empty, whole-row and random extents: one
    launch, equal to the plain version."""
    comb, neutral, exact = COMBINES[name]
    rng = np.random.default_rng(30)
    K, n, B = 5, 256, 300
    forest = torch.stack([build_tree(torch.from_numpy(
        rng.integers(0, 100, n).astype(np.float32)), comb, neutral)
        for _ in range(K)]).cuda()
    rows = _i32(rng.integers(0, K, B)).cuda()
    starts = rng.integers(0, n, B)
    ends = np.minimum(starts + rng.integers(0, n, B), n)
    ends[:3] = starts[:3]
    starts[3], ends[3] = 0, n
    s, e = _i32(starts).cuda(), _i32(ends).cuda()
    before = fq.launch_count()
    got = fq.flatfat_query(forest, rows, s, e, comb, neutral).cpu().numpy()
    torch.cuda.synchronize()
    assert fq.launch_count() == before + 1
    want = fq.flatfat_query_plain(forest, rows, s, e, comb,
                                  neutral).cpu().numpy()
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_non_kernel_combine_raises_naming_the_roadmap_item():
    tree = torch.zeros(16, device="cuda")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A7b"):
        fq.flatfat_query(tree, None, _i32([0]).cuda(), _i32([4]).cuda(),
                         lambda a, b: a + b, 0.0)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A7b"):
        WindowComputeEngine(("ffat", torch.mul, 1.0), device="cuda")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A7b"):
        WinSeqFFATResidentLogic(lambda t: t.value, torch.mul, 1.0, 64, 16,
                                device="cuda")


def _run_logic(lg, n, chunk=500, n_keys=3):
    out = []
    for c in range(0, n, chunk):
        idx = np.arange(c, min(c + chunk, n))
        lg.svc(TupleBatch({"key": idx % n_keys, "id": idx // n_keys,
                           "ts": idx // n_keys,
                           "value": (idx % 7).astype(np.float64)}),
               0, out.append)
    lg.eos_flush(out.append)
    return {(r.key, r.id): (r.value, r.ts) for r in out}


@pytest.mark.parametrize("lane", ["pane", "ffat_resident", "ffat_rebuild"])
def test_lane_on_the_card_matches_the_cpu_and_launches_per_batch(lane):
    """Each lane of the kernel on CUDA against the same lane on the CPU,
    with one K2 launch per launched batch."""
    def make(device):
        if lane == "ffat_resident":
            return WinSeqFFATResidentLogic(lambda t: t.value, torch.add, 0.0,
                                           512, 16, device=device)
        kind = "sum" if lane == "pane" else ("ffat", torch.maximum, -np.inf)
        return WinSeqTPULogic(kind, 256, 32, wf.WinType.CB, batch_len=16,
                              resident=True if lane == "pane" else None,
                              value_of=lambda t: t.value, device=device)

    want = _run_logic(make("cpu"), 6000)
    lg = make("cuda")
    fq.reset_launch_count()
    fq.reset_fused_launch_count()
    fq.reset_build_query_launch_count()
    got = _run_logic(lg, 6000)
    assert want and got == want
    # the resident lanes run only the fused update+query kernel, the
    # rebuild lane only the fused build+query kernel
    counts = {"update": fq.fused_launch_count(),
              "build": fq.build_query_launch_count(),
              "query": fq.launch_count()}
    mine = "build" if lane == "ffat_rebuild" else "update"
    assert counts.pop(mine) == lg.launched_batches > 0
    assert counts == {k: 0 for k in counts}


# ---------------------------------------------------------------------------
# the fused FlatFAT update+query kernel
# ---------------------------------------------------------------------------

def _fused_case(case, rng):
    """(K, n, runs (rows, starts, lens), windows (rows, starts, ends)) in
    id space: ring wrap of runs and windows, several runs on one row,
    empty runs, rows with windows but no run, windows of 0 and n
    leaves."""
    if case == "n16":
        return 3, 16, ([0, 0, 1], [14, 18, 5], [4, 3, 0]), \
            ([0, 0, 0, 2, 2, 1, 0], [10, 0, 20, 5, 30, 7, 16],
             [26, 16, 20, 9, 40, 8, 21])
    if case == "n2":
        return 2, 2, ([1], [1], [2]), ([0, 1, 1, 1, 1], [0, 1, 1, 0, 3],
                                       [2, 3, 2, 0, 4])
    if case == "empty":
        return 2, 16, ([], [], []), ([], [], [])
    K, n = 6, 256
    rows, starts, lens = [], [], []
    for r in range(K - 1):  # the last row gets windows only
        pos = int(rng.integers(0, 4 * n))
        for _ in range(int(rng.integers(1, 4))):  # consecutive runs
            ln = int(rng.integers(0, 65))
            rows.append(r)
            starts.append(pos)
            lens.append(ln)
            pos += ln
    B = 200
    q_rows = rng.integers(0, K, B)
    q_starts = rng.integers(0, 4 * n, B)
    q_ends = q_starts + rng.integers(0, n + 1, B)
    return K, n, (rows, starts, lens), (q_rows, q_starts, q_ends)


@pytest.mark.parametrize("name", list(COMBINES))
@pytest.mark.parametrize("case", ["random", "n16", "n2", "empty"])
def test_fused_kernel_matches_plain(case, name):
    """One step of the fused kernel against its plain version on the
    same packed inputs: equal results and equal forests after it; one
    launch, none for an empty step."""
    comb, neutral, exact = COMBINES[name]
    rng = np.random.default_rng(40)
    K, n, (rows, starts, lens), (q_rows, q_starts, q_ends) = \
        _fused_case(case, rng)
    forest = torch.stack([build_tree(torch.from_numpy(
        rng.integers(0, 100, n).astype(np.float32)), comb, neutral)
        for _ in range(K)]).cuda()
    values = rng.integers(0, 100, int(np.sum(lens))).astype(np.float32)
    buf, sizes = pack_step(n, K, rows, starts, lens, values, q_rows,
                           q_starts, q_ends, pinned=True)
    inputs = step_inputs(buf.cuda(), sizes)
    want_forest = forest.clone()
    before = fq.fused_launch_count()
    got = fq.flatfat_update_query(forest, inputs, comb, neutral)
    torch.cuda.synchronize()
    assert fq.fused_launch_count() == before + (case != "empty")
    want = fq.flatfat_update_query_plain(want_forest, inputs, comb, neutral)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert got.shape == (len(q_rows),)
    if exact:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(forest.cpu().numpy(),
                                      want_forest.cpu().numpy())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(forest.cpu().numpy(),
                                   want_forest.cpu().numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_fused_non_kernel_combine_raises_naming_the_roadmap_item():
    buf, sizes = pack_step(8, 1, [0], [0], [1], [1.0], [0], [0], [1])
    with pytest.raises(NotImplementedError, match="ROADMAP.md A7b"):
        fq.flatfat_update_query(torch.zeros((1, 16), device="cuda"),
                                step_inputs(buf.cuda(), sizes),
                                lambda a, b: a + b, 0.0)


# ---------------------------------------------------------------------------
# the fused build+query kernel (the FFAT rebuild lane)
# ---------------------------------------------------------------------------

def _build_query_case(case, rng):
    """(n, se [2, B]): the rebuild lane's launch shape (config 15: 8 keys
    x 512 windows of 4096 sliding by 16), two tiles with the edges, two
    tiling rounds (4096 tile roots), and a batch of empty windows."""
    if case == "rebuild":
        n, per_key = 1 << 17, 4096 + 511 * 16
        starts = (np.repeat(np.arange(8) * per_key, 512)
                  + np.tile(np.arange(512) * 16, 8))
        return n, np.stack([starts, starts + 4096])
    if case == "empty":
        return 2048, np.stack([np.arange(100), np.arange(100) // 2])
    n = 2048 if case == "two_tiles" else 1 << 22
    starts = rng.integers(0, n, 500)
    ends = np.minimum(starts + rng.integers(0, 5000, 500), n)
    for i, (a, b) in enumerate([(0, n), (n - 1, n), (5, 5), (9, 3),
                                (1021, 1027), (n, n), (0, 1)]):
        starts[i], ends[i] = a, b
    return n, np.stack([starts, ends])


@pytest.mark.parametrize("name", list(COMBINES))
@pytest.mark.parametrize("case", ["rebuild", "two_tiles", "two_rounds",
                                  "empty"])
def test_build_query_kernel_matches_plain(case, name):
    """One launch of the fused build+query kernel against build_tree,
    the plain query and the where, bitwise, on integer and random f32
    leaves."""
    comb, neutral, _exact = COMBINES[name]
    rng = np.random.default_rng(50)
    n, se = _build_query_case(case, rng)
    se = _i32(se).cuda()
    for leaves in (rng.integers(0, 97, n), rng.normal(size=n)):
        v = torch.from_numpy(leaves.astype(np.float32)).cuda()
        before = fq.build_query_launch_count()
        got = fq.flatfat_build_query(v, se, comb, neutral)
        torch.cuda.synchronize()
        assert fq.build_query_launch_count() == before + 1
        want = fq.flatfat_build_query_plain(v, se, comb, neutral)
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      want.cpu().numpy())


def test_build_query_non_kernel_combine_raises_naming_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP.md A7b"):
        fq.flatfat_build_query(torch.zeros(2048, device="cuda"),
                               _i32([[0], [4]]).cuda(), lambda a, b: a + b,
                               0.0)


def test_cuda_ffat_engine_launches_one_build_query_per_batch():
    rng = np.random.default_rng(51)
    T, B = 70_000, 3000
    starts = rng.integers(0, T - 4096, B)
    ends = starts + rng.integers(0, 4097, B)
    cols = {"value": rng.integers(0, 97, T).astype(np.float64)}
    gwids = np.arange(B, dtype=np.int64)
    for comb, neutral in ((torch.add, 0.0), (torch.maximum, -np.inf)):
        eng = WindowComputeEngine(("ffat", comb, neutral), device="cuda")
        before = (fq.build_query_launch_count(), fq.launch_count())
        with eng.launch_context():
            got = eng.compute(cols, starts, ends, gwids).block()
        assert (fq.build_query_launch_count(), fq.launch_count()) == \
            (before[0] + 1, before[1])
        want = WindowComputeEngine(("ffat", comb, neutral),
                                   device="cpu").compute(
            cols, starts, ends, gwids).block()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the window-sum kernel, its engine and the headline graph
# ---------------------------------------------------------------------------

WS_CASES = ["random", "empty", "single", "crosses_128_lanes", "end_is_T"]


def _ws_extents(case, rng):
    """(T, starts, ends) for one named case."""
    if case == "random":
        T = 3000
        starts = np.sort(rng.integers(0, 2500, 24))
        return T, starts, starts + rng.integers(1, 400, 24)
    if case == "empty":
        return 300, np.array([0, 5, 299, 300]), np.array([0, 5, 299, 300])
    if case == "single":
        return 300, np.array([0, 17, 299]), np.array([1, 18, 300])
    if case == "crosses_128_lanes":
        return 1024, np.array([127, 100, 250, 0]), np.array([129, 300, 640,
                                                             1024])
    return 777, np.array([0, 700, 776, 777]), np.array([777, 777, 777, 777])


def _se(starts, ends):
    return torch.from_numpy(np.stack([starts, ends]).astype(np.int32))


@pytest.mark.parametrize("case", WS_CASES)
def test_cuda_kernel_matches_plain(case):
    """The window-sum kernel against its plain version (exact on integer
    data) and the float64 sum (rtol 1e-5 on f32)."""
    rng = np.random.default_rng(20 + WS_CASES.index(case))
    T, starts, ends = _ws_extents(case, rng)
    se = _se(starts, ends).cuda()
    for integer in (True, False):
        vals = (rng.integers(0, 97, T) if integer
                else rng.normal(size=T)).astype(np.float32)
        v = torch.from_numpy(vals).cuda()
        before = ws.launch_count()
        got = ws.window_sums(v, se).cpu().numpy()
        torch.cuda.synchronize()
        assert ws.launch_count() == before + 1
        c = np.concatenate([[0.0], np.cumsum(vals.astype(np.float64))])
        if integer:
            np.testing.assert_array_equal(got, c[ends] - c[starts])
            np.testing.assert_array_equal(
                got, ws.window_sums_plain(v, se).cpu().numpy())
        else:
            np.testing.assert_allclose(got, c[ends] - c[starts], rtol=1e-5,
                                       atol=1e-5)


def _form_extents(case, rng):
    """(T, starts, ends, max_extent) at the main paths' launch shapes:
    the headline's 2-pane windows, the pane-rebuild cell's 64 panes, the
    wide raw-tuple shape, and edges past the buffer's ends."""
    if case == "headline":
        per_key = np.arange(64)
        starts = (np.arange(64)[:, None] * 65 + per_key[None, :]).ravel()
        return 64 * 65, starts, starts + 2, 2
    if case == "pane":
        starts = (np.arange(8)[:, None] * 191
                  + np.arange(128)[None, :]).ravel()
        return 8 * 191, starts, starts + 64, 64
    if case == "wide":
        T = 1 << 21
        starts = rng.integers(0, T - 4096, 4096)
        return T, starts, starts + rng.integers(1, 4097, 4096), 4096
    starts = np.array([-5, 0, 3, 4999, 5000, 10, 7, 33])
    ends = np.array([3, 5000, 3, 5003, 5000, 42, 6, 66])
    return 5000, starts, ends, 33


@pytest.mark.parametrize("form", ["thread", "warp"])
@pytest.mark.parametrize("case", ["headline", "pane", "wide", "edges"])
def test_window_sum_forms_match_plain(case, form):
    """Each form of the window-sum kernel at each main-path shape (the
    hint names the form; either form is right for any extent): exact on
    integer data against the plain version and the float64 sum, rtol
    1e-5 on random f32."""
    rng = np.random.default_rng(52)
    T, starts, ends, widest = _form_extents(case, rng)
    hint = min(widest, 32) if form == "thread" else None
    assert ws.form_for(hint) == form
    se = _se(starts, ends).cuda()
    s, e = np.clip(starts, 0, T), np.clip(ends, 0, T)
    # integer data: every prefix sum below 2^24, so the plain version's
    # prefix scan is exact too
    hi = min(97, (1 << 24) // T)
    for integer in (True, False):
        vals = (rng.integers(0, hi, T) if integer
                else rng.random(T)).astype(np.float32)
        v = torch.from_numpy(vals).cuda()
        got = ws.window_sums(v, se, max_extent=hint).cpu().numpy()
        c = np.concatenate([[0.0], np.cumsum(vals.astype(np.float64))])
        want = np.where(e > s, c[e] - c[np.minimum(s, e)], 0.0)
        if integer:
            np.testing.assert_array_equal(got, want)
            if case != "edges":  # the plain version does not clamp
                np.testing.assert_array_equal(
                    got, ws.window_sums_plain(v, se).cpu().numpy())
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["sum", "count", "mean", "max", "min",
                                  "mean_panes"])
def test_cuda_engine_matches_cpu_engine(kind):
    """The CUDA lane of the engine (the window-sum kernel for the sum
    kinds) against its CPU lane, exact on integer data; one kernel
    launch per sum operand."""
    rng = np.random.default_rng(5)
    T, B, max_w = 5000, 3000, 16
    lens = rng.integers(0, max_w + 1, B)
    starts = rng.integers(0, T - max_w, B)
    ends = starts + lens
    cols = {"value": rng.integers(0, 97, T).astype(np.float64),
            "count": rng.integers(1, 50, T).astype(np.float64)}
    gwids = np.arange(B, dtype=np.int64)
    eng = WindowComputeEngine(kind, device="cuda")
    before = ws.launch_count()
    with eng.launch_context():
        h = eng.compute(cols, starts, ends, gwids)
    got = h.block()
    launches = {"sum": 1, "mean": 1, "mean_panes": 2}.get(kind, 0)
    assert ws.launch_count() - before == launches
    want = WindowComputeEngine(kind, device="cpu").compute(
        cols, starts, ends, gwids).block()
    np.testing.assert_array_equal(got, want)


def _headline(device):
    """The headline graph (bench.py config 2's law at a small size:
    SynthChunk BatchSource -> WinSeqTPU("sum", TB 64/32) -> Sink) with
    size-based launch triggers; returns (graph, keys, ids, values)."""
    n_events, n_keys, source_batch = 200_000, 64, 20_000
    chunks = iter(range(0, n_events, source_batch))
    out = []

    def source(ctx):
        i = next(chunks, None)
        return None if i is None else SynthChunk(
            i, min(source_batch, n_events - i), n_keys, 97, 1.0, 0.0)

    def sink(item):
        if item is not None:
            out.append(item)

    g = wf.PipeGraph("headline", wf.Mode.DEFAULT,
                     config=wf.RuntimeConfig(device=device))
    op = WinSeqTPU("sum", 64, 32, wf.WinType.TB, batch_len=512,
                   emit_batches=True, max_buffer_elems=1 << 21,
                   inflight_depth=8, max_batch_delay_ms=1e9)
    g.add_source(BatchSource(source, 1)).add(op).add_sink(Sink(sink))
    g.run()
    cols = [np.concatenate([np.asarray(c) for c in col]) for col in
            zip(*((b.key, b.id, b["value"]) for b in out))]
    return (g, *cols)


def test_headline_graph_on_the_card_launches_the_kernel_per_batch():
    want = _headline("cpu")[1:]
    ws.reset_launch_count()
    g, *got = _headline("cuda")
    logic = next(lg for node in g._all_nodes() for lg in
                 ([s.logic for s in node.logic.segments]
                  if isinstance(node.logic, FusedLogic) else [node.logic])
                 if isinstance(lg, WinSeqTPULogic))
    assert logic.device.type == "cuda"
    assert ws.launch_count() == logic.launched_batches > 0
    np.testing.assert_array_equal(got[0], want[0])  # keys, in order
    np.testing.assert_array_equal(got[1], want[1])  # ids, in order
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=0)
