"""The port's kernels and the lanes that run them, on the card: the
window-sum kernel (K1, both forms), the FlatFAT query kernel (K2), the
fused FlatFAT update+query kernel and the fused build+query kernel of
the FFAT rebuild lane against their plain versions, the engines,
the headline graph, the resident lanes and the device farms (KeyFarmTPU
coalesced and not, PaneFarmTPU fused at LEVEL2, a custom window
function) on CUDA against the same on the CPU, one kernel launch per
launched batch; the application models (the Yahoo step against its CPU
run, NEXMark Q5 and Q7 against their numpy oracles: Q5's count windows
launch the window-sum kernel once a batch, Q7's max none); the resident
FFAT forest repartitioned 1 -> 3 -> 1 across replicas on the card as
the elastic plane moves keyed state.  The three
FlatFAT kernels run every combine: the builtins and user combines
compiled from their torch ops into a library of their own (a product,
``logaddexp``, a NaN-skipping max written with ``where``, and
``left_weighted``), counted apart; a combine that cannot be lowered
raises ValueError when it is bound to the card.

This file imports neither jax nor the reference package, so it runs
where the card is:

    python -m pytest -m cuda tests/test_torch_card.py

Every test is marked ``cuda`` and skips without a card.  Tolerances:
exact for max/min, for add on integer-valued data and for the arithmetic
user combines (one correctly rounded intrinsic an op, in the plain
version's order); ``rtol=1e-5`` for the non-commutative
``left_weighted`` in the query kernels, for sums of random f32 data (the
kernel and the float64 sum add in other orders) and for ``logaddexp``
(the kernel's expf/log1pf against torch's own, over a fold of up to
~2 log2(n) + 1 combines).  The build+query kernel is exact for every
other combine and any data: it combines the very pairs the plain
version combines.  So is the query kernel, bit for bit over leaves that
hold +0, -0 and NaN, with ``logaddexp`` within 64 ulp.
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
from windflow_tpu_torch.operators.tpu.farms_tpu import (KeyFarmTPU,
                                                        PaneFarmTPU)
from windflow_tpu_torch.runtime.node import ChainedLogic, FusedLogic

from torch_graphs import (PORT, USER_EXACT, USER_RTOL, assert_same_bits,
                          left_weighted, q5_oracle, q7_oracle, signed_zeros,
                          user_combines, user_values)

pytestmark = pytest.mark.cuda

# name -> (combine, neutral, exact)
COMBINES = {"add": (torch.add, 0.0, True),
            "max": (torch.maximum, -np.inf, True),
            "min": (torch.minimum, np.inf, True),
            "left_weighted": (left_weighted, 0.0, False)}
# the user combines no kernel builds in: compiled from their torch ops
USER = ("mul", "logaddexp", "where_max")
COMBINES.update({name: (c, neutral, USER_EXACT[name])
                 for name, (c, neutral) in user_combines(PORT).items()
                 if name in USER})


def _vals(name, rng, size):
    """Integer-valued leaves, or a user combine's own law (near 1 for
    the product, NaNs among them for the NaN-skipping max)."""
    if name in USER:
        return user_values(name, rng, size)
    return rng.integers(0, 100, size).astype(np.float32)


def _check(got, want, exact):
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=USER_RTOL, atol=1e-6)


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m cuda tests/test_torch_card.py)")


def _i32(a):
    return torch.from_numpy(np.asarray(a, np.int32))


def _kernel_cases():
    """(name, n): every combine at n = 2^8 (under the ids these cases
    had before n varied), 2^7 and 2^9 -- level counts either side of the
    kernel's chunk of walk steps -- and 2^16, 2^17."""
    cases = []
    for name in COMBINES:
        cases.append(pytest.param(name, 256, id=name))
        cases += [pytest.param(name, n, id=f"{name}-n{n}")
                  for n in (128, 512, 1 << 16, 1 << 17)]
    return cases


def _ulps(got, want):
    """The largest distance in f32 ulps of two arrays whose NaNs sit at
    the same places."""
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)

    def ordered(a):
        i = a[~nan].view(np.int32).astype(np.int64)
        return np.where(i >= 0, i, -(i & 0x7FFFFFFF))

    return int(np.abs(ordered(got) - ordered(want)).max(initial=0))


@pytest.mark.parametrize("name,n", _kernel_cases())
def test_kernel_matches_plain(name, n):
    """A forest query with empty, whole-row, reversed, clamped and
    random extents, rows outside the forest among them, over leaves that
    hold +0, -0 and NaN: one launch, bitwise equal to the plain version
    (both fold the same nodes in the same order from the neutral), and
    logaddexp within 64 ulp of it (the kernel's expf/log1pf against
    torch's own)."""
    comb, neutral, _exact = COMBINES[name]
    rng = np.random.default_rng(30)
    K, B = 5, 300

    def leaves():
        v = _vals(name, rng, n)
        v[rng.integers(0, n, n // 8)] = 0.0
        v[rng.integers(0, n, n // 8)] = -0.0
        v[rng.integers(0, n, 2)] = np.nan
        return torch.from_numpy(v)

    forest = torch.stack([build_tree(leaves(), comb, neutral)
                          for _ in range(K)]).cuda()
    rows = rng.integers(0, K, B)
    rows[[4, 5]] = -1, K
    starts = rng.integers(0, n, B)
    ends = np.minimum(starts + rng.integers(0, n, B), n)
    ends[:3] = starts[:3]
    starts[3], ends[3] = 0, n
    # reversed, then clamped at both ends
    starts[6:9], ends[6:9] = (n - 1, 5, -7), (3, 1, n + 9)
    starts[9], ends[9] = -n, 2 * n
    r, s, e = (_i32(a).cuda() for a in (rows, starts, ends))
    before = fq.launch_count()
    users = fq.user_launch_counts()["flatfat_query"]
    got = fq.flatfat_query(forest, r, s, e, comb, neutral).cpu().numpy()
    torch.cuda.synchronize()
    assert fq.launch_count() == before + 1
    assert fq.user_launch_counts()["flatfat_query"] == \
        users + (fq.builtin_op(comb) is None)
    want = fq.flatfat_query_plain(forest, r, s, e, comb,
                                  neutral).cpu().numpy()
    assert np.isnan(got[[4, 5]]).all()
    if name == "logaddexp":
        assert _ulps(got, want) <= 64
    else:
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def _zero_call(path, kind, device):
    """One max or min call of ``path`` on ``device`` over +0/-0 values
    with NaN (the same draw on every device), as numpy."""
    from windflow_tpu_torch.parallel.mesh import make_mesh
    from windflow_tpu_torch.parallel.sharded import ShardedWindowEngine
    rng = np.random.default_rng(["sparse_table", "wmr", "pf_ring",
                                 "kf"].index(path))
    if path == "sparse_table":  # the engine's max/min kinds
        T, B = 3000, 2000
        vals = signed_zeros(rng, T, kind, n_nan=3).astype(np.float64)
        starts = rng.integers(0, T - 64, B)
        ends = starts + rng.integers(0, 65, B)
        return WindowComputeEngine(kind, device=device).compute(
            {"value": vals}, starts, ends, np.arange(B)).block()
    if path == "kf":  # K2r over 8 shards' rows laid end to end
        S, T, B = 8, 1 << 10, 300
        values = signed_zeros(rng, (S, T), kind, n_nan=3)
        starts = rng.integers(0, T - 64, (S, B)).astype(np.int32)
        ends = (starts + rng.integers(0, 65, (S, B))).astype(np.int32)
        eng = ShardedWindowEngine(make_mesh(S, device=device), 64, 32, kind)
        return eng.compute_kf(values, starts, ends).cpu().numpy()
    if path == "wmr":  # _fold over the stripes, pmax / pmin over 'win'
        eng = ShardedWindowEngine(make_mesh(8, win_axis=4, device=device),
                                  8, 4, kind)
        stripes = signed_zeros(rng, (16, 4, 32, 64), kind, n_nan=3,
                               zero_rate=0.03)
        return eng.compute_wmr(stripes).cpu().numpy()
    eng = ShardedWindowEngine(make_mesh(8, win_axis=4, device=device), 32,
                              8, kind)
    panes = signed_zeros(rng, (16, 32, 4), kind, n_nan=3, zero_rate=0.1)
    return eng.compute_pf_ring(panes, 4).cpu().numpy()


@pytest.mark.parametrize("path", ["sparse_table", "wmr", "pf_ring", "kf"])
@pytest.mark.parametrize("kind", ["max", "min"])
def test_signed_zero_folds_on_the_card_match_the_cpu(kind, path):
    """Max and min over +0/-0 values with NaN on CUDA: the engine's
    sparse table, ``_fold`` in compute_wmr and compute_pf_ring and
    compute_kf's K2r, bit for bit the same call on the CPU (which the
    CPU twins hold against the reference, ROADMAP C12); K2r under the
    builtin kind launches the shared library, no user library."""
    users = dict(fq.user_launch_counts())
    before = fq.build_query_launch_count()
    got = _zero_call(path, kind, "cuda")
    torch.cuda.synchronize()
    assert fq.build_query_launch_count() == before + (path == "kf")
    assert fq.user_launch_counts() == users
    want = _zero_call(path, kind, "cpu")
    assert (want == 0).any()
    assert_same_bits(got, want)


def test_non_kernel_combine_raises_naming_the_roadmap_item():
    """A combine no kernel builds in resolves on the card into its own
    library (the query kernel, the ffat engine and the resident logic
    all take it); one that cannot be lowered raises ValueError where it
    is bound to the card, before any launch."""
    tree = build_tree(torch.arange(16, dtype=torch.float32).cuda(),
                      lambda a, b: a + b, 0.0)
    got = fq.flatfat_query(tree, None, _i32([0]).cuda(), _i32([4]).cuda(),
                           lambda a, b: a + b, 0.0)
    assert got.cpu().numpy().tolist() == [6.0]
    k = fq.resolve_combine(torch.mul)
    assert k.user and k.code == fq.USER_OP
    assert WindowComputeEngine(("ffat", torch.mul, 1.0),
                               device="cuda")._ffat_combine.lib is k.lib
    WinSeqFFATResidentLogic(lambda t: t.value, torch.mul, 1.0, 64, 16,
                            device="cuda")

    def branchy(a, b):
        return a if a > b else b

    with pytest.raises(ValueError, match="control flow"):
        WindowComputeEngine(("ffat", branchy, 0.0), device="cuda")
    with pytest.raises(ValueError, match="control flow"):
        WinSeqFFATResidentLogic(lambda t: t.value, branchy, 0.0, 64, 16,
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


@pytest.mark.parametrize("lane", ["pane", "ffat_resident", "ffat_rebuild",
                                  "ffat_resident_user", "ffat_rebuild_user"])
def test_lane_on_the_card_matches_the_cpu_and_launches_per_batch(lane):
    """Each lane of the kernel on CUDA against the same lane on the CPU,
    with one K2 launch per launched batch; the FFAT lanes also under a
    user combine (torch.logaddexp, neutral -inf: every launch one of its
    generated library, values within rtol 1e-5 of the CPU's)."""
    user = lane.endswith("_user")
    comb, neutral = ((torch.logaddexp, -np.inf) if user else
                     (torch.add, 0.0) if lane.startswith("ffat_resident")
                     else (torch.maximum, -np.inf))

    def make(device):
        if lane.startswith("ffat_resident"):
            return WinSeqFFATResidentLogic(lambda t: t.value, comb, neutral,
                                           512, 16, device=device)
        kind = "sum" if lane == "pane" else ("ffat", comb, neutral)
        return WinSeqTPULogic(kind, 256, 32, wf.WinType.CB, batch_len=16,
                              resident=True if lane == "pane" else None,
                              value_of=lambda t: t.value, device=device)

    want = _run_logic(make("cpu"), 6000)
    lg = make("cuda")
    fq.reset_launch_count()
    fq.reset_fused_launch_count()
    fq.reset_build_query_launch_count()
    fq.reset_user_launch_counts()
    got = _run_logic(lg, 6000)
    assert want and sorted(got) == sorted(want)
    if user:
        keys = sorted(want)
        np.testing.assert_allclose([got[k][0] for k in keys],
                                   [want[k][0] for k in keys],
                                   rtol=USER_RTOL, atol=0)
        assert [got[k][1] for k in keys] == [want[k][1] for k in keys]
    else:
        assert got == want
    # the resident lanes run only the fused update+query kernel, the
    # rebuild lane only the fused build+query kernel
    counts = {"update": fq.fused_launch_count(),
              "build": fq.build_query_launch_count(),
              "query": fq.launch_count()}
    mine = "build" if lane.startswith("ffat_rebuild") else "update"
    assert counts[mine] == lg.launched_batches > 0
    entry = {"build": "flatfat_build_query",
             "update": "flatfat_update_query"}[mine]
    assert fq.user_launch_counts()[entry] == (counts[mine] if user else 0)
    counts.pop(mine)
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
        _vals(name, rng, n)), comb, neutral) for _ in range(K)]).cuda()
    values = _vals(name, rng, int(np.sum(lens)))
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
    _check(got, want, exact)
    _check(forest.cpu().numpy(), want_forest.cpu().numpy(), exact)


def test_fused_non_kernel_combine_raises_naming_the_roadmap_item():
    """A combine no kernel builds in runs the fused kernel through its
    own library, counted as a user launch; one that cannot be lowered
    raises ValueError before any launch."""
    buf, sizes = pack_step(8, 1, [0], [0], [1], [1.0], [0], [0], [1])
    users = fq.user_launch_counts()["flatfat_update_query"]
    got = fq.flatfat_update_query(torch.zeros((1, 16), device="cuda"),
                                  step_inputs(buf.cuda(), sizes),
                                  lambda a, b: a + b, 0.0)
    assert got.cpu().numpy().tolist() == [1.0]
    assert fq.user_launch_counts()["flatfat_update_query"] == users + 1
    with pytest.raises(ValueError, match="the op"):
        fq.flatfat_update_query(torch.zeros((1, 16), device="cuda"),
                                step_inputs(buf.cuda(), sizes),
                                lambda a, b: torch.sin(a) + b, 0.0)


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
    datas = ((user_values(name, rng, n), user_values(name, rng, n))
             if name in USER else (rng.integers(0, 97, n),
                                   rng.normal(size=n)))
    for leaves in datas:
        v = torch.from_numpy(leaves.astype(np.float32)).cuda()
        before = fq.build_query_launch_count()
        got = fq.flatfat_build_query(v, se, comb, neutral)
        torch.cuda.synchronize()
        assert fq.build_query_launch_count() == before + 1
        want = fq.flatfat_build_query_plain(v, se, comb, neutral)
        _check(got.cpu().numpy(), want.cpu().numpy(),
               USER_EXACT.get(name, True))


def test_build_query_non_kernel_combine_raises_naming_the_roadmap_item():
    """A combine no kernel builds in runs the build+query kernel through
    its own library; one that cannot be lowered raises ValueError."""
    got = fq.flatfat_build_query(torch.ones(2048, device="cuda"),
                                 _i32([[0], [4]]).cuda(), lambda a, b: a + b,
                                 0.0)
    assert got.cpu().numpy().tolist() == [4.0]
    with pytest.raises(ValueError, match="result"):
        fq.flatfat_build_query(torch.zeros(2048, device="cuda"),
                               _i32([[0], [4]]).cuda(), lambda a, b: a > b,
                               0.0)


def test_cuda_ffat_engine_launches_one_build_query_per_batch():
    rng = np.random.default_rng(51)
    T, B = 70_000, 3000
    starts = rng.integers(0, T - 4096, B)
    ends = starts + rng.integers(0, 4097, B)
    cols = {"value": rng.integers(0, 97, T).astype(np.float64)}
    gwids = np.arange(B, dtype=np.int64)
    for comb, neutral in ((torch.add, 0.0), (torch.maximum, -np.inf),
                          (left_weighted, 0.0)):
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


def _device_logics(g):
    """Every device window engine of a graph, fused stages' halves
    included."""
    found = []
    for node in g._all_nodes():
        for lg in ([seg.logic for seg in node.logic.segments]
                   if isinstance(node.logic, FusedLogic) else [node.logic]):
            halves = [lg.a, lg.b] if isinstance(lg, ChainedLogic) else [lg]
            found += [h for h in halves if isinstance(h, WinSeqTPULogic)]
    return found


def _sum_of_squares(gwid, cols, mask):
    v = torch.where(mask, cols["value"], 0.0)
    return torch.sum(v * v)


FARMS = {
    "key_farm": lambda: KeyFarmTPU(
        "sum", 64, 32, wf.WinType.TB, parallelism=2, batch_len=512,
        emit_batches=True, max_batch_delay_ms=1e9),
    "key_farm_par2": lambda: KeyFarmTPU(
        "sum", 64, 32, wf.WinType.TB, parallelism=2, coalesce=False,
        batch_len=512, emit_batches=True, max_batch_delay_ms=1e9),
    "pane_farm_level2": lambda: PaneFarmTPU(
        "sum", "sum", 64, 32, wf.WinType.TB, batch_len=512,
        opt_level=wf.OptLevel.LEVEL2, emit_batches=True,
        max_batch_delay_ms=1e9),
    "custom": lambda: KeyFarmTPU(
        _sum_of_squares, 64, 32, wf.WinType.TB, parallelism=2,
        batch_len=512, emit_batches=True, max_batch_delay_ms=1e9),
}


def _farm_rows(farm, device):
    """The headline's stream law at a small size through one device
    farm; returns (graph, key -> [(id, value)] in arrival order)."""
    n_events, n_keys, source_batch = 100_000, 16, 10_000
    chunks = iter(range(0, n_events, source_batch))
    rows = {}

    def source(ctx):
        i = next(chunks, None)
        return None if i is None else SynthChunk(
            i, min(source_batch, n_events - i), n_keys, 97, 1.0, 0.0)

    def sink(item):
        if item is None:
            return
        for k, i, v in zip(np.asarray(item.key).tolist(),
                           np.asarray(item.id).tolist(),
                           np.asarray(item["value"]).tolist()):
            rows.setdefault(k, []).append((i, v))

    g = wf.PipeGraph("farm", wf.Mode.DEFAULT,
                     config=wf.RuntimeConfig(device=device))
    g.add_source(BatchSource(source, 1)).add(FARMS[farm]()) \
        .add_sink(Sink(sink))
    g.run()
    return g, rows


@pytest.mark.parametrize("farm", list(FARMS))
def test_device_farm_on_the_card_matches_the_cpu(farm):
    """Every window of the farm on the card equals the CPU run's (per
    key, in arrival order; exact on these integer values); the builtin
    sum stages launch the window-sum kernel once per batch, the custom
    window function never."""
    _g, want = _farm_rows(farm, "cpu")
    ws.reset_launch_count()
    g, got = _farm_rows(farm, "cuda")
    logics = _device_logics(g)
    assert logics and all(lg.device.type == "cuda" for lg in logics)
    batches = sum(lg.launched_batches for lg in logics)
    assert batches > 0
    assert ws.launch_count() == (0 if farm == "custom" else batches)
    assert got == want


# ---------------------------------------------------------------------------
# the application models (models/yahoo.py, models/nexmark.py)
# ---------------------------------------------------------------------------

def _hand_kernel_launches():
    return (ws.launch_count(), fq.launch_count(), fq.fused_launch_count(),
            fq.build_query_launch_count())


@pytest.mark.parametrize("shape", [(10, 4, 256), (100, 8, 1024)])
def test_yahoo_step_on_the_card_matches_the_cpu(shape):
    """make_step with its default device runs on the card (numpy inputs
    go there, CUDA tensors stay); the counts equal the CPU run's
    exactly (whole numbers below 2^24)."""
    from windflow_tpu_torch.models import yahoo
    n_campaigns, n_windows, win_len = shape
    args = yahoo.example_step_args(n_campaigns=n_campaigns,
                                   n_windows=n_windows, win_len=win_len)
    want = yahoo.make_step(*shape, device="cpu")(*args)
    got = yahoo.make_step(*shape)(*args)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    got_t = yahoo.make_step(*shape, device="cpu")(
        *(torch.as_tensor(a).cuda() for a in args))
    assert got_t.device.type == "cuda"
    np.testing.assert_array_equal(got_t.cpu().numpy(), want.numpy())


def _model_table(build, kernel):
    """Run a models graph on the card (the default RuntimeConfig);
    returns {(key, id): value}.  Count windows sum their per-pane counts
    with the window-sum kernel, once a batch (``kernel``); max is a
    torch program: no hand kernel launched (``kernel=False``)."""
    rows = {}

    def sink(item):
        if item is None:
            return
        if hasattr(item, "cols"):
            rows.update(zip(zip(np.asarray(item.key).tolist(),
                                np.asarray(item.id).tolist()),
                            np.asarray(item["value"]).tolist()))
        else:
            rows[(item.key, item.id)] = item.value

    g = wf.PipeGraph("model", wf.Mode.DEFAULT)
    build(g, sink)
    before = _hand_kernel_launches()
    g.run()
    after = _hand_kernel_launches()
    logics = _device_logics(g)
    assert logics and all(lg.device.type == "cuda" for lg in logics)
    batches = sum(lg.launched_batches for lg in logics)
    assert batches > 0
    assert after == (before[0] + (batches if kernel else 0),) + before[1:]
    return rows


def test_q5_on_the_card_matches_the_oracle():
    from windflow_tpu_torch.models import nexmark
    N, NA, WINL, SL = 60_000, 40, 8192, 4096
    got = _model_table(lambda g, sink: nexmark.build_q5_hot_items(
        g, N, WINL, SL, sink, n_auctions=NA, batch_size=16_384,
        device_batch=512), kernel=True)
    assert got == q5_oracle(PORT, N, NA, WINL, SL, 16_384)


def test_q7_on_the_card_matches_the_oracle():
    from windflow_tpu_torch.models import nexmark
    N, WINL = 60_000, 10_000
    got = _model_table(lambda g, sink: nexmark.build_q7_highest_bid(
        g, N, WINL, sink, batch_size=16_384, device_batch=256),
        kernel=False)
    assert {i: v for (_k, i), v in got.items()} == \
        q7_oracle(PORT, N, WINL, 16_384)


def test_resident_lane_crash_restart_on_the_card(tmp_path):
    """The resident FFAT lane under the durability plane on the card:
    epochs snapshot the forest off the device, a crash on the engine
    restores it onto a fresh forest before the first fused launch of
    the new attempt, and every window reaches the sink once, equal to
    the closed form (integer values: exact)."""
    from windflow_tpu_torch.core import DurabilityConfig
    from windflow_tpu_torch.durability import run_with_epochs
    from windflow_tpu_torch.resilience import FaultPlan
    from torch_graphs import NO_CADENCE_S, dur_val, gated_source
    n, n_keys, win, slide = 20_000, 4, 96, 16
    wins, counts = {}, {}
    logics = []

    def sink(r):
        if r is not None:
            wins[(r.key, r.id)] = r.value
            counts[(r.key, r.id)] = counts.get((r.key, r.id), 0) + 1

    def factory(attempt):
        cfg = wf.RuntimeConfig(
            durability=DurabilityConfig(epoch_interval_s=NO_CADENCE_S,
                                        path=str(tmp_path / "epochs")),
            fault_plan=(FaultPlan(seed=9).crash_replica(
                "win_seqffat_tpu", at_tuple=12_000) if attempt == 0
                else None))
        g = wf.PipeGraph("card_resident", wf.Mode.DEFAULT, config=cfg)
        g.add_source(gated_source(PORT, n, n_keys,
                                  epochs_at=(4000, 8000, 16_000))) \
            .add(wf.WinSeqFFATTPUBuilder(lambda t: t.value, "sum")
                 .with_cb_windows(win, slide).build()) \
            .add_sink(wf.SinkBuilder(sink).with_exactly_once().build())
        return g

    fq.reset_fused_launch_count()
    g = run_with_epochs(factory, max_restarts=2)
    assert g._epoch_restored == 2
    for nd in g._all_nodes():
        for lg in ([s.logic for s in nd.logic.segments]
                   if isinstance(nd.logic, FusedLogic) else [nd.logic]):
            if isinstance(lg, WinSeqFFATResidentLogic):
                logics.append(lg)
    assert logics and logics[0].device.type == "cuda"
    assert logics[0].launched_batches > 0
    assert fq.fused_launch_count() > logics[0].launched_batches
    want = {}
    for k in range(n_keys):
        vals = [dur_val(i) for i in range(k, n, n_keys)]
        for w in range((len(vals) - 1) // slide + 1):
            want[(k, w)] = float(sum(vals[w * slide: w * slide + win]))
    assert max(counts.values()) == 1
    assert wins == want


def test_resident_forest_repartitions_across_replicas_on_the_card():
    """[rescale15]'s protocol at a small size: one resident FFAT logic on
    the card takes the first half of the stream; its keyed state goes
    through ``partition_keyed_state`` into 3 fresh logics on the card,
    which take the next quarter routed by ``owner_of``;
    ``merge_keyed_states`` brings it back into one logic, which finishes
    the stream.  Every window equals the unsplit lane's on the CPU and
    the closed form (integer values: exact); every forest stays on the
    card, and after each repartition each logic's fused update+query
    launches equal its launched batches, no other kernel launched."""
    from windflow_tpu_torch.elastic import (merge_keyed_states, owner_of,
                                            partition_keyed_state)
    n, n_keys, win, slide, chunk = 24_000, 8, 96, 16, 2_000

    def logic(device):
        return WinSeqFFATResidentLogic(lambda t: t.value, torch.add, 0.0,
                                       win, slide, device=device)

    def batch(lo, hi):
        idx = np.arange(lo, hi)
        return TupleBatch({"key": idx % n_keys, "id": idx // n_keys,
                           "ts": idx // n_keys,
                           "value": (idx % 7).astype(np.float64)})

    def flat(out):
        return {(r.key, r.id): r.value for r in out}

    cpu, want = logic("cpu"), []
    for c in range(0, n, chunk):
        cpu.svc(batch(c, c + chunk), 0, want.append)
    cpu.eos_flush(want.append)

    class Node:
        def __init__(self, lg):
            self.logic, self.name = lg, "win_seqffat_resident"

    def others():
        return (fq.launch_count(), fq.build_query_launch_count(),
                ws.launch_count())

    out, reps = [], [logic("cuda")]
    stages = {n // 2: 3, 3 * n // 4: 1}
    fq.reset_launch_count()
    fq.reset_build_query_launch_count()
    ws.reset_launch_count()
    for c in range(0, n, chunk):
        if c in stages:
            merged, stateful = merge_keyed_states([Node(r) for r in reps])
            assert stateful and set(merged) == set(range(n_keys))
            reps = [logic("cuda") for _ in range(stages[c])]
            for part, rep in zip(
                    partition_keyed_state(merged, len(reps)), reps):
                rep.load_keyed_state(part)
                assert rep.forest.tree.is_cuda
        b = batch(c, c + chunk)
        owners = np.array([owner_of(int(k), len(reps)) for k in b.key])
        for i, rep in enumerate(reps):
            sel = np.nonzero(owners == i)[0]
            if not len(sel):
                continue
            before = (fq.fused_launch_count(), rep.launched_batches)
            rep.svc(b.take(sel), 0, out.append)
            assert fq.fused_launch_count() - before[0] \
                == rep.launched_batches - before[1] > 0
    before = (fq.fused_launch_count(), reps[0].launched_batches)
    reps[0].eos_flush(out.append)
    assert fq.fused_launch_count() - before[0] \
        == reps[0].launched_batches - before[1]
    assert others() == (0, 0, 0)
    assert flat(out) == flat(want)
    for k in range(n_keys):
        vals = [float(i % 7) for i in range(k, n, n_keys)]
        for w in range((len(vals) - 1) // slide + 1):
            assert flat(out)[(k, w)] == float(sum(
                vals[w * slide: w * slide + win]))


def test_resident_forest_off_the_card_raises():
    """A resident logic bound to the card whose forest is on the host
    (a load that bypassed its device) raises on its next step; it never
    takes the kernel's plain version."""
    from windflow_tpu_torch.ops.flatfat_torch import BatchedFlatFAT
    lg = WinSeqFFATResidentLogic(lambda t: t.value, torch.add, 0.0, 96, 16,
                                 device="cuda")
    lg.forest = BatchedFlatFAT(torch.add, 0.0, 2, lg.capacity,
                               device="cpu")
    idx = np.arange(200)
    before = fq.fused_launch_count()
    with pytest.raises(RuntimeError, match="forest on cpu"):
        lg.svc(TupleBatch({"key": idx % 2, "id": idx // 2, "ts": idx // 2,
                           "value": np.ones(200)}), 0, lambda r: None)
    assert fq.fused_launch_count() == before


def test_q5_device_lane_across_two_workers_launches_k1_in_worker_1(
        tmp_path, monkeypatch):
    """NEXMark Q5 on the device lane across two worker processes (the
    distributed runtime): worker 1 owns the engine and launches the
    window-sum kernel once a batch on the card; worker 0 owns none and
    opens no CUDA context.  The sink is pinned to worker 0, so the
    engine's windows cross the wire back; they equal the oracle."""
    import json
    import torch_dist_builds as builds
    from windflow_tpu_torch.distributed import run_distributed
    n = 60_000
    out = tmp_path / "q5.json"
    probes = tmp_path / "probes"
    probes.mkdir()
    for var, value in (("WFT_Q5_N", str(n)), ("WFT_Q5_OUT", str(out)),
                       ("WFT_Q5_PLACEMENT", "device"),
                       ("WFT_DEVICE", "cuda"),
                       ("WFT_PROBE_DIR", str(probes)),
                       ("WFT_LOG_DIR", str(tmp_path / "log"))):
        monkeypatch.setenv(var, value)
    report = run_distributed(builds.build_q5, n_workers=2,
                             config_fn=builds.config_q5, graph_name="q5",
                             workdir=str(tmp_path / "work"),
                             assignment={"q5_counts": 1, "q5_sink": 0},
                             timeout_s=120.0)
    assert json.loads(out.read_text()) == builds.q5_oracle(n)
    merged = report["merged"]
    assert merged["Wire"]["Balanced"]
    assert merged["Conservation"]["Edges_balanced"]
    w0, w1 = builds.read_probes(str(probes))
    assert not w0["jax"] and not w1["jax"]
    assert w0["engines"] == [] and w0["k1_launches"] == 0
    assert not w0["cuda_initialized"]
    (engine,) = w1["engines"]
    assert engine["placement"] == "device"
    assert engine["device"].startswith("cuda")
    assert w1["k1_launches"] == engine["batches"] > 0
    assert sum(int(r.get("Device_launches", 0) or 0)
               for op in merged["Operators"]
               for r in op.get("Replicas") or ()) == engine["batches"]


def test_two_k1_tenants_contend_for_the_card_under_leases(tmp_path):
    """Two tenants' window-sum lanes under ``Server(devices=1)``: the
    planner leases the card to both (two holders on one lane: the card
    is contended, and the rows name it), both lanes launch the
    window-sum kernel once a batch, and each tenant's windows equal the
    same lane's on the CPU exactly."""
    import threading
    import torch_sched_builds as builds
    from windflow_tpu_torch.elastic import ElasticityConfig
    from torch_dist_builds import device_engines
    from windflow_tpu_torch.serving import Server, TenantSpec
    n = 1 << 16
    gate = threading.Event()

    def lane(g, device_rows, gated):
        src = builds.batch_source(n)
        g.add_source(BatchSource(
            (lambda ctx: gate.wait(60) and src(ctx)) if gated else src)) \
            .add(WinSeqTPU("sum", builds.WIN, builds.SLIDE, wf.WinType.TB,
                           batch_len=128, emit_batches=True,
                           placement="device")) \
            .add_sink(Sink(device_rows))

    def cfg(device):
        return wf.RuntimeConfig(log_dir=str(tmp_path), device=device,
                                elasticity=ElasticityConfig(enabled=False))

    want, want_sink = builds.window_rows_sink()
    g = wf.PipeGraph("cpu_lane", wf.Mode.DEFAULT, cfg("cpu"))
    lane(g, want_sink, gated=False)
    g.run()
    rows = {}
    ws.reset_launch_count()
    srv = Server(capacity=1 << 16, devices=1, arbiter=False)
    try:
        handles = []
        for prio, name in enumerate(("a", "b")):
            rows[name], sink = builds.window_rows_sink()
            handles.append(srv.submit(
                name, lambda g, s=sink: lane(g, s, gated=True),
                TenantSpec(credits=1024, priority=prio), config=cfg("cuda")))
        blk = srv.devices.block()
        assert blk["Holders"] == 2 and blk["Contended"]
        assert {r["Chip"] for r in blk["Leases"]} == {"cuda:0"}
        assert handles[1].graph.placements[0]["lease"]["contended"]
        gate.set()
        for h in handles:
            assert h.wait(120) == "COMPLETED", h.error
    finally:
        gate.set()
        srv.close()
    engines = [lg for h in handles for lg in device_engines(h.graph)]
    assert all(lg.device.type == "cuda" for lg in engines)
    assert ws.launch_count() == sum(lg.launched_batches
                                    for lg in engines) > 0
    for name in rows:
        assert sorted(rows[name]) == sorted(want), name


# ---------------------------------------------------------------------------
# the mesh plane: logical shards on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["sum", "mean", "max", "min", "logaddexp"])
def test_mesh_compute_kf_launches_one_kernel_a_call(kind):
    """compute_kf on CUDA tensors never takes a plain path: one K1
    launch a call for sums and means, one K2r launch for max/min/FFAT
    folds, for all 8 shards; the windows equal the CPU engine's (K2r
    bitwise for max/min, logaddexp and sums within rtol 1e-5)."""
    from windflow_tpu_torch.parallel.mesh import make_mesh
    from windflow_tpu_torch.parallel.sharded import ShardedWindowEngine
    rng = np.random.default_rng(61)
    S, T, B = 8, 1 << 12, 300
    values = rng.normal(size=(S, T)).astype(np.float32)
    starts = rng.integers(0, T - 512, (S, B)).astype(np.int32)
    ends = (starts + rng.integers(0, 513, (S, B))).astype(np.int32)
    spec = (("ffat", None, torch.logaddexp, -np.inf)
            if kind == "logaddexp" else kind)
    eng = ShardedWindowEngine(make_mesh(S, device="cuda"), 64, 32, spec)
    assert eng.device.type == "cuda"
    ws.reset_launch_count()
    fq.reset_build_query_launch_count()
    got = eng.compute_kf(values, starts, ends)
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    tree = kind not in ("sum", "mean")
    assert (ws.launch_count(), fq.build_query_launch_count()) == \
        ((0, 1) if tree else (1, 0))
    want = ShardedWindowEngine(make_mesh(S, device="cpu"), 64, 32,
                               spec).compute_kf(values, starts, ends)
    if kind in ("max", "min"):
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    else:
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_key_farm_mesh_on_the_card_launches_k1_per_batch():
    """KeyFarmMesh("sum") on 8 logical shards of the card: the windows
    equal the same graph on the CPU mesh, and K1's launches equal the
    logic's batches (no other kernel)."""
    from windflow_tpu_torch.operators.tpu.mesh_farm import (
        KeyFarmMesh, KeyFarmMeshLogic)
    from windflow_tpu_torch.parallel.mesh import make_mesh

    def run(device):
        rows = []
        idx = [np.arange(i, i + 4096) for i in range(0, 1 << 17, 4096)]
        batches = [TupleBatch({"key": e % 16, "id": e // 16, "ts": e // 16,
                               "value": (e % 97).astype(np.float64)})
                   for e in idx]
        it = iter(batches)
        g = wf.PipeGraph("mesh", wf.Mode.DEFAULT)
        g.add_source(BatchSource(lambda ctx: next(it, None))).add(
            KeyFarmMesh(make_mesh(8, device=device), 256, 128,
                        wf.WinType.TB, batch_windows=64)).add_sink(
            Sink(lambda b: b is not None and rows.extend(zip(
                b.key.tolist(), b.id.tolist(), b["value"].tolist()))))
        g.run()
        logic = next(lg for n in g._all_nodes()
                     for lg in ([sg.logic for sg in n.logic.segments]
                                if isinstance(n.logic, FusedLogic)
                                else [n.logic])
                     if isinstance(lg, KeyFarmMeshLogic))
        return rows, logic

    ws.reset_launch_count()
    fq.reset_build_query_launch_count()
    got, logic = run("cuda")
    assert ws.launch_count() == logic.launched_batches > 0
    assert fq.build_query_launch_count() == 0
    want, _ = run("cpu")
    assert got == want


# ---------------------------------------------------------------------------
# the feed and placement plane (chip_smoke.py phase 17) at small sizes
# ---------------------------------------------------------------------------

def _one_engine(g):
    (logic,) = _device_logics(g)
    return logic


def _window_rows(rows):
    """A sink callback appending (key, id, value) of result batches and
    records."""
    def sink(item):
        if item is None:
            return
        if isinstance(item, TupleBatch):
            rows.extend(zip(item.key.tolist(), item.id.tolist(),
                            item["value"].tolist()))
        else:
            rows.append((item.key, item.id, item.value))
    return sink


def _feed_graph(device):
    """FeedSource with 2 feeders (the arena's columns of the law key e %
    16, id = ts = e // 16, value e % 97) into WinSeqTPU("sum", TB 256 /
    128) with size-based launch triggers."""
    from windflow_tpu_torch.ingest.feed import FeedSource
    sb, n_chunks = 8192, 32

    def chunk_fn(i, take):
        if i >= n_chunks:
            return None
        idx = take(sb, np.int64)
        idx[:] = np.arange(i * sb, (i + 1) * sb)
        keys = np.mod(idx, 16, out=take(sb, np.int64))
        vals = np.mod(idx, 97, out=take(sb, np.int64)).astype(np.float64)
        ids = np.floor_divide(idx, 16, out=idx)
        return keys, ids, ids, vals

    rows = []
    g = wf.PipeGraph("feed", wf.Mode.DEFAULT,
                     config=wf.RuntimeConfig(device=device))
    g.add_source(FeedSource(chunk_fn, feeders=2)).add(
        WinSeqTPU("sum", 256, 128, wf.WinType.TB, batch_len=512,
                  emit_batches=True, max_batch_delay_ms=1e9)).add_sink(
        Sink(_window_rows(rows)))
    g.run()
    return g, sorted(rows)


def _replay_graph(device):
    """A replay source with pane pre-reduction at the ingest edge (the
    law key e % 4, id = ts = e // 4, value e % 31) into WinSeqTPU("sum",
    TB 2048 / 1024)."""
    n = 1 << 18
    ar = np.arange(n, dtype=np.int64)
    trace = TupleBatch({"key": ar % 4, "id": ar // 4, "ts": ar // 4,
                        "value": (ar % 31).astype(np.float64)})
    src = wf.SourceBuilder.from_replay(trace, speedup=None,
                                       chunk=4096).build()
    rows = []
    g = wf.PipeGraph("replay", wf.Mode.DEFAULT,
                     config=wf.RuntimeConfig(device=device))
    g.add_source(src).add(WinSeqTPU("sum", 2048, 1024, wf.WinType.TB,
                                    emit_batches=True)).add_sink(
        Sink(_window_rows(rows)))
    g.run()
    assert src.logics[0].coalescer.pre_reduce is not None
    return g, sorted(rows)


@pytest.mark.parametrize("graph", ["feed_source", "replay_prereduce"])
def test_feed_lane_on_the_card_launches_k1_per_batch(graph):
    """A FeedSource with two feeders, and a replay source whose pane
    partials are pre-reduced at the ingest edge, into K1 on the card:
    windows exact (integer values) and equal to the CPU run, K1's
    launches equal to the engine's batches, no other kernel."""
    run = {"feed_source": _feed_graph, "replay_prereduce": _replay_graph}[
        graph]
    _g, want = run("cpu")
    ws.reset_launch_count()
    fq.reset_fused_launch_count()
    g, got = run("cuda")
    logic = _one_engine(g)
    assert logic.device.type == "cuda"
    assert ws.launch_count() == logic.launched_batches > 0
    assert fq.fused_launch_count() == 0
    assert got == want and got


def _step19(device, step):
    """Config 19's shape at 2^18 events: WinSeqTPU("sum", 1024, 16, CB,
    batch_len 16, value_of) behind a BatchSource of 8,192-event batches
    (key e % 8, id = ts = e // 8, value e % 97), device step on or
    off."""
    n, sb = 1 << 18, 8192
    batches = iter(range(0, n, sb))

    def source():
        i = next(batches, None)
        if i is None:
            return None
        idx = np.arange(i, min(i + sb, n))
        return TupleBatch({"key": idx % 8, "id": idx // 8, "ts": idx // 8,
                           "value": (idx % 97).astype(np.float64)})

    rows = []
    g = wf.PipeGraph("step19", wf.Mode.DEFAULT,
                     config=wf.RuntimeConfig(device=device,
                                             device_step=step))
    g.add_source(BatchSource(source)).add(
        WinSeqTPU("sum", 1024, 16, wf.WinType.CB, batch_len=16,
                  max_buffer_elems=1 << 21, inflight_depth=8,
                  value_of=lambda t: t.value)).add_sink(
        Sink(_window_rows(rows)))
    g.run()
    return g, sorted(rows)


def test_device_step_config19_on_the_card_on_and_off_bitwise():
    """Config 19's shape with the device step on and off on the card:
    bitwise equal, equal to the CPU run; the planner promotes the lane
    onto the resident pane lane, so the fused update+query kernel
    launches once a batch (K1 none), at most 2 launches an ingest chunk
    with the step on."""
    from windflow_tpu_torch.graph.device_step import DeviceStepLogic
    _g, want = _step19("cpu", True)
    got = {}
    for step in (False, True):
        ws.reset_launch_count()
        fq.reset_fused_launch_count()
        g, got[step] = _step19("cuda", step)
        logic = _one_engine(g)
        assert logic.device.type == "cuda" and logic._resident is not None
        assert fq.fused_launch_count() == logic.launched_batches > 0
        assert ws.launch_count() == 0
        steps = [n.logic for n in g._all_nodes()
                 if isinstance(n.logic, DeviceStepLogic)]
        assert bool(steps) == step
        if step:
            chunks = sum(s.chunks_in for s in steps)
            assert 0 < logic.launched_batches <= 2 * chunks
    assert got[True] == got[False] == want
