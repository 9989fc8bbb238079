"""The port's FlatFAT (windflow_tpu_torch/ops/cuda/flatfat_query.py and
ops/flatfat_torch.py) held against the reference: the plain query
against the Pallas kernel ``windflow_tpu/ops/pallas/flatfat_query.py``
(interpret mode on the CPU, as tests/test_tpu_operators.py runs it) and
the XLA query of ``FlatFATJax``; the port's trees and forests against
the reference's after every step; the engine's ffat kind against the
reference engine with the Pallas gate on and off.  (The kernel is held
against the plain version on the card by tests/test_torch_card.py and
chip_smoke.py.)

Inputs come from seeded numpy; the reference gets ``jnp.add`` /
``jnp.maximum`` / ``jnp.minimum`` where the port gets ``torch.add`` /
``torch.maximum`` / ``torch.minimum``.  Tolerances: exact for max/min
and for add on integer-valued data (every partial sum below 2^24); exact
too for ``left_weighted`` (0.5 a is exact in f32, so both sides round
each step alike) and for add on random f32, where both sides combine
the same pairs in the same order -- the tests still state ``rtol=1e-5``
for those two, the bound the port promises.

The plain query is held at n = 2^7, 2^8 and 2^9 (level counts either
side of the kernel's chunk of walk steps) against both, at 2^16 and
2^17 against ``FlatFATJax`` alone, and over a forest whose row ids
include ones outside it (NaN there).  Max and min are also held bit for
bit on leaves of +0 and -0 with a NaN (ROADMAP C12: ``jnp`` orders -0
below +0, which torch's CPU ops do not): against the XLA query as they
stand, against the Pallas kernel with every -0 of the port's result
made +0, as that kernel's leaf loads make them (ROADMAP C13).

The user combines no kernel builds in (``tests/torch_graphs.py``:
a product, ``logaddexp``, a NaN-skipping max written with ``where``, and
``left_weighted``, which the kernels compile from its torch ops like any
other) run through the same tests: the arithmetic ones exactly,
``logaddexp`` within ``rtol=1e-5`` (jnp's and torch's exp/log1p forms
may part by an ulp a combine).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from windflow_tpu.ops.flatfat_jax import BatchedFlatFAT as RefForest
from windflow_tpu.ops.flatfat_jax import FlatFATJax
from windflow_tpu.ops.pallas.flatfat_query import flatfat_query_ranges
from windflow_tpu.ops.window_compute import \
    WindowComputeEngine as RefEngine
from windflow_tpu_torch.ops.cuda import flatfat_query as fq
from windflow_tpu_torch.ops.flatfat_torch import (BatchedFlatFAT,
                                                  FlatFATTorch, build_tree)
from windflow_tpu_torch.ops.window_compute import WindowComputeEngine

from torch_graphs import (PACKAGES, USER_EXACT, assert_same_bits,
                          left_weighted, signed_zeros, user_combines,
                          user_values)

RTOL = 1e-5

_REF_USER, _PORT_USER = (user_combines(p) for p in PACKAGES)
# name -> (reference combine, port combine, neutral, exact)
COMBINES = {
    "add": (jnp.add, torch.add, 0.0, True),
    "max": (jnp.maximum, torch.maximum, -np.inf, True),
    "min": (jnp.minimum, torch.minimum, np.inf, True),
    "left_weighted": (left_weighted, left_weighted, 0.0, False),
}
# the user combines the kernels compile from their torch ops
USER = ("mul", "logaddexp", "where_max")
COMBINES.update({name: (_REF_USER[name][0], _PORT_USER[name][0],
                        _PORT_USER[name][1], USER_EXACT[name])
                 for name in USER})


def _values(name, rng, shape, law):
    """Leaves of a law: "int" integer-valued, "f32" normal, "zeros"
    +0 and -0 with a NaN (max and min); a user combine's own law."""
    if name in USER:
        return user_values(name, rng, shape)
    if law == "zeros":
        return signed_zeros(rng, shape, name, n_nan=1)
    return (rng.integers(0, 100, shape) if law == "int"
            else rng.normal(size=shape)).astype(np.float32)


def _check(got, want, exact):
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def _i32(a):
    return torch.from_numpy(np.asarray(a, np.int32))


def _extents(rng, n, B):
    starts = rng.integers(0, n - 1, B)
    ends = np.minimum(starts + rng.integers(1, n // 2 + 2, B), n)
    return starts, ends


def _query_cases():
    """(name, law, n, K): every combine at n = 2^8 (under the ids these
    cases had before n varied), 2^7 and 2^9 -- level counts either side
    of the kernel's chunk of walk steps; add and left_weighted at 2^16
    and 2^17 (against FlatFATJax alone: the interpreted Pallas kernel
    would walk those trees for minutes); and a forest of K = 3 trees
    whose row ids include ones outside it.  Max and min also on signed
    zeros, at the same sizes."""
    cases = []
    for name in COMBINES:
        laws = ("int", "f32") + (("zeros",) if name in ("max", "min")
                                 else ())
        for law in laws:
            base = f"{name}-{law}"
            cases.append(pytest.param(name, law, 256, 0, id=base))
            cases += [pytest.param(name, law, n, 0, id=f"{base}-n{n}")
                      for n in (128, 512)]
            if name in ("add", "left_weighted"):
                cases += [pytest.param(name, law, n, 0,
                                       id=f"{base}-n{n}")
                          for n in (1 << 16, 1 << 17)]
            cases.append(pytest.param(name, law, 256, 3,
                                      id=f"{base}-forest"))
    return cases


@pytest.mark.parametrize("name,law,n,K", _query_cases())
def test_plain_query_matches_pallas_and_xla(name, law, n, K):
    ref_c, port_c, neutral, exact = COMBINES[name]
    exact = exact and (law != "f32" or name != "add")
    rng = np.random.default_rng(list(COMBINES).index(name))
    B = 64
    trees, refs = [], []
    for _ in range(max(K, 1)):
        leaves = _values(name, rng, n, law)
        f = FlatFATJax(ref_c, neutral, n)
        f.build(leaves)
        trees.append(np.array(f.tree))
        refs.append(f)
    starts, ends = _extents(rng, n, B)
    rows = rng.integers(-1, K + 1, B) if K else np.zeros(B, np.int64)
    want = np.full(B, np.nan, np.float32)
    pallas = want.copy()
    for r, (tree, f) in enumerate(zip(trees, refs)):
        sel = rows == r
        want[sel] = f.query_ranges(starts[sel], ends[sel])
        if n <= 512:
            pallas[sel] = flatfat_query_ranges(tree, starts[sel], ends[sel],
                                               ref_c, neutral)
    got = fq.flatfat_query_plain(torch.from_numpy(np.stack(trees)),
                                 _i32(rows) if K else None, _i32(starts),
                                 _i32(ends), port_c, neutral).numpy()
    if K:  # both kinds of row outside the forest are drawn
        assert (rows < 0).any() and (rows >= K).any()
    _check(got, want, exact)
    if n <= 512:
        _check(got, pallas, exact)
    if law == "zeros":  # zero results, held bit for bit
        assert (want == 0).any()
        assert_same_bits(got, want)
        # the Pallas kernel reads a leaf as the sum of its lane row with
        # the other lanes zeroed, so a -0 leaf reads +0 (-0 + +0): its
        # result is the XLA query's with every -0 made +0 (ROADMAP C13)
        assert_same_bits(got + np.float32(0.0), pallas)


@pytest.mark.parametrize("name", list(COMBINES))
def test_build_tree_matches_reference(name):
    ref_c, port_c, neutral, exact = COMBINES[name]
    rng = np.random.default_rng(7)
    leaves = _values(name, rng, 128, "int")
    f = FlatFATJax(ref_c, neutral, 128)
    f.build(leaves)
    got = build_tree(torch.from_numpy(leaves), port_c, neutral).numpy()
    _check(got, np.asarray(f.tree), exact)


def test_edges_match_reference():
    """Empty extents, the whole range [0, n), extents ending at n, and
    the smallest tree (n = 2)."""
    for n, starts, ends in ((16, [0, 3, 0, 15, 16, 7], [0, 3, 16, 16, 16,
                                                         16]),
                            (2, [0, 0, 1, 2], [2, 1, 2, 2])):
        for name in ("add", "max", "left_weighted"):
            ref_c, port_c, neutral, exact = COMBINES[name]
            leaves = np.arange(1, n + 1, dtype=np.float32)
            f = FlatFATJax(ref_c, neutral, n)
            f.build(leaves)
            want = f.query_ranges(np.array(starts), np.array(ends))
            got = fq.flatfat_query(torch.from_numpy(np.array(f.tree)), None,
                                   _i32(starts), _i32(ends), port_c,
                                   neutral).numpy()
            _check(got, want, exact)


def test_forest_rows_and_bad_rows():
    """A forest query picks each window's row; a row outside the forest
    gives NaN (the kernel's guard against reading outside it)."""
    rng = np.random.default_rng(3)
    K, n = 3, 32
    forest = np.stack([build_tree(torch.from_numpy(
        rng.integers(0, 50, n).astype(np.float32)), torch.add, 0.0).numpy()
        for _ in range(K)])
    rows = np.array([0, 1, 2, 1, 3, -1])
    starts = np.array([0, 5, 9, 0, 0, 0])
    ends = np.array([32, 6, 31, 0, 4, 4])
    got = fq.flatfat_query(torch.from_numpy(forest), _i32(rows),
                           _i32(starts), _i32(ends), torch.add, 0.0).numpy()
    leaves = forest[:, n:]
    want = [leaves[r, s:e].sum() for r, s, e in zip(rows[:4], starts[:4],
                                                     ends[:4])]
    np.testing.assert_array_equal(got[:4], want)
    assert np.isnan(got[4:]).all()


def test_wrapper_runs_plain_version_on_cpu_tensors():
    tree = build_tree(torch.arange(8, dtype=torch.float32), torch.add, 0.0)
    before = fq.launch_count()
    out = fq.flatfat_query(tree, None, _i32([0, 2]), _i32([8, 5]),
                           torch.add, 0.0)
    assert fq.launch_count() == before  # the kernel was not launched
    np.testing.assert_array_equal(out.numpy(), [28.0, 9.0])
    # any torch combine runs on the CPU, compiled in the kernel or not
    def comb(a, b):
        return torch.maximum(a, b) + 0.0
    tree = build_tree(torch.arange(8, dtype=torch.float32), comb, -1.0)
    out = fq.flatfat_query(tree, None, _i32([0, 1]), _i32([8, 3]), comb,
                           -1.0)
    np.testing.assert_array_equal(out.numpy(), [7.0, 2.0])


def test_kernel_combines():
    """The builtins keep the shared library's op codes; every other
    torch combine is lowered into a library of its own (the body that
    library compiles in), and what cannot be lowered raises."""
    from windflow_tpu_torch.ops.cuda.combine_lower import lower_combine
    for c in (torch.add, torch.maximum, torch.minimum, "sum", "count",
              "max", "min"):
        assert fq.builtin_op(c) is not None
    for c in (left_weighted, lambda a, b: a + b, torch.mul,
              torch.logaddexp, _PORT_USER["where_max"][0]):
        assert fq.builtin_op(c) is None
        assert lower_combine(c).startswith("const ")
    for c in (jnp.add, np.add):
        with pytest.raises(ValueError):
            lower_combine(c)


@pytest.mark.parametrize("bad", ["dtype", "not_pow2", "extents_dtype",
                                 "lengths", "rows_dtype", "not_contiguous"])
def test_wrapper_rejects_malformed_input(bad):
    tree = torch.zeros(16)
    rows, starts, ends = None, _i32([0, 1]), _i32([2, 3])
    if bad == "dtype":
        tree = tree.double()
    elif bad == "not_pow2":
        tree = torch.zeros(12)
    elif bad == "extents_dtype":
        starts = starts.long()
    elif bad == "lengths":
        ends = _i32([2])
    elif bad == "rows_dtype":
        rows = torch.zeros(2, dtype=torch.int64)
    else:
        tree = torch.zeros(32)[::2]
    with pytest.raises(ValueError):
        fq.flatfat_query(tree, rows, starts, ends, torch.add, 0.0)


def test_single_tree_update_matches_reference():
    rng = np.random.default_rng(11)
    a = FlatFATJax(jnp.maximum, -np.inf, 64)
    b = FlatFATTorch(torch.maximum, -np.inf, 64, device="cpu")
    leaves = rng.integers(0, 100, 50).astype(np.float32)
    a.build(leaves)
    b.build(leaves)
    for _ in range(4):
        pos = rng.choice(64, 9, replace=False)
        vals = rng.integers(0, 100, 9).astype(np.float32)
        a.update(pos, vals)
        b.update(pos, vals)
        np.testing.assert_array_equal(b.tree.numpy(), np.asarray(a.tree))
        s, e = _extents(rng, 64, 20)
        np.testing.assert_array_equal(b.query_ranges(s, e),
                                      a.query_ranges(s, e))


@pytest.mark.parametrize("name", ["add", "max", "left_weighted"] +
                         list(USER))
def test_forest_steps_match_reference(name):
    """The port's forest equals the reference's after every update,
    fused update+query and run-descriptor launch, ring wrap included
    (a capacity of 32 leaves under ids up to 200)."""
    ref_c, port_c, neutral, exact = COMBINES[name]
    rng = np.random.default_rng(5)
    K, n = 4, 32
    a = RefForest(ref_c, neutral, K, n)
    b = BatchedFlatFAT(port_c, neutral, K, n, device="cpu")
    nxt = np.zeros(K, np.int64)  # per-key next leaf id
    for step in range(30):
        kind = step % 3
        key = int(rng.integers(0, K))
        cnt = int(rng.integers(1, 16))
        ids = np.arange(nxt[key], nxt[key] + cnt)
        vals = (user_values(name, rng, cnt) if name in USER
                else rng.integers(0, 50, cnt).astype(np.float32))
        nxt[key] += cnt
        qk = np.arange(K)
        qe = nxt.copy()
        qs = np.maximum(0, qe - rng.integers(1, n + 1, K))
        if kind == 0:
            a.update(np.full(cnt, key), ids, vals)
            b.update(np.full(cnt, key), ids, vals)
            r1, r2 = a.query(qk, qs, qe), b.query(qk, qs, qe)
        elif kind == 1:
            r1 = a.update_query(np.full(cnt, key), ids, vals, qk, qs, qe)
            r2 = b.update_query(np.full(cnt, key), ids, vals, qk, qs, qe)
        else:
            r1 = a.update_runs_query([key], [ids[0]], [cnt], vals, qk, qs,
                                     qe)
            r2 = b.update_runs_query([key], [ids[0]], [cnt], vals, qk, qs,
                                     qe)
        _check(b.tree_numpy(), np.asarray(a.tree), exact)
        _check(r2, r1, exact)
    assert nxt.max() > n  # the rings wrapped
    assert b.state_bytes == a.state_bytes == K * 2 * n * 4


@pytest.mark.parametrize("pallas", ["1", "0"])
@pytest.mark.parametrize("name", ["add", "max", "min"] + list(USER))
def test_engine_ffat_kind_matches_reference(name, pallas, monkeypatch):
    """The ffat kind of the port's engine against the reference engine
    on its Pallas query (WINDFLOW_PALLAS_FFAT=1) and on its XLA query
    (=0)."""
    ref_c, port_c, neutral, exact = COMBINES[name]
    monkeypatch.setenv("WINDFLOW_PALLAS_FFAT", pallas)
    rng = np.random.default_rng(4)
    T, B = 500, 40
    vals = _values(name, rng, T, "int").astype(np.float64)
    starts = rng.integers(0, T - 1, B)
    ends = np.minimum(starts + rng.integers(0, 80, B), T)
    gwids = np.arange(B, dtype=np.int64)
    want = RefEngine(("ffat", ref_c, neutral)).compute(
        {"value": vals}, starts, ends, gwids).block()
    got = WindowComputeEngine(("ffat", port_c, neutral), device="cpu") \
        .compute({"value": vals}, starts, ends, gwids).block()
    assert got.shape == (B,)
    _check(got, want, exact)


def test_ffat_kind_with_a_non_kernel_combine_runs_on_the_cpu():
    """A user combine (here the non-commutative left_weighted, which no
    kernel builds in) runs on the CPU through the plain version, in the
    reference's order."""
    vals = np.arange(1.0, 41.0)
    starts, ends = np.array([0, 4, 7, 20]), np.array([3, 11, 40, 33])
    gwids = np.arange(4)
    want = RefEngine(("ffat", left_weighted, 0.0)).compute(
        {"value": vals}, starts, ends, gwids).block()
    got = WindowComputeEngine(("ffat", left_weighted, 0.0),
                              device="cpu").compute(
        {"value": vals}, starts, ends, gwids).block()
    np.testing.assert_allclose(got, want, rtol=RTOL)
