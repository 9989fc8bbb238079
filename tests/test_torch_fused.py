"""The port's fused FlatFAT step (``flatfat_update_query``: new leaves,
their root paths and every window in one launch) held against the
reference's fused programs ``_batched_programs.update_runs_and_query``
and ``update_and_query`` (windflow_tpu/ops/flatfat_jax.py:176-207),
which the reference's ``BatchedFlatFAT`` runs.

On the CPU the wrapper runs the plain version, fed the kernel's exact
input layout (``flatfat_torch.pack_step``: one int32 buffer of
row-grouped CSR, run and window descriptors and values).  The reference
answers a wrapping window as two pieces combined on the host; the port
ships it as one (start mod n, length) window.  After every step the
forests must be equal, and so must the results: exactly for max/min and
for add on integer-valued data (every partial sum below 2^24), and
within ``rtol=1e-5`` on random f32 and for the non-commutative
``left_weighted`` (in practice exact: both sides combine the same pairs
in the same order).  The user combines no kernel builds in
(``tests/torch_graphs.py``: a product, ``logaddexp``, a NaN-skipping max
written with ``where``) run through the same steps: the arithmetic ones
exactly, ``logaddexp`` within ``rtol=1e-5`` (jnp's and torch's exp/log1p
forms may part by an ulp a combine).  The kernel itself is held against
the plain version on the card by tests/test_torch_card.py and
chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from windflow_tpu.ops.flatfat_jax import BatchedFlatFAT as RefForest
from windflow_tpu_torch.ops.cuda import flatfat_query as fq
from windflow_tpu_torch.ops.flatfat_torch import (BatchedFlatFAT,
                                                  pack_step, step_inputs)

from torch_graphs import (PACKAGES, USER_EXACT, left_weighted,
                          user_combines, user_values)

RTOL = 1e-5

_REF_USER, _PORT_USER = (user_combines(p) for p in PACKAGES)
# name -> (reference combine, port combine, neutral)
COMBINES = {
    "add": (jnp.add, torch.add, 0.0),
    "max": (jnp.maximum, torch.maximum, -np.inf),
    "min": (jnp.minimum, torch.minimum, np.inf),
    "left_weighted": (left_weighted, left_weighted, 0.0),
}
# the user combines the kernels compile from their torch ops
USER = ("mul", "logaddexp", "where_max")
COMBINES.update({name: (_REF_USER[name][0], _PORT_USER[name][0],
                        _PORT_USER[name][1]) for name in USER})


def _check(got, want, exact):
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def _runs(rng, K, n, nxt):
    """Runs of new leaves for this step, in id space: 0-3 consecutive
    runs on a few rows (some empty), so runs share rows and parents and
    cross the ring's end; ``nxt`` is each row's next id."""
    rows, starts, lens = [], [], []
    for row in rng.permutation(K)[:int(rng.integers(0, K + 1))]:
        for _ in range(int(rng.integers(1, 4))):
            ln = int(rng.integers(0, max(2, n // 3)))
            rows.append(int(row))
            starts.append(int(nxt[row]))
            lens.append(ln)
            nxt[row] += ln
    return rows, starts, lens


def _windows(rng, K, n, nxt):
    """Windows over live ids of any row (rows without a run included):
    empty ones, whole-ring ones and ring-wrapping ones among them."""
    B = int(rng.integers(0, 3 * K))
    rows = rng.integers(0, K, B)
    lens = rng.integers(0, n + 1, B)
    lens[:2] = (0, n)[:B]
    ends = nxt[rows] - rng.integers(0, 2, B)
    starts = ends - np.minimum(lens, np.maximum(ends, 0))
    return rows, np.maximum(starts, 0), np.maximum(ends, 0)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "f32"])
@pytest.mark.parametrize("name", list(COMBINES))
@pytest.mark.parametrize("n", [2, 16, 256])
def test_packed_plain_matches_reference_runs(n, name, integer):
    """Run-descriptor steps: the packed plain version against the
    reference's update_runs_and_query, forest and results, over steps
    with several runs per row, ring wrap, rows with windows but no run
    and empty steps."""
    ref_c, port_c, neutral = COMBINES[name]
    exact = name in ("max", "min") or (name == "add" and integer) \
        or USER_EXACT.get(name, False)
    rng = np.random.default_rng(n + len(name) + integer)
    K = 5
    a = RefForest(ref_c, neutral, K, n)
    b = BatchedFlatFAT(port_c, neutral, K, n, device="cpu")
    nxt = np.zeros(K, np.int64)
    for step in range(12):
        rows, starts, lens = _runs(rng, K, n, nxt)
        total = int(np.sum(lens))
        vals = (user_values(name, rng, total) if name in USER
                else (rng.integers(0, 50, total) if integer
                      else rng.normal(size=total)).astype(np.float32))
        q_rows, q_s, q_e = _windows(rng, K, n, nxt)
        if step == 5:  # an empty step
            rows, starts, lens, vals = [], [], [], vals[:0]
            q_rows, q_s, q_e = q_rows[:0], q_s[:0], q_e[:0]
        # the reference takes at least one run (a padded one is empty)
        r1 = a.update_runs_query(rows or [0], starts or [0], lens or [0],
                                 vals, q_rows, q_s, q_e)
        buf, sizes = pack_step(n, K, rows, starts, lens, vals, q_rows, q_s,
                               q_e)
        r2 = fq.flatfat_update_query_plain(b.tree, step_inputs(buf, sizes),
                                           port_c, neutral).numpy()
        _check(b.tree_numpy(), np.asarray(a.tree), exact)
        assert r2.shape == (len(q_rows),)
        _check(r2, r1, exact)
    assert nxt.max() > n  # the rings wrapped


@pytest.mark.parametrize("name", list(COMBINES))
def test_position_steps_match_reference(name):
    """Position steps (BatchedFlatFAT.update_query: each value at ring
    position id % n of its key, rows interleaved) against the
    reference's update_and_query, plus query-only steps."""
    ref_c, port_c, neutral = COMBINES[name]
    rng = np.random.default_rng(9)
    K, n = 4, 16
    a = RefForest(ref_c, neutral, K, n)
    b = BatchedFlatFAT(port_c, neutral, K, n, device="cpu")
    nxt = np.zeros(K, np.int64)
    for step in range(10):
        keys = rng.integers(0, K, int(rng.integers(1, 12)))
        ids = np.empty(len(keys), np.int64)
        for i, k in enumerate(keys):  # arrival order per key
            ids[i] = nxt[k]
            nxt[k] += 1
        vals = (user_values(name, rng, len(keys)) if name in USER
                else rng.integers(0, 50, len(keys)).astype(np.float32))
        q_rows, q_s, q_e = _windows(rng, K, n, nxt)
        if step % 3 == 2:
            a.update(keys, ids, vals)
            b.update(keys, ids, vals)
            r1, r2 = a.query(q_rows, q_s, q_e), b.query(q_rows, q_s, q_e)
        else:
            r1 = a.update_query(keys, ids, vals, q_rows, q_s, q_e)
            r2 = b.update_query(keys, ids, vals, q_rows, q_s, q_e)
        exact = USER_EXACT.get(name, True) and name != "left_weighted"
        _check(b.tree_numpy(), np.asarray(a.tree), exact)
        _check(r2, r1, exact)
    assert nxt.max() > n


def test_plain_primitives_match_reference_composition():
    """The plain version's primitives composed as the reference's fused
    program (expand_runs, update_sparse, the query over two-piece
    windows) against the reference's, forest and pieces."""
    rng = np.random.default_rng(2)
    K, n = 3, 16
    a = RefForest(jnp.add, 0.0, K, n)
    tree = torch.zeros((K, 2 * n))
    vals = rng.integers(0, 50, 20).astype(np.float32)
    runs = ([0, 2, 0], [13, 4, 4], [7, 9, 4])  # row 0 wraps, goes on
    k2, s2, e2, ok, wraps, B = a._pack_queries([0, 1, 2, 0], [3, 0, 2, 9],
                                               [17, 5, 13, 25])
    assert wraps.any()
    ref_tree, ref_out = a._update_runs_query(
        a.tree, *(jnp.asarray(np.asarray(x, np.int32)) for x in runs),
        jnp.asarray(vals), jnp.asarray(k2), jnp.asarray(s2),
        jnp.asarray(e2), jnp.asarray(ok))
    keys, pos, valid = fq.expand_runs(*(torch.tensor(x) for x in runs),
                                      len(vals), n)
    fq.update_sparse(tree, keys, pos, torch.from_numpy(vals), valid,
                     torch.add)
    got = fq.flatfat_query_plain(tree, torch.from_numpy(k2),
                                 torch.from_numpy(s2), torch.from_numpy(e2),
                                 torch.add, 0.0)
    np.testing.assert_array_equal(tree.numpy(), np.asarray(ref_tree))
    np.testing.assert_array_equal(got.numpy()[ok], np.asarray(ref_out)[ok])


def test_pack_step_layout():
    """Rows group into sorted CSR, a row's runs keep their order and
    their value offsets, windows keep their output index, and a window
    of exactly n leaves stays whole."""
    n = 8
    buf, sizes = pack_step(n, 4, [2, 0, 2], [9, 3, 11], [2, 1, 3],
                           np.arange(6, dtype=np.float32), [3, 2, 0],
                           [16, 5, 4], [24, 6, 4])
    assert sizes == (3, 3, 3, 6)
    inp = step_inputs(buf, sizes)
    # rows 0, 2, 3; run_ptr; q_ptr
    assert inp.groups.tolist() == [0, 2, 3, 0, 1, 3, 3, 0, 1, 2, 3]
    assert inp.runs.tolist() == [[3, 1, 3], [1, 2, 3], [2, 0, 3]]
    assert inp.queries.tolist() == [[4, 5, 0], [0, 1, 8], [2, 1, 0]]
    assert inp.values.tolist() == list(range(6))
    assert inp.values.dtype == torch.float32


@pytest.mark.parametrize("bad", ["run_too_long", "negative_run",
                                 "values", "window", "row"])
def test_pack_step_rejects_what_the_kernel_cannot_take(bad):
    args = dict(run_rows=[0], run_starts=[0], run_lens=[2],
                values=[1.0, 2.0], q_rows=[0], q_starts=[0], q_ends=[2])
    if bad == "run_too_long":
        args.update(run_lens=[9], values=np.ones(9))
    elif bad == "negative_run":
        args.update(run_lens=[-1], values=[])
    elif bad == "values":
        args.update(values=[1.0])
    elif bad == "window":
        args.update(q_ends=[9])
    else:
        args.update(q_rows=[2])
    with pytest.raises(ValueError):
        pack_step(8, 2, **args)


def test_wrapper_runs_plain_version_on_cpu_tensors():
    """On a CPU forest the wrapper runs the plain version (no kernel
    launch counted) for any torch combine."""
    forest = torch.zeros((2, 16))
    buf, sizes = pack_step(8, 2, [1], [6], [4], [1.0, 2.0, 3.0, 4.0],
                           [1, 1, 0], [6, 4, 0], [10, 12, 8])
    before = fq.fused_launch_count()

    def comb(a, b):
        return a + b + 0.0

    out = fq.flatfat_update_query(forest, step_inputs(buf, sizes), comb,
                                  0.0)
    assert fq.fused_launch_count() == before
    np.testing.assert_array_equal(out.numpy(), [10.0, 10.0, 0.0])
    assert forest[1, 1].item() == 10.0  # the root


@pytest.mark.parametrize("bad", ["forest_dtype", "forest_1d", "groups",
                                 "values_dtype", "not_contiguous"])
def test_wrapper_rejects_malformed_input(bad):
    forest = torch.zeros((2, 16))
    buf, sizes = pack_step(8, 2, [1], [6], [2], [1.0, 2.0], [1], [6], [8])
    inp = step_inputs(buf, sizes)
    if bad == "forest_dtype":
        forest = forest.double()
    elif bad == "forest_1d":
        forest = torch.zeros(16)
    elif bad == "groups":
        inp = inp._replace(groups=inp.groups[:-1])
    elif bad == "values_dtype":
        inp = inp._replace(values=inp.values.double())
    else:
        forest = torch.zeros((2, 32))[:, ::2]
    with pytest.raises(ValueError):
        fq.flatfat_update_query(forest, inp, torch.add, 0.0)
