"""Custom window functions in the port: a torch callable
``fn(gwid, cols, mask) -> 0-d tensor`` as the window kind of
``WindowComputeEngine`` and of the device window operators, held
against the reference's ``_custom_program`` (the same function written
in jnp) on the same inputs, on the CPU.

Tolerance: f32 sums of squares of random normals over up to 300
values, ``rtol=1e-5`` (the reference's window-sum tests use 1e-3 to
1e-6 for f32 device sums); integer-valued graph windows are exact.
"""
import importlib
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_graphs import PACKAGES, PORT, both, by_key, mod, oracle

RTOL = 1e-5


def sq_jnp(gwid, cols, mask):
    v = jnp.where(mask, cols["value"], 0.0)
    return jnp.sum(v * v)


def sq_torch(gwid, cols, mask):
    v = torch.where(mask, cols["value"], 0.0)
    return torch.sum(v * v)


def mixed_jnp(gwid, cols, mask):
    """Two columns, the window id, a masked max and a count."""
    w = jnp.where(mask, cols["weight"], 0.0)
    top = jnp.max(jnp.where(mask, cols["value"], -jnp.inf))
    n = jnp.sum(mask)
    return jnp.sum(w * cols["value"]) + jnp.where(n > 0, top, 0.0) \
        + 0.25 * gwid.astype(jnp.float32) + n


def mixed_torch(gwid, cols, mask):
    w = torch.where(mask, cols["weight"], 0.0)
    top = torch.max(torch.where(mask, cols["value"], -torch.inf))
    n = torch.sum(mask)
    return torch.sum(w * cols["value"]) + torch.where(n > 0, top, 0.0) \
        + 0.25 * gwid.to(torch.float32) + n


FNS = {"sum_of_squares": (sq_jnp, sq_torch),
       "mixed": (mixed_jnp, mixed_torch)}


def _batch(seed, T=4000, B=300, max_w=300):
    rng = np.random.default_rng(seed)
    cols = {"value": rng.normal(size=T), "weight": rng.uniform(size=T)}
    starts = rng.integers(0, T - max_w, B)
    ends = starts + rng.integers(1, max_w + 1, B)
    return cols, starts, ends, rng.integers(0, 1 << 20, B)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fn", list(FNS))
def test_callable_kind_matches_the_reference_program(fn, seed):
    """Random extents of widths 1-300 (w_pad 256 or 512)."""
    cols, starts, ends, gwids = _batch(seed)
    f_jnp, f_torch = FNS[fn]
    ref_eng = mod("windflow_tpu", "ops.window_compute").WindowComputeEngine
    port_eng = mod(PORT, "ops.window_compute").WindowComputeEngine
    want = ref_eng(f_jnp).compute(cols, starts, ends, gwids).block()
    got = port_eng(f_torch, device="cpu").compute(cols, starts, ends,
                                                  gwids).block()
    assert got.shape == want.shape == (len(starts),)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)


def test_callable_kind_on_the_reference_case():
    """tests/test_tpu_operators.py::test_custom_fn, in torch."""
    port_eng = mod(PORT, "ops.window_compute").WindowComputeEngine
    out = port_eng(sq_torch, device="cpu").compute(
        {"value": np.arange(10, dtype=np.float64)}, np.array([0, 4]),
        np.array([4, 10]), np.arange(2)).block()
    np.testing.assert_allclose(out, [sum(v * v for v in range(4)),
                                     sum(v * v for v in range(4, 10))])


def test_python_branch_on_data_fails_under_vmap():
    """A function that branches in Python on its data cannot be vmapped
    (as under jax.vmap); the error reaches the caller."""
    def branchy(gwid, cols, mask):
        return cols["value"].sum() if cols["value"][0] > 0 else gwid * 0.0

    port_eng = mod(PORT, "ops.window_compute").WindowComputeEngine
    cols, starts, ends, gwids = _batch(0, B=8)
    with pytest.raises(RuntimeError):
        port_eng(branchy, device="cpu").compute(cols, starts, ends, gwids)


@pytest.mark.parametrize("combine", [lambda a, b: a * b])
def test_user_ffat_combine_on_the_card_raises_naming_a7c(combine):
    """A user FFAT combine is no builtin of the FlatFAT kernels: it is
    lowered from its torch ops into a library of its own (checked here
    without a card: the lowering, not the build).  What cannot be
    lowered raises ValueError, before anything is built."""
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq
    from windflow_tpu_torch.ops.cuda.combine_lower import lower_combine
    assert fq.builtin_op(combine) is None
    assert lower_combine(combine) == \
        "const float t0 = __fmul_rn(a, b); return t0;"
    assert fq.builtin_op(torch.add) == 0
    with pytest.raises(ValueError, match="the op"):
        fq.resolve_combine(lambda a, b: torch.sin(a) + b)


# ---------------------------------------------------------------------------
# a callable kind end to end: WinSeqTPU and KeyFarmTPU graphs
# ---------------------------------------------------------------------------

def _sq(pkg):
    return sq_jnp if pkg == "windflow_tpu" else sq_torch


@pytest.mark.parametrize("op", ["win_seq_tpu", "key_farm_tpu"])
@pytest.mark.parametrize("win_type", ["CB", "TB"])
def test_callable_kind_graph_matches_reference(op, win_type):
    """Sum of squares of the ordered stream's ids, windows 12 / 4: the
    Python staging lane (never the native engine) in both packages,
    exact on these integer values."""
    def make(wf):
        fn = _sq(wf.__name__)
        b = (wf.WinSeqTPUBuilder(fn) if op == "win_seq_tpu"
             else wf.KeyFarmTPUBuilder(fn).with_parallelism(2)
             .with_coalesce(False))
        b = b.with_batch(8)
        b = (b.with_cb_windows(12, 4) if win_type == "CB"
             else b.with_tb_windows(12, 4))
        built = b.build()
        for lg in built.stages()[0].replicas:
            assert lg._native is None
        return built

    got, _ = both(make, n_keys=4)
    expect = oracle(48, 12, 4, agg=lambda vs: sum(v * v for v in vs))
    assert by_key(got) == {k: expect for k in range(4)}


def test_callable_kind_snapshot_resumes_in_the_port():
    """A reference WinSeqTPU with a callable kind, checkpointed
    mid-stream, resumes in the port with the same remaining windows."""
    from windflow_tpu_torch.convert import from_reference_state

    def logic(pkg, **kw):
        wf = importlib.import_module(pkg)
        WinSeqTPU = mod(pkg, "operators.tpu.win_seq_tpu").WinSeqTPU
        return WinSeqTPU(_sq(pkg), 12, 4, wf.WinType.CB, batch_len=8,
                         max_batch_delay_ms=1e9, **kw).stages()[0] \
            .replicas[0]

    def feed(lg, pkg, lo, hi, out):
        BasicRecord = mod(pkg, "core").BasicRecord
        for i in range(lo, hi):
            lg.svc(BasicRecord(i % 3, i // 3, i // 3, float(i // 3)), 0,
                   out.append)

    n, half = 3 * 48, 3 * 23
    full, full_out = logic(PACKAGES[0]), []
    feed(full, PACKAGES[0], 0, n, full_out)
    full.eos_flush(full_out.append)

    ref, first = logic(PACKAGES[0]), []
    feed(ref, PACKAGES[0], 0, half, first)
    ref._drain_all(first.append)
    snap = pickle.loads(pickle.dumps(ref.state_dict()))
    port, rest = logic(PORT, device="cpu"), []
    port.load_state(from_reference_state(snap))
    feed(port, PORT, half, n, rest)
    port.eos_flush(rest.append)

    def rows(out):
        return sorted((r.key, r.id, r.value) for r in out)
    assert rows(first + rest) == rows(full_out)
