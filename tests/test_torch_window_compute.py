"""The port's WindowComputeEngine held against the reference engine
(windflow_tpu/ops/window_compute.py) at the bucketed launch shapes, for
every builtin kind the headline and its neighbours launch.

Inputs come from seeded numpy.  Integer-valued data makes every sum,
count and prefix sum exact in f32, so the two engines must agree
exactly; on random f32 data max/min (selections) stay exact and sums
over short extents agree within ``rtol=1e-5``.
"""
import numpy as np
import pytest
import torch

from windflow_tpu.ops.window_compute import \
    WindowComputeEngine as RefEngine
from windflow_tpu_torch.ops.cuda import window_sum as ws
from windflow_tpu_torch.ops.window_compute import (ResidentPaneCarry,
                                                   WindowComputeEngine)

# (T, B, widest extent): shapes on both sides of the 2048 bucket floor
# and of the tile/scan switch at 32
SHAPES = [(100, 10, 8), (5000, 3000, 16), (5000, 3000, 500),
          (70_000, 2100, 4096)]
KINDS = ["sum", "count", "mean", "max", "min", "mean_panes"]


def _launch(T, B, max_w, seed, integer=True):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_w + 1, B)
    starts = rng.integers(0, T - max_w, B)
    ends = starts + lens
    if integer:
        vals = rng.integers(0, 97, T).astype(np.float64)
    else:
        vals = rng.random(T)
    cols = {"value": vals, "count": rng.integers(1, 50, T).astype(np.float64)}
    gwids = np.arange(B, dtype=np.int64)
    return cols, starts, ends, gwids


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", KINDS)
def test_engine_matches_reference_on_integer_data(kind, shape):
    T, B, max_w = shape
    cols, starts, ends, gwids = _launch(T, B, max_w, seed=hash(shape) % 1000)
    want = RefEngine(kind).compute(cols, starts, ends, gwids).block()
    got = WindowComputeEngine(kind, device="cpu").compute(
        cols, starts, ends, gwids).block()
    assert got.shape == want.shape == (B,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["sum", "max", "min"])
def test_engine_matches_reference_on_random_f32(kind):
    cols, starts, ends, gwids = _launch(5000, 3000, 16, seed=7,
                                        integer=False)
    want = RefEngine(kind).compute(cols, starts, ends, gwids).block()
    got = WindowComputeEngine(kind, device="cpu").compute(
        cols, starts, ends, gwids).block()
    if kind == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_handle_on_cpu_is_ready_and_trimmed():
    cols, starts, ends, gwids = _launch(100, 10, 8, seed=1)
    h = WindowComputeEngine("sum", device="cpu").compute(cols, starts, ends,
                                                         gwids)
    assert h.ready()
    assert h.block().shape == (10,)


def test_cpu_engine_does_not_launch_the_kernel():
    cols, starts, ends, gwids = _launch(5000, 3000, 16, seed=2)
    before = ws.launch_count()
    WindowComputeEngine("sum", device="cpu").compute(cols, starts, ends,
                                                     gwids).block()
    assert ws.launch_count() == before


def test_cuda_is_the_default_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WindowComputeEngine("sum", device="cuda")
    eng = WindowComputeEngine("sum")  # unbound: binds the card on use
    assert eng.device is None
    cols, starts, ends, gwids = _launch(100, 10, 8, seed=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eng.compute(cols, starts, ends, gwids)


@pytest.mark.parametrize("kind", [lambda a, b: a * b])
def test_unported_kinds_raise_naming_the_roadmap_item(kind, monkeypatch):
    """Custom window functions and user FFAT combines are ported: such an
    ffat kind runs on the CPU, and its combine lowers for the card's
    kernels.  Binding an ffat kind whose combine cannot be lowered to a
    CUDA device raises ValueError at bind (the device faked here, so
    the bind takes the card's branch without one)."""
    from windflow_tpu_torch.ops import window_compute
    from windflow_tpu_torch.ops.cuda.combine_lower import lower_combine
    assert "__fmul_rn(a, b)" in lower_combine(kind)
    cols, starts, ends, gwids = _launch(100, 10, 8, seed=4)
    got = WindowComputeEngine(("ffat", kind, 1.0), device="cpu").compute(
        cols, starts, ends, gwids).block()  # CPU: runs
    assert np.isfinite(got).all()
    monkeypatch.setattr(window_compute, "resolve_device", torch.device)
    eng = WindowComputeEngine(("ffat", lambda a, b: a if a > b else b, 1.0))
    with pytest.raises(ValueError, match="control flow"):
        eng.bind("cuda")
    assert eng.device is None


def test_ffat_kind_works_on_the_cpu():
    cols, starts, ends, gwids = _launch(5000, 3000, 16, seed=8)
    got = WindowComputeEngine(("ffat", torch.maximum, -np.inf),
                              device="cpu").compute(cols, starts, ends,
                                                    gwids).block()
    want = WindowComputeEngine("max", device="cpu").compute(
        cols, starts, ends, gwids).block()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["sum", "max"])
def test_resident_carry_answers_pane_queries(kind):
    """The resident pane carry's fused launch: new pane partials of two
    keys scattered as runs, windows answered over their pane ranges,
    a ring wrap included (capacity 8 panes)."""
    carry = ResidentPaneCarry(kind, 2, initial_keys=2, headroom=4,
                              device="cpu")
    assert carry.capacity == 8
    comb = np.add if kind == "sum" else np.maximum
    panes = {0: np.arange(1.0, 13.0), 1: np.arange(20.0, 32.0)}
    launch = carry.launch_engine()
    for k in panes:
        assert carry.row_of(k) == k
    out = launch.compute(
        {"run_rows": np.array([0, 1], np.int32),
         "run_starts": np.array([4, 4]), "run_lens": np.array([8, 8],
                                                              np.int32),
         "value": np.concatenate([panes[0][4:], panes[1][4:]]),
         "q_rows": np.array([0, 1, 1])},
        np.array([6, 9, 10]), np.array([10, 12, 12]), np.arange(3)).block()
    want = [comb.reduce(panes[0][6:10]), comb.reduce(panes[1][9:12]),
            comb.reduce(panes[1][10:12])]
    np.testing.assert_array_equal(out, want)
    assert carry.state_bytes == 2 * 2 * 8 * 4


def test_unknown_kind_is_rejected():
    with pytest.raises(ValueError):
        WindowComputeEngine("median", device="cpu")
