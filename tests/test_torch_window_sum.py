"""The port's batched window sum (windflow_tpu_torch/ops/cuda/window_sum)
held against the reference: its plain version against the Pallas kernel
``windflow_tpu/ops/pallas/window_sum.py`` (interpret mode on the CPU, as
tests/test_tpu_operators.py runs it) and against the reference engine's
XLA programs ``_tile_sum_program`` / ``_scan_program``.  (The CUDA
kernel is held against the plain version on the card by
tests/test_torch_card.py and chip_smoke.py.)

Inputs come from seeded numpy.  Tolerances: exact on integer-valued
data (every sum below 2^24 is exact in f32 whatever the order), and
``rtol=1e-5`` on random f32 data (the two sides add in different
orders).
"""
import numpy as np
import pytest
import torch

from windflow_tpu.ops.pallas.window_sum import window_sums as pallas_sums
from windflow_tpu.ops.window_compute import (_scan_program,
                                             _tile_sum_program)
from windflow_tpu_torch.ops.cuda import window_sum as ws

RTOL = 1e-5


def _extents(case, rng):
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
    if case == "end_is_T":
        return 777, np.array([0, 700, 776, 777]), np.array([777, 777, 777,
                                                            777])
    raise ValueError(case)


CASES = ["random", "empty", "single", "crosses_128_lanes", "end_is_T"]


def _se(starts, ends):
    return torch.from_numpy(np.stack([starts, ends]).astype(np.int32))


def _data(T, integer, rng):
    if integer:
        return rng.integers(0, 97, T).astype(np.float32)
    return rng.normal(size=T).astype(np.float32)


def _f64(vals, starts, ends):
    c = np.concatenate([[0.0], np.cumsum(vals.astype(np.float64))])
    return c[ends] - c[starts]


def _check(got, want, integer):
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "f32"])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_kernel(case, integer):
    rng = np.random.default_rng(CASES.index(case))
    T, starts, ends = _extents(case, rng)
    vals = _data(T, integer, rng)
    want = np.asarray(pallas_sums(vals, starts, ends))
    got = ws.window_sums_plain(torch.from_numpy(vals),
                               _se(starts, ends)).numpy()
    _check(got, want, integer)
    _check(got, _f64(vals, starts, ends), integer)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "f32"])
@pytest.mark.parametrize("case", CASES)
def test_plain_forms_match_xla_programs(case, integer):
    """tile_sum against _tile_sum_program and scan_sum against
    _scan_program("sum"), at the reference engine's padded shapes."""
    rng = np.random.default_rng(10 + CASES.index(case))
    T, starts, ends = _extents(case, rng)
    vals = _data(T, integer, rng)
    T_pad = ws.next_pow2(max(T, 2048))
    B_pad = ws.next_pow2(max(len(starts), 2048))
    padded = np.zeros(T_pad, np.float32)
    padded[:T] = vals
    se = np.zeros((2, B_pad), np.int32)
    se[0, :len(starts)], se[1, :len(starts)] = starts, ends
    v_t, se_t = torch.from_numpy(padded), torch.from_numpy(se)
    w_pad = ws.next_pow2(max(int((ends - starts).max()), 2))
    _check(ws.tile_sum(v_t, se_t, w_pad).numpy(),
           np.asarray(_tile_sum_program(w_pad)(padded, se)), integer)
    _check(ws.scan_sum(v_t, se_t).numpy(),
           np.asarray(_scan_program("sum")(padded, se)), integer)


def test_plain_switches_forms_at_tile_max_w():
    """Short extents take the gather tile, long ones the prefix scan --
    the reference engine's _TILE_MAX_W switch, kept because the scan's
    differencing carries the whole buffer's f32 rounding into each
    window."""
    from windflow_tpu.ops.window_compute import _TILE_MAX_W
    assert ws._TILE_MAX_W == _TILE_MAX_W
    # a buffer whose prefix sums lose small windows late in it
    vals = np.full(1 << 16, 1000.0, np.float32)
    vals[-3:] = [0.25, 0.5, 0.125]
    starts, ends = np.array([len(vals) - 3]), np.array([len(vals)])
    got = ws.window_sums_plain(torch.from_numpy(vals),
                               _se(starts, ends)).numpy()
    np.testing.assert_array_equal(got, [0.875])
    scan = ws.scan_sum(torch.from_numpy(vals), _se(starts, ends)).numpy()
    assert scan[0] != 0.875


def test_wrapper_runs_plain_version_on_cpu_tensors():
    rng = np.random.default_rng(3)
    T, starts, ends = _extents("random", rng)
    vals = torch.from_numpy(_data(T, True, rng))
    before = ws.launch_count()
    got = ws.window_sums(vals, _se(starts, ends))
    assert ws.launch_count() == before  # the kernel was not launched
    np.testing.assert_array_equal(
        got.numpy(), ws.window_sums_plain(vals, _se(starts, ends)).numpy())


@pytest.mark.parametrize("bad", ["dtype", "extents_dtype", "extents_shape",
                                 "not_contiguous"])
def test_wrapper_rejects_malformed_input(bad):
    vals = torch.zeros(16)
    se = torch.zeros((2, 4), dtype=torch.int32)
    if bad == "dtype":
        vals = vals.double()
    elif bad == "extents_dtype":
        se = se.long()
    elif bad == "extents_shape":
        se = torch.zeros((3, 4), dtype=torch.int32)
    else:
        vals = torch.zeros(32)[::2]
    with pytest.raises(ValueError):
        ws.window_sums(vals, se)
