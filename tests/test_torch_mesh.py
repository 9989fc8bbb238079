"""The port's mesh plane (windflow_tpu_torch/parallel/) against the
reference: every case of tests/test_parallel.py twinned -- the
reference on its 8 forced host devices, the port on
``make_mesh(8, ..., device="cpu")`` (8 logical shards on the CPU) --
with the same inputs, made with numpy; the two-process exercise on
gloo; and the port's own cases (no card: the default mesh raises;
compute_kf's one-launch layout against a fold per row).

Tolerances are the reference tests' own (rtol 1e-5, the ring 1e-4),
for each package against numpy and for the port against the
reference.  Max and min on +0/-0 values with NaN are held bit for bit
against the reference on every path (ROADMAP C12).
"""
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_graphs import assert_same_bits, signed_zeros
from torch_mesh import PACKAGES, PORT, make_mesh, mod

REPO = Path(__file__).resolve().parents[1]


def _engine(pkg, mesh, *args, **kw):
    return mod(pkg, "parallel.sharded").ShardedWindowEngine(mesh, *args,
                                                            **kw)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _steps(win, slide, **kw):
    """The fused step of both packages on their example inputs (equal
    draws): {pkg: (inputs, outputs)} as numpy."""
    out = {}
    for pkg in PACKAGES:
        eng = _engine(pkg, make_mesh(pkg, 2), win_len=win, slide_len=slide)
        args = eng.example_inputs(**kw)
        out[pkg] = ([_np(a) for a in args],
                    [_np(r) for r in eng.step(*args)])
    ref_in, port_in = out[PACKAGES[0]][0], out[PORT][0]
    for a, b in zip(ref_in, port_in):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    return out


# ---------------------------------------------------------------------------
# tests/test_parallel.py:27-104
# ---------------------------------------------------------------------------

def test_mesh_shape():
    for pkg in PACKAGES:
        mesh = make_mesh(pkg, 2)
        assert mesh.shape["key"] == 4
        assert mesh.shape["win"] == 2


def test_kf_path_key_sharded_sums():
    got = _steps(16, 8)
    for pkg, (args, (kf, _, _)) in got.items():
        v, s, e = args[:3]
        expect = np.stack([[v[k, s[k, i]:e[k, i]].sum()
                            for i in range(s.shape[1])]
                           for k in range(v.shape[0])])
        np.testing.assert_allclose(kf, expect, rtol=1e-5)
    np.testing.assert_allclose(got[PORT][1][0], got[PACKAGES[0]][1][0],
                               rtol=1e-5)


def test_wmr_path_psum_over_win_axis():
    got = _steps(16, 8)
    for pkg, (args, (_, wmr, _)) in got.items():
        assert wmr.shape[1] == 1
        np.testing.assert_allclose(wmr[:, 0, :], args[3].sum(axis=(1, 3)),
                                   rtol=1e-5)
    np.testing.assert_allclose(got[PORT][1][1], got[PACKAGES[0]][1][1],
                               rtol=1e-5)


def test_pf_path_pane_combine():
    got = _steps(8, 4, pane_len=4, panes_per_shard=4)
    for pkg, (args, (_, _, pf)) in got.items():
        pane = args[4]  # [K, W, P_loc, pane_len]
        partials = pane.sum(axis=-1).reshape(pane.shape[0], -1)
        wpp, spp = 8 // 4, 4 // 4
        n_win = (partials.shape[1] - wpp) // spp + 1
        expect = np.stack([[partials[k, w * spp: w * spp + wpp].sum()
                            for w in range(n_win)]
                           for k in range(partials.shape[0])])
        np.testing.assert_allclose(pf, expect, rtol=1e-5)
    np.testing.assert_allclose(got[PORT][1][2], got[PACKAGES[0]][1][2],
                               rtol=1e-5)


def test_key_sharding_layout():
    """Every slot holds a key shard, replicated over 'win'."""
    import jax
    ref = mod(PACKAGES[0], "parallel.mesh")
    x = jax.device_put(np.zeros((8, 4)),
                       ref.key_sharding(make_mesh(PACKAGES[0], 2), rank=2))
    assert len(x.sharding.device_set) == 8
    port = mod(PORT, "parallel.mesh")
    mesh = make_mesh(PORT, 2)
    sh = port.key_sharding(mesh, rank=2)
    assert sh.spec == ("key", None) and len(sh.device_set) == 8
    data = np.arange(32, dtype=np.float32).reshape(8, 4)
    shards = port.key_shards(data, sh)
    assert set(shards) == sh.device_set
    for k, row in enumerate(mesh.devices):
        for slot in row:  # replicated over 'win'
            assert np.array_equal(shards[slot].numpy(),
                                  data[2 * k: 2 * k + 2])


@pytest.mark.parametrize("win_axis,win,slide,pane", [
    (2, 16, 8, 4),
    (4, 32, 8, 4),    # windows span chunks
    (8, 64, 16, 4),   # full 8-ring
    (4, 96, 8, 4),    # wpp > p_loc: multi-hop ring
])
def test_pf_ring_matches_numpy(win_axis, win, slide, pane):
    """Ring pane combine == numpy sliding sums, in both packages."""
    outs = {}
    for pkg in PACKAGES:
        mesh = make_mesh(pkg, win_axis)
        eng = _engine(pkg, mesh, win_len=win, slide_len=slide)
        K = mesh.shape["key"] * 2
        p_total = 8 * win_axis
        rng = np.random.default_rng(3)
        pane_vals = rng.normal(size=(K, p_total, pane)).astype(np.float32)
        out = outs[pkg] = _np(eng.compute_pf_ring(pane_vals, pane))
        partials = pane_vals.sum(-1)
        wpp, spp = win // pane, slide // pane
        for k in range(K):
            for w in range(out.shape[1]):
                g = w * spp
                want = (partials[k, g:g + wpp].sum() if g + wpp <= p_total
                        else 0.0)
                np.testing.assert_allclose(out[k, w], want, rtol=1e-4,
                                           err_msg=f"{pkg} k={k} w={w}")
    np.testing.assert_allclose(outs[PORT], outs[PACKAGES[0]], rtol=1e-4)


def test_make_multihost_mesh_single_process_fallback():
    ref = mod(PACKAGES[0], "parallel.mesh").make_multihost_mesh(win_axis=2)
    port = mod(PORT, "parallel.mesh").make_multihost_mesh(win_axis=2,
                                                          device="cpu")
    for mesh in (ref, port):
        assert mesh.shape["win"] == 2 and mesh.shape["key"] >= 1
    assert port.group is None


_GLOO_WORKER = r"""
import datetime, sys
pid, port = int(sys.argv[1]), sys.argv[2]
import numpy as np
import torch
import torch.distributed as dist
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=pid,
                        timeout=datetime.timedelta(seconds=60))
from windflow_tpu_torch.parallel.mesh import make_multihost_mesh
from windflow_tpu_torch.parallel.sharded import ShardedWindowEngine

mesh = make_multihost_mesh(win_axis=2, n_local=4, device="cpu")
assert mesh.shape == {"key": 4, "win": 2}, mesh.shape
assert mesh.size == 8
# every 'win' row inside one process (the combines' locality)
for row in mesh.devices:
    assert len({d.process_index for d in row}) == 1, mesh.devices
assert mesh.key_rows == (2 * pid, 2 * pid + 2), mesh.key_rows

# the WMR REDUCE over the 2-process mesh: per-key-row sums combined
# over 'win' in each process, the key rows all_gathered, vs numpy
rows = 8
x = np.arange(rows * 16, dtype=np.float32).reshape(rows, 16)
eng = ShardedWindowEngine(mesh, 1, 1, "sum")
got = eng.compute_wmr(x.reshape(rows, 2, 1, 8)).numpy()
np.testing.assert_allclose(got[:, 0], x.sum(-1), rtol=1e-6)
dist.destroy_process_group()
assert "jax" not in sys.modules and "windflow_tpu" not in sys.modules
print(f"proc {pid}: ok", flush=True)
"""


def test_multihost_mesh_two_process_dcn_exercise(tmp_path):
    """Two real processes form the ('key', 'win') mesh over a gloo
    process group (4 logical shards each) and run the WMR combine with
    its key rows gathered across them, checked against numpy in each
    process; neither imports jax."""
    def fresh_port():
        with socket.socket() as s_:
            s_.bind(("127.0.0.1", 0))
            return s_.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_GLOO_WORKER)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")

    def run_workers(port):
        procs = [subprocess.Popen(
            [sys.executable, str(script), str(i), str(port)],
            env=env, cwd=str(REPO), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for i in (0, 1)]
        deadline = time.monotonic() + 150
        outs = ["", ""]
        timed_out = False
        for i, p in enumerate(procs):
            try:
                outs[i], _ = p.communicate(
                    timeout=max(1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                timed_out = True
                p.kill()
                outs[i], _ = p.communicate()
        return procs, outs, timed_out

    # a port picked here can be stolen before rank 0 binds it: one retry
    # on a fresh port covers that race without masking real failures
    for attempt in range(2):
        procs, outs, timed_out = run_workers(fresh_port())
        stolen = any("EADDRINUSE" in o or "Address already in use" in o
                     for o in outs)
        if not (timed_out or stolen) or attempt == 1:
            break
    if timed_out:
        pytest.fail("gloo workers timed out:\n"
                    + "\n".join(o[-2000:] for o in outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (i, out[-2000:])
        assert f"proc {i}: ok" in out, (i, out[-2000:])


# ---------------------------------------------------------------------------
# port only
# ---------------------------------------------------------------------------

def test_default_mesh_needs_the_card():
    """No fallback: without CUDA the default mesh raises, and so does a
    KeyFarmMesh built on it; the CPU only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import windflow_tpu_torch as wf
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wf.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wf.make_multihost_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wf.KeyFarmMesh(wf.make_mesh(8), 8, 4, wf.WinType.TB)
    mesh = wf.make_mesh(device="cpu")
    assert mesh.shape == {"key": 1, "win": 1} and mesh.device.type == "cpu"
    with pytest.raises(ValueError, match="not divisible"):
        wf.make_mesh(6, win_axis=4, device="cpu")


def _row_fold(kind, v, s, e):
    """One FlatFAT per row (the reference's vmapped per-row tree) with
    the plain query, the same combine; 0 for empty extents."""
    from windflow_tpu_torch.ops.cuda.flatfat_query import (
        build_tree, flatfat_query_plain)
    from windflow_tpu_torch.ops.cuda.window_sum import next_pow2
    comb, neutral = kind
    rows = []
    for r in range(v.shape[0]):
        leaves = torch.full((next_pow2(max(v.shape[1], 2)),), neutral)
        leaves[: v.shape[1]] = torch.from_numpy(v[r])
        tree = build_tree(leaves, comb, neutral)
        out = flatfat_query_plain(tree, None, torch.from_numpy(s[r]),
                                  torch.from_numpy(e[r]), comb, neutral)
        rows.append(torch.where(torch.from_numpy(e[r] > s[r]), out,
                                torch.zeros_like(out)))
    return torch.stack(rows).numpy()


def left_weighted(a, b):
    """Non-commutative and not associative: a fold under it shows which
    nodes were combined, in which order and grouping."""
    return a * 0.5 + b


# kind -> (combine, neutral) of the per-row fold
FOLDS = {"max": (torch.maximum, float("-inf")),
         "min": (torch.minimum, float("inf")),
         "left_weighted": (left_weighted, 0.0),
         "logaddexp": (torch.logaddexp, float("-inf"))}


@pytest.mark.parametrize("S,T", [(3, 16), (5, 64), (8, 256), (3, 1024)])
@pytest.mark.parametrize("kind", ["sum", "mean", "count", "max", "min",
                                  "left_weighted", "logaddexp"])
def test_compute_kf_one_launch_layout_equals_per_row(kind, S, T):
    """compute_kf lays every shard's row end to end for one K1 / K2r
    launch (extents offset by the row's stride; a tree of
    next_pow2(S) * T leaves, at least 2048): the same windows as a
    fold per row, for a non-power-of-two S and for S * T below 2048.
    Sums on integer data (exact in f32) and folds under max, min and
    the non-associative ``left_weighted`` bitwise the per-row tree's
    (the same nodes, order and grouping); ``logaddexp`` within rtol
    1e-6, because torch's CPU kernel rounds a lane of its vector body
    and of its scalar tail differently."""
    from windflow_tpu_torch.parallel.mesh import make_mesh as port_mesh
    from windflow_tpu_torch.parallel.sharded import ShardedWindowEngine
    rng = np.random.default_rng(S * T)
    B = 12
    starts = rng.integers(0, T, (S, B)).astype(np.int32)
    ends = np.minimum(starts + rng.integers(0, 9, (S, B)), T).astype(
        np.int32)
    ends[:, 0] = starts[:, 0]          # an empty window a row
    starts[:, 1], ends[:, 1] = 0, T    # a whole row
    if kind in ("sum", "mean", "count"):
        values = rng.integers(0, 97, (S, T)).astype(np.float32)
    else:
        values = rng.normal(size=(S, T)).astype(np.float32)
    spec = ("ffat",) + FOLDS[kind] if kind in ("left_weighted",
                                               "logaddexp") else kind
    eng = ShardedWindowEngine(port_mesh(S, device="cpu"), 8, 4, spec)
    got = eng.compute_kf(values, starts, ends).numpy()
    n = (ends - starts).astype(np.float64)
    c = np.concatenate([np.zeros((S, 1)), np.cumsum(values, 1,
                                                    dtype=np.float64)], 1)
    sums = np.take_along_axis(c, ends, 1) - np.take_along_axis(c, starts, 1)
    if kind == "sum":
        want = sums
    elif kind == "mean":
        want = (sums.astype(np.float32)
                / np.maximum(n, 1).astype(np.float32))
    elif kind == "count":
        want = n
    else:
        want = _row_fold(FOLDS[kind], values, starts, ends)
    assert got.shape == (S, B) and got.dtype == np.float32
    if kind == "logaddexp":
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        assert np.array_equal(got, want.astype(np.float32)), (got, want)


def test_kf_engine_on_a_mesh_of_one_shard_matches_the_cpu_window_engine():
    """compute_kf on one shard equals the port's single-engine window
    engine on the same extents (both on the CPU)."""
    from windflow_tpu_torch.ops.window_compute import WindowComputeEngine
    from windflow_tpu_torch.parallel.mesh import make_mesh as port_mesh
    from windflow_tpu_torch.parallel.sharded import ShardedWindowEngine
    rng = np.random.default_rng(7)
    T, B = 4096, 256
    vals = rng.integers(0, 97, T).astype(np.float32)
    starts = np.sort(rng.integers(0, T - 64, B)).astype(np.int32)
    ends = (starts + rng.integers(1, 64, B)).astype(np.int32)
    eng = ShardedWindowEngine(port_mesh(1, device="cpu"), 64, 32, "sum")
    got = eng.compute_kf(vals[None], starts[None], ends[None]).numpy()[0]
    want = WindowComputeEngine("sum", device="cpu").compute(
        {"value": vals}, starts, ends, np.arange(B)).block()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 7, 16])
def test_pairwise_fold_takes_numpy_and_torch(n):
    """The port's pairwise_fold folds a numpy array (numpy combine) and
    a torch tensor (torch combine) alike, odd widths padded with the
    neutral: the same tree, so a non-associative combine gives the same
    values on both."""
    from windflow_tpu_torch.parallel.sharded import pairwise_fold
    x = np.random.default_rng(n).normal(size=(3, n)).astype(np.float32)
    got_np = pairwise_fold(x, left_weighted, 0.0)
    got_t = pairwise_fold(torch.from_numpy(x), left_weighted, 0.0)
    assert isinstance(got_np, np.ndarray) and got_np.shape == (3,)
    np.testing.assert_array_equal(got_np, got_t.numpy())
    np.testing.assert_array_equal(
        pairwise_fold(x, np.maximum, -np.inf), x.max(-1))



@pytest.mark.parametrize("kind", ["sum", "mean"])
def test_compute_kf_at_config4_feed_matches_the_reference(kind):
    """compute_kf's sums and means on the CPU at config 4's feed (value
    e % 97) as [8, 2^18] rows, windows 4096 / 2048: each row scanned on
    its own, as the reference's per-row cumsum, within the reference
    test's rtol 1e-5 of the reference's compute_kf on its 8-device mesh
    (a scan over all rows laid end to end missed it by 3.6e-5)."""
    S, T, win, slide = 8, 1 << 18, 4096, 2048
    values = (np.arange(S * T) % 97).astype(np.float32).reshape(S, T)
    w = np.arange((T - 1) // slide + 1)
    starts = np.broadcast_to(w * slide, (S, len(w))).astype(np.int32)
    ends = np.minimum(starts + win, T).astype(np.int32)
    got = {}
    for pkg in PACKAGES:
        eng = _engine(pkg, make_mesh(pkg, 1), win, slide, kind)
        got[pkg] = _np(eng.compute_kf(values, starts, ends))
    c = np.concatenate([np.zeros((S, 1)),
                        np.cumsum(values, 1, dtype=np.float64)], 1)
    want = np.take_along_axis(c, ends, 1) - np.take_along_axis(c, starts, 1)
    if kind == "mean":
        want = want / (ends - starts)
    assert got[PORT].shape == (S, len(w)) and got[PORT].dtype == np.float32
    np.testing.assert_allclose(got[PORT], got[PACKAGES[0]], rtol=1e-5)
    np.testing.assert_allclose(got[PORT], want, rtol=1e-5)


def _signed_zero_inputs(path, kind):
    """(win_axis, win, slide, args) of one path's call: +0/-0 values
    with NaN, at the shapes of the twins above."""
    rng = np.random.default_rng(["kf", "wmr", "pf_ring"].index(path))
    if path == "kf":  # 8 key rows, windows of 0..8 leaves
        T, B = 64, 16
        starts = rng.integers(0, T, (8, B)).astype(np.int32)
        ends = np.minimum(starts + rng.integers(0, 9, (8, B)), T).astype(
            np.int32)
        return 1, 8, 4, (signed_zeros(rng, (8, T), kind, n_nan=2), starts,
                         ends)
    if path == "wmr":  # [K_rows, W_shards, B, stripe_len]
        return 2, 8, 4, (signed_zeros(rng, (8, 2, 6, 5), kind, n_nan=2,
                                      zero_rate=0.3),)
    # [K, W_shards * P_loc, pane_len]: 8 panes a window, 2 a slide
    return 4, 32, 8, (signed_zeros(rng, (8, 32, 4), kind, n_nan=2,
                                   zero_rate=0.2), 4)


@pytest.mark.parametrize("path", ["kf", "wmr", "pf_ring"])
@pytest.mark.parametrize("kind", ["max", "min"])
def test_signed_zeros_match_the_reference(kind, path):
    """compute_kf (the plain K2r fold), compute_wmr and compute_pf_ring
    (``_fold``'s reductions) order -0 below +0 and propagate NaN as the
    reference's XLA programs do: bit for bit."""
    win_axis, win, slide, args = _signed_zero_inputs(path, kind)
    got = {}
    for pkg in PACKAGES:
        eng = _engine(pkg, make_mesh(pkg, win_axis), win, slide, kind)
        got[pkg] = _np(getattr(eng, f"compute_{path}")(*args))
    want = got[PACKAGES[0]]
    assert (want == 0).any()
    assert_same_bits(got[PORT], want)
