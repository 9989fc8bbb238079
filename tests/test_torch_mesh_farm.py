"""KeyFarmMesh and WinMapReduceMesh of the port against the reference:
every parametrisation of the KeyFarmMesh, WinMapReduceMesh and 'mean'
cases of tests/test_mesh_farm.py, the same graph through both packages
on the same batches (tests/torch_mesh.py).  The reference runs on its 8
forced host devices, the port on 8 logical shards on the CPU, where
compute_kf's sums run K1's plain version and its max/min/FFAT folds
K2r's.

Window keys, ids and arrival order must be equal exactly.  Values: the
id-sum tests compare with ``==`` (integer sums are exact in f32 in both
packages); the kinds tests hold both packages to the reference's
``1e-5 * max(1, |oracle|)`` and to each other within the same bound.
"""
import numpy as np
import pytest

from torch_mesh import (PACKAGES, PORT, by_key, combine, geometry_batches,
                        geometry_oracle, make_mesh, mod, oracle,
                        ordered_batches, run, twin)


def _key_farm(pkg, mesh, *args, **kw):
    return mod(pkg, "operators.tpu.mesh_farm").KeyFarmMesh(mesh, *args, **kw)


def _wmr(pkg, mesh, *args, **kw):
    return mod(pkg, "operators.tpu.wmr_mesh").WinMapReduceMesh(mesh, *args,
                                                               **kw)


def _tb(pkg):
    return mod(pkg, "core").WinType.TB


def _ffat_abs_max(pkg):
    return ("ffat", lambda v: np.abs(v), combine(pkg, "maximum"),
            float("-inf"))


# ---------------------------------------------------------------------------
# KeyFarmMesh: tests/test_mesh_farm.py:41-80, :81-84, :227-297, :449-517
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("win,slide", [(12, 4), (8, 8)])
def test_mesh_farm_matches_oracle(win, slide):
    n_keys, per_key = 16, 48
    got = twin(lambda pkg: _key_farm(pkg, make_mesh(pkg, 1), win, slide,
                                     _tb(pkg), batch_windows=16),
               ordered_batches(n_keys, per_key, 256))
    expect = oracle(per_key, win, slide)
    for pkg in PACKAGES:
        rows = by_key(got[pkg])
        assert set(rows) == set(range(n_keys))
        for k in rows:
            assert rows[k] == expect, (pkg, k, rows[k])


def test_mesh_farm_uses_all_shards():
    for pkg in PACKAGES:
        op = _key_farm(pkg, make_mesh(pkg, 1), 8, 4, _tb(pkg))
        assert op.engine.n_key_shards == 8


@pytest.mark.parametrize("kind", ["count", "mean", "max", "min", "ffat"])
def test_mesh_farm_kinds_match_oracle(kind):
    """Beyond sum: count/mean/max/min and FFAT lift+combine; on the
    port's CPU mean runs K1's plain version, max/min/FFAT K2r's."""
    win, slide = 12, 4
    n_keys, per_key = 8, 40
    rngs = {k: np.random.default_rng(k).normal(size=per_key)
            for k in range(n_keys)}

    def make(pkg):
        spec = _ffat_abs_max(pkg) if kind == "ffat" else kind
        return _key_farm(pkg, make_mesh(pkg, 1), win, slide, _tb(pkg),
                         batch_windows=16, kind=spec)

    got = twin(make, ordered_batches(n_keys, per_key, 256, rngs), tol=1e-5)

    def expect(seg):
        if kind == "count":
            return float(len(seg))
        if kind == "mean":
            return float(seg.mean())
        if kind == "max":
            return float(seg.max())
        if kind == "min":
            return float(seg.min())
        return float(np.abs(seg).max())

    for pkg in PACKAGES:
        rows = by_key(got[pkg])
        assert set(rows) == set(range(n_keys))
        for k in range(n_keys):
            g_ = 0
            while g_ * slide < per_key:
                want = expect(rngs[k][g_ * slide: g_ * slide + win])
                assert abs(rows[k][g_] - want) < 1e-5 * max(1, abs(want)), \
                    (pkg, kind, k, g_)
                g_ += 1


@pytest.mark.parametrize("geometry", [(8, 24), (16, 16), (1, 1),
                                      (100, 10)])
def test_key_farm_mesh_geometry_edges(geometry):
    """Hopping once lost every key's final window."""
    win, slide = geometry
    got = twin(lambda pkg: _key_farm(pkg, make_mesh(pkg, 1), win, slide,
                                     _tb(pkg), batch_windows=8),
               geometry_batches(4096, 16))
    for pkg in PACKAGES:
        geometry_oracle(got[pkg], 4096, 16, win, slide)


def test_key_farm_mesh_sparse_hopping_no_empty_windows():
    """A gap id far ahead must not fabricate empty windows."""
    ts = np.array([0, 1, 2, 3, 4, 5, 130], np.int64)
    batch = {"key": np.zeros(len(ts), np.int64), "id": ts, "ts": ts,
             "value": np.ones(len(ts))}
    got = twin(lambda pkg: _key_farm(pkg, make_mesh(pkg, 1), 8, 24,
                                     _tb(pkg), batch_windows=4), [batch])
    for pkg in PACKAGES:
        assert sorted((i, v) for _k, i, v in got[pkg]) == [(0, 6.0)]


# ---------------------------------------------------------------------------
# WinMapReduceMesh: tests/test_mesh_farm.py:344-446, :520-524
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("win_axis", [2, 4, 8])
@pytest.mark.parametrize("win,slide", [(12, 4), (8, 8), (4, 12)])
def test_wmr_mesh_matches_oracle(win_axis, win, slide):
    n_keys, per_key = 6, 48
    ops = {}

    def make(pkg):
        ops[pkg] = _wmr(pkg, make_mesh(pkg, win_axis), win, slide, _tb(pkg),
                        batch_windows=16)
        return ops[pkg]

    got = twin(make, ordered_batches(n_keys, per_key, 200))
    expect = oracle(per_key, win, slide)
    for pkg in PACKAGES:
        assert ops[pkg].engine.n_win_shards == win_axis
        rows = by_key(got[pkg])
        assert set(rows) == set(range(n_keys))
        for k in rows:
            assert rows[k] == expect, (pkg, k, rows[k])


@pytest.mark.parametrize("kind", ["count", "max", "min", "ffat"])
def test_wmr_mesh_kinds_match_oracle(kind):
    win, slide = 12, 4
    n_keys, per_key = 5, 40
    rngs = {k: np.random.default_rng(100 + k).normal(size=per_key)
            for k in range(n_keys)}

    def make(pkg):
        spec = _ffat_abs_max(pkg) if kind == "ffat" else kind
        return _wmr(pkg, make_mesh(pkg, 4), win, slide, _tb(pkg),
                    batch_windows=16, kind=spec)

    got = twin(make, ordered_batches(n_keys, per_key, 128, rngs), tol=1e-5)

    def expect(seg):
        if kind == "count":
            return float(len(seg))
        if kind == "max":
            return float(seg.max())
        if kind == "min":
            return float(seg.min())
        return float(np.abs(seg).max())

    for pkg in PACKAGES:
        rows = by_key(got[pkg])
        assert set(rows) == set(range(n_keys))
        for k in range(n_keys):
            g_ = 0
            while g_ * slide < per_key:
                want = expect(rngs[k][g_ * slide: g_ * slide + win])
                assert abs(rows[k][g_] - want) < 1e-5 * max(1, abs(want)), \
                    (pkg, kind, k, g_)
                g_ += 1


def test_mesh_mean_rejected_on_wmr():
    for pkg in PACKAGES:
        with pytest.raises(ValueError, match="mean"):
            _wmr(pkg, make_mesh(pkg, 2), 8, 4, _tb(pkg), kind="mean")


def test_mesh_mean_rejected_on_pane_farm():
    for pkg in PACKAGES:
        cls = mod(pkg, "operators.tpu.pane_mesh").PaneFarmMesh
        with pytest.raises(ValueError, match="mean"):
            cls(make_mesh(pkg, 2), 8, 4, _tb(pkg), kind="mean")


def test_port_mesh_farm_records_plane_matches_batches():
    """Port only: ``emit_batches=False`` emits the same windows as
    records, in the same order, as the batch plane."""
    batches = ordered_batches(8, 40, 256)
    rows = {eb: run(PORT, _key_farm(PORT, make_mesh(PORT, 1), 12, 4,
                                    _tb(PORT), batch_windows=16,
                                    emit_batches=eb), batches)
            for eb in (True, False)}
    assert rows[True] == rows[False] and len(rows[True]) == 8 * 10
