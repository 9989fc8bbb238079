"""PaneFarmMesh of the port against the reference: every parametrisation
of the PaneFarmMesh cases of tests/test_mesh_farm.py, the same graph
through both packages on the same batches (tests/torch_mesh.py).  The
reference runs its ring of ``ppermute`` hops on 8 forced host devices,
the port the ring as rolls over 8 logical shards on the CPU.

Window keys, ids and arrival order must be equal exactly, every window
once.  Values: each package held to the reference test's oracle bound
(``1e-3 * max(1, |oracle|)`` for the random sums, ``1e-5`` for the
kinds, exact for the geometry edges' window counts and sums), and the
port to the reference within ``1e-5 * max(1, |reference|)``: the
packages fold the same f32 pane partials in the same tree, but the
reference's host PLQ runs its FFAT combine through jnp in f32 where the
port's runs in float64.
"""
import numpy as np
import pytest

from torch_mesh import (PACKAGES, combine, geometry_batches, geometry_oracle,
                        make_mesh, mod, ordered_batches, twin)

TOL = 1e-5


def _pane_farm(pkg, mesh, *args, **kw):
    return mod(pkg, "operators.tpu.pane_mesh").PaneFarmMesh(mesh, *args,
                                                            **kw)


def _tb(pkg):
    return mod(pkg, "core").WinType.TB


def _no_duplicates(rows):
    keys = [(k, i) for k, i, _v in rows]
    assert len(set(keys)) == len(keys), "duplicate window"


# ---------------------------------------------------------------------------
# tests/test_mesh_farm.py:87-151, :154-224, :300-341, :576-592
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("win_axis,win,slide,per_key", [
    (2, 32, 8, 600),    # wpp=4, spp=1
    (4, 96, 8, 800),    # multi-hop ring (wpp=12 > p_loc at W=4)
    (2, 12, 8, 500),    # coprime wpp=3 / spp=2
    (2, 16, 16, 300),   # tumbling
    (2, 8, 16, 300),    # sampling (slide > win): inter-window gaps
])
def test_pane_farm_mesh_matches_oracle(win_axis, win, slide, per_key):
    n_keys = 6
    vals = {k: np.random.default_rng(k).random(per_key)
            for k in range(n_keys)}
    got = twin(lambda pkg: _pane_farm(pkg, make_mesh(pkg, win_axis), win,
                                      slide, _tb(pkg), panes_per_epoch=16),
               ordered_batches(n_keys, per_key, 1024, vals), tol=TOL)
    for pkg in PACKAGES:
        _no_duplicates(got[pkg])
        rows = {(k, i): v for k, i, v in got[pkg]}
        missing, bad = 0, 0
        for k in range(n_keys):
            w = 0
            while w * slide < per_key:
                want = float(vals[k][w * slide: w * slide + win].sum())
                gv = rows.get((k, w))
                if gv is None:
                    missing += 1
                elif abs(gv - want) > 1e-3 * max(1, abs(want)):
                    bad += 1
                w += 1
        assert missing == 0 and bad == 0, (pkg, missing, bad, len(rows))


@pytest.mark.parametrize("win,slide,OFFSET", [
    (32, 8, 10_000_000_003),   # sliding
    (8, 16, 10_000_000_011),   # sampling, first id inside a gap pane
])
def test_pane_farm_mesh_large_first_timestamp_anchors(win, slide, OFFSET):
    per_key, n_keys = 300, 2
    vals = {k: np.random.default_rng(k).random(per_key)
            for k in range(n_keys)}
    got = twin(lambda pkg: _pane_farm(pkg, make_mesh(pkg, 2), win, slide,
                                      _tb(pkg), panes_per_epoch=16),
               ordered_batches(n_keys, per_key, 256, vals, offset=OFFSET),
               tol=TOL)
    for pkg in PACKAGES:
        _no_duplicates(got[pkg])
        rows = {(k, i): v for k, i, v in got[pkg]}
        assert rows, "no windows emitted"
        bad = 0
        for (k, w), gv in rows.items():
            lo, hi = w * slide, w * slide + win
            a = max(0, lo - OFFSET)
            b = max(0, min(per_key, hi - OFFSET))
            want = float(vals[k][a:b].sum()) if b > a else 0.0
            if abs(gv - want) > 1e-3 * max(1, abs(want)):
                bad += 1
        assert bad == 0, (pkg, bad, len(rows))
        for k in range(n_keys):
            w = -(-OFFSET // slide)
            while w * slide + win <= OFFSET + per_key:
                assert (k, w) in rows, (pkg, k, w)
                w += 1


@pytest.mark.parametrize("kind", ["max", "ffat"])
def test_pane_farm_mesh_kinds(kind):
    """Pane partials and the ring's window fold both run the combine
    (the port's FFAT PLQ on CPU float64 tensors)."""
    win, slide, per_key, n_keys = 32, 8, 600, 4
    vals = {k: np.random.default_rng(100 + k).normal(size=per_key)
            for k in range(n_keys)}

    def make(pkg):
        spec = (("ffat", None, combine(pkg, "minimum"), float("inf"))
                if kind == "ffat" else kind)
        return _pane_farm(pkg, make_mesh(pkg, 2), win, slide, _tb(pkg),
                          panes_per_epoch=16, kind=spec)

    got = twin(make, ordered_batches(n_keys, per_key, 512, vals), tol=TOL)
    for pkg in PACKAGES:
        rows = {(k, i): v for k, i, v in got[pkg]}
        assert rows
        bad = 0
        for k in range(n_keys):
            w = 0
            while w * slide < per_key:
                seg = vals[k][w * slide: w * slide + win]
                want = float(seg.max() if kind == "max" else seg.min())
                gv = rows.get((k, w))
                if gv is None or abs(gv - want) > 1e-5 * max(1, abs(want)):
                    bad += 1
                w += 1
        assert bad == 0, (pkg, bad, len(rows))


@pytest.mark.parametrize("geometry", [(16, 16), (8, 24), (100, 10)])
def test_pane_farm_mesh_geometry_edges(geometry):
    """Tumbling, hopping and long windows, exact against the oracle."""
    win, slide = geometry
    got = twin(lambda pkg: _pane_farm(pkg, make_mesh(pkg, 2), win, slide,
                                      _tb(pkg), panes_per_epoch=16),
               geometry_batches(4096, 4))
    for pkg in PACKAGES:
        geometry_oracle(got[pkg], 4096, 4, win, slide)
