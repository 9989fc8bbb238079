"""Shared harness of the mesh plane's twins: one mesh graph, built by a
function of the package, runs through the reference (``windflow_tpu``,
on the 8 forced host devices of tests/conftest.py) and the port
(``windflow_tpu_torch``, on ``make_mesh(8, ..., device="cpu")``: 8
logical shards on the CPU) on the same batches, made with numpy.

A mesh operator is one logic with one sink behind it, so the sink's
arrival order is deterministic in both packages: window keys, ids and
their order must be equal exactly, values within the tolerance the
reference test states.
"""
import importlib
import threading

import numpy as np

PACKAGES = ("windflow_tpu", "windflow_tpu_torch")
PORT = "windflow_tpu_torch"


def mod(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


def make_mesh(pkg, win_axis, n=8):
    mk = mod(pkg, "parallel.mesh").make_mesh
    if pkg == PORT:
        return mk(n, win_axis=win_axis, device="cpu")
    return mk(n, win_axis=win_axis)


def combine(pkg, name):
    """``jnp.<name>`` for the reference, ``torch.<name>`` for the port."""
    if pkg == PORT:
        import torch
        return getattr(torch, name)
    import jax.numpy as jnp
    return getattr(jnp, name)


def ordered_batches(n_keys, per_key, chunk, values=None, offset=0):
    """The reference tests' batch streams: index i -> key i % n_keys,
    id = ts = offset + i // n_keys, value ``values[key][i // n_keys]``
    (default: float(i // n_keys)), in chunks of ``chunk``."""
    out = []
    total = n_keys * per_key
    for i in range(0, total, chunk):
        idx = i + np.arange(min(chunk, total - i))
        keys, pos = idx % n_keys, idx // n_keys
        if values is None:
            vals = pos.astype(np.float64)
        else:
            vals = np.empty(len(idx))
            for k in range(n_keys):
                m = keys == k
                vals[m] = values[k][pos[m]]
        ids = offset + pos
        out.append({"key": keys, "id": ids, "ts": ids, "value": vals})
    return out


class Rows:
    """Sink callback: every (key, id, value) in arrival order."""

    def __init__(self):
        self.lock = threading.Lock()
        self.rows = []

    def __call__(self, item):
        if item is None:
            return
        with self.lock:
            if hasattr(item, "get_control_fields"):
                self.rows.append((int(item.key), int(item.id),
                                  float(item.value)))
            else:
                self.rows.extend(zip(
                    np.asarray(item.key).tolist(),
                    np.asarray(item.id).tolist(),
                    np.asarray(item["value"], np.float64).tolist()))


def run(pkg, op, batches):
    """source -> ``op`` -> sink in package ``pkg``; the sink's rows."""
    wf = importlib.import_module(pkg)
    TupleBatch = mod(pkg, "core.tuples").TupleBatch
    BatchSource = mod(pkg, "operators.batch_ops").BatchSource
    Sink = mod(pkg, "operators.basic_ops").Sink
    it = iter(batches)

    def source(ctx):
        b = next(it, None)
        return None if b is None else TupleBatch(
            {k: v.copy() for k, v in b.items()})

    rows = Rows()
    g = wf.PipeGraph("mesh", wf.Mode.DEFAULT)
    g.add_source(BatchSource(source)).add(op).add_sink(Sink(rows))
    g.run()
    return rows.rows


def twin(make_op, batches, tol=None):
    """The graph ``make_op(pkg)`` through both packages.  Keys, ids and
    arrival order equal; values equal (``tol`` None) or within ``tol``
    relative to max(1, |reference value|), as the reference tests
    compare with their oracles.  Returns {pkg: rows}."""
    got = {pkg: run(pkg, make_op(pkg), batches) for pkg in PACKAGES}
    want, port = got[PACKAGES[0]], got[PORT]
    assert [r[:2] for r in port] == [r[:2] for r in want]
    pv = np.array([r[2] for r in port])
    wv = np.array([r[2] for r in want])
    if tol is None:
        assert np.array_equal(pv, wv), np.nonzero(pv != wv)
    else:
        bad = np.abs(pv - wv) > tol * np.maximum(1.0, np.abs(wv))
        assert not bad.any(), (np.nonzero(bad), pv[bad], wv[bad])
    return got


def by_key(rows):
    out = {}
    for k, i, v in rows:
        out.setdefault(k, {})[i] = v
    return out


def oracle(per_key, win, slide):
    """The reference tests' id-sum oracle: gwid -> sum of ids in
    [g*slide, g*slide + win), every window whose start was reached."""
    out = {}
    g = 0
    while g * slide < per_key:
        out[g] = float(sum(v for v in range(per_key)
                           if g * slide <= v < g * slide + win))
        g += 1
    return out


def geometry_batches(n, nk):
    """The geometry tests' stream: uniform ones, 512 a batch."""
    out = []
    for i in range(0, n, 512):
        idx = i + np.arange(min(512, n - i))
        ids = idx // nk
        out.append({"key": idx % nk, "id": ids, "ts": ids,
                    "value": np.ones(len(idx))})
    return out


def geometry_oracle(rows, n, nk, win, slide):
    """The reference's _run_geometry_oracle check: windows and their
    sum equal the closed form's."""
    per_key = n // nk
    ew, es, gi = 0, 0, 0
    while gi * slide < per_key:
        ew += 1
        es += max(0, min(per_key, gi * slide + win) - gi * slide)
        gi += 1
    assert (len(rows), sum(r[2] for r in rows)) == (ew * nk, float(es * nk))
