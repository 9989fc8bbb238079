"""The port's synthetic stream fixtures (windflow_tpu_torch/utils/
synthetic.py) against the reference's (windflow_tpu/utils/synthetic.py):
the same seeded streams, record for record and batch for batch, and the
reference's own checks of the bounded-shuffle fixture
(tests/test_synthetic.py) held on the port's copy.  Everything is exact:
the generators are numpy and Python ``random``, no device code runs.
"""
import numpy as np
import pytest

from torch_graphs import PACKAGES, PORT, mod


def _drain(pkg, fn):
    Shipper = mod(pkg, "core.shipper").Shipper
    out = []
    while fn(Shipper(out.append), None):
        pass
    return [(r.key, r.id, r.ts, r.value) for r in out]


def _synthetic(pkg):
    return mod(pkg, "utils.synthetic")


@pytest.mark.parametrize("key_type", ["int", "str"])
@pytest.mark.parametrize("n_keys,per_key,seed,jitter",
                         [(4, 9, 1, 4), (3, 5, 2, 3), (3, 20, 4, 3),
                          (7, 50, 0, 5)])
def test_pareto_ooo_stream_matches_reference(n_keys, per_key, seed, jitter,
                                             key_type):
    ref, port = (_synthetic(pkg).pareto_ooo_stream(
        n_keys, per_key, seed=seed, jitter=jitter, key_type=key_type)
        for pkg in PACKAGES)
    assert port.events == ref.events
    assert _drain(PORT, port) == _drain(PACKAGES[0], ref)


@pytest.mark.parametrize("n_keys,per_key", [(1, 10), (4, 25), (16, 7)])
def test_ordered_keyed_stream_matches_reference(n_keys, per_key):
    streams = [_drain(pkg, _synthetic(pkg).ordered_keyed_stream(
        n_keys, per_key, value_of=lambda i: 0.5 * i)) for pkg in PACKAGES]
    assert streams[1] == streams[0]
    assert len(streams[1]) == n_keys * per_key


@pytest.mark.parametrize("n_events,n_keys,batch_size,seed",
                         [(20_000, 8, 4096, 0), (1000, 3, 1000, 5),
                          (70_001, 16, 65_536, 2)])
def test_batch_stream_matches_reference(n_events, n_keys, batch_size, seed):
    fns = [_synthetic(pkg).batch_stream(n_events, n_keys, batch_size, seed)
           for pkg in PACKAGES]
    sent = 0
    while True:
        ref, port = (fn(None) for fn in fns)
        if ref is None:
            assert port is None
            break
        assert type(port).__module__.startswith(PORT)
        assert sorted(port.cols) == sorted(ref.cols)
        for c in ref.cols:
            np.testing.assert_array_equal(port[c], ref[c])
            assert port[c].dtype == ref[c].dtype
        sent += len(ref)
    assert sent == n_events


# the reference's checks of the fixture (tests/test_synthetic.py), on the
# port's copy

def test_port_pareto_ooo_disorder_is_jitter_bounded():
    n_keys, per_key, jitter = 4, 9, 4
    fn = _synthetic(PORT).pareto_ooo_stream(n_keys, per_key, seed=1,
                                            jitter=jitter)
    assert len(fn.events) == n_keys * per_key
    for pos, (k, i, _ts) in enumerate(fn.events):
        assert abs(pos - (i * n_keys + k)) < jitter


def test_port_pareto_ooo_tail_is_permuted():
    n_keys, per_key, jitter = 4, 9, 4
    permuted_tail = False
    for seed in range(8):
        fn = _synthetic(PORT).pareto_ooo_stream(n_keys, per_key, seed=seed,
                                                jitter=jitter)
        in_order = [(i * n_keys + k) for k, i, _ in fn.events[-jitter:]]
        if in_order != sorted(in_order):
            permuted_tail = True
            break
    assert permuted_tail, "stream tail is never out of order"


def test_port_pareto_ooo_stream_is_restartable():
    Shipper = mod(PORT, "core.shipper").Shipper
    fn = _synthetic(PORT).pareto_ooo_stream(3, 5, seed=2, jitter=3)
    first = _drain(PORT, fn)
    assert len(first) == 15
    assert _drain(PORT, fn) == []
    fn.reset()
    assert _drain(PORT, fn) == first
    fn(Shipper(lambda r: None), None)
    fn.reset()
    assert _drain(PORT, fn) == first


def test_port_pareto_ooo_timestamps_advance_per_key():
    fn = _synthetic(PORT).pareto_ooo_stream(3, 20, seed=4, jitter=3)
    per_key = {}
    for k, _i, ts in sorted(fn.events, key=lambda e: (e[0], e[1])):
        if k in per_key:
            assert ts > per_key[k]
        per_key[k] = ts
