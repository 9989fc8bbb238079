"""Synthetic stream generators for tests and benchmarks (the port's copy
of ``windflow_tpu/utils/synthetic.py``: the same seeded streams).

Mirrors the reference's shared test fixtures (mp_common.hpp:125-163):
a source whose timestamps progress with Pareto-distributed increments
and bounded out-of-order jitter -- the stress input for TB windows with
triggering delays and for the PROBABILISTIC (K-slack) mode.
"""
from __future__ import annotations

import random
from typing import Any, Callable

import numpy as np

from ..core.tuples import BasicRecord, TupleBatch


def ordered_keyed_stream(n_keys: int, per_key: int,
                         value_of: Callable[[int], float] = float):
    """Round-robin keys, per-key dense ids, ts == id (the in-order
    fixture used across the suites)."""
    state = {"i": 0}

    def fn(shipper, ctx):
        i = state["i"]
        if i >= n_keys * per_key:
            return False
        key = i % n_keys
        tid = i // n_keys
        shipper.push(BasicRecord(key, tid, tid, value_of(tid)))
        state["i"] = i + 1
        return True

    return fn


def pareto_ooo_stream(n_keys: int, per_key: int, seed: int = 0,
                      alpha: float = 1.5, jitter: int = 3,
                      key_type: str = "int"):
    """Out-of-order keyed stream: per-key timestamps advance by Pareto
    increments; emission order is per-key round-robin so the merged
    stream is out of order by up to ``jitter`` positions per key
    (mp_common.hpp Pareto timestamp source).

    ``key_type='str'`` exercises non-integral keys (the reference's
    ``_string`` test variants)."""
    rnd = random.Random(seed)
    ts = {k: 0 for k in range(n_keys)}
    # round-robin across keys (NOT key-segment concatenation: that
    # would reset the merged timeline to ~0 at every key boundary,
    # giving unbounded lateness instead of the documented
    # jitter-bounded disorder)
    buffer = []
    for i in range(per_key):
        for k in range(n_keys):
            ts[k] += max(1, int(rnd.paretovariate(alpha)))
            buffer.append((k, i, ts[k]))
    # bounded shuffle: permute within consecutive windows of `jitter`,
    # INCLUDING the final partial window -- the old loop stopped at
    # len(buffer) - jitter, so the stream tail was always in order and
    # tail-sensitive paths (EOS flush of open windows, K-slack late
    # handling at stream end) were never exercised out of order
    for i in range(0, len(buffer), jitter):
        window = buffer[i:i + jitter]
        rnd.shuffle(window)
        buffer[i:i + jitter] = window
    state = {"i": 0}

    def fn(shipper, ctx):
        i = state["i"]
        if i >= len(buffer):
            # exhausted state stays sticky: parallel replicas share this
            # closure, and an auto-rewind here would hand the whole
            # buffer to a replica still in its step loop.  reset() below
            # is the explicit restart.
            return False
        k, tid, t = buffer[i]
        key: Any = f"key_{k}" if key_type == "str" else k
        shipper.push(BasicRecord(key, tid, t, float(tid)))
        state["i"] = i + 1
        return True

    def reset():
        state["i"] = 0

    fn.events = list(buffer)
    fn.reset = reset
    return fn


def batch_stream(n_events: int, n_keys: int, batch_size: int = 65536,
                 seed: int = 0):
    """Columnar batch source body for the hot plane."""
    rng = np.random.default_rng(seed)
    state = {"sent": 0}

    def fn(ctx):
        i = state["sent"]
        if i >= n_events:
            return None
        n = min(batch_size, n_events - i)
        ts = i + np.arange(n, dtype=np.int64)
        state["sent"] = i + n
        return TupleBatch({
            "key": ts % n_keys,
            "id": ts // n_keys,
            "ts": ts // n_keys,
            "value": rng.random(n),
        })

    return fn
