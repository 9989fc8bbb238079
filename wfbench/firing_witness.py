"""How many window results reach the sink while a stream runs, against
how many are due by then, where every key gets tuples for a short
stretch of event time and never again, as NEXMark's auctions get bids:
the witness that the port fires a key's time-based windows only on that
key's next tuple, not when event time passes their end.

    python3 wfbench/firing_witness.py <cuda|cpu> <seconds> <seed> \
        [<seed> ...]

Streams 1M events a second in 1 ms ticks (event n is due, and stamped,
at n microseconds; its key is n // 1000 plus a draw of 0..7 from the
seed, so a key lives ~1 ms), counts each key's events in 1 s tumbling
windows with ``KeyFarmTPU("count")``, stops, drains, and prints one JSON
line a seed: windows due before the stop, results before and after it,
the drain's seconds, and the exact comparison of every result.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from wfbench import harness  # noqa: E402

RATE = 1_000_000              # events a second; event time in us
TICK = RATE // 1000
LIFE = 1000                   # events over which a key gets tuples


def witness(device: str, seconds: float, seed: int) -> dict:
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.core.basic import WinType
    from windflow_tpu_torch.core.tuples import TupleBatch
    from windflow_tpu_torch.operators.basic_ops import Sink
    from windflow_tpu_torch.operators.batch_ops import BatchSource
    from windflow_tpu_torch.operators.tpu.farms_tpu import KeyFarmTPU

    n_max = int(RATE * (seconds + 1))
    draw = np.random.default_rng(seed).integers(0, 8, n_max)
    keys = np.arange(n_max, dtype=np.int64) // LIFE * 8 + draw
    st = {"t0": None, "sent": 0, "t_stop": None}

    def ticks(ctx=None):
        now = time.perf_counter()
        if st["t0"] is None:
            st["t0"] = now
        if now - st["t0"] >= seconds:
            st["t_stop"] = st["t_stop"] or now
            return None
        due = int((now - st["t0"]) * 1000) * TICK
        if due <= st["sent"]:
            time.sleep(max(0.0, st["t0"] + (st["sent"] // TICK + 1) / 1000
                           - time.perf_counter()))
            due = int((time.perf_counter() - st["t0"]) * 1000) * TICK
        a = st["sent"]
        b = a + max(TICK, min(65536, due - a))
        st["sent"] = b
        ids = np.arange(a, b, dtype=np.int64)
        return TupleBatch({"key": keys[a:b], "id": ids, "ts": ids,
                           "value": np.ones(b - a)})

    sink = harness.Sink(harness.make_span(False))
    g = wf.PipeGraph("firing_witness", wf.Mode.DEFAULT,
                     config=wf.RuntimeConfig(device=device))
    g.add_source(BatchSource(ticks, name="witness_source")) \
        .add(KeyFarmTPU("count", RATE, RATE, WinType.TB, batch_len=4096,
                        emit_batches=True, name="witness_count")) \
        .add_sink(Sink(sink, name="witness_sink"))
    g.run()
    drained = time.perf_counter()
    got = sink.arrays()
    # the reference: each (key, 1 s window) holding an event, its count
    sent = st["sent"]
    pair = keys[:sent] * (sent // RATE + 1) + np.arange(sent) // RATE
    u, counts = np.unique(pair, return_counts=True)
    want = {"key": u // (sent // RATE + 1), "wid": u % (sent // RATE + 1),
            "value": counts.astype(np.float64)}
    due_s = (want["wid"] + 1.0)       # a window's end, s from the start
    before = int((got["arrival"] < st["t_stop"]).sum())
    return {"seed": seed, "device": device, "seconds": seconds,
            "events": sent,
            "windows_due_before_stop": int(
                (due_s < st["t_stop"] - st["t0"]).sum()),
            "results_before_stop": before,
            "results_after_stop": len(got["key"]) - before,
            "drain_s": drained - st["t_stop"],
            "checks": harness.compare(got, want, 0.0)[0]}


if __name__ == "__main__":
    device, secs = sys.argv[1:3]
    for seed in sys.argv[3:]:
        print(json.dumps(witness(device, float(secs), int(seed))),
              flush=True)
