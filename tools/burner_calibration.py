"""Calibrate [contend K1]'s throughput floor (chip_smoke.py phase 15).

The victim's paced record lane (one record a millisecond) runs beside
the neighbour's burner farm of N replicas (each record a 10 ms busy
loop holding the interpreter lock) under one ``Server``; prints the
victim's records/s over 5 s for N in (0, 1, 2, 4, 8).  The floor must
lie between the rate beside the full farm (a breach) and the rate
beside one burner (what the arbiter's squeeze reaches).

    python3 tools/burner_calibration.py     # from the repo root
"""
import os
import sys
import tempfile
import threading
import time
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402
import windflow_tpu_torch as wf  # noqa: E402
from windflow_tpu_torch.serving import Server, TenantSpec  # noqa: E402

CARD = cs.torch.cuda.is_available()
if not CARD:  # the CPU only to rehearse without a card
    cs.SERVE_DEVICE = "cpu"
LOG = os.path.join(tempfile.gettempdir(), "burner_calibration")
print(cs.card_line() if CARD else "cpu", f"{os.cpu_count()} cores",
      flush=True)
for n in (0, 1, 2, 4, 8):
    stop = threading.Event()
    vrec = {"sent": 0}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        srv = Server(capacity=1 << 16, arbiter=False)
        try:
            def build_victim(g):
                g.add_source(wf.SourceBuilder(
                    cs.paced_records(10 ** 6, 0.001, vrec)).build()) \
                    .add(wf.MapBuilder(lambda t: None).build()) \
                    .add_sink(wf.SinkBuilder(lambda r: None).build())

            def build_noisy(g, n=n):
                g.add_source(wf.SourceBuilder(
                    cs.burner_records(stop)).build()) \
                    .add(wf.MapBuilder(cs.burn_10ms).with_name("burn")
                         .with_key_by().with_parallelism(n).build()) \
                    .add_sink(wf.SinkBuilder(lambda r: None).build())

            srv.submit("vic", build_victim, TenantSpec(credits=1024),
                       config=cs.serve_config(LOG))
            if n:
                srv.submit("noisy", build_noisy, TenantSpec(credits=4096),
                           config=cs.serve_config(LOG, queue_capacity=32))
            time.sleep(1.0)
            a = vrec["sent"]
            time.sleep(5.0)
            print(f"burners {n}: victim {(vrec['sent'] - a) / 5.0:.1f} "
                  f"records/s", flush=True)
        finally:
            stop.set()
            srv.close()
