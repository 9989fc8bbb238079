"""The bytes a benchmark cell's BatchFilter selects and gathers.

Run from the root of a checkout (on the card, or ``--device cpu``):

    python3 tools/filter_bytes.py --workload ysb.saturate \
        --seed 7300000012 --events 16777216

It streams ``--events`` events of the cell's traffic through the cell's
pipeline (``wfbench/configs/<config>.py``) with tracing on, closes the
stream, checks every window against the cell's reference and prints a
JSON object with the filter's ``Bytes_selected`` (what an eager take of
the kept rows copies) and ``Bytes_gathered`` (the columns its consumer
read), their ratio, the kept rows and the bytes of each a row.
"""
import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from wfbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="ysb.saturate")
    ap.add_argument("--seed", type=int, default=7300000012)
    ap.add_argument("--events", type=int, default=1 << 24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.core.tuples import TupleBatch

    spec = harness.Spec(args.workload)
    cfg, cell = spec.config, spec.cell
    stream = spec.config_mod.make_stream(cfg, cell, args.seed)
    batch = int(cell["source_batch"])
    sent = {"n": 0}

    def source(ctx=None):
        n = min(batch, args.events - sent["n"])
        if n <= 0:
            return None
        b = TupleBatch(stream.columns(sent["n"], n))
        sent["n"] += n
        return b

    source.stream = stream
    sink = harness.Sink(harness.make_span(False))
    with tempfile.TemporaryDirectory() as logs:
        g = wf.PipeGraph(f"filter_bytes_{args.workload}", wf.Mode.DEFAULT,
                         config=wf.RuntimeConfig(device=args.device,
                                                 tracing=True,
                                                 log_dir=logs))
        spec.config_mod.build(g, cfg, cell, source, sink,
                              harness.make_span(False))
        g.run()
        stats = json.loads(g.stats.to_json())
    want = spec.reference.windows(cfg, cell, stream, args.events)
    checks, _pairs, wrong = harness.compare(sink.arrays(), want, 0.0)
    same = wrong == 0 and all(v[0] == 0 for v in checks.values())
    rec = [dict(r, Operator=op["Operator_name"])
           for op in stats["Operators"] for r in op["Replicas"]
           if "Bytes_selected" in r]
    out = {"workload": args.workload, "seed": args.seed,
           "events": args.events, "device": args.device,
           "windows": int(len(want["key"])), "checks": checks,
           "windows_equal_reference": bool(same), "records": [
               {k: r[k] for k in ("Operator", "Bytes_selected",
                                  "Bytes_gathered")} for r in rec]}
    if len(rec) == 1:
        sel, gat = rec[0]["Bytes_selected"], rec[0]["Bytes_gathered"]
        row = sum(np.dtype(c.dtype).itemsize
                  for c in stream.columns(0, 1).values())
        out.update(gathered_pct=100.0 * gat / sel, row_bytes=row,
                   kept_rows=sel // row, gathered_bytes_a_row=gat / (sel
                                                                / row))
    print(json.dumps(out, indent=1))
    return 0 if same and len(rec) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
