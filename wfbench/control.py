"""The control of a cell's correctness check: the reference put in the
program's place, its window values computed in the nearest precision
below the configuration's (bfloat16 for the configurations' float32),
judged by the same comparison as a run.  It has to come out not
correct.

    python3 wfbench/control.py --workload <cell> --events <n> \
        --seeds <s> [<s> ...]

``--events`` is the stream length of a run of the cell (its stderr
line says how many events a run made).  Prints, per seed, each number
compared beside its limit and the verdict, as one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from wfbench import harness  # noqa: E402


def lower_precision(values, dtype: str = "bfloat16"):
    """``values`` rounded to ``dtype`` and back to float64."""
    import numpy as np
    import torch
    return torch.from_numpy(np.asarray(values, np.float64)).to(
        getattr(torch, dtype)).to(torch.float64).numpy()


def control(spec: harness.Spec, seed: int, n_events: int) -> dict:
    stream = spec.config_mod.make_stream(spec.config, spec.cell, seed)
    want = spec.reference.windows(spec.config, spec.cell, stream, n_events)
    ctrl = dict(want, value=lower_precision(want["value"]))
    checks, _pairs, _wrong = harness.compare(
        ctrl, want, float(spec.config.get("rtol", 0.0)))
    return {"seed": seed, "events": n_events, "windows": len(want["key"]),
            "checks": checks, "correct": harness.verdict(checks)}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--events", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    spec = harness.Spec(args.workload)
    for seed in args.seeds:
        print(json.dumps(control(spec, seed, args.events)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
