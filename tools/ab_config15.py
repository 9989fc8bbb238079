"""A/B of bench config 15's FFAT rebuild lane between two checkouts, on
one CUDA card.

    python3 tools/ab_config15.py PARENT_DIR CHANGE_DIR [--pairs 10]

Each run is a fresh process started in one checkout: it builds that
checkout's kernels (a no-op once built), drives the rebuild lane
(``chip_smoke.run15`` with ``chip_smoke.ffat_lane("rebuild")``: 8M
events, CB window 4096 / slide 16) through the checkout's own port,
holds every window to the closed-form oracle and reports tuples/s and
the window latency p50 / p99.  Runs alternate between the checkouts,
the parent first in even pairs and the change first in odd ones.  The
script prints every run, then per side the median and quartiles of each
metric, and how many pairs the change won.  Exits non-zero if a run
fails or no CUDA device is present.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

# one run, executed with the checkout as the working directory
_CHILD = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from windflow_tpu_torch.ops.cuda import flatfat_query, window_sum
from windflow_tpu_torch.runtime import native
if not torch.cuda.is_available():
    sys.exit("no CUDA device")
window_sum.load_kernel()
flatfat_query.load_kernel()
native.get_lib()
g, sink, secs = cs.run15(lambda: cs.ffat_lane("rebuild"), cs.N15,
                         cs.SLIDE15)
got = cs.sorted_windows(sink, "ab")
cs.hold_to_oracle(got, cs.oracle15(cs.N15, cs.SLIDE15), "ab")
p50, p99 = (float(np.percentile(got[3], q)) * 1e3 for q in (50, 99))
print(json.dumps({"tuples_per_s": cs.N15 / secs, "p50_ms": p50,
                  "p99_ms": p99}))
"""

METRICS = ("tuples_per_s", "p50_ms", "p99_ms")


def run_once(tree: str) -> dict:
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=tree,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"run in {tree} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    trees = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    runs = {"parent": [], "change": []}
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for side in order:
            r = run_once(trees[side])
            runs[side].append(r)
            print(f"pair {i} {side}: " + ", ".join(
                f"{m} {r[m]:.3f}" for m in METRICS), flush=True)
    for m in METRICS:
        higher_better = m == "tuples_per_s"
        a = np.array([r[m] for r in runs["parent"]])
        b = np.array([r[m] for r in runs["change"]])
        wins = int(np.sum(b > a) if higher_better else np.sum(b < a))
        line = "; ".join(
            f"{side} median {np.median(v):.3f} (quartiles "
            f"{np.percentile(v, 25):.3f} .. {np.percentile(v, 75):.3f})"
            for side, v in (("parent", a), ("change", b)))
        print(f"{m}: {line}; change better in {wins} of {args.pairs} "
              f"pairs", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
