"""Run one benchmark cell of windflow_tpu_torch on the card.

    python3 wfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

prints the run's result as one JSON line on standard output, and the
numbers its correctness was judged by on the last lines of standard
error.  It exits non-zero, printing no result, without a CUDA card.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this folder, heads the import path: the
# program and the benchmark's own modules load from the checkout
sys.path[0] = ROOT

if __name__ == "__main__":
    from wfbench import harness
    sys.exit(harness.main(sys.argv[1:]))
