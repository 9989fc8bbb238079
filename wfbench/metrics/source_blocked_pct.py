"""source_blocked_pct: the share (%) of the measured window that the
source thread spent outside the benchmark's generator callback, handing
batches to the graph (running the chained operators, waiting on a full
channel), by the benchmark's own clock."""


def read(run):
    calls = run.window_calls()
    if len(calls) == 0:
        return None
    inside = float((calls[:, 1] - calls[:, 0]).sum())
    return 100.0 * (1.0 - inside / run.window_s)
