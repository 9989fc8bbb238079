"""ops_self_pct: the share (%) of the measured window spent in the
port's own operator code on the chain's thread: the union of the
``windflow/op/*`` ranges (one an operator's svc call, recorded under
WINDFLOW_TORCH_PROFILE=1), each less the ranges nested in it (lying
wholly inside it) that run on the chain's thread: other operators'
``windflow/op/*``, the fold's ``windflow/fold`` and the benchmark's
generator and application functions (``wfbench/generate``,
``wfbench/filter``, ``wfbench/join``).  The profile records no thread,
so ranges of a dispatcher thread (``windflow/emit/*``,
``windflow/window_launch``, ``wfbench/sink``) are neither summed nor
subtracted, nor is a range that only overlaps an operator's in time."""

import bisect

from wfbench import roofline

OP = "windflow/op/"
NESTED = (OP, "windflow/fold", "wfbench/generate", "wfbench/filter",
          "wfbench/join")


def self_intervals(host):
    """Each ``windflow/op/*`` range less the ranges nested in it, as a
    list of (operator range's name, start, end) pieces."""
    inner = sorted((a, b) for name, a, b in host
                   if name.startswith(NESTED))
    starts = [a for a, _ in inner]
    pieces = []
    for name, a, b in host:
        if not name.startswith(OP):
            continue
        t = a
        i = bisect.bisect_left(starts, a)
        while i < len(inner) and inner[i][0] <= b:
            x, y = inner[i]
            i += 1
            if y > b or (x, y) == (a, b):
                continue      # not wholly inside, or the range itself
            if x > t:
                pieces.append((name, t, x))
            t = max(t, y)
        if b > t:
            pieces.append((name, t, b))
    return pieces


def read(run):
    prof = run.profile
    if prof is None:
        return None
    if not any(name.startswith(OP) and b > run.t_start and a < run.t_end
               for name, a, b in prof.host):
        return None
    pieces = [(a, b) for _, a, b in self_intervals(prof.host)]
    busy = roofline.busy_s(pieces, run.t_start, run.t_end)
    return 100.0 * busy / run.window_s
