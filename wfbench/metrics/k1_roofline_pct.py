"""k1_roofline_pct: K1's share (%) of its roofline over the window:
the least time the card needs for the windows launched in the window
(each window's pane partials read once, its result written once, its
extent read once, over 3.35 TB/s), over K1's device time in the
window's trace.  The work is the benchmark's own count (windows the
engines staged, times the panes a window of the configuration), so it
reads the same whatever kernel does it."""

import math

from wfbench import roofline


def read(run):
    prof = run.profile
    if prof is None:
        return None
    k1 = [(a, b) for a, b in prof.device_intervals("window_sum")
          if run.t_start <= a < run.t_end]
    if not k1:
        return None
    busy = sum(b - a for a, b in k1)
    panes = _panes(run.config["window_s"], run.config["slide_s"])
    nbytes = roofline.window_sum_bytes(
        run.counter_delta("windows_launched"), panes)
    return 100.0 * roofline.bound_s(nbytes) / busy


def _panes(win, slide):
    """Panes a window: the window over gcd(window, slide), in ms."""
    w, s = round(win * 1000), round(slide * 1000)
    return w // math.gcd(w, s)
