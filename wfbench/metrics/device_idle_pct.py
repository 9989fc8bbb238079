"""device_idle_pct: the share (%) of the measured window in which no
kernel, copy or set ran on the card: one minus the union of the
device's intervals in the trace over the window's length."""

from wfbench import roofline


def read(run):
    prof = run.profile
    if prof is None:
        return None
    busy = roofline.busy_s(prof.device_intervals(), run.t_start, run.t_end)
    return 100.0 * (1.0 - busy / run.window_s)
