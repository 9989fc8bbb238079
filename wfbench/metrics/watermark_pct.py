"""watermark_pct: the share (%) of the measured window that the window
engines spent on watermarks: the union of the port's
``windflow/watermark`` ranges (one a watermark taken by a window
engine: its firing by event time, the freeing of keys and the launch
of what fired, recorded under WINDFLOW_TORCH_PROFILE=1), clipped to
the window, over the window's length."""

from wfbench import roofline


def read(run):
    prof = run.profile
    if prof is None:
        return None
    spans = [(a, b) for name, a, b in prof.host
             if name == "windflow/watermark"]
    if not spans:
        return None
    return 100.0 * roofline.busy_s(spans, run.t_start, run.t_end) \
        / run.window_s
