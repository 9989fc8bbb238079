"""fold_pct: the share (%) of the measured window that the native
engine spent folding chunks: the union of the port's ``windflow/fold``
ranges (one a chunk's ingest, recorded under WINDFLOW_TORCH_PROFILE=1),
clipped to the window, over the window's length."""

from wfbench import roofline


def read(run):
    prof = run.profile
    if prof is None:
        return None
    folds = [(a, b) for name, a, b in prof.host if name == "windflow/fold"]
    busy = roofline.busy_s(folds, run.t_start, run.t_end)
    if busy == 0.0:
        return None
    return 100.0 * busy / run.window_s
