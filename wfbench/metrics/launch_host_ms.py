"""launch_host_ms: the mean host duration of the port's launch_span
ranges (``windflow/window_launch``, one a device launch, recorded under
WINDFLOW_TORCH_PROFILE=1) that began in the window."""


def read(run):
    prof = run.profile
    if prof is None:
        return None
    spans = [b - a for name, a, b in prof.host
             if name.startswith("windflow/window_launch")
             and run.t_start <= a < run.t_end]
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
