"""close_lag_ms: how long a closed window takes to reach the sink.  For
each window due inside the measured window, the time from the end of
the source call whose last event carried the watermark (the last
event's time less the configuration's lag) past the window's end to the
first arrival of the window's rows at the sink; the median over those
windows, in ms, by the host's clock.  Window w spans event time
[w * slide, w * slide + window); event n lies at time n (units of
1/event_rate s)."""

import numpy as np


def read(run):
    cfg = run.config
    if "watermark_lag_s" not in cfg or run.results is None:
        return None
    rate = int(cfg["event_rate"])
    win, slide = int(cfg["window_s"] * rate), int(cfg["slide_s"] * rate)
    lag = int(cfg["watermark_lag_s"] * rate)
    calls = np.array(run.calls, dtype=np.float64).reshape(-1, 4)
    if len(calls) == 0:
        return None
    last = calls[:, 3] + calls[:, 2] - 1          # each call's last event
    wids = run.results["wid"]
    arrival = run.results["arrival"]
    lags = []
    for w in np.unique(wids):
        # the first call after which the watermark passes the window's end
        k = int(np.searchsorted(last - lag, w * slide + win, side="left"))
        if k >= len(calls):
            continue
        t_due = calls[k, 1]
        if not run.t_start <= t_due < run.t_end:
            continue
        lags.append(arrival[wids == w].min() - t_due)
    if not lags:
        return None
    return 1e3 * float(np.median(lags))
