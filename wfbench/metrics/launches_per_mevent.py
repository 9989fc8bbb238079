"""launches_per_mevent: device launches of the window engines (the
stats' Device_launches) over the window, per million source events."""


def read(run):
    events = run.events_in_window
    if events == 0:
        return None
    return run.counter_delta("launches") / (events / 1e6)
