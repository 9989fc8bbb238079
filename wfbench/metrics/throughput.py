"""throughput: events the source handed to the graph during the
measured window, over the window's seconds (host clock).  The window
starts at a source call and ends at the first call past its length, so
every event counted was taken by the graph inside it."""


def read(run):
    return run.events_in_window / run.window_s
