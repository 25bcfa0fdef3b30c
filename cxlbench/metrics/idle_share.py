"""Percent of the window in which no kernel, copy or set ran on the card
(the profiler's device intervals, merged).  One reader for each cell's
``idle_share.<cell>``; the run fails where the busy seconds exceed the
window."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    return 100.0 * (ctx["window_s"] - tr.busy_s) / ctx["window_s"]
