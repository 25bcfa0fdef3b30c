"""Millions of memory events priced a second: every round's real events
(the merged epochs', BI traffic included, no padding), as the reference
rebuilds them, times the rounds, over the window."""


def read(ctx):
    events = ctx["work"].get("events_per_unit")
    if ctx["traffic"]["kind"] != "fabric_rounds" or not events:
        return None
    return events * ctx["counters"]["units"] / ctx["window_s"] / 1e6
