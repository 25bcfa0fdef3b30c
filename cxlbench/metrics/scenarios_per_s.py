"""Scenarios priced over the whole window."""


def read(ctx):
    if ctx["traffic"]["kind"] != "scenario_sweep":
        return None
    return ctx["counters"]["scenarios"] / ctx["window_s"]
