"""Milliseconds a step of simulation left exposed: window seconds a step
less the report's native seconds a step (the host clock around the step
and its output stream's sync)."""


def read(ctx):
    c = ctx["counters"]
    if ctx["traffic"]["kind"] != "attached_prefill" or not c["units"]:
        return None
    return 1e3 * (ctx["window_s"] - c["native_s"]) / c["units"]
