"""A sweep's host-to-device transfer milliseconds (``SweepResult.transfer_s``,
CUDA events)."""


def read(ctx):
    c = ctx["counters"]
    if ctx["traffic"]["kind"] != "scenario_sweep" or not c["units"]:
        return None
    return 1e3 * c["transfer_s"] / c["units"]
