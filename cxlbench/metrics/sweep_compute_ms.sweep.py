"""A sweep's device compute milliseconds, cascades and reduce to the
result on the host (``SweepResult.compute_s``, CUDA events)."""


def read(ctx):
    c = ctx["counters"]
    if ctx["traffic"]["kind"] != "scenario_sweep" or not c["units"]:
        return None
    return 1e3 * c["compute_s"] / c["units"]
