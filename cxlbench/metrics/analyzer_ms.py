"""The analyzer's milliseconds a unit, from the program's report (the
engine thread's seconds a dispatch: ``SimReport.analyzer_s`` a step,
``FabricReport.analyzer_s`` a round), overlapped with the unit."""


def read(ctx):
    c = ctx["counters"]
    if "analyzer_s" not in c or not c["units"]:
        return None
    return 1e3 * c["analyzer_s"] / c["units"]
