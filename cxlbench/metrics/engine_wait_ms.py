"""The analyzer's wait for its totals, milliseconds a unit: the
``analyzer.finish`` spans, the one device-to-host copy of a dispatch,
which waits for the device's work on it."""

from cxlbench import program_spans


def read(ctx):
    return program_spans.ms_per_unit(ctx, "analyzer.finish")
