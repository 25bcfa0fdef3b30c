"""The analyzer's host-to-device copies, milliseconds a unit on the host's
clock: the ``analyzer.transfer`` spans (on the default path the pageable
copies of every plane, and any wait for the stream inside them)."""

from cxlbench import program_spans


def read(ctx):
    return program_spans.ms_per_unit(ctx, "analyzer.transfer")
