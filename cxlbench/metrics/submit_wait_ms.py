"""How long the session's thread waits on the engine, milliseconds a unit:
the ``engine.submit_wait`` spans (backpressure at submit, while the
handle's batches in flight are at their limit)."""

from cxlbench import program_spans


def read(ctx):
    return program_spans.ms_per_unit(ctx, "engine.submit_wait")
