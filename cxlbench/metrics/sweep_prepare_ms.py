"""A sweep's preparation on the host, milliseconds a sweep: the
``sweep.prepare`` spans (placement, skeletons, the topology stack, cascade
keys and cache scales, before the planes are packed)."""

from cxlbench import program_spans


def read(ctx):
    return program_spans.ms_per_unit(ctx, "sweep.prepare")
