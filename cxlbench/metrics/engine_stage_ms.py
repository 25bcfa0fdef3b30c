"""The analyzer's host staging, milliseconds a unit: the ``analyzer.stage``
spans (validating the epochs, the stager, the scale and window rows), on
whichever thread dispatches; the engine's under the asynchronous default."""

from cxlbench import program_spans


def read(ctx):
    return program_spans.ms_per_unit(ctx, "analyzer.stage")
