"""The training data pipeline (port of ``repro/data``)."""
