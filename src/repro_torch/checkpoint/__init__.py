"""Checkpoints and the fault-tolerance manager (port of ``repro/checkpoint``)."""
