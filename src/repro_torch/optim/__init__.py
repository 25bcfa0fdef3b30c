"""Optimizer and gradient compression for the training step (port of
``repro/optim``)."""
