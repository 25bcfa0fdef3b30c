"""Step-function builders: training, prefill and decode."""
