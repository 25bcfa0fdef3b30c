"""CXLMemSim in PyTorch for NVIDIA Hopper — the port of :mod:`repro`.

The JAX package ``repro`` stays the reference; this package imports nothing
of it and never imports ``jax``.  Entry points take a ``device`` argument
that defaults to ``"cuda"``; ``device="cpu"`` runs the plain PyTorch
versions of the kernels.  See ``ROADMAP.md`` for what is ported so far.
"""
