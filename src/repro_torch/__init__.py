"""CXLMemSim in PyTorch for NVIDIA Hopper — the port of :mod:`repro`.

The JAX package ``repro`` stays the reference; this package imports nothing
of it and never imports ``jax``.  Entry points take a ``device`` argument
that defaults to ``"cuda"``; ``device="cpu"`` runs the plain PyTorch
versions of the kernels.  See ``ROADMAP.md`` for what is ported so far.
"""

import torch as _torch

# A workaround, its cause not confirmed.  Under parallel test workers the
# port's plain chunked SSD scan, run as a process's first vectorized op over
# 2 intra-op threads, now and then came out off by about 1e-4 relative
# (torch 2.13 on an AMX-capable Xeon, about 1 of 10 fresh processes, the
# same values in every failing worker), and never after one small
# single-threaded exp first.  Lazy, thread-unsafe setup of the elementwise
# kernels fits that, as would thread-local math-library state; the fault did
# not recur outside the test workers, so neither is shown.  The port's plain
# versions are the CPU reference of its kernels, so that call is made here,
# once, before any of them runs; tests/test_torch_ssd.py runs the scan first
# in fresh 2-thread processes to guard it.
_torch.exp(_torch.zeros(1))
