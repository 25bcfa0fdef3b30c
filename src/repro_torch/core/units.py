"""Named unit-conversion constants and helpers — the only legal conversion
points.  A copy of ``repro/core/units.py``: the port imports nothing of the
JAX package, so it keeps its own.

Every ns↔s / ns↔ms / GiB↔bytes / GB↔bytes scale change in the simulator
routes through this module.  The simdim units checker
(:mod:`repro.analysis.units`) enforces that: a raw ``* 1e-9`` against a
``_ns`` value anywhere else is a ``unit-raw-conversion`` finding, because
scattered conversion literals are exactly how the shipped ns↔s accounting
slips happened.  This file is the checker's one exempt definition site.

Conventions the constants encode (see ``core/topology.py`` docstrings):

* ``_gbps`` fields are **GB/s == bytes/ns** (the 1e9 cancels), so bandwidth
  math inside the analyzers needs no conversion at all — ``bytes / gbps``
  is already ns.
* Decimal (``GB``, 1e9) is used for link rates; binary (``GiB``/``MiB``,
  2**30/2**20) for memory capacities, matching vendor datasheets.

Each helper keeps the exact arithmetic form (``* 1e-9`` vs ``/ 1e9``) of
the call sites it replaced, so the refactor is bitwise-neutral.  All
helpers are plain float scaling, so they work on Python floats, numpy
arrays and torch tensors alike.
"""

from __future__ import annotations

__all__ = [
    "BYTES_PER_GB",
    "BYTES_PER_GIB",
    "BYTES_PER_MIB",
    "FLOPS_PER_GFLOP",
    "NS_PER_MS",
    "NS_PER_S",
    "MS_PER_S",
    "NS_PER_US",
    "S_PER_NS",
    "bytes_to_gib",
    "bytes_to_mib",
    "gbps_to_bytes_per_s",
    "gib_to_bytes",
    "mib_to_bytes",
    "ms_to_ns",
    "ns_to_ms",
    "ns_to_s",
    "ns_to_us",
    "s_to_ms",
    "s_to_ns",
    "us_to_ns",
]

# time: the simulator's native clock is nanoseconds; reports are seconds
NS_PER_S = 1e9
S_PER_NS = 1e-9
NS_PER_MS = 1e6
NS_PER_US = 1e3
MS_PER_S = 1e3

# data: decimal GB for rates, binary GiB/MiB for capacities (exact ints)
BYTES_PER_GB = 1e9
BYTES_PER_GIB = 2**30
BYTES_PER_MIB = 2**20

FLOPS_PER_GFLOP = 1e9


def ns_to_s(x):
    """Simulated-nanosecond totals -> report seconds (``* 1e-9`` form)."""
    return x * S_PER_NS


def s_to_ns(x):
    """Wall/roofline seconds -> simulator nanoseconds (``* 1e9`` form)."""
    return x * NS_PER_S


def s_to_ms(x):
    """Report seconds -> milliseconds for human-facing prints (``* 1e3``)."""
    return x * MS_PER_S


def ns_to_ms(x):
    """Nanoseconds -> milliseconds for human-facing tables (``/ 1e6``)."""
    return x / NS_PER_MS


def ms_to_ns(x):
    return x * NS_PER_MS


def ns_to_us(x):
    return x / NS_PER_US


def us_to_ns(x):
    return x * NS_PER_US


def gib_to_bytes(x):
    """Binary-GiB capacities -> bytes; exact for integer inputs."""
    return x * BYTES_PER_GIB


def bytes_to_gib(x):
    return x / BYTES_PER_GIB


def mib_to_bytes(x):
    return x * BYTES_PER_MIB


def bytes_to_mib(x):
    return x / BYTES_PER_MIB


def gbps_to_bytes_per_s(x):
    """Link rate in GB/s (== bytes/ns) -> bytes per *second*."""
    return x * BYTES_PER_GB
