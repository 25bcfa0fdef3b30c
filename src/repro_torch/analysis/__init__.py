"""simlint for the port — repo-aware static analysis and runtime sanitizers
over ``src/repro_torch`` (the counterpart of the reference's
``repro.analysis``, in PyTorch's idiom; it imports nothing of JAX or the
reference).

The rules encode invariants the simulator has shipped bugs against:

  * **lock-discipline** (:mod:`.locks`): classes declare which attributes a
    lock guards (:func:`repro_torch.annotations.guarded_by`); every lexical
    read/write of a guarded attribute must sit inside a ``with
    <...>.<lock>:`` block.
  * **contracts** (:mod:`.contracts`): ``summary()`` key-set literals must
    match their key-lock tests, and event-trace rebuilds must thread the
    ``weight``/``host``/``qos`` columns.
  * **units** (:mod:`.units`) and **axes** (:mod:`.axes`): physical units
    and named-axis shape contracts, by abstract interpretation.
  * **dispatch** (:mod:`.dispatch`): the counterparts of the reference's
    jit-hygiene rules for eager PyTorch and ctypes kernels — no host sync
    on the card's dispatch path, no library load or ``nvcc`` run around
    ``kernels/build.py``, no f64 in the f32 kernel wrappers.

Run it::

    PYTHONPATH=src python -m repro_torch.analysis --strict

Suppress a finding with an inline ``simlint: ignore[rule] -- justification``
comment on the finding's line (``simlint-torch:`` for the dispatch rules,
which the reference's linter — also run over the port — does not have);
``--strict`` rejects bare suppressions and suppressions that no longer match
anything.

The runtime half lives in :mod:`.sanitize`
(:class:`~.sanitize.RecompileSanitizer`, :class:`~.sanitize.LockOrderSanitizer`,
:class:`~.sanitize.AxisSanitizer`) and :mod:`.pytest_plugin` runs the
port's tests under them.
"""

from .findings import Finding
from .framework import CheckConfig, Checker, SourceFile, registered_checkers, run_checks

__all__ = [
    "CheckConfig",
    "Checker",
    "Finding",
    "SourceFile",
    "registered_checkers",
    "run_checks",
]

# importing the checker modules registers them
from . import axes, contracts, dispatch, locks, units  # noqa: E402,F401  (registration imports)
