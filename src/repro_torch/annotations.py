"""Source-level lock annotations (the port's copy of ``guarded_by`` and
``single_threaded`` from the reference's analysis package).

Both are zero-cost at run time: a class declares which fields belong to
which lock, and a method says why it runs on one thread only.  A
lock-discipline checker reads the *syntactic* form — it matches the call by
its name — so these copies are read the same way as the originals, and the
port needs nothing of the analysis framework itself.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple, TypeVar

__all__ = ["guarded_by", "single_threaded"]

F = TypeVar("F", bound=Callable)


def guarded_by(lock: str, *fields: str) -> Dict[str, Tuple[str, ...]]:
    """Declare that ``fields`` may only be accessed while ``<lock>`` is held.

    Used as a class-body declaration::

        class Session:
            _simlint_guards = guarded_by("_report_lock", "_report")

    Each field is an attribute name (``"_report"`` matches any
    ``<expr>._report``) or a dotted pair (``"_handle.dropped_batches"``
    matches only ``<expr>._handle.dropped_batches``).  ``lock`` is matched by
    the final attribute name of a ``with`` item's context expression:
    ``with self._cv:`` and ``with self.engine._cv:`` both hold ``"_cv"``.
    ``__init__``, methods whose name ends in ``_locked`` (the caller holds
    the lock) and methods marked :func:`single_threaded` are exempt.
    Declarations merge with ``|``.
    """
    return {lock: tuple(fields)}


def single_threaded(reason: str) -> Callable[[F], F]:
    """Mark a method as running on one thread only; the reason is
    mandatory."""
    if not isinstance(reason, str) or not reason.strip():
        raise ValueError("single_threaded requires a non-empty reason string")

    def mark(fn: F) -> F:
        fn.__simlint_single_threaded__ = reason  # type: ignore[attr-defined]
        return fn

    return mark
