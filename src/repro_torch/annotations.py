"""Source-level annotations (the port's copy of ``guarded_by``,
``single_threaded`` and ``axes`` from the reference's analysis package).

All are zero-cost at run time: a class declares which fields belong to
which lock, a method says why it runs on one thread only, and a dispatch
surface declares the named axes of its tensor parameters.  The checkers
read the *syntactic* form — they match the call by its name — so these
copies are read the same way as the originals, and the port needs nothing
of the analysis framework itself.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple, TypeVar

__all__ = ["axes", "guarded_by", "single_threaded"]

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


def _parse_spec(spec: str) -> Tuple[str, ...]:
    toks = tuple(t.strip() for t in spec.split(",")) if spec.strip() else ()
    for t in toks:
        if not (t == "_" or t.isdigit() or t.isidentifier()):
            raise ValueError(f"bad axis token {t!r} in spec {spec!r}")
    return toks


def axes(*pos_specs: str, **kw_specs: str) -> Callable[[F], F]:
    """Declare named-axis shape contracts on a function's tensor parameters.

    Positional specs bind to the function's leading parameters in order,
    keyword specs by parameter name::

        @axes("B,N", bits="B,N", stts="S")
        def congestion_cascade(t, bits, stts): ...

    A spec is a comma-separated axis list: names (unified across one call's
    parameters), integer literals (exact sizes) or ``_`` (any size); ``""``
    is a scalar.  The static axes checker reads the decorator's literal
    arguments; at run time the function is returned unchanged (the
    reference's runtime validation has no counterpart here).  Malformed
    specs raise when the module is imported."""
    for spec in pos_specs + tuple(kw_specs.values()):
        _parse_spec(spec)

    def mark(fn: F) -> F:
        return fn

    return mark
