"""Source-level annotations the port's checkers understand (the port's copy
of ``guarded_by``, ``single_threaded``, ``unit`` and ``axes`` from the
reference's analysis package, with its runtime axis validation).

These are ordinary runtime objects (introspectable, importable with zero
dependencies on the analysis framework) whose *syntactic* form is what the
AST checkers read — they match the call by its name, so the reference's
checkers read these copies as they read the originals.  This module is the
single home of the annotations: :mod:`repro_torch.analysis` imports them
from here, and the core modules import them without loading the checkers.
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Callable, Dict, Tuple, TypeVar

__all__ = [
    "AxisContractError",
    "axes",
    "axes_validation",
    "guarded_by",
    "single_threaded",
    "unit",
]

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


# --------------------------------------------------------------------------- #
# units


def unit(u: str, x: Any) -> Any:
    """Assert the physical unit of ``x`` for the units checker; returns ``x``.

    An identity at run time: the *string literal* is what the checker reads,
    so it must be a literal at the call site (``unit("ns", end - start)``).
    Vocabulary: ``"ns"``, ``"s"``, ``"ms"``, ``"us"``, ``"bytes"``,
    ``"gbps"`` (GB/s == bytes/ns), ``"gib"``, ``"mib"``, ``"1"``; compound
    units use ``/`` (``"bytes/s"``).
    """
    if not isinstance(u, str) or not u.strip():
        raise ValueError("unit() requires a non-empty unit string literal")
    return x


# --------------------------------------------------------------------------- #
# named-axis shape contracts


class AxisContractError(TypeError):
    """A tensor reached an ``@axes``-annotated function with the wrong shape."""


_AXES_ACTIVE = 0  # nesting depth of active axes_validation() scopes
_AXES_SINK: Any = None  # innermost scope's record-only list, or None to raise
checks = 0  # calls validated while a scope was active (the sanitizer reads it)


class axes_validation:
    """Context manager that arms run-time checking of ``@axes`` contracts.

    Zero-cost when not entered: decorated functions check one module-global
    integer and call straight through.  Used by
    :class:`repro_torch.analysis.sanitize.AxisSanitizer`; nests correctly.

    With ``sink`` (a list), violation messages are appended to it instead
    of raising — the innermost scope's mode wins while it is active.
    """

    def __init__(self, sink: Any = None) -> None:
        self._sink = sink
        self._prev_sink: Any = None

    def __enter__(self) -> "axes_validation":
        global _AXES_ACTIVE, _AXES_SINK
        _AXES_ACTIVE += 1
        self._prev_sink = _AXES_SINK
        _AXES_SINK = self._sink
        return self

    def __exit__(self, *exc: Any) -> None:
        global _AXES_ACTIVE, _AXES_SINK
        _AXES_ACTIVE -= 1
        _AXES_SINK = self._prev_sink


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
    parameters, so a transposed ``[N, B]`` dispatch fails the moment ``B``
    binds two sizes), integer literals (exact sizes) or ``_`` (any size);
    ``""`` is a scalar.  The static axes checker
    (:mod:`repro_torch.analysis.axes`) reads the decorator's literal
    arguments.  At run time the wrapper checks one module-global integer and
    calls straight through, unless an :class:`axes_validation` scope (armed
    by :class:`~repro_torch.analysis.sanitize.AxisSanitizer`) is active:
    then every call validates the declared axes against the actual
    ``.shape`` tuples before the function runs, so a transposed dispatch
    raises before any kernel launches.  Parameters bound to ``None`` or to
    shapeless values are skipped.  ``functools.wraps`` publishes
    ``__wrapped__`` and the signature.  Malformed specs raise when the
    module is imported.
    """
    parsed_kw = {name: _parse_spec(s) for name, s in kw_specs.items()}
    parsed_pos = tuple(_parse_spec(s) for s in pos_specs)

    def deco(fn: F) -> F:
        sig = inspect.signature(fn)
        params = [
            p.name
            for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
        ]
        if len(parsed_pos) > len(params):
            raise ValueError(
                f"axes(): {len(parsed_pos)} positional specs but "
                f"{fn.__name__} has only {len(params)} positional parameters"
            )
        specs: Dict[str, Tuple[str, ...]] = dict(zip(params, parsed_pos))
        for name, toks in parsed_kw.items():
            if name not in sig.parameters:
                raise ValueError(f"axes(): {fn.__name__} has no parameter {name!r}")
            specs[name] = toks

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            if _AXES_ACTIVE:
                _validate(fn.__qualname__, sig, specs, args, kwargs)
            return fn(*args, **kwargs)

        wrapper.__simlint_axes__ = specs  # type: ignore[attr-defined]
        return wrapper  # type: ignore[return-value]

    return deco


def _fail(msg: str) -> None:
    if _AXES_SINK is not None:
        _AXES_SINK.append(msg)
        return
    raise AxisContractError(msg)


def _validate(
    qualname: str,
    sig: inspect.Signature,
    specs: Dict[str, Tuple[str, ...]],
    args: Tuple[Any, ...],
    kwargs: Dict[str, Any],
) -> None:
    global checks
    checks += 1
    try:
        bound = sig.bind(*args, **kwargs)
    except TypeError:
        return  # let the call itself raise the real signature error
    env: Dict[str, int] = {}
    for name, toks in specs.items():
        if name not in bound.arguments:
            continue
        val = bound.arguments[name]
        if val is None:
            continue
        shape = getattr(val, "shape", None)
        if shape is None:
            continue
        shape = tuple(shape)
        if len(shape) != len(toks):
            _fail(
                f"{qualname}: {name} declared axes [{','.join(toks)}] "
                f"(rank {len(toks)}) but got shape {shape} (rank {len(shape)})"
            )
            continue
        for i, (tok, dim) in enumerate(zip(toks, shape)):
            if tok == "_":
                continue
            if tok.isdigit():
                if int(tok) != dim:
                    _fail(
                        f"{qualname}: {name} axis {i} declared {tok} "
                        f"but got {dim} (shape {shape})"
                    )
                continue
            if tok in env and env[tok] != dim:
                _fail(
                    f"{qualname}: axis {tok!r} bound to {env[tok]} earlier in "
                    f"this call but {name} has {tok}={dim} at position {i} "
                    f"(shape {shape}) — transposed or mismatched dispatch"
                )
            env[tok] = dim
