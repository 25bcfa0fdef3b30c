"""Finding records — the machine-readable output unit of the port's simlint
(a copy of ``repro/analysis/findings.py``)."""

from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["Finding"]


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at one source location.

    Sort order (path, line, col) gives deterministic reports; ``rule`` is
    the suppression key (``# simlint: ignore[<rule>] -- why``).
    """

    path: str
    line: int
    col: int
    rule: str
    message: str
    checker: str = ""

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"

    def to_dict(self) -> Dict[str, object]:
        return {
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "rule": self.rule,
            "message": self.message,
            "checker": self.checker,
        }
