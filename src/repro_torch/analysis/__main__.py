"""``python -m repro_torch.analysis`` — the port's simlint CLI.

Examples::

    PYTHONPATH=src python -m repro_torch.analysis --strict   # the port's gate
    PYTHONPATH=src python -m repro_torch.analysis --json src/repro_torch/core
    PYTHONPATH=src python -m repro_torch.analysis --checkers dispatch,locks

With no paths it checks ``src/repro_torch`` and the port's tests
(``tests/test_torch_*.py``) under the repository root.

Exit status: 0 clean, 1 findings, 2 usage error.  ``--strict`` additionally
fails on suppressions without a ``-- justification`` and on suppressions
that no longer suppress anything.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .framework import registered_checkers, run_checks


def _find_root(start: Path) -> Path:
    """The repo root: nearest ancestor holding pyproject.toml or .git."""
    for p in [start] + list(start.parents):
        if (p / "pyproject.toml").exists() or (p / ".git").exists():
            return p
    return start


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files/directories to check (default: src/repro_torch and "
        "tests/test_torch_*.py under the repo root)",
    )
    parser.add_argument(
        "--strict", action="store_true",
        help="also fail on bare or unused suppressions",
    )
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="machine-readable findings on stdout",
    )
    parser.add_argument(
        "--checkers", default=None,
        help="comma-separated subset (default: all registered)",
    )
    parser.add_argument(
        "--root", default=None,
        help="repo root override (default: auto-detected)",
    )
    args = parser.parse_args(argv)

    root = Path(args.root).resolve() if args.root else _find_root(Path.cwd())
    paths = (
        [Path(p) for p in args.paths]
        if args.paths
        else [root / "src" / "repro_torch"] + sorted((root / "tests").glob("test_torch_*.py"))
    )
    for p in paths:
        if not p.exists():
            print(f"error: no such path: {p}", file=sys.stderr)
            return 2
    checker_names = None
    if args.checkers:
        checker_names = [c.strip() for c in args.checkers.split(",") if c.strip()]
        unknown = set(checker_names) - set(registered_checkers())
        if unknown:
            print(
                f"error: unknown checkers {sorted(unknown)}; "
                f"registered: {sorted(registered_checkers())}",
                file=sys.stderr,
            )
            return 2

    report = run_checks(
        paths, root, strict=args.strict, checker_names=checker_names
    )
    if args.as_json:
        print(json.dumps(
            {
                "findings": [f.to_dict() for f in report.findings],
                "suppressed": [
                    {**f.to_dict(), "justification": s.justification}
                    for f, s in report.suppressed
                ],
                "files_checked": report.files_checked,
            },
            indent=2,
        ))
    else:
        for f in report.findings:
            print(f.format())
        print(
            f"simlint: {len(report.findings)} finding(s), "
            f"{len(report.suppressed)} suppressed, "
            f"{report.files_checked} file(s) checked"
            + (" [strict]" if args.strict else "")
        )
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
